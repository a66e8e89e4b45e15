"""Model math of the port (dense tp=1 subset)."""
