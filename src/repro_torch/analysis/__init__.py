"""Analysis of the port: the card's constants, the analytical cost model
that prices the transfer timeline's operators, and the trace reader."""
