"""The compiled chunked-ZeRO runtime of the port (``repro.runtime`` twin)."""
