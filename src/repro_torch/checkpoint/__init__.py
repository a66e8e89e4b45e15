"""Chunk-granular checkpoints of the port, in the reference's format."""
