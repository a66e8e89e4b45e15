"""Chunk-based heterogeneous memory management (PatrickStar core), ported."""
