"""Core retrieval modules: distances, engine, builders, index, spec, metrics."""
