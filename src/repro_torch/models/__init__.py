"""Models: the two-tower retrieval model and its embedding substrate."""
