"""Training: the optimizer, its schedule and the train step."""
