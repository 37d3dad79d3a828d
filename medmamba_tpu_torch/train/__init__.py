"""Training: the optimizer, the steps and checkpoints."""
