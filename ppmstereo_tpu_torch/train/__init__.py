"""Training: loss, optimiser, step, checkpoints, the loop."""
