"""Training-side utilities of the port: checkpoints (`train/checkpoint`)."""
