"""Training-side utilities of the port: checkpoints (`train/checkpoint`),
the optimizers (`train/optimizer`) and the fault-tolerant loop
(`train/loop`)."""
