"""Checkpoints, logs and meters of a training run."""
