"""Training data: the patch dataset and the per-step input draw and
augmentation."""
