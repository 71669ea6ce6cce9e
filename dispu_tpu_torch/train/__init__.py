"""CD training: the state with its Adam moments, the steps and the
trainer."""
