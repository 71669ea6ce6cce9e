"""Point-cloud ops: geometry, kNN, FPS and gathers."""
