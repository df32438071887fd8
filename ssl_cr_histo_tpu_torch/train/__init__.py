"""Training support: optimizer, state, checkpoints, epoch helpers."""
