"""Normalization, metrics and checkpoints (the serving subset)."""
