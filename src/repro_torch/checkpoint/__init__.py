"""Checkpoints in the reference's format."""
