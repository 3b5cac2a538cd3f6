"""Optimizer: AdamW on the port's param trees."""
