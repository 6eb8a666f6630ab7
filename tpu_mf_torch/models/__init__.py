"""Model state and evaluation."""
