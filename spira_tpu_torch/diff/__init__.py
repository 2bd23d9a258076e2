"""Inverse rendering: recover scene parameters by gradient descent."""
