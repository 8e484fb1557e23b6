"""Adagrad."""
