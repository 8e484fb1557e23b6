"""Runtime configuration base."""
