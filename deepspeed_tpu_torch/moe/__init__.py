"""Dense FFN (the expert stacks are not ported yet)."""
