"""Optimizers: Adam in its fused (decoupled-decay) and coupled forms."""
