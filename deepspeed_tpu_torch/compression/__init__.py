"""Compression: int8 serving weights (``int8.py``)."""
