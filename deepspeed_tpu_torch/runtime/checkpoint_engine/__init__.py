"""Checkpoint engines: the atomic layout, the torch engine and the async writer."""
