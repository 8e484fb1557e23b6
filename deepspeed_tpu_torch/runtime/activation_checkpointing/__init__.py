"""Activation checkpointing (JAX ``runtime/activation_checkpointing``)."""
