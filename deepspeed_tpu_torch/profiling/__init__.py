"""Metrics and the no-op tracer the scheduler uses."""
