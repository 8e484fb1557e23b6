"""Mixed-precision support: loss scaling."""
