"""Configurations of the port (own copies; nothing is imported from the
reference package)."""
