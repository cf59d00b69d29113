"""DHash core for PyTorch: hashing, the linear bucket table, the backend
registry, the live-rebuild protocol and the engine."""
