"""DHash core for PyTorch: hashing, the linear bucket table, the backend
registry, the live-rebuild protocol and the engine, and the paper's
comparison tables (``baselines``).  The package imports ``baselines`` only:
``backend`` needs the kernel wrappers, which import ``hashing`` from here."""

from repro_torch.core import baselines

__all__ = ["baselines"]
