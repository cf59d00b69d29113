"""PyTorch/CUDA port of DHash (NVIDIA Hopper).

The JAX package ``repro`` is the reference; this package is its counterpart
for one H100.  Layout and names mirror the reference so a reader finds the
counterpart of every module:

* ``core/``    — hashing, the linear bucket table, the backend registry,
                 the DHash rebuild protocol and the engine that drives it;
* ``kernels/`` — the hand-written CUDA kernels (``csrc/*.cu``), their
                 wrappers and plain PyTorch versions (``probe.py``), and the
                 op layer built on them (``ops.py``);
* ``configs/`` — the ``dhash-paper`` service configuration;
* ``convert.py`` — state to and from nested dicts of numpy arrays.

Importing this package (or any module in it) builds nothing and needs no
GPU: kernels are compiled the first time one is launched.
"""
