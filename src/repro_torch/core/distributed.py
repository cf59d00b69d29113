"""Sharded tables: the stack helpers of the reference's ``distributed.py``.

A sharded deployment holds one table a shard, stacked on a leading axis
(``make_stacked``, which is ``dhash.make_stack``); inside a shard's program
``peel`` gives its table and ``unpeel`` puts it back.  Only these helpers
are ported so far: the router (owner hashing, the capped exchange of
``routed_lookup`` / ``routed_update`` / ``routed_stack_lookup`` /
``routed_stack_update``, ``routed_service_step``) is ``ROADMAP.md`` A6.
"""
from __future__ import annotations

import torch

from repro_torch.core import dhash
from repro_torch.core.struct_utils import map_tensors


def make_stacked(nshards: int, backend: str = "linear", capacity: int = 1024,
                 *, chunk: int = 256, seed: int = 0,
                 device: torch.device | str = "cuda",
                 **kw) -> dhash.DHashState:
    """``nshards`` independent shard tables stacked on a leading axis
    (``dhash.make_stack``: shard i seeded ``seed + i``)."""
    return dhash.make_stack(nshards, backend, capacity, chunk=chunk,
                            seed=seed, device=device, **kw)


def peel(stacked: dhash.DHashState) -> dhash.DHashState:
    """A shard's table from its one-table stack (leading axis of size 1):
    a VIEW, so writes through it land in ``stacked``."""
    return map_tensors(lambda x: x[0], stacked)


def unpeel(d: dhash.DHashState) -> dhash.DHashState:
    """The inverse of ``peel``: ``d`` as a one-table stack (a view)."""
    return map_tensors(lambda x: x.unsqueeze(0), d)
