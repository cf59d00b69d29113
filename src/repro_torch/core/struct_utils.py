"""State-container helpers.

Every state object in the port is a frozen dataclass whose array fields are
``torch.Tensor``s and whose configuration fields are plain Python values.
There is no pytree registration: PyTorch runs eagerly, so containers are
just passed around.  ``replace`` builds a new container that SHARES the
tensors it was not given — it never copies device memory.  ``assign_``
goes the other way: it writes one container's tensors into another's in
place, for a caller that must keep its tensors' storage (an engine step
captured in a CUDA graph).  ``map_tensors`` builds a container of the same
structure from one or more (a table stack, its views, copies).
"""
from __future__ import annotations

import dataclasses
from typing import TypeVar

import torch

_T = TypeVar("_T")


def state_dataclass(cls: type[_T]) -> type[_T]:
    """Decorator: frozen dataclass (the counterpart of the reference's
    ``pytree_dataclass``, minus the pytree registration)."""
    return dataclasses.dataclass(frozen=True)(cls)


def replace(obj: _T, **kw) -> _T:
    return dataclasses.replace(obj, **kw)  # type: ignore[type-var]


def assign_(dst, src, where=None) -> None:
    """Write every tensor of container ``src`` into the tensor at the same
    place in ``dst`` (same structure), IN PLACE, so that ``dst``'s tensors
    keep their storage: a tensor ``src`` shares with ``dst`` is skipped.
    With ``where`` (a 0-dim bool tensor) each is taken only where it is set
    (``torch.where``, decided on the device)."""
    if dst is src:
        return
    if isinstance(dst, torch.Tensor):
        dst.copy_(src if where is None else torch.where(where, src, dst))
        return
    if dataclasses.is_dataclass(dst):
        for f in dataclasses.fields(dst):
            assign_(getattr(dst, f.name), getattr(src, f.name), where)


def map_tensors(fn, obj, *more):
    """A container of ``obj``'s structure whose every tensor is ``fn`` of
    the tensors at the same place in ``obj`` and ``more`` (containers of
    one structure); every other field is ``obj``'s."""
    if isinstance(obj, torch.Tensor):
        return fn(obj, *more)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{
            f.name: map_tensors(fn, getattr(obj, f.name),
                                *(getattr(m, f.name) for m in more))
            for f in dataclasses.fields(obj)})
    return obj
