"""State-container helpers.

Every state object in the port is a frozen dataclass whose array fields are
``torch.Tensor``s and whose configuration fields are plain Python values.
There is no pytree registration: PyTorch runs eagerly, so containers are
just passed around.  ``replace`` builds a new container that SHARES the
tensors it was not given — it never copies device memory.
"""
from __future__ import annotations

import dataclasses
from typing import TypeVar

_T = TypeVar("_T")


def state_dataclass(cls: type[_T]) -> type[_T]:
    """Decorator: frozen dataclass (the counterpart of the reference's
    ``pytree_dataclass``, minus the pytree registration)."""
    return dataclasses.dataclass(frozen=True)(cls)


def replace(obj: _T, **kw) -> _T:
    return dataclasses.replace(obj, **kw)  # type: ignore[type-var]
