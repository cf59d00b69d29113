"""State to and from nested dicts of numpy arrays.

The layout mirrors the field names of the reference's ``DHashState`` /
``LinearTable`` / ``HashFn``, so a state of either package flattens to the
same tree and both can start from — and be compared on — the same bytes:

    {"backend": str, "chunk": int, "fwd_hazard": bool, "fused": bool,
     "nres_cap": int,
     "old": {"capacity": int, "max_probes": int,
             "hfn": {"kind": str, "seeds": uint32[...]},
             "key": int32[C], "val": int32[C], "state": int32[C]},
     "new": {...},
     "hazard_key": int32[chunk], "hazard_val": int32[chunk],
     "hazard_live": bool[chunk],
     "cursor": int32[], "rebuilding": bool[], "epoch": int32[],
     "lookups": int32[], "expensive": int32[]}

Hash seeds are ``uint32`` in the tree and int64 words in ``[0, 2**32)`` in
the port.  The insert kernel's claim scratch is not part of a table's
contents: it is made anew on the way in and left out on the way back.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import buckets, hashing
from repro_torch.core.dhash import DHashState

_SCALARS = (("cursor", np.int32), ("rebuilding", np.bool_),
            ("epoch", np.int32), ("lookups", np.int32),
            ("expensive", np.int32))
_STATIC = ("backend", "chunk", "fwd_hazard", "fused", "nres_cap")


def _to_dev(a, dtype, device) -> torch.Tensor:
    # np.array copies: the port owns (and may write) what it is given
    return torch.as_tensor(np.array(a, dtype=dtype), device=device)


def table_from_numpy(tree: dict, device: torch.device | str = "cuda"
                     ) -> buckets.LinearTable:
    """One ``LinearTable`` on ``device`` from its tree."""
    dev = torch.device(device)
    seeds = np.asarray(tree["hfn"]["seeds"]).astype(np.uint32)
    hfn = hashing.HashFn(kind=str(tree["hfn"]["kind"]),
                         seeds=_to_dev(seeds.astype(np.int64), np.int64, dev))
    capacity = int(tree["capacity"])
    claim = None
    if dev.type == "cuda":
        from repro_torch.kernels.probe import new_claim
        claim = new_claim(capacity, dev)
    return buckets.LinearTable(
        capacity=capacity, max_probes=int(tree["max_probes"]), hfn=hfn,
        key=_to_dev(tree["key"], np.int32, dev),
        val=_to_dev(tree["val"], np.int32, dev),
        state=_to_dev(tree["state"], np.int32, dev), claim=claim)


def table_to_numpy(t: buckets.LinearTable) -> dict:
    return {"capacity": t.capacity, "max_probes": t.max_probes,
            "hfn": {"kind": t.hfn.kind,
                    "seeds": t.hfn.seeds.cpu().numpy().astype(np.uint32)},
            "key": t.key.cpu().numpy(), "val": t.val.cpu().numpy(),
            "state": t.state.cpu().numpy()}


def state_from_numpy(tree: dict, device: torch.device | str = "cuda"
                     ) -> DHashState:
    """The port's ``DHashState`` on ``device`` from a tree laid out as the
    module docstring says."""
    kw = {"backend": str(tree["backend"]), "chunk": int(tree["chunk"]),
          "fwd_hazard": bool(tree["fwd_hazard"]), "fused": bool(tree["fused"]),
          "nres_cap": int(tree["nres_cap"])}
    for name, dt in _SCALARS:
        kw[name] = _to_dev(np.asarray(tree[name], dtype=dt).reshape(()), dt,
                           device)
    return DHashState(
        old=table_from_numpy(tree["old"], device),
        new=table_from_numpy(tree["new"], device),
        hazard_key=_to_dev(tree["hazard_key"], np.int32, device),
        hazard_val=_to_dev(tree["hazard_val"], np.int32, device),
        hazard_live=_to_dev(tree["hazard_live"], np.bool_, device), **kw)


def state_to_numpy(d: DHashState) -> dict:
    """Inverse of ``state_from_numpy`` (synchronises: it copies to the host)."""
    tree = {name: getattr(d, name) for name in _STATIC}
    tree["old"] = table_to_numpy(d.old)
    tree["new"] = table_to_numpy(d.new)
    for name in ("hazard_key", "hazard_val", "hazard_live"):
        tree[name] = getattr(d, name).cpu().numpy()
    for name, dt in _SCALARS:
        tree[name] = np.asarray(getattr(d, name).cpu().numpy(), dtype=dt)
    return tree
