"""State to and from nested dicts of numpy arrays.

The layout mirrors the field names of the reference's ``DHashState`` /
``LinearTable`` / ``TwoChoiceTable`` / ``CuckooTable`` / ``ChainTable`` /
``HashFn``, so a state of either package flattens to the same tree and both
can start from — and be compared on — the same bytes:

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

with a two-row table (``backend`` twochoice or cuckoo) as

    {"nbuckets": int, "width": int, "max_rounds" | "max_kick": int,
     "hfn_a": {...}, "hfn_b": {...},
     "key": int32[R, W], "val": int32[R, W], "state": int32[R, W]}

(R = nbuckets for twochoice, 2 * nbuckets for cuckoo), and a chain table
as

    {"nbuckets": int, "arena": int, "max_chain": int, "dirty_cap": int,
     "hfn": {...}, "akey": int32[N], "aval": int32[N], "anext": int32[N],
     "astate": int32[N], "heads": int32[B], "free_stack": int32[N],
     "free_top": int32[], "bstart": int32[B], "blen": int32[B],
     "sorted_upto": int32[]}.

An elastic policy (``core/policy.py``'s ``ElasticPolicy``) is its
configuration fields as plain values beside its device state:

    {"grow_load": float, ..., "place_headroom": float,
     "armed": bool[], "want_grow": bool[], "want_shrink": bool[],
     "target_capacity": int32[], "fires": int32[]}.

A table stack (``dhash.make_stack``; a stacked policy, ``policy.stack``)
is the same tree with every array leading with [T] (scalars [T]).  Hash
seeds are ``uint32`` in the tree and int64 words in ``[0, 2**32)`` in
the port.  The two-row insert kernel's claim scratch (twochoice and cuckoo
tables only) is not part of a table's contents: it is made anew on the way
in and left out on the way back.

Model weights (``params_from_numpy`` / ``params_to_numpy``) are the
reference's ``transformer.init_params`` tree as nested dicts of numpy
arrays (``{"embed": [V, D], "final_norm": [D], "attn_stack": {"wq": [L, D,
Hq, hd], ...}}``), the same nesting of tensors in the port.  A bfloat16
array (numpy's ``ml_dtypes.bfloat16``) travels as its 16-bit words.  A
hash router's per-layer seeds travel with the weights as
``"hash_seeds"``: ``uint32 [n_layers, top_k, 2]`` in the tree, int64 words
in ``[0, 2**32)`` in the port.  The reference draws them inside its step
(``jax.random.randint(PRNGKey(0), (n, top_k, 2), 0, 2**31 - 1)``), which
the port does not re-implement: a caller that holds the port to the
reference adds that array to the reference's tree before converting it.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import buckets, hashing
from repro_torch.core.dhash import DHashState
from repro_torch.core.policy import ElasticPolicy

_SCALARS = (("cursor", np.int32), ("rebuilding", np.bool_),
            ("epoch", np.int32), ("lookups", np.int32),
            ("expensive", np.int32))
_STATIC = ("backend", "chunk", "fwd_hazard", "fused", "nres_cap")


def _to_dev(a, dtype, device) -> torch.Tensor:
    # np.array copies: the port owns (and may write) what it is given
    return torch.as_tensor(np.array(a, dtype=dtype), device=device)


# the configuration fields of each table type, in the reference's order
_META = {buckets.LinearTable: ("capacity", "max_probes"),
         buckets.TwoChoiceTable: ("nbuckets", "width", "max_rounds"),
         buckets.CuckooTable: ("nbuckets", "width", "max_kick"),
         buckets.ChainTable: ("nbuckets", "arena", "max_chain", "dirty_cap")}
_HFNS = {buckets.LinearTable: ("hfn",),
         buckets.TwoChoiceTable: ("hfn_a", "hfn_b"),
         buckets.CuckooTable: ("hfn_a", "hfn_b"),
         buckets.ChainTable: ("hfn",)}
_SLOTS = ("key", "val", "state")
# the tables that keep a claim scratch on a CUDA device
_CLAIMS = (buckets.TwoChoiceTable, buckets.CuckooTable)
_ARRAYS = {buckets.ChainTable: ("akey", "aval", "anext", "astate", "heads",
                                "free_stack", "free_top", "bstart", "blen",
                                "sorted_upto")}
_BY_BACKEND = {"linear": buckets.LinearTable,
               "twochoice": buckets.TwoChoiceTable,
               "cuckoo": buckets.CuckooTable,
               "chain": buckets.ChainTable}


def _hfn_from(tree: dict, dev) -> hashing.HashFn:
    seeds = np.asarray(tree["seeds"]).astype(np.uint32)
    return hashing.HashFn(kind=str(tree["kind"]),
                          seeds=_to_dev(seeds.astype(np.int64), np.int64, dev))


def table_from_numpy(tree: dict, device: torch.device | str = "cuda",
                     backend: str | None = None):
    """One table on ``device`` from its tree; its type is ``backend``'s, or
    read from the tree's configuration fields when ``backend`` is None."""
    dev = torch.device(device)
    if backend is not None:
        cls = _BY_BACKEND[backend]
    else:
        cls = next(c for c, meta in _META.items() if meta[-1] in tree)
    kw = {m: int(tree[m]) for m in _META[cls]}
    kw.update({h: _hfn_from(tree[h], dev) for h in _HFNS[cls]})
    kw.update({f: _to_dev(tree[f], np.int32, dev)
               for f in _ARRAYS.get(cls, _SLOTS)})
    if dev.type == "cuda" and cls in _CLAIMS:
        from repro_torch.kernels.probe import new_claim
        kw["claim"] = new_claim(kw["key"].shape[:-1], dev)
    return cls(**kw)


def table_to_numpy(t) -> dict:
    tree = {m: getattr(t, m) for m in _META[type(t)]}
    for h in _HFNS[type(t)]:
        fn = getattr(t, h)
        tree[h] = {"kind": fn.kind,
                   "seeds": fn.seeds.cpu().numpy().astype(np.uint32)}
    for f in _ARRAYS.get(type(t), _SLOTS):
        tree[f] = getattr(t, f).cpu().numpy()
    return tree


def state_from_numpy(tree: dict, device: torch.device | str = "cuda"
                     ) -> DHashState:
    """The port's ``DHashState`` on ``device`` from a tree laid out as the
    module docstring says."""
    kw = {"backend": str(tree["backend"]), "chunk": int(tree["chunk"]),
          "fwd_hazard": bool(tree["fwd_hazard"]), "fused": bool(tree["fused"]),
          "nres_cap": int(tree["nres_cap"])}
    for name, dt in _SCALARS:
        kw[name] = _to_dev(tree[name], dt, device)
    return DHashState(
        old=table_from_numpy(tree["old"], device, kw["backend"]),
        new=table_from_numpy(tree["new"], device, kw["backend"]),
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


_POLICY_STATE = (("armed", np.bool_), ("want_grow", np.bool_),
                 ("want_shrink", np.bool_), ("target_capacity", np.int32),
                 ("fires", np.int32))


def policy_from_numpy(tree: dict, device: torch.device | str = "cuda"
                      ) -> ElasticPolicy:
    """The port's ``ElasticPolicy`` on ``device`` from its tree."""
    state = dict(_POLICY_STATE)
    kw = {f.name: tree[f.name] for f in dataclasses.fields(ElasticPolicy)
          if f.name not in state}
    for name, dt in _POLICY_STATE:
        kw[name] = _to_dev(tree[name], dt, device)
    return ElasticPolicy(**kw)


def policy_to_numpy(pol: ElasticPolicy) -> dict:
    """Inverse of ``policy_from_numpy`` (synchronises)."""
    state = dict(_POLICY_STATE)
    tree = {f.name: getattr(pol, f.name)
            for f in dataclasses.fields(ElasticPolicy)
            if f.name not in state}
    for name, dt in _POLICY_STATE:
        tree[name] = np.asarray(getattr(pol, name).cpu().numpy(), dtype=dt)
    return tree


def _param_to_dev(a, device) -> torch.Tensor:
    a = np.array(a)             # a writable copy
    if a.dtype == np.uint32:    # hash seeds: u32 words as int64
        a = a.astype(np.int64)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def params_from_numpy(tree: dict, device: torch.device | str = "cuda"
                      ) -> dict:
    """Model weights on ``device`` from a nested dict of numpy arrays (the
    reference's ``init_params`` tree, ``np.asarray`` of each leaf)."""
    return {k: params_from_numpy(v, device) if isinstance(v, dict)
            else _param_to_dev(v, device) for k, v in tree.items()}


def params_to_numpy(params: dict) -> dict:
    """Inverse of ``params_from_numpy`` (synchronises).  A bfloat16 tensor
    comes back as an ``ml_dtypes.bfloat16`` array, the hash seeds as
    ``uint32``."""
    out = {}
    for k, v in params.items():
        if isinstance(v, dict):
            out[k] = params_to_numpy(v)
        elif v.dtype == torch.int64:      # hash seeds: u32 words
            out[k] = v.cpu().numpy().astype(np.uint32)
        elif v.dtype == torch.bfloat16:
            import ml_dtypes
            out[k] = v.cpu().view(torch.int16).numpy().view(
                ml_dtypes.bfloat16)
        else:
            out[k] = v.cpu().numpy()
    return out
