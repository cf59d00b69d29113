"""Seeded hash-function families.

The whole point of DHash is that the *hash function is data*: a rebuild swaps
it live.  A ``HashFn`` is a small container (``kind`` is configuration,
``seeds`` is a tensor), and ``fresh(kind, rng)`` draws a brand-new function
from the family.

Three families, mirroring the paper's discussion of defending against
collision attacks (§1):

* ``multiply_shift`` — Dietzfelbinger's 2-universal scheme; cheapest.
* ``mix32``          — murmur3 finalizer with seed folding; good avalanche.
* ``tabulation``     — 3-independent tabulation hashing; strongest guarantees,
                       one 4x256 u32 table of entropy.

All arithmetic is unsigned 32-bit with intentional wrap-around; keys are
int32.  PyTorch has few ``uint32`` operators and ``>>`` on ``int32`` is an
arithmetic shift, so every 32-bit word is carried in an ``int64`` tensor
holding its value in ``[0, 2**32)``: shifts are then logical, ``%`` is
unsigned, and products are formed from 16-bit halves so no intermediate
leaves the signed 64-bit range.  Results are bit-for-bit those of the
reference's ``uint32`` arithmetic.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.struct_utils import replace, state_dataclass

HASH_KINDS = ("multiply_shift", "mix32", "tabulation")

_M32 = 0xFFFFFFFF


@state_dataclass
class HashFn:
    kind: str
    # u32 words carried as int64 in [0, 2**32):
    # multiply_shift: [2] (a|1, b); mix32: [2]; tabulation: [4, 256]
    seeds: torch.Tensor


def as_u32(x: torch.Tensor) -> torch.Tensor:
    """Reinterpret an integer tensor as unsigned 32-bit words (carried as
    int64): an ``int32`` -1 becomes 0xFFFFFFFF."""
    return x.to(torch.int64) & _M32


def _mul32(x: torch.Tensor, c) -> torch.Tensor:
    """Wrapping 32-bit product of u32 words ``x`` and ``c`` (a Python int or
    a u32 tensor), without overflowing int64: x*c = x*c_lo + (x*c_hi << 16)."""
    c_lo, c_hi = c & 0xFFFF, c >> 16
    return (x * c_lo + (((x * c_hi) & 0xFFFF) << 16)) & _M32


def fresh(kind: str, rng: np.random.Generator | int,
          device: torch.device | str = "cuda") -> HashFn:
    """Draw a new hash function from family ``kind``.  Draws from the numpy
    generator with the reference's calls in the reference's order, so equal
    seeds give equal ``seeds``."""
    if isinstance(rng, (int, np.integer)):
        rng = np.random.default_rng(int(rng))
    if kind == "multiply_shift":
        a = np.uint32(rng.integers(0, 2**32, dtype=np.uint32) | np.uint32(1))
        b = np.uint32(rng.integers(0, 2**32, dtype=np.uint32))
        seeds = np.stack([a, b])
    elif kind == "mix32":
        seeds = rng.integers(0, 2**32, size=(2,), dtype=np.uint32)
    elif kind == "tabulation":
        seeds = rng.integers(0, 2**32, size=(4, 256), dtype=np.uint32)
    else:  # pragma: no cover - guarded by HASH_KINDS
        raise ValueError(f"unknown hash kind {kind!r}; choose from {HASH_KINDS}")
    return HashFn(kind=kind, seeds=torch.as_tensor(
        seeds.astype(np.int64), device=device))


def reseed(fn: HashFn, salt: torch.Tensor | int) -> HashFn:
    """Derive a fresh function of the same family from ``fn`` and a scalar
    ``salt`` — runs on the device that holds ``fn.seeds`` (no host RNG, no
    host read), so an engine can start a new rebuild epoch without a
    round-trip.  Distinct salts give decorrelated seed vectors via the mix32
    finalizer over (seed, position, salt)."""
    s = fn.seeds
    pos = torch.arange(s.numel(), dtype=torch.int64,
                       device=s.device).reshape(s.shape)
    salt = torch.as_tensor(salt, device=s.device).to(torch.int32)
    salt32 = (_mul32(as_u32(salt), 0x9E3779B1) + 0x85EBCA77) & _M32
    seeds = _mix32(s ^ salt32, 0x27D4EB2F ^ pos, 0x165667B1)
    if fn.kind == "multiply_shift":
        seeds = seeds.clone()
        seeds[0] |= 1  # multiplier must be odd
    return replace(fn, seeds=seeds)


def _mix32(x: torch.Tensor, s0, s1) -> torch.Tensor:
    x = x ^ s0
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    x = x ^ (x >> 16)
    return x ^ s1


def lead_shape(fn: HashFn) -> tuple:
    """The leading axes of ``fn.seeds`` past one function's own shape: ()
    for one function, (T,) for the functions of a table stack."""
    own = 2 if fn.kind == "tabulation" else 1
    return tuple(fn.seeds.shape[:fn.seeds.dim() - own])


def hash_u32(fn: HashFn, keys: torch.Tensor) -> torch.Tensor:
    """Full-width u32 hash of int32 keys, as int64 in [0, 2**32).  A stack
    of functions (seeds [T, ...]) hashes keys [T, Q], row t by function
    t."""
    k = as_u32(keys)
    s = fn.seeds
    stacked = bool(lead_shape(fn))
    if fn.kind in ("multiply_shift", "mix32"):
        s0, s1 = (s[..., i, None] if stacked else s[i] for i in (0, 1))
        if fn.kind == "multiply_shift":
            return (_mul32(k, s0) + s1) & _M32
        return _mix32(k, s0, s1)
    # tabulation
    if not stacked:
        return (s[0][k & 0xFF] ^ s[1][(k >> 8) & 0xFF]
                ^ s[2][(k >> 16) & 0xFF] ^ s[3][(k >> 24) & 0xFF])
    out = None
    for j in range(4):      # row t's byte j looks up function t's table j
        w = torch.gather(s[:, j], -1, (k >> (8 * j)) & 0xFF)
        out = w if out is None else out ^ w
    return out


def bucket_of(fn: HashFn, keys: torch.Tensor, nbuckets: int) -> torch.Tensor:
    """Bucket index in [0, nbuckets) as int32. Power-of-two sizes use a mask."""
    h = hash_u32(fn, keys)
    if nbuckets & (nbuckets - 1) == 0:
        return (h & (nbuckets - 1)).to(torch.int32)
    return (h % nbuckets).to(torch.int32)


def hash_combine(h: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Order-dependent u32 combine (for content hashing, e.g. prefix-cache
    block ids).  Returns u32 words as int64."""
    h = as_u32(h)
    x = as_u32(x)
    return _mix32(x ^ ((_mul32(h, 0x9E3779B1) + 0x85EBCA77) & _M32),
                  0x27D4EB2F, h)
