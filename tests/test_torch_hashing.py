"""Port vs reference: the seeded hash families, bit for bit.

Same numpy inputs through ``repro.core.hashing`` (JAX) and
``repro_torch.core.hashing`` (PyTorch, CPU); tolerance 0 everywhere — the
path has no floating point.
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.core import hashing as jh  # noqa: E402
from repro_torch.core import hashing as th  # noqa: E402

KINDS = jh.HASH_KINDS
EDGE = np.array([0, 1, -1, 2, -2, 255, 256, 65535, 65536, 2**31 - 1,
                 -2**31, -2**31 + 1, 0x7FFF0000, 12345, -98765], np.int32)
KEYS = np.concatenate([
    EDGE, np.random.default_rng(0).integers(-2**31, 2**31, 1000)
    .astype(np.int32)])
NBUCKETS = (1, 2, 64, 100, 1000, 4096, 3 * 7 * 11 * 13, 1 << 21, (1 << 21) + 1)


def _u32(t) -> np.ndarray:
    return t.numpy().astype(np.uint32)


def _pair(kind: str, seed: int):
    return jh.fresh(kind, seed), th.fresh(kind, seed, device="cpu")


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("seed", [0, 5, 2**31 + 7])
def test_fresh_same_seed_same_seeds(kind, seed):
    a, b = _pair(kind, seed)
    assert b.kind == a.kind == kind
    assert np.array_equal(np.asarray(a.seeds), _u32(b.seeds))
    if kind == "multiply_shift":
        assert int(b.seeds[0]) & 1


@pytest.mark.parametrize("kind", KINDS)
def test_fresh_draws_in_reference_order(kind):
    """Two functions from ONE generator: the second draw matches too."""
    ra, rb = np.random.default_rng(9), np.random.default_rng(9)
    for _ in range(2):
        a, b = jh.fresh(kind, ra), th.fresh(kind, rb, device="cpu")
        assert np.array_equal(np.asarray(a.seeds), _u32(b.seeds))


@pytest.mark.parametrize("kind", KINDS)
def test_hash_u32_bit_for_bit(kind):
    a, b = _pair(kind, 3)
    got = _u32(th.hash_u32(b, torch.as_tensor(KEYS)))
    assert np.array_equal(np.asarray(jh.hash_u32(a, jnp.asarray(KEYS))), got)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("nbuckets", NBUCKETS)
def test_bucket_of_bit_for_bit(kind, nbuckets):
    a, b = _pair(kind, 11)
    want = np.asarray(jh.bucket_of(a, jnp.asarray(KEYS), nbuckets))
    got = th.bucket_of(b, torch.as_tensor(KEYS), nbuckets)
    assert got.dtype == torch.int32
    assert np.array_equal(want, got.numpy())
    assert got.min() >= 0 and got.max() < nbuckets


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("salt", [0, 1, 2, 7, -1, -3, 2**31 - 1, -2**31])
def test_reseed_bit_for_bit(kind, salt):
    a, b = _pair(kind, 4)
    ra = jh.reseed(a, jnp.asarray(salt, jnp.int32))
    rb = th.reseed(b, torch.tensor(salt, dtype=torch.int32))
    assert np.array_equal(np.asarray(ra.seeds), _u32(rb.seeds))
    assert not np.array_equal(_u32(b.seeds), _u32(rb.seeds))
    # and the reseeded function hashes alike
    assert np.array_equal(
        np.asarray(jh.bucket_of(ra, jnp.asarray(KEYS), 1000)),
        th.bucket_of(rb, torch.as_tensor(KEYS), 1000).numpy())


def test_reseed_accepts_python_int_salt():
    b = th.fresh("mix32", 1, device="cpu")
    assert torch.equal(th.reseed(b, 5).seeds,
                       th.reseed(b, torch.tensor(5, dtype=torch.int32)).seeds)


@pytest.mark.parametrize("kind", KINDS)
def test_hash_combine_bit_for_bit(kind):
    a, b = _pair(kind, 8)
    h = np.asarray(jh.hash_u32(a, jnp.asarray(KEYS)))
    want = np.asarray(jh.hash_combine(jnp.asarray(h), jnp.asarray(KEYS)))
    got = th.hash_combine(torch.as_tensor(h.astype(np.int64)),
                          torch.as_tensor(KEYS))
    assert np.array_equal(want, _u32(got))
    # an int32 running hash (negative bit patterns) is reinterpreted, not
    # sign-extended
    h32 = h.view(np.int32).copy()
    want = np.asarray(jh.hash_combine(jnp.asarray(h32), jnp.asarray(KEYS)))
    got = th.hash_combine(torch.as_tensor(h32), torch.as_tensor(KEYS))
    assert np.array_equal(want, _u32(got))


def test_unknown_kind_raises():
    with pytest.raises(ValueError):
        th.fresh("nope", 0, device="cpu")
