"""The contract the staged-set kernels are held to on the card: where a
hazard buffer or a chain arena's dirty-tail window holds a key more than
once, a lookup answers with its LOWEST live index, as argmax over the match
mask gives it.  ``tc_probe2`` and ``chain_probe2`` find it through a hashed
index in shared memory, not by a scan in index order, so the contract is
pinned here on the plain versions they are compared with on the card
(``probe2_plain``, ``tc_probe2_plain``, ``chain_probe2_plain``,
``chain_dirty_window``) and, on the same inputs, against the JAX reference:
its ordered lookups return the lowest live copy's value and its ordered
deletes kill the lowest live copy.  Tolerance 0.
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.core import backend as jbe  # noqa: E402
from repro.core import buckets as jb  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro_torch.core import backend as tbe  # noqa: E402
from repro_torch.core import buckets as tb  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import probe as tprobe  # noqa: E402
from test_torch_chain_ops import _grown, parts, port  # noqa: E402
from test_torch_linear_ops import ordered_case as linear_case  # noqa: E402
from test_torch_twochoice_ops import ordered_case as tc_case  # noqa: E402

LIVE, TOMB, MIGRATED = 1, 2, 3
J = jnp.asarray


def T(a) -> torch.Tensor:
    return torch.as_tensor(np.array(a))


def N(t) -> np.ndarray:
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def duplicate(hk, hv, hl, rng):
    """A hazard buffer in which m live entries each give their key to two
    more live entries at higher indices, with other values, and half of
    those lowest copies are killed (so the answer is then the next live
    copy).  Returns (keys, values, live, the copied keys)."""
    hk, hv, hl = hk.copy(), hv.copy(), hl.copy()
    live = rng.permutation(np.flatnonzero(hl))
    m = len(live) // 3
    a, b, c = np.sort(live[:3 * m].reshape(m, 3), axis=1).T   # a < b < c
    hk[b] = hk[a]
    hk[c] = hk[a]
    hv[b] = hv[a] + 1
    hv[c] = hv[a] + 2
    hl[a[: m // 2]] = False
    return hk, hv, hl, hk[a]


def lowest_live(keys, live, qk) -> np.ndarray:
    """The lowest index i with keys[i] == q and live[i] for each query q,
    else -1."""
    eq = (qk[:, None] == keys[None, :]) & live[None, :]
    return np.where(eq.any(1), eq.argmax(1), -1)


def check_plain_hz(out, hk, hl, qk):
    """``hz_idx`` of a plain probe2 version: the lowest live index where
    the old table did not resolve the query, else -1; and the duplicates
    must matter (a key with two live copies, a key whose first copy is
    dead)."""
    _, _, f_old, _, hz, _ = (N(x) for x in out)
    want = np.where(f_old, -1, lowest_live(hk, hl, qk))
    assert np.array_equal(hz, want)
    n_live = ((qk[:, None] == hk[None, :]) & hl[None, :]).sum(1)
    first = np.array([np.flatnonzero(hk == k)[0] if (hk == k).any() else -1
                      for k in qk])
    assert ((n_live >= 2) & ~f_old).any()
    assert ((hz >= 0) & (hz != first)).any()


def _linear():
    old, new, hk, hv, hl, h0o, h0n, qk = linear_case(1000, 4000, 256, 600,
                                                     16, 7)
    hk, hv, hl, _ = duplicate(hk, hv, hl, np.random.default_rng(7))
    targs = (tuple(map(T, old)), tuple(map(T, new)), T(hk), T(hv), T(hl),
             T(h0o), T(h0n), T(qk))
    jargs = (tuple(map(J, old)), tuple(map(J, new)), J(hk), J(hv), J(hl),
             J(h0o), J(h0n), J(qk))
    jf, jv = jops.ordered_lookup_fused(*jargs, max_probes=16)
    tf, tv = tops.ordered_lookup_fused(*targs, max_probes=16)
    win = np.asarray(jb.batch_winners(J(qk), jnp.ones(qk.size, bool)))
    jd = jops.ordered_delete_fused(*jargs, J(win), max_probes=16)
    td = tops.ordered_delete_fused(*targs, T(win), max_probes=16)
    return ((jf, jv), (tf, tv), jd[2], td[2],
            tprobe.probe2_plain(*targs, 16), hk, hl, qk)


def _twochoice():
    old, new, hk, hv, hl, rao, rbo, ran, rbn, qk = tc_case(100, 405, 6, 256,
                                                           600, 8)
    hk, hv, hl, _ = duplicate(hk, hv, hl, np.random.default_rng(8))
    rows = (rao, rbo, ran, rbn)
    targs = (tuple(map(T, old)), tuple(map(T, new)), T(hk), T(hv), T(hl),
             *map(T, rows), T(qk))
    jargs = (tuple(map(J, old)), tuple(map(J, new)), J(hk), J(hv), J(hl),
             *map(J, rows), J(qk))
    jf, jv = jops.twochoice_ordered_lookup(*jargs)
    tf, tv = tops.twochoice_ordered_lookup(*targs)
    win = np.asarray(jb.batch_winners(J(qk), jnp.ones(qk.size, bool)))
    jd = jops.twochoice_ordered_delete(*jargs, J(win))
    td = tops.twochoice_ordered_delete(*targs, T(win))
    return ((jf, jv), (tf, tv), jd[2], td[2],
            tprobe.tc_probe2_plain(*targs), hk, hl, qk)


def _chain():
    rng, told, tnew, k1, k2, k3, hk, hl = _grown("plain")
    hk, hv, hl, dup = duplicate(hk, hk * 7, hl, rng)
    po, pn = port(told), port(tnew)
    qs = np.concatenate([k1[:50], k2[:50], k3[:20], hk, dup, dup,
                         rng.integers(8_000_000, 9_000_000, 30)
                         ]).astype(np.int32)
    jf, jv = jbe.chain_ordered_lookup_fused(told, tnew, J(hk), J(hv), J(hl),
                                            J(qs))
    tf, tv = tbe.chain_ordered_lookup_fused(po, pn, T(hk), T(hv), T(hl),
                                            T(qs))
    dm = np.asarray(jb.batch_winners(J(qs), jnp.ones(qs.size, bool)))
    jd = jbe.chain_ordered_delete_fused(told, tnew, J(hk), J(hv), J(hl),
                                        J(qs), J(dm))
    bo = tb.hashing.bucket_of(po.hfn, T(qs), po.nbuckets)
    bn = tb.hashing.bucket_of(pn.hfn, T(qs), pn.nbuckets)
    out = tprobe.chain_probe2_plain(parts(po), parts(pn), T(hk), T(hv),
                                    T(hl), bo, bn, T(qs), 64, 512)
    po, pn = port(told), port(tnew)
    td = tbe.chain_ordered_delete_fused(po, pn, T(hk), T(hv), T(hl), T(qs),
                                        T(dm))
    return (jf, jv), (tf, tv), jd[2], td[2], out, hk, hl, qs


@pytest.mark.parametrize("case", [_linear, _twochoice, _chain],
                         ids=["linear", "twochoice", "chain"])
def test_duplicate_hazard_keys_resolve_to_the_lowest_live_index(case):
    """A hazard buffer with duplicate live keys, dead copies among them:
    the ordered lookup's values and the ordered delete's kills equal the
    reference's, and the plain probe2 version's hz_idx is the lowest live
    index."""
    (jf, jv), (tf, tv), jhl, thl, out, hk, hl, qk = case()
    for a, b in ((jf, tf), (jv, tv), (jhl, thl)):
        assert np.array_equal(np.asarray(a), N(b))
    check_plain_hz(out, hk, hl, qk)
    killed = hl & ~N(thl)
    assert killed.any()
    # a delete kills the lowest live copy and leaves the later ones
    assert (lowest_live(hk, hl, hk[killed]) == np.flatnonzero(killed)).all()


@pytest.mark.parametrize("su,dirty,cap", [(100, 300, 512), (650, 50, 64),
                                          (0, 700, 512)])
def test_duplicate_tail_keys_resolve_to_the_lowest_live_node(su, dirty, cap):
    """A dirty tail holding duplicate live keys with TOMB and MIGRATED nodes
    between them: ``chain_dirty_window`` equals the reference's
    ``_chain_dirty_window`` and answers with the lowest live window node at
    or past ``sorted_upto``."""
    rng = np.random.default_rng(su + dirty)
    n = 700
    size = min(cap, n)
    base = min(su, n - size)
    ak = rng.choice(1_000_000, n, replace=False).astype(np.int32)
    st = np.full(n, LIVE, np.int32)
    tail = su + rng.permutation(min(dirty, n - su))
    m = len(tail) // 5
    a, b, c, dead = (tail[i * m:(i + 1) * m] for i in range(4))
    ak[b] = ak[a]
    ak[c] = ak[a]
    st[a[: m // 2]] = TOMB
    st[dead[: m // 2]] = TOMB
    st[dead[m // 2:]] = MIGRATED
    below = np.arange(base, su)[:m]          # in the window, below the tail
    ak[below] = ak[a][: below.size]
    av = np.arange(n, dtype=np.int32) * 3
    qk = np.concatenate([ak[a], ak[dead], rng.integers(
        2_000_000, 3_000_000, 50)]).astype(np.int32)
    args = (np.int32(su), np.int32(dirty))
    jo = jops._chain_dirty_window((J(ak), J(av), J(st)), *map(J, args), J(qk),
                                  cap)
    po = tprobe.chain_dirty_window((T(ak), T(av), T(st)), *map(T, args),
                                   T(qk), cap)
    for x, y in zip(jo, po):
        assert np.array_equal(np.asarray(x), N(y))
    pos = np.arange(base, base + size)
    valid = (st[pos] == LIVE) & (pos >= su)
    want = lowest_live(ak[pos], valid, qk)
    assert np.array_equal(N(po[2]), np.where(want >= 0, base + want, -1))
    first = lowest_live(ak[pos], np.ones(size, bool), qk)
    assert ((want >= 0) & (want != first)).any(), \
        "some lowest live copy must follow a dead or untracked one"
