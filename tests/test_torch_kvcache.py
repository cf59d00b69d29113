"""Port vs reference: the paged KV cache (``serving/kvcache.py``).

The JAX functions and the port's run side by side on the CPU on the same
inputs, step by step: ``paged_decode_attention`` on scattered pages (the
reference's own case, and with windows, softcaps and tenants), page
allocation / resolution / release on one table and on a tenant stack
under skew, the capped router's spill slab (overflow-proof and compact),
and ``rehash_step`` through live rehashes.  Pages, found flags, free
stacks, counters and pools are exactly equal; attention outputs within
1e-5 (float32); the page tables as live key -> value maps (old > hazard >
new).  The port's tables run plain (``fused=False``) and fused (the
kernels' plain versions on the CPU); the reference's always plain.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.core import dhash as jdhash  # noqa: E402
from repro.serving import kvcache as jkv  # noqa: E402
from repro.models.attention import decode_attention  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import dhash as tdhash  # noqa: E402
from repro_torch.serving import eviction as tev  # noqa: E402
from repro_torch.serving import kvcache as tkv  # noqa: E402
from test_torch_convert import jax_state_tree  # noqa: E402
from test_torch_dhash import _content  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
_J = {"alloc": jax.jit(jkv.alloc_pages),
      "free": jax.jit(jkv.free_sequences, static_argnums=2),
      "resolve_at": jax.jit(jkv.resolve_blocks_at),
      "resolve": jax.jit(jkv.resolve_blocks, static_argnums=2),
      "rehash": jax.jit(jkv.rehash_step),
      "append": jax.jit(jkv.append_token)}


def _t(x, dtype=None) -> torch.Tensor:
    t = torch.from_numpy(np.array(x))
    return t if dtype is None else t.to(dtype)


def _i(x) -> torch.Tensor:
    return _t(np.asarray(x, np.int32))


def _b(x) -> torch.Tensor:
    return _t(np.asarray(x, bool))


def make_pair(monkeypatch, fused: bool, **kw):
    """(reference kv, port kv) made with the same arguments; the port's
    tables fused or plain (DHASH_FUSED read at make, then restored)."""
    j = jkv.make(**kw, dtype=jnp.float32)
    monkeypatch.setenv("DHASH_FUSED", "on" if fused else "off")
    t = tkv.make(**kw, dtype=torch.float32, device="cpu")
    monkeypatch.delenv("DHASH_FUSED")
    assert t.table.fused == fused
    return j, t


def _slice(tree: dict, i: int) -> dict:
    return {k: _slice(v, i) if isinstance(v, dict)
            else (v[i] if isinstance(v, np.ndarray) and v.ndim else v)
            for k, v in tree.items()}


def table_maps(tree: dict, n_tenants: int) -> list:
    if n_tenants == 1:
        return [_content(tree)]
    return [_content(_slice(tree, i)) for i in range(n_tenants)]


def same_kv(j, t, where: str, pools: bool = False):
    """Every counter, the free stack and the page tables' live maps (and
    the pools, when asked)."""
    for f in ("free_stack", "free_top", "route_spill", "route_drop",
              "alloc_fail"):
        np.testing.assert_array_equal(getattr(t, f).numpy(),
                                      np.asarray(getattr(j, f)),
                                      err_msg=f"{where}: {f}")
    jt, tt = jax_state_tree(j.table), convert.state_to_numpy(t.table)
    for f in ("cursor", "rebuilding", "epoch"):
        np.testing.assert_array_equal(tt[f], jt[f], err_msg=f"{where}: {f}")
    assert table_maps(tt, t.n_tenants) == table_maps(jt, j.n_tenants), where
    if pools:
        for f in ("pool_k", "pool_v"):
            np.testing.assert_array_equal(
                getattr(t, f)[:, :t.n_pages].numpy(),
                np.asarray(getattr(j, f)), err_msg=f"{where}: {f}")


def test_block_key_packing_is_the_reference_s():
    rng = np.random.default_rng(0)
    seq = rng.integers(0, 1 << 20, size=64).astype(np.int32)
    blk = rng.integers(0, 1 << 15, size=64).astype(np.int32)
    np.testing.assert_array_equal(
        tkv.block_key(_i(seq), _i(blk)).numpy(),
        np.asarray(jkv.block_key(jnp.asarray(seq), jnp.asarray(blk))))
    assert tkv.block_key(_i([3]), _i([7])).dtype == torch.int32


def test_scatter_drop_drops_the_index_past_the_end():
    x = _i([10, 11, 12, 13])
    got = tkv._scatter_drop(x, _i([4, 0, 4, 2]), _i([90, 91, 92, 93]))
    np.testing.assert_array_equal(got.numpy(), [91, 11, 93, 13])
    assert x.tolist() == [10, 11, 12, 13]


@pytest.mark.parametrize("n_tenants,fused", [(1, False), (1, True),
                                             (3, True)])
def test_paged_decode_attention_on_random_pages(monkeypatch, n_tenants,
                                                fused):
    """The reference's case (pages scattered by token-by-token appends of
    three sequences), then windows and a softcap: the port's attention
    against the reference's paged one and against its dense
    ``decode_attention``."""
    rng = np.random.default_rng(3)
    L, PS, NP, KV, HD, B, HQ = 1, 4, 32, 2, 8, 3, 4
    j, t = make_pair(monkeypatch, fused, layers=L, page_size=PS, n_pages=NP,
                     kv_heads=KV, head_dim=HD, seed=1, n_tenants=n_tenants)
    slen = np.array([9, 5, 12], np.int32)
    seq_ids = np.array([1, 2, 3], np.int32)
    dense_k = rng.normal(size=(B, 16, KV, HD)).astype(np.float32)
    dense_v = rng.normal(size=(B, 16, KV, HD)).astype(np.float32)
    for b in range(B):
        for pos in range(int(slen[b])):
            args = (seq_ids[b: b + 1], np.array([pos], np.int32),
                    dense_k[None, b: b + 1, pos], dense_v[None, b: b + 1, pos])
            j = _J["append"](j, *map(jnp.asarray, args))
            t = tkv.append_token(t, *map(_t, args))
    same_kv(j, t, "after the appends", pools=True)
    q = rng.normal(size=(B, HQ, HD)).astype(np.float32)
    for window, softcap in ((0, 0.0), (3, 0.0), (0, 5.0), (6, 5.0)):
        got = tkv.paged_decode_attention(t, 0, _t(q), _t(seq_ids),
                                         _t(slen), 4, window=window,
                                         softcap=softcap)
        ref = jkv.paged_decode_attention(j, jnp.asarray(0), jnp.asarray(q),
                                         jnp.asarray(seq_ids),
                                         jnp.asarray(slen), 4, window=window,
                                         softcap=softcap)
        dense = decode_attention(jnp.asarray(q)[:, None],
                                 jnp.asarray(dense_k), jnp.asarray(dense_v),
                                 jnp.asarray(slen), window=window,
                                 softcap=softcap)[:, 0]
        what = f"window={window} softcap={softcap}"
        np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                   err_msg=what, **TOL)
        np.testing.assert_allclose(got.numpy(), np.asarray(dense),
                                   err_msg=what, **TOL)


@pytest.mark.parametrize("n_tenants,fused", [(1, False), (1, True),
                                             (4, False), (4, True)])
def test_alloc_resolve_free_step_by_step(monkeypatch, n_tenants, fused):
    """A random schedule of allocations (some blocks already mapped, some
    slots masked) and releases, held to the reference after every op:
    pages, found, free stack, counters and the tables' live maps."""
    rng = np.random.default_rng(7 + n_tenants)
    j, t = make_pair(monkeypatch, fused, layers=1, page_size=4, n_pages=48,
                     kv_heads=1, head_dim=4, max_blocks=6,
                     n_tenants=n_tenants)
    live: dict[int, int] = {}                 # seq -> blocks mapped
    next_seq = 1
    for step in range(10):
        sids = []
        while len(sids) < 6:
            if live and rng.random() < 0.6:
                sids.append(int(rng.choice(list(live))))
            else:
                sids.append(next_seq)
                live[next_seq] = 0
                next_seq += 1
        sids = np.array(sids, np.int32)
        blk = np.array([min(live[s], 5) for s in sids], np.int32)
        mask = rng.random(6) < 0.8
        j, pj = _J["alloc"](j, *map(jnp.asarray, (sids, blk, mask)))
        t, pt = tkv.alloc_pages(t, _t(sids), _t(blk), _t(mask))
        np.testing.assert_array_equal(pt.numpy(), np.asarray(pj),
                                      err_msg=f"step {step} pages")
        for s, m, p in zip(sids, mask, np.asarray(pj)):
            if m and p >= 0:
                live[int(s)] = min(live[int(s)] + 1, 6)
        same_kv(j, t, f"step {step} alloc")
        pg_j, f_j = _J["resolve_at"](j, jnp.asarray(sids), jnp.asarray(blk))
        pg_t, f_t = tkv.resolve_blocks_at(t, _t(sids), _t(blk))
        np.testing.assert_array_equal(f_t.numpy(), np.asarray(f_j))
        np.testing.assert_array_equal(pg_t.numpy()[f_t.numpy()],
                                      np.asarray(pg_j)[np.asarray(f_j)])
        pj2, fj2 = _J["resolve"](j, jnp.asarray(sids), 6)
        pt2, ft2 = tkv.resolve_blocks(t, _t(sids), 6)
        np.testing.assert_array_equal(ft2.numpy(), np.asarray(fj2))
        np.testing.assert_array_equal(np.where(ft2.numpy(), pt2.numpy(), -1),
                                      np.where(fj2, pj2, -1))
        if step % 3 == 2:
            done = np.array(sorted(live)[:2], np.int32)
            j = _J["free"](j, jnp.asarray(done), 6)
            t = tkv.free_sequences(t, _t(done), 6)
            for s in done:
                live.pop(int(s))
            same_kv(j, t, f"step {step} free")
    assert int(t.free_top) + sum(live.values()) >= 0


@pytest.mark.parametrize("fused", [False, True])
def test_capped_router_adversarial_skew_against_the_reference(monkeypatch,
                                                              fused):
    """100 % of the keys in one tenant (the reference's :267 case): the
    spill slab serves them in the same pass, spill is accounted on that
    tenant, and the full-width router gives the same pages."""
    def run(cap_factor):
        j, t = make_pair(monkeypatch, fused, layers=1, page_size=4,
                         n_pages=64, kv_heads=1, head_dim=8, max_blocks=8,
                         n_tenants=8, cap_factor=cap_factor)
        sids = np.array([3 + 8 * i for i in range(16)], np.int32)
        blk = np.zeros(16, np.int32)
        ones = np.ones(16, bool)
        j, pj = _J["alloc"](j, *map(jnp.asarray, (sids, blk, ones)))
        t, pt = tkv.alloc_pages(t, *map(_t, (sids, blk, ones)))
        np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))
        return j, t, sids, blk, pt.numpy()

    j, t, sids, blk, pages = run(2.0)
    same_kv(j, t, "skewed alloc")
    assert (pages >= 0).all() and len(set(pages.tolist())) == 16
    assert t.route_spill[3] == 12 and int(t.route_spill.sum()) == 12
    lj = jax.device_get(jkv.table_load(j, with_spill=True))
    lt = tkv.table_load(t, with_spill=True)
    for a, b in zip(lt, lj):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    hj, ht = jax.device_get(jkv.table_health(j)), tkv.table_health(t)
    for a, b in zip(ht, hj):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    pg, fnd = tkv.resolve_blocks_at(t, _t(sids), _t(blk))
    assert bool(fnd.all()) and np.array_equal(pg.numpy(), pages)
    _, _, _, _, pages_full = run(0.0)
    np.testing.assert_array_equal(pages, pages_full)
    j = _J["free"](j, jnp.asarray(sids), 8)
    t = tkv.free_sequences(t, _t(sids), 8)
    same_kv(j, t, "skewed free")
    assert int(t.free_top) == 64


def test_compact_slab_drops_exactly_as_the_reference(monkeypatch):
    j, t = make_pair(monkeypatch, True, layers=1, page_size=4, n_pages=64,
                     kv_heads=1, head_dim=8, max_blocks=8, n_tenants=8,
                     cap_factor=2.0, spill_slack=0.5)
    sids = np.array([3 + 8 * i for i in range(16)], np.int32)
    blk = np.zeros(16, np.int32)
    ones = np.ones(16, bool)
    j, pj = _J["alloc"](j, *map(jnp.asarray, (sids, blk, ones)))
    t, pt = tkv.alloc_pages(t, *map(_t, (sids, blk, ones)))
    np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))
    same_kv(j, t, "compact slab")
    assert int((pt >= 0).sum()) == 12 and int(t.route_drop[3]) == 4
    assert int(t.alloc_fail) == 4 and int(t.free_top) == 64 - 12


def test_single_table_rehash_step_through_a_live_rehash(monkeypatch):
    """A same-shape rehash of the page table started with the same seed
    on both sides, stepped while pages are allocated and resolved: cursor,
    flags and live maps equal after every step; the host swap at the end
    (the engine's ``rebuild_finish``)."""
    for fused in (False, True):
        j, t = make_pair(monkeypatch, fused, layers=1, page_size=4,
                         n_pages=32, kv_heads=1, head_dim=4, max_blocks=4,
                         table_chunk=8)
        rng = np.random.default_rng(11)
        sids = np.arange(1, 9, dtype=np.int32)
        for b in range(2):
            m = np.ones(8, bool)
            j, _ = _J["alloc"](j, jnp.asarray(sids),
                               jnp.full((8,), b, jnp.int32), jnp.asarray(m))
            t, _ = tkv.alloc_pages(t, _t(sids), _i(np.full(8, b)), _t(m))
        j = jkv.replace(j, table=jdhash.rebuild_start(j.table, seed=5))
        t = tkv.replace(t, table=tdhash.rebuild_start(t.table, seed=5))
        steps = 0
        while not bool(jdhash.rebuild_done(j.table)):
            j, t = _J["rehash"](j), tkv.rehash_step(t)
            steps += 1
            new = rng.choice(sids, 3, replace=False).astype(np.int32)
            blk = np.full(3, 2 + steps % 2, np.int32)
            m = rng.random(3) < 0.7
            j, pj = _J["alloc"](j, *map(jnp.asarray, (new, blk, m)))
            t, pt = tkv.alloc_pages(t, *map(_t, (new, blk, m)))
            np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))
            same_kv(j, t, f"fused={fused} rehash step {steps}")
            pgj, fj = _J["resolve"](j, jnp.asarray(sids), 4)
            pgt, ft = tkv.resolve_blocks(t, _t(sids), 4)
            np.testing.assert_array_equal(ft.numpy(), np.asarray(fj))
            np.testing.assert_array_equal(np.where(ft.numpy(), pgt.numpy(), 0),
                                          np.where(fj, pgj, 0))
        assert bool(tdhash.rebuild_done(t.table)) and steps > 4
        j = jkv.replace(j, table=jdhash.rebuild_finish(j.table))
        t = tkv.replace(t, table=tdhash.rebuild_finish(t.table, done=True))
        same_kv(j, t, f"fused={fused} after the swap")


@pytest.mark.parametrize("fused", [False, True])
def test_tenant_stack_rehash_step_advances_only_the_selected(monkeypatch,
                                                             fused):
    """The reference's :267-style multi-tenant case against the reference
    step by step: a rehash on tenants 0 and 2 only, every tenant resolving
    mid-flight; epochs swap on the device; then one tenant's sequences
    freed."""
    j, t = make_pair(monkeypatch, fused, layers=1, page_size=4, n_pages=64,
                     kv_heads=1, head_dim=8, max_blocks=8, n_tenants=4)
    sids = np.arange(1, 9, dtype=np.int32)
    blk = np.zeros(8, np.int32)
    ones = np.ones(8, bool)
    j, pj = _J["alloc"](j, *map(jnp.asarray, (sids, blk, ones)))
    t, pt = tkv.alloc_pages(t, *map(_t, (sids, blk, ones)))
    np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))
    mask = np.array([True, False, True, False])
    j = jkv.start_rehash(j, jnp.asarray(mask))
    t = tkv.start_rehash(t, _t(mask))
    assert t.table.rebuilding.tolist() == mask.tolist()
    for s in range(40):
        j, t = _J["rehash"](j), tkv.rehash_step(t)
        same_kv(j, t, f"tenant rehash step {s}")
        pg, fnd = tkv.resolve_blocks_at(t, _t(sids), _t(blk))
        assert bool(fnd.all()) and np.array_equal(pg.numpy(), pt.numpy())
    assert t.table.epoch.tolist() == [1, 0, 1, 0]
    j = _J["free"](j, jnp.asarray([4, 8], jnp.int32), 8)
    t = tkv.free_sequences(t, _i([4, 8]), 8)
    same_kv(j, t, "after freeing tenant 0")
    assert int(t.free_top) == 64 - 6


def _prefixed(monkeypatch, fused):
    t = tkv.make(layers=1, page_size=4, n_pages=16, kv_heads=1, head_dim=4,
                 max_blocks=4, prefix_cache=True, evict_batch=4,
                 device="cpu", prefix_fused=fused, dtype=torch.float32)
    # six cached pages at three stamps, two of them pinned
    pages = _i([15, 14, 13, 12, 11, 10])
    ps, ok = tev.publish(t.prefix, _i([100, 101, 102, 103, 104, 105]),
                         pages, _b([True] * 6))
    assert bool(ok.all())
    ps = tev.acquire(ps, _i([14, 12]), _b([True, True]))
    return tkv.replace(t, prefix=ps, free_stack=torch.arange(16,
                                                             dtype=torch.int32),
                       free_top=torch.tensor(10, dtype=torch.int32))


def _clone_kv(kv):
    from repro_torch.core.struct_utils import map_tensors
    return map_tensors(lambda x: x.clone(), kv)


def _kv_arrays(kv) -> dict:
    ps = kv.prefix
    out = {f: getattr(kv, f).numpy().copy() for f in ("free_stack",
                                                      "free_top")}
    out.update({f: getattr(ps, f).numpy().copy() for f in (
        "refcnt", "cached", "stamp", "clock", "evictions")})
    out["table"] = _content(convert.state_to_numpy(ps.table))
    out["rev"] = _content(convert.state_to_numpy(ps.rev))
    return out


@pytest.mark.parametrize("fused", [False, True])
def test_masked_evict_for_equals_the_gated_form(monkeypatch, fused):
    """``_evict_for`` runs the eviction masked where the reference gates it
    on ``shortage > 0``: at a shortage <= 0 the masked run leaves every
    field as the skipped call would; above 0 both forms run the same
    eviction."""
    def gated(kv, shortage):
        return tkv._evict_for(kv, shortage) if int(shortage) > 0 else kv

    for shortage in (-3, 0, 2, 7):
        a = _prefixed(monkeypatch, fused)
        b = _clone_kv(a)
        sh = torch.tensor(shortage, dtype=torch.int32)
        got, want = _kv_arrays(tkv._evict_for(a, sh)), _kv_arrays(
            gated(b, sh))
        assert got.keys() == want.keys()
        for k in got:
            if isinstance(got[k], dict):
                assert got[k] == want[k], (shortage, k)
            else:
                np.testing.assert_array_equal(got[k], want[k],
                                              err_msg=f"{shortage} {k}")
        if shortage > 0:
            assert int(got["evictions"]) == min(shortage, 4)
            assert int(got["free_top"]) == 10 + min(shortage, 4)
        else:
            assert int(got["evictions"]) == 0


def test_paged_decode_step_counts_one_resolve_a_layer_and_drops_inactive(
        monkeypatch):
    """``paged_decode_step`` against the reference's on one step with an
    inactive slot: logits within 1e-5, the pools equal (the inactive
    slot's write went to the sink, which the reference drops), and one
    ``resolve_blocks`` call a layer."""
    from repro.configs.base import ArchConfig as JCfg
    from repro.models import transformer as jtr
    from repro.serving.engine import paged_decode_step as jstep
    from repro_torch.configs.base import ArchConfig as TCfg
    from repro_torch.serving.engine import paged_decode_step as tstep
    kw = dict(n_layers=3, d_model=32, n_heads=4, n_kv_heads=2, d_ff=64,
              vocab_size=64, dtype="float32", qk_norm=True)
    jc, tc = JCfg("t-step", "dense", **kw), TCfg("t-step", "dense", **kw)
    jp = jtr.init_params(jc, jax.random.PRNGKey(1))
    tp = convert.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                   "cpu")
    j, t = make_pair(monkeypatch, True, layers=3, page_size=4, n_pages=16,
                     kv_heads=2, head_dim=8, max_blocks=4)
    step_j = jax.jit(jstep, static_argnums=(1, 7))
    args = [np.array([5, 6], np.int32), np.array([7, 9], np.int32),
            np.array([0, 2], np.int32), np.array([True, True])]
    for s in range(6):
        if s == 3:
            args[3] = np.array([True, False])     # slot 1 pauses mid-block
        lj, j = step_j(jp, jc, j, *map(jnp.asarray, args), 4)
        calls = tkv.COUNTS["resolve_blocks"]
        lt, t = tstep(tp, tc, t, *map(_t, args), 4)
        assert tkv.COUNTS["resolve_blocks"] - calls == 3
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj),
                                   err_msg=f"step {s}", **TOL)
        same_kv(j, t, f"step {s}")
        np.testing.assert_allclose(t.pool_k[:, :16].numpy(),
                                   np.asarray(j.pool_k), **TOL)
        args[2] = np.where(args[3], args[2] + 1, args[2]).astype(np.int32)
        args[1] = np.asarray(lt.argmax(-1), np.int32)
