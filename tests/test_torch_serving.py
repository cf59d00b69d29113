"""Port vs reference: the serving engine as a whole (``serving/engine.py``,
``launch/serve.py``).

The reference's engine tests (``tests/test_serving.py``: end to end with
page reclaim, paged decode against dense decode, a live rehash while
serving, the tenant stack against one table, the adaptive routing cap, the
prefix cache) each run through the JAX ``ServingEngine`` and the port's on
the same weights (``convert.params_from_numpy``) and prompts.  Finished
tokens, ``rehashes``, ``free_top``, the router and prefix-cache counters
are equal, and every request finishes.  The port's page tables run fused
(the kernels' plain versions on the CPU) and, end to end, plain as well;
the reference's run plain.

The reference engine is run with each decode step waited for: it hands
its slot arrays to ``jnp.asarray``, which on the CPU may alias the numpy
memory, and writes them again while an asynchronously dispatched step may
still be reading them, so that it sometimes decodes a request to other
tokens (ROADMAP C; the cause of its flaky
``test_multi_tenant_engine_matches_single_tenant``).  Waiting changes
nothing else of what it computes.
"""
from __future__ import annotations

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.configs.base import ArchConfig as JCfg  # noqa: E402
from repro.core import dhash as jdhash  # noqa: E402
from repro.models import transformer as jtr  # noqa: E402
from repro.serving.engine import ServeConfig as JSC  # noqa: E402
from repro.serving.engine import ServingEngine as JEngine  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs.base import ArchConfig as TCfg  # noqa: E402
from repro_torch.core import dhash as tdhash  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.models import transformer as ttr  # noqa: E402
from repro_torch.serving.engine import ServeConfig as TSC  # noqa: E402
from repro_torch.serving.engine import ServingEngine as TEngine  # noqa: E402

SMALL = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
             vocab_size=256, dtype="float32", attn_chunk=32, loss_chunk=32)


@pytest.fixture(scope="module")
def small():
    jcfg, tcfg = JCfg("t-serve", "dense", **SMALL), \
        TCfg("t-serve", "dense", **SMALL)
    jp = jtr.init_params(jcfg, jax.random.PRNGKey(0))
    tp = convert.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                   "cpu")
    return jcfg, jp, tcfg, tp


def engines(small, monkeypatch, fused: bool = True, **sc):
    """(reference engine, port engine) on the same weights and config; the
    port's tables fused or plain (DHASH_FUSED at make, then restored)."""
    jcfg, jp, tcfg, tp = small
    monkeypatch.delenv("DHASH_FUSED", raising=False)
    je = JEngine(jp, jcfg, JSC(**sc))
    step = je._step
    je._step = lambda *a, **k: jax.block_until_ready(step(*a, **k))
    monkeypatch.setenv("DHASH_FUSED", "on" if fused else "off")
    te = TEngine(tp, tcfg, TSC(**sc))
    monkeypatch.delenv("DHASH_FUSED")
    assert te.kv.table.fused == fused
    return je, te


def submit_both(je, te, prompts, tenant=None):
    return [(je.submit(list(p), tenant=tenant), te.submit(list(p),
                                                          tenant=tenant))
            for p in prompts]


def finished(eng, ids) -> list:
    return [eng.finished[i] for i in ids]


def same_engines(je, te, sids, where):
    js, ts = zip(*sids)
    assert js == ts, where
    assert finished(te, ts) == finished(je, js), where
    assert te.rehashes == je.rehashes, where
    assert int(te.kv.free_top) == int(je.kv.free_top), where
    assert (te.router_spills, te.router_drops) == \
        (je.router_spills, je.router_drops), where
    assert te.alloc_fails == je.alloc_fails == 0, where
    np.testing.assert_array_equal(te.kv.route_spill.numpy(),
                                  np.asarray(je.kv.route_spill))


def _count(t) -> int:
    if t.cursor.dim():
        return int(tdhash.stack_count_items(t).sum())
    return int(tdhash.count_items(t))


@pytest.mark.parametrize("fused", [False, True])
def test_engine_end_to_end_and_page_reclaim(small, monkeypatch, fused):
    je, te = engines(small, monkeypatch, fused, max_seqs=4, page_size=8,
                     n_pages=64, max_blocks=8, max_new_tokens=6)
    rng = np.random.default_rng(0)
    sids = submit_both(je, te, [rng.integers(1, 255,
                                             size=rng.integers(3, 10))
                                for _ in range(6)])
    je.run(max_steps=500)
    steps = te.run(max_steps=500)
    same_engines(je, te, sids, "end to end")
    assert all(len(o) == 6 for o in te.finished.values())
    assert int(te.kv.free_top) == 64 and _count(te.kv.table) == 0
    assert int(jax.device_get(jdhash.count_items(je.kv.table))) == 0
    # the host reads: one argmax a sampling step, one poll a step, none in
    # the prefill steps
    assert te.host_reads == 2 * steps


def test_paged_decode_matches_dense(small, monkeypatch):
    """The engine's greedy tokens equal the port's dense decode
    (``decode_logits`` over ``init_cache``) and the reference engine's."""
    _, _, tcfg, tp = small
    prompt = [5, 9, 17, 3]
    je, te = engines(small, monkeypatch, max_seqs=2, page_size=8,
                     n_pages=64, max_blocks=8, max_new_tokens=4)
    sids = submit_both(je, te, [prompt])
    je.run()
    te.run()
    same_engines(je, te, sids, "paged")
    cache = ttr.init_cache(tcfg, 1, 64, device="cpu")
    toks, outs = list(prompt), []
    for i in range(len(prompt) + 3):
        logits, cache = tmodel.decode_logits(
            tp, tcfg, torch.tensor([[toks[i]]], dtype=torch.int32), cache)
        if i >= len(prompt) - 1:
            outs.append(int(logits[0].argmax()))
            toks.append(outs[-1])
    assert outs == te.finished[sids[0][1]]


def test_live_rehash_during_serving(small, monkeypatch):
    """The page table passes its rehash trigger mid-serving: every request
    completes, the table rebuilds (host swap) as often as the
    reference's, and every active sequence's pages resolve after every
    step."""
    je, te = engines(small, monkeypatch, max_seqs=4, page_size=4,
                     n_pages=256, max_blocks=16, max_new_tokens=24,
                     rehash_load_factor=0.02)
    rng = np.random.default_rng(1)
    sids = submit_both(je, te, [rng.integers(1, 255, size=12)
                                for _ in range(8)])
    je.run(max_steps=2000)
    steps = rebuilding = 0
    while (te.queue or te.active.any()) and steps < 2000:
        te.step()
        steps += 1
        rebuilding += bool(te.kv.table.rebuilding)
        act = np.where(te.active)[0]
        from repro_torch.serving import kvcache as tkv
        pages, found = tkv.resolve_blocks(
            te.kv, torch.as_tensor(te.seq_ids[act]), te.sc.max_blocks)
        nblk = (te.lengths[act] + te.sc.page_size - 1) // te.sc.page_size
        need = np.arange(te.sc.max_blocks)[None] < nblk[:, None]
        assert found.numpy()[need].all(), steps
        live = pages.numpy()[need]
        assert len(set(live.tolist())) == live.size, steps
        free = set(te.kv.free_stack[:int(te.kv.free_top)].tolist())
        assert free.isdisjoint(live.tolist()), steps
    same_engines(je, te, sids, "live rehash")
    assert te.rehashes >= 1 and rebuilding > 0
    assert all(len(o) == 24 for o in te.finished.values())


def test_multi_tenant_engine_matches_single_tenant(small, monkeypatch):
    """A tenant stack decodes exactly as one table, while per-tenant
    rehash epochs advance under a low trigger."""
    outs, counters = {}, {}
    for tenants in (1, 3):
        je, te = engines(small, monkeypatch, max_seqs=4, page_size=8,
                         n_pages=64, max_blocks=8, max_new_tokens=6,
                         n_tenants=tenants,
                         rehash_load_factor=0.01 if tenants > 1 else 0.7)
        rng = np.random.default_rng(0)
        sids = submit_both(je, te, [rng.integers(1, 255,
                                                 size=rng.integers(3, 10))
                                    for _ in range(6)])
        je.run(max_steps=500)
        te.run(max_steps=500)
        js, ts = zip(*sids)
        outs[tenants] = (finished(je, js), finished(te, ts))
        counters[tenants] = (
            (je.rehashes, int(je.kv.free_top), je.router_spills,
             je.router_drops, np.asarray(je.kv.route_spill).tolist()),
            (te.rehashes, int(te.kv.free_top), te.router_spills,
             te.router_drops, te.kv.route_spill.tolist()))
        assert len(te.finished) == 6 and int(te.kv.free_top) == 64
        assert _count(te.kv.table) == 0
    for tenants in (1, 3):
        assert outs[tenants][1] == outs[tenants][0], tenants
    assert outs[3][1] == outs[1][1], "tenant partition changed decoding"
    for tenants in (1, 3):
        assert counters[tenants][1] == counters[tenants][0], tenants
    assert counters[3][1][0] >= 1, "low trigger must start tenant rehashes"


def test_adaptive_cap_engine_wiring_and_decode_identity(small, monkeypatch):
    """``ServeConfig.adaptive_cap``: the RouteCapController walks the cap
    off the poll's spill counters exactly as the reference's does, and
    decoding is the static full-width run's."""
    outs = {}
    for adaptive in (False, True):
        je, te = engines(small, monkeypatch, max_seqs=4, page_size=8,
                         n_pages=64, max_blocks=8, max_new_tokens=6,
                         n_tenants=8, cap_factor=2.0 if adaptive else 0.0,
                         adaptive_cap=adaptive, rehash_load_factor=0.9)
        rng = np.random.default_rng(3)
        sids = submit_both(je, te, [rng.integers(1, 255,
                                                 size=rng.integers(3, 10))
                                    for _ in range(6)], tenant=5)
        je.run(max_steps=500)
        te.run(max_steps=500)
        same_engines(je, te, sids, f"adaptive={adaptive}")
        outs[adaptive] = finished(te, [s for _, s in sids])
        if adaptive:
            jc, tc = je.cap_ctl, te.cap_ctl
            for f in ("cap_factor", "grows", "shrinks", "flaps", "occ",
                      "_spill_prev"):
                assert getattr(tc, f) == getattr(jc, f), f
            assert te.kv.cap_factor == tc.cap_factor
            assert tc.grows + tc.shrinks > 0 and te.router_spills > 0
        else:
            assert te.cap_ctl is None
    assert outs[True] == outs[False]


@pytest.mark.parametrize("backend", ["linear", "chain"])
def test_prefix_cache_decode_identity(small, monkeypatch, backend):
    """Prefix adoption is invisible to decoding: shared-prefix prompts
    decode the same with the cache on and off, the second wave adopts, and
    every counter is the reference's.  On chain (the macro benchmark's
    fingerprint index) the index is also rehashed live mid-run with the
    same seed on both sides."""
    rng = np.random.default_rng(7)
    fam = [rng.integers(1, 255, size=16).tolist() for _ in range(2)]
    prompts = [f + rng.integers(1, 255, size=4).tolist() + [1]
               for f in fam for _ in range(3)]
    kw = (dict(prefix_backend="chain",
               prefix_kw=(("nbuckets", 16), ("max_chain", 64)))
          if backend == "chain" else {})
    outs = {}
    for on in (False, True):
        je, te = engines(small, monkeypatch, max_seqs=2, page_size=4,
                         n_pages=64, max_blocks=8, max_new_tokens=4,
                         prefix_cache=on, prefix_capacity=256,
                         **(kw if on else {}))
        sids = submit_both(je, te, prompts)
        if on and backend == "chain":
            for _ in range(3):
                je.step()
                te.step()
            je.prefix_rehash(seed=9)
            te.prefix_rehash(seed=9)
            assert bool(te.kv.prefix.table.rebuilding)
        je.run(max_steps=2000)
        te.run(max_steps=2000)
        same_engines(je, te, sids, f"prefix={on}")
        outs[on] = finished(te, [s for _, s in sids])
        if on:
            for f in ("cache_lookups", "cache_hits", "publishes",
                      "evictions", "prefix_epoch"):
                assert getattr(te, f) == getattr(je, f), f
            assert te.cache_hits > 0 and te.publishes > 0
            if backend == "chain":
                assert te.prefix_epoch == 1
            np.testing.assert_array_equal(te.kv.prefix.refcnt.numpy(),
                                          np.asarray(je.kv.prefix.refcnt))
            np.testing.assert_array_equal(te.kv.prefix.cached.numpy(),
                                          np.asarray(je.kv.prefix.cached))
    assert outs[True] == outs[False]


def test_launch_serve_on_the_cpu(capsys, monkeypatch):
    monkeypatch.delenv("DHASH_FUSED", raising=False)
    eng = serve.main(["--device", "cpu", "--requests", "2", "--max-new",
                      "3", "--seed", "1"])
    out = capsys.readouterr().out
    assert "served 2/2 requests, 6 tokens" in out, out
    assert eng.params["embed"].device.type == "cpu"
    assert not eng.kv.table.fused          # DHASH_FUSED unset, off the card
    assert all(len(v) == 3 for v in eng.finished.values())
    assert int(eng.kv.free_top) == 1024


def test_launch_serve_defaults_to_the_gpu():
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU")
    with pytest.raises(RuntimeError):
        serve.main(["--requests", "1", "--max-new", "1"])


def test_serving_tables_run_the_kernels_on_cuda(monkeypatch):
    """On a CUDA device the page table, the prefix index and its reverse
    index are fused with no variable set; elsewhere they follow
    DHASH_FUSED, as the reference's do."""
    from repro_torch.serving import eviction, kvcache
    monkeypatch.delenv("DHASH_FUSED", raising=False)
    assert eviction.table_fused(torch.device("cuda")) is True
    assert eviction.table_fused("cuda:0") is True
    assert eviction.table_fused("cuda", False) is False
    assert eviction.table_fused("cpu") is None
    assert eviction.table_fused("cpu", True) is True
    for env, tenants in (("off", 1), ("on", 1), ("on", 2)):
        monkeypatch.setenv("DHASH_FUSED", env)
        kv = kvcache.make(2, 4, 16, 1, 4, max_blocks=4, n_tenants=tenants,
                          prefix_cache=True, prefix_backend="chain",
                          device="cpu")
        tables = (kv.table, kv.prefix.table, kv.prefix.rev)
        assert [t.fused for t in tables] == [env == "on"] * 3

