"""Port vs reference: the experts (``models/moe.py``), the MoE decode of
``models/transformer.py`` with and without the DHash override table, and
the router half of ``train/train_step.py``.

The same inputs, made from a seed with numpy, go through the JAX function
and its counterpart in the port on the CPU.  Tolerances: expert ids,
loads, packed words and tables exactly equal; top-k gates and the aux
loss within 1e-6; ``moe_ffn`` outputs and the caches' K/V within 1e-5
absolute and relative (float32); decode logits within 1e-6 of the step's
largest |logit| (the reductions' float32 roundoff, which the expert
products add to, reaches 1.6e-5 on logits of up to ~59, 3.3e-7 of the
largest; an elementwise 1e-5 would fail on the small ones).  The MoE decodes take the reference's
weights AND its hash seeds (``jax.random.randint(PRNGKey(0), ...)``, which
the reference draws inside its step) through ``convert.params_from_numpy``;
the override table is the reference's ``make_router_table`` on both sides,
at rest and across a live rebuild that runs to its epoch swap.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro import configs as jconfigs  # noqa: E402
from repro.core import dhash as jdhash  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import transformer as jtr  # noqa: E402
from repro.train import train_step as jts  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import dhash as tdhash  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models import transformer as ttr  # noqa: E402
from repro_torch.serving.engine import ServeConfig  # noqa: E402
from repro_torch.serving.engine import ServingEngine  # noqa: E402
from repro_torch.train import train_step as tts  # noqa: E402
from test_torch_convert import assert_tree_equal, jax_state_tree  # noqa: E402
from test_torch_dhash import _content  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
MOE_ARCHS = ("arctic-480b", "llama4-scout-17b-a16e")


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


def close(port: torch.Tensor, ref, what: str, tol=TOL):
    np.testing.assert_allclose(port.float().numpy(),
                               np.asarray(ref, np.float32), err_msg=what,
                               **tol)


def close_scaled(port: torch.Tensor, ref, what: str, frac: float = 1e-6):
    ref = np.asarray(ref, np.float32)
    diff = float(np.abs(port.numpy() - ref).max())
    assert diff <= frac * float(np.abs(ref).max()), (what, diff)


def ref_seeds(n: int, k: int) -> np.ndarray:
    """The reference's per-layer hash seeds, as its decode draws them."""
    return np.asarray(jax.random.randint(jax.random.PRNGKey(0), (n, k, 2), 0,
                                         2**31 - 1).astype(jnp.uint32))


def to_port(jt) -> tdhash.DHashState:
    return convert.state_from_numpy(jax_state_tree(jt), "cpu")


def overrides(ids: np.ndarray, k: int, n_experts: int, rng):
    """(keys, packed values): an override of ``k`` random experts for each
    of ``ids``."""
    e = rng.integers(0, n_experts, size=(len(ids), 2)).astype(np.int32)
    packed = jmoe.pack_assignment(jnp.asarray(e[:, 0]),
                                  jnp.asarray(e[:, 1]) if k == 2 else None)
    return np.asarray(ids, np.int32), np.asarray(packed)


def override_table(ids: np.ndarray, k: int, n_experts: int, rng):
    """The reference's router table with an override for each of ``ids``."""
    jt = jts.make_router_table(jconfigs.get_smoke("arctic-480b"))
    keys, packed = overrides(ids, k, n_experts, rng)
    jt, ok = jdhash.insert(jt, jnp.asarray(keys), jnp.asarray(packed))
    assert bool(np.asarray(ok).all())
    return jt


@pytest.mark.parametrize("k", [1, 2])
def test_topk_route(k):
    rng = np.random.default_rng(k)
    x = rng.normal(size=(37, 24)).astype(np.float32)
    w = rng.normal(size=(24, 8)).astype(np.float32) * 0.3
    ids, gate, aux = tmoe.topk_route(_t(x), _t(w), k)
    jids, jgate, jaux = jmoe.topk_route(jnp.asarray(x), jnp.asarray(w), k)
    assert ids.dtype == torch.int32
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    close(gate, jgate, "gate", dict(rtol=1e-6, atol=1e-6))
    close(aux, jaux, "aux", dict(rtol=1e-6, atol=1e-6))


@pytest.mark.parametrize("table", ["none", "rest", "mid_rebuild"])
@pytest.mark.parametrize("k,n_experts", [(1, 16), (2, 128), (2, 7)])
def test_hash_route(table, k, n_experts):
    rng = np.random.default_rng(n_experts + k)
    ids = np.concatenate([rng.integers(0, 202048, size=300),
                          [0, 1, 2**31 - 1, 17, 17]]).astype(np.int32)
    seeds = rng.integers(0, 2**32, size=(k, 2), dtype=np.uint32)
    jt = tt = None
    if table != "none":
        jt = override_table(ids[::3], k, n_experts, rng)
        if table == "mid_rebuild":
            jt = jdhash.rebuild_start(jt, seed=5)
            for _ in range(3):
                jt = jdhash.rebuild_step(jt)
            assert bool(jt.rebuilding) and bool(jt.hazard_live.any())
        tt = to_port(jt)
    got = tmoe.hash_route(_t(ids), tt, _t(seeds.astype(np.int64)),
                          n_experts, k)
    want = jmoe.hash_route(jnp.asarray(ids), jt, jnp.asarray(seeds),
                           n_experts, k)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    assert got[0].dtype == torch.int32
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    assert float(got[2]) == float(want[2]) == 0.0
    if table != "none":     # the overrides took effect
        f, _ = tdhash.lookup(tt, _t(ids))
        assert 0 < int(f.sum()) < len(ids)


def test_pack_assignment():
    rng = np.random.default_rng(3)
    e1, e2 = (rng.integers(0, 2**15, size=64).astype(np.int32)
              for _ in range(2))
    np.testing.assert_array_equal(
        tmoe.pack_assignment(_t(e1), _t(e2)).numpy(),
        np.asarray(jmoe.pack_assignment(jnp.asarray(e1), jnp.asarray(e2))))
    np.testing.assert_array_equal(
        tmoe.pack_assignment(_t(e1)).numpy(),
        np.asarray(jmoe.pack_assignment(jnp.asarray(e1))))


def _moe_case(name: str, rng):
    """(x [B,S,D], expert_id [B,S,K], gate [B,S,K], E)."""
    if name == "drops":             # most assignments on expert 0
        b, s, k, e = 3, 6, 2, 4
        eid = np.where(rng.random((b, s, k)) < 0.7, 0,
                       rng.integers(0, e, (b, s, k)))
    elif name == "same-expert":     # tokens whose top-2 name one expert
        b, s, k, e = 2, 5, 2, 8
        eid = rng.integers(0, e, (b, s, k))
        eid[:, ::2, 1] = eid[:, ::2, 0]
    else:                           # decode: S = 1
        b, s, k, e = 6, 1, 2, 8
        eid = rng.integers(0, e, (b, s, k))
        eid[::2, 0, 1] = eid[::2, 0, 0]
    x = rng.normal(size=(b, s, 16)).astype(np.float32)
    gate = rng.random((b, s, k)).astype(np.float32)
    return x, eid.astype(np.int32), gate, e


@pytest.mark.parametrize("capacity_factor", [1.0, 1.25])
@pytest.mark.parametrize("case", ["drops", "same-expert", "decode"])
def test_moe_ffn(case, capacity_factor):
    rng = np.random.default_rng(len(case))
    x, eid, gate, e = _moe_case(case, rng)
    ws = [rng.normal(size=s).astype(np.float32) * 0.3
          for s in ((e, 16, 24), (e, 16, 24), (e, 24, 16))]
    out, load = tmoe.moe_ffn(_t(x), _t(eid), _t(gate), *map(_t, ws),
                             capacity_factor=capacity_factor)
    jout, jload = jax.jit(jmoe.moe_ffn, static_argnames="capacity_factor")(
        jnp.asarray(x), jnp.asarray(eid), jnp.asarray(gate),
        *map(jnp.asarray, ws), capacity_factor=capacity_factor)
    close(out, jout, f"{case} out")
    assert load.dtype == torch.int32
    np.testing.assert_array_equal(load.numpy(), np.asarray(jload))
    # the case hurts: some assignment was dropped
    assert int(load.sum()) < eid.size


def test_make_router_table_and_rebalance(monkeypatch):
    monkeypatch.delenv("DHASH_FUSED", raising=False)
    for arch in MOE_ARCHS:
        cfg_j, cfg_t = jconfigs.get_smoke(arch), tconfigs.get_smoke(arch)
        tt = tts.make_router_table(cfg_t, device="cpu")
        jt = jts.make_router_table(cfg_j)
        assert_tree_equal(convert.state_to_numpy(tt), jax_state_tree(jt))
    cfg = tconfigs.get_smoke("qwen3-8b")
    assert tts.make_router_table(cfg, device="cpu") is None
    assert tts.rebalance_router({}, np.ones(4), cfg) == {}
    cfg_j, cfg_t = (jconfigs.get_smoke("arctic-480b"),
                    tconfigs.get_smoke("arctic-480b"))
    js = {"router_table": jts.make_router_table(cfg_j)}
    ts = {"router_table": tts.make_router_table(cfg_t, device="cpu")}
    even = np.full(8, 5, np.int32)
    hot = np.array([40, 1, 2, 3, 0, 0, 1, 1], np.int32)
    # balanced: nothing; skewed: a rebuild starts; skewed again while it
    # runs: nothing more
    for load, rebuilding in ((even, False), (hot, True), (hot, True)):
        js = jts.rebalance_router(js, jnp.asarray(load), cfg_j)
        ts = tts.rebalance_router(ts, _t(load), cfg_t)
        assert bool(ts["router_table"].rebuilding) == \
            bool(js["router_table"].rebuilding) == rebuilding
        assert_tree_equal(convert.state_to_numpy(ts["router_table"]),
                          jax_state_tree(js["router_table"]))
    # on a CUDA device the table runs the kernels whatever DHASH_FUSED says
    from repro_torch.serving import eviction
    assert eviction.table_fused("cuda") is True
    assert eviction.table_fused("cpu") is None


def moe_pair(arch: str, seed: int = 2):
    jcfg, tcfg = jconfigs.get_smoke(arch), tconfigs.get_smoke(arch)
    jp = jtr.init_params(jcfg, jax.random.PRNGKey(seed))
    tree = jax.tree_util.tree_map(np.asarray, jp)
    tree["hash_seeds"] = ref_seeds(jcfg.n_layers, jcfg.top_k)
    return jcfg, jp, tcfg, convert.params_from_numpy(tree, "cpu")


@pytest.mark.parametrize("mode,fused", [("none", False), ("rest", False),
                                        ("rebuild", False),
                                        ("rebuild", True)])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_decode_against_the_reference(arch, mode, fused, monkeypatch):
    """Eight decode steps of four sequences, the override table absent, at
    rest, or rebuilt live from step 2 to its epoch swap (16 transitions a
    step on both sides, then each side's same-shape swap): logits and the
    caches' K/V after every step, and the tables' contents."""
    jcfg, jp, tcfg, tp = moe_pair(arch)
    rng = np.random.default_rng(4)
    b, smax, steps = 4, 8, 8
    toks = rng.integers(0, 24, size=(steps, b, 1)).astype(np.int32)
    jt = tt = None
    if mode != "none":
        keys, packed = overrides(np.arange(0, 24, 2), jcfg.top_k,
                                 jcfg.n_experts, rng)
        monkeypatch.delenv("DHASH_FUSED", raising=False)
        jt, _ = jdhash.insert(jts.make_router_table(jcfg), jnp.asarray(keys),
                              jnp.asarray(packed))
        monkeypatch.setenv("DHASH_FUSED", "on" if fused else "off")
        tt = tts.make_router_table(tcfg, device="cpu")
        monkeypatch.delenv("DHASH_FUSED")
        assert tt.fused == fused
        tt, ok = tdhash.insert(tt, _t(keys), _t(packed))
        assert bool(ok.all())
    jc = jtr.init_cache(jcfg, b, smax)
    tc = ttr.init_cache(tcfg, b, smax, device="cpu")
    logits_fn = jax.jit(jmodel.decode_logits, static_argnums=1)
    swapped = False
    for s in range(steps):
        jl, jc = logits_fn(jp, jcfg, jnp.asarray(toks[s]), jc, jt)
        tl, tc = tmodel.decode_logits(tp, tcfg, _t(toks[s]), tc,
                                      router_table=tt)
        close_scaled(tl, jl, f"{arch} {mode} logits step {s}")
        for k in ("k", "v"):
            close(tc[k], jc[k], f"{arch} {mode} cache {k} step {s}")
        if mode == "rebuild" and s >= 2:
            if s == 2:
                jt = jdhash.rebuild_start(jt, seed=23)
                tt = tdhash.rebuild_start(tt, seed=23)
            for _ in range(16):
                jt = jdhash.rebuild_step(jt)
                tt = tdhash.rebuild_step(tt)
            jt = jdhash.finish_same_shape(jt)
            tt = tdhash.finish_same_shape(tt)
            swapped |= int(tt.epoch) == 1
        if tt is not None:
            assert _content(convert.state_to_numpy(tt)) == \
                _content(jax_state_tree(jt)), (arch, mode, s)
            assert bool(tt.rebuilding) == bool(jt.rebuilding)
    assert swapped == (mode == "rebuild")


def test_moe_init_tree_and_seeds():
    """The port's own init: the reference's tree (router, the three expert
    stacks, the dense MLP beside them where ``dense_ff_residual``) plus
    ``hash_seeds`` [n_layers, top_k, 2] in [0, 2**31 - 1), seeded; the
    seeds survive a round trip through ``convert``."""
    for arch in MOE_ARCHS:
        jcfg, tcfg = jconfigs.get_smoke(arch), tconfigs.get_smoke(arch)
        jp = jtr.init_params(jcfg, jax.random.PRNGKey(0))
        mine = ttr.init_params(tcfg, torch.Generator().manual_seed(1))
        again = ttr.init_params(tcfg, torch.Generator().manual_seed(1))
        assert set(mine) == set(jp) | {"hash_seeds"}
        assert set(mine["attn_stack"]) == set(jp["attn_stack"])
        for k, v in jp["attn_stack"].items():
            assert tuple(mine["attn_stack"][k].shape) == v.shape, k
        seeds = mine["hash_seeds"]
        assert seeds.shape == (tcfg.n_layers, tcfg.top_k, 2)
        assert int(seeds.min()) >= 0 and int(seeds.max()) < 2**31 - 1
        assert torch.equal(seeds, again["hash_seeds"])
        back = convert.params_to_numpy(mine)
        assert back["hash_seeds"].dtype == np.uint32
        assert torch.equal(convert.params_from_numpy(back, "cpu")
                           ["hash_seeds"], seeds)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_serving_engine_refuses_experts(arch):
    """The paged step has no expert block (the reference's applies the
    dense MLP in every layer: ROADMAP C), so the engine refuses an expert
    configuration instead of serving it without its experts."""
    cfg = tconfigs.get_smoke(arch)
    params = ttr.init_params(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(NotImplementedError, match="expert"):
        ServingEngine(params, cfg, ServeConfig(max_seqs=2, n_pages=16,
                                               max_blocks=4))
