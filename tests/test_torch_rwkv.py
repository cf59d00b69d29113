"""Port vs reference: ``models/rwkv.py`` (RWKV6 "Finch") and
``rwkv6-3b``'s decode (``models/transformer.py``, ``models/model.py``).

The same inputs, made from a seed with numpy (weights: the reference's
``init_params`` / ``rwkv6_init`` through ``convert.params_from_numpy``),
go through the JAX function and its counterpart in the port on the CPU
(``device="cpu"``).  Tolerance: ``TOL``, 1e-5 absolute and relative, in
float32; a whole model's decode ``DECODE_TOL`` (5e-5 absolute; its test
says why).  Each reference function is jitted once a shape.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro import configs as jconfigs  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.models import rwkv as jrwkv  # noqa: E402
from repro.models import transformer as jtr  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.models import rwkv as trwkv  # noqa: E402
from repro_torch.models import transformer as ttr  # noqa: E402
from repro_torch.serving.engine import ServeConfig, ServingEngine  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
# a whole model's decode (test_rwkv6_decode_logits_step_by_step says why)
DECODE_TOL = dict(rtol=1e-5, atol=5e-5)
# one RWKV6 layer: d_model 32 in 4 heads of 8, d_ff 48, LoRA rank 8
D, NH, HS, FF = 32, 4, 8, 48
MIX = dict(n_heads=NH, head_size=HS)


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


def close(port: torch.Tensor, ref, what: str, tol=TOL):
    np.testing.assert_allclose(port.float().numpy(),
                               np.asarray(ref, np.float32), err_msg=what,
                               **tol)


def layer_pair(fused: bool, seed: int = 0):
    """One layer's weights: the reference's, with the constant leaves (the
    lerps, the decay's base, the bonus ``u`` and ``ln_x``) redrawn so that
    they bite, and the port's copy."""
    jp = jax.tree_util.tree_map(np.asarray, jrwkv.rwkv6_init(
        jax.random.PRNGKey(seed), D, FF, lora_r=8, dtype=jnp.float32,
        fused_rkvg=fused, **MIX))
    rng = np.random.default_rng(seed)
    for k in [k for k in jp if "mu_" in k]:
        jp[k] = rng.uniform(0, 1, size=(D,)).astype(np.float32)
    jp["w0"] = rng.uniform(-3, 0.5, size=(D,)).astype(np.float32)
    jp["u"] = rng.normal(size=(D,)).astype(np.float32) * 0.5
    jp["ln_x"] = rng.normal(size=(HS,)).astype(np.float32) * 0.1
    return jp, convert.params_from_numpy(jp, "cpu")


def rkvw(rng, b: int, s: int):
    r, k, v = (rng.normal(size=(b, s, NH, HS)).astype(np.float32)
               for _ in "rkv")
    logw = -np.exp(rng.uniform(-4, 1, size=(b, s, NH, HS))).astype(
        np.float32)
    u = rng.normal(size=(NH, HS)).astype(np.float32)
    s0 = rng.normal(size=(b, NH, HS, HS)).astype(np.float32)
    return r, k, v, logw, u, s0


@pytest.mark.parametrize("s", [8, 24, 13])
def test_wkv_scan_chunked_against_the_reference(s):
    """Chunk 8 at S = the chunk (one scan), a multiple of it (three
    chunks, the state threaded) and not a multiple (one scan), from a
    random state."""
    arrs = rkvw(np.random.default_rng(s), 2, s)
    fn = jax.jit(jrwkv.wkv_scan_chunked, static_argnames="chunk")
    jo, js = fn(*map(jnp.asarray, arrs), chunk=8)
    to, ts = trwkv.wkv_scan_chunked(*map(_t, arrs), chunk=8)
    close(to, jo, "wkv out")
    close(ts, js, "wkv state")
    # the chunked form is the recurrence itself
    po, ps = trwkv.wkv_scan(*map(_t, arrs))
    close(to, po.numpy(), "chunked vs plain out")
    close(ts, ps.numpy(), "chunked vs plain state")


@pytest.mark.parametrize("fused", [False, True])
def test_time_and_channel_mix_against_the_reference(fused):
    """Both projection forms (four matrices; the stacked ``w_rkvg``) over
    6 tokens, from a previous token and a state, with ``tp_state`` given
    (the port ignores it: ROADMAP A7 g)."""
    jp, tp = layer_pair(fused, seed=1 + fused)
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 6, D)).astype(np.float32)
    prev = rng.normal(size=(2, 1, D)).astype(np.float32)
    s0 = rng.normal(size=(2, NH, HS, HS)).astype(np.float32)
    tm = jax.jit(lambda x, p, pt, s0: jrwkv.rwkv6_time_mix(
        x, p, prev_token=pt, s0=s0, **MIX))
    jy, js = tm(jnp.asarray(x), jp, jnp.asarray(prev), jnp.asarray(s0))
    ty, ts = trwkv.rwkv6_time_mix(_t(x), tp, prev_token=_t(prev), s0=_t(s0),
                                  tp_state="replicated", **MIX)
    close(ty, jy, "time mix y")
    close(ts, js, "time mix state")
    assert ts.dtype == torch.float32
    cm = jax.jit(jrwkv.rwkv6_channel_mix)
    close(trwkv.rwkv6_channel_mix(_t(x), tp, _t(prev)),
          cm(jnp.asarray(x), jp, jnp.asarray(prev)), "channel mix")
    close(trwkv.rwkv6_channel_mix(_t(x), tp),
          cm(jnp.asarray(x), jp), "channel mix, no previous token")


def test_step_by_step_equals_the_multi_token_call():
    """The port's own check (the one the card runs at full width): the
    time and channel mixes stepped one token at a time with
    ``prev_token`` / ``s0`` give one call over the 12 tokens, outputs and
    final state."""
    _, tp = layer_pair(False, seed=4)
    x = _t(np.random.default_rng(5).normal(size=(2, 12, D)).astype(
        np.float32))
    y, state = trwkv.rwkv6_time_mix(x, tp, **MIX)
    c = trwkv.rwkv6_channel_mix(x, tp)
    ys, cs, st = [], [], None
    for t in range(12):
        prev = x[:, t - 1:t] if t else None
        y1, st = trwkv.rwkv6_time_mix(x[:, t:t + 1], tp, prev_token=prev,
                                      s0=st, **MIX)
        ys.append(y1)
        cs.append(trwkv.rwkv6_channel_mix(x[:, t:t + 1], tp, prev))
    close(torch.cat(ys, 1), y.numpy(), "time mix")
    close(st, state.numpy(), "state")
    close(torch.cat(cs, 1), c.numpy(), "channel mix")


def test_init_constants_are_the_reference_s():
    """``rwkv6_init``'s constant leaves (``mu_*``, ``cmu_*``, ``w0``,
    ``u``, ``ln_x``) equal the reference's, each layer; every leaf's shape
    and dtype too, in both projection forms."""
    for fused in (False, True):
        jp = jrwkv.rwkv6_init(jax.random.PRNGKey(0), D, FF, dtype=jnp.bfloat16,
                              fused_rkvg=fused, **MIX)
        tp = trwkv.rwkv6_init(
            lambda shape, scale: torch.zeros(shape, dtype=torch.bfloat16), 3,
            D, FF, dtype=torch.bfloat16, device="cpu", fused_rkvg=fused,
            **MIX)
        assert set(tp) == set(jp)
        for k, leaf in jp.items():
            assert tuple(tp[k].shape) == (3,) + leaf.shape, k
            assert str(tp[k].dtype).split(".")[-1] == str(leaf.dtype), k
            if k.startswith(("mu_", "cmu_")) or k in ("w0", "u", "ln_x"):
                for row in tp[k]:
                    np.testing.assert_array_equal(
                        row.float().numpy(), np.asarray(leaf, np.float32), k)


@pytest.fixture(scope="module")
def rwkv():
    jcfg, tcfg = jconfigs.get_smoke("rwkv6-3b"), tconfigs.get_smoke("rwkv6-3b")
    jp = jtr.init_params(jcfg, jax.random.PRNGKey(7))
    return jcfg, jp, tcfg, convert.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jp), "cpu")


def test_rwkv6_decode_logits_step_by_step(rwkv):
    """Four steps of three sequences through the untied ``unembed``: the
    hidden states, the logits and every cache entry (``wkv``, ``tm_prev``,
    ``cm_prev``; ``len`` exactly) within ``DECODE_TOL``: the decay
    exp(-exp(w)) multiplies float32 roundoff of w by exp(w) (up to e^4,
    the clip), so from the second step on, the state carries ~3e-6 of
    relative error (2.0e-5 on a ``wkv`` entry of ~8); the port's own init
    and cache have the reference's tree and shapes."""
    jcfg, jp, tcfg, tp = rwkv
    assert not tcfg.tie_embeddings and "unembed" in tp
    mine = ttr.init_params(tcfg, torch.Generator().manual_seed(0))
    flat = jax.tree_util.tree_flatten_with_path(jp)[0]
    for path, leaf in flat:
        node = mine
        for k in path:
            node = node[k.key]
        assert tuple(node.shape) == leaf.shape, path
    assert len(flat) == sum(len(v) if isinstance(v, dict) else 1
                            for v in mine.values())
    # bf16 stacks with float32 leaves (mu_*, cmu_*, w0, u) round-trip
    jb = jax.tree_util.tree_map(np.asarray, jtr.init_params(
        jcfg.scaled(dtype="bfloat16"), jax.random.PRNGKey(1)))
    back = convert.params_to_numpy(convert.params_from_numpy(jb, "cpu"))
    for (path, a), b in zip(jax.tree_util.tree_flatten_with_path(back)[0],
                            jax.tree_util.tree_leaves(jb)):
        assert a.dtype == b.dtype, path
        np.testing.assert_array_equal(a, b, str(path))
    assert back["rwkv_stack"]["w0"].dtype == np.float32
    rng = np.random.default_rng(8)
    jc = jtr.init_cache(jcfg, 3, 8)
    tc = ttr.init_cache(tcfg, 3, 8, device="cpu")
    assert {k: tuple(v.shape) for k, v in tc.items()} == \
        {k: v.shape for k, v in jc.items()}
    fn = jax.jit(jmodel.decode_logits, static_argnums=1)
    fwd = jax.jit(jtr.forward_decode, static_argnums=1)
    for s in range(4):
        tok = rng.integers(0, jcfg.vocab_size, size=(3, 1)).astype(np.int32)
        jh, _ = fwd(jp, jcfg, jnp.asarray(tok), jc)
        th, _ = ttr.forward_decode(tp, tcfg, _t(tok),
                                   {k: v.clone() for k, v in tc.items()})
        close(th, jh, f"hidden step {s}", DECODE_TOL)
        jl, jc = fn(jp, jcfg, jnp.asarray(tok), jc)
        tl, tc = tmodel.decode_logits(tp, tcfg, _t(tok), tc)
        close(tl, jl, f"logits step {s}", DECODE_TOL)
        np.testing.assert_array_equal(tc["len"].numpy(), np.asarray(jc["len"]))
        for k in ("wkv", "tm_prev", "cm_prev"):
            close(tc[k], jc[k], f"cache {k} step {s}", DECODE_TOL)


def test_engine_and_launcher_refuse_rwkv6(rwkv):
    """No attention stack to page: the engine raises, and the launcher
    refuses the id as the reference's does."""
    _, _, tcfg, tp = rwkv
    with pytest.raises(NotImplementedError, match="decode_logits"):
        ServingEngine(tp, tcfg, ServeConfig(max_seqs=2, n_pages=16,
                                            max_blocks=4))
    with pytest.raises(SystemExit, match="attention archs"):
        serve.main(["--arch", "rwkv6-3b", "--device", "cpu"])
