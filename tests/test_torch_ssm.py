"""Port vs reference: ``models/ssm.py`` (mamba2) and ``zamba2-1.2b``'s
decode, mamba2 layers with the weight-shared attention block between
their groups (``models/transformer.py``).

The same inputs, made from a seed with numpy (weights: the reference's
``init_params`` / ``mamba2_init`` through ``convert.params_from_numpy``),
go through the JAX function and its counterpart in the port on the CPU
(``device="cpu"``).  Tolerance: ``TOL``, 1e-5 absolute and relative, in
float32, unless a test's docstring states another.  Each reference
function is jitted once a shape.
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
from repro.models import ssm as jssm  # noqa: E402
from repro.models import transformer as jtr  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402
from repro_torch.models import transformer as ttr  # noqa: E402
from repro_torch.serving.engine import ServeConfig, ServingEngine  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
# one mamba2 layer: d_model 32, d_inner 64 in 4 heads of 16, 8 states
KW = dict(d_inner=64, n_heads=4, headdim=16, d_state=8, conv_k=4)


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


def close(port: torch.Tensor, ref, what: str, **tol):
    np.testing.assert_allclose(port.float().numpy(),
                               np.asarray(ref, np.float32), err_msg=what,
                               **(tol or TOL))


def layer_pair(seed: int = 0):
    """One mamba2 layer's weights: the reference's, and the port's copy;
    ``dt_bias`` and ``norm`` drawn so that they bite."""
    jp = jssm.mamba2_init(jax.random.PRNGKey(seed), 32, dtype=jnp.float32,
                          **{k: v for k, v in KW.items() if k != "headdim"})
    rng = np.random.default_rng(seed)
    jp = dict(jax.tree_util.tree_map(np.asarray, jp),
              dt_bias=rng.normal(size=(4,)).astype(np.float32) * 0.5,
              norm=rng.normal(size=(64,)).astype(np.float32) * 0.1)
    return jp, convert.params_from_numpy(jp, "cpu")


@pytest.mark.parametrize("with_h0", [False, True])
def test_causal_conv_and_ssd_chunked(with_h0):
    rng = np.random.default_rng(1)
    b, s, nh, hp, ds, chunk = 2, 16, 3, 4, 5, 8
    x = rng.normal(size=(b, s, 6)).astype(np.float32)
    w = rng.normal(size=(4, 6)).astype(np.float32)
    close(tssm.causal_conv1d(_t(x), _t(w)),
          jssm.causal_conv1d(jnp.asarray(x), jnp.asarray(w)), "conv")
    xh = rng.normal(size=(b, s, nh, hp)).astype(np.float32)
    dt = rng.uniform(0.05, 1.5, size=(b, s, nh)).astype(np.float32)
    a_log = np.log(np.linspace(1.0, 16.0, nh)).astype(np.float32)
    bm, cm = (rng.normal(size=(b, s, ds)).astype(np.float32) for _ in "bc")
    h0 = (rng.normal(size=(b, nh, ds, hp)).astype(np.float32)
          if with_h0 else None)
    fn = jax.jit(jssm.ssd_chunked, static_argnames="chunk")
    jy, jh = fn(*map(jnp.asarray, (xh, dt, a_log, bm, cm)), chunk=chunk,
                h0=None if h0 is None else jnp.asarray(h0))
    ty, th = tssm.ssd_chunked(*map(_t, (xh, dt, a_log, bm, cm)), chunk=chunk,
                              h0=None if h0 is None else _t(h0))
    close(ty, jy, "ssd y")
    close(th, jh, "ssd final state")
    assert ty.dtype == th.dtype == torch.float32
    # two halves, the second from the first's state, equal one pass
    h, ys = None if h0 is None else _t(h0), []
    for i in (0, 8):
        y, h = tssm.ssd_chunked(*(_t(a[:, i:i + 8]) for a in (xh, dt)),
                                _t(a_log),
                                *(_t(a[:, i:i + 8]) for a in (bm, cm)),
                                chunk=chunk, h0=h)
        ys.append(y)
    close(torch.cat(ys, 1), ty.numpy(), "halves y")
    close(h, th.numpy(), "halves state")


def test_mamba2_forward_and_decode_against_the_reference():
    """The block's forward over 16 tokens (chunk 8), then three decode
    steps from a random state, each with its state."""
    jp, tp = layer_pair()
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 16, 32)).astype(np.float32)
    fwd = jax.jit(lambda x, p: jssm.mamba2_forward(x, p, chunk=8, **KW))
    close(tssm.mamba2_forward(_t(x), tp, chunk=8, **KW),
          fwd(jnp.asarray(x), jp), "mamba2_forward")
    dec = jax.jit(lambda x, st, p: jssm.mamba2_decode(x, st, p, **KW))
    jst = {"h": rng.normal(size=(2, 4, 8, 16)).astype(np.float32),
           "conv": rng.normal(size=(2, 3, 80)).astype(np.float32)}
    tst = {k: _t(v) for k, v in jst.items()}
    for s in range(3):
        x1 = rng.normal(size=(2, 1, 32)).astype(np.float32)
        jy, jst = dec(jnp.asarray(x1), jst, jp)
        ty, tst = tssm.mamba2_decode(_t(x1), tst, tp, **KW)
        close(ty, jy, f"decode y step {s}")
        for k in ("h", "conv"):
            close(tst[k], jst[k], f"decode {k} step {s}")
        assert tst["h"].dtype == torch.float32


def test_decode_teacher_forced_against_the_chunked_forward():
    """The port's own check (the one the card runs at full width): 16
    decode steps from a zero state give the chunked forward's outputs and
    its final state (``final_state``)."""
    _, tp = layer_pair(3)
    x = _t(np.random.default_rng(4).normal(size=(2, 16, 32)).astype(
        np.float32))
    y, st = tssm.mamba2_forward(x, tp, chunk=8, final_state=True, **KW)
    state = {"h": torch.zeros(2, 4, 8, 16), "conv": torch.zeros(2, 3, 80)}
    ys = []
    for t in range(16):
        y1, state = tssm.mamba2_decode(x[:, t:t + 1], state, tp, **KW)
        ys.append(y1)
    close(torch.cat(ys, 1), y.numpy(), "decode vs forward")
    for k in ("h", "conv"):
        close(state[k], st[k].numpy(), f"final state {k}")


def test_init_constants_are_the_reference_s():
    """``mamba2_init``'s constant leaves: ``d_skip``, ``dt_bias`` and the
    zero ``norm`` equal; ``a_log`` (log(linspace(1, 16)) at zamba2's 64
    heads) within 1e-6 relative: the reference's XLA float32 linspace and
    log are not correctly rounded (up to 3 ulps off float64's rounded
    once, which the port takes)."""
    jp = jssm.mamba2_init(jax.random.PRNGKey(0), 256, d_inner=4096,
                          n_heads=64, d_state=64, conv_k=4,
                          dtype=jnp.bfloat16)
    tp = tssm.mamba2_init(
        lambda shape, scale: torch.zeros(shape, dtype=torch.bfloat16), 2,
        256, d_inner=4096, n_heads=64, d_state=64, conv_k=4,
        dtype=torch.bfloat16, device="cpu")
    assert set(tp) == set(jp)
    for k, leaf in jp.items():
        assert tuple(tp[k].shape) == (2,) + leaf.shape, k
        assert str(tp[k].dtype).split(".")[-1] == str(leaf.dtype), k
    for k in ("d_skip", "dt_bias", "norm"):
        for row in tp[k]:
            np.testing.assert_array_equal(row.float().numpy(),
                                          np.asarray(jp[k], np.float32), k)
    np.testing.assert_allclose(tp["a_log"][1].numpy(),
                               np.asarray(jp["a_log"]), rtol=1e-6, atol=0)


@pytest.fixture(scope="module")
def zamba():
    jcfg, tcfg = jconfigs.get_smoke("zamba2-1.2b"), \
        tconfigs.get_smoke("zamba2-1.2b")
    jp = jtr.init_params(jcfg, jax.random.PRNGKey(5))
    return jcfg, jp, tcfg, convert.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jp), "cpu")


def test_zamba2_tree_and_cache_are_the_reference_s(zamba):
    """The port's own init and cache: the reference's tree and shapes
    (``mamba_stack``, ``shared_attn`` unstacked), the deterministic leaves
    equal, and ``n_apps`` K/V caches for the shared block."""
    jcfg, jp, tcfg, _ = zamba
    mine = ttr.init_params(tcfg, torch.Generator().manual_seed(0))
    flat = jax.tree_util.tree_flatten_with_path(jp)[0]
    assert len(flat) == sum(len(v) if isinstance(v, dict) else 1
                            for v in mine.values())
    for path, leaf in flat:
        node = mine
        for k in path:
            node = node[k.key]
        assert tuple(node.shape) == leaf.shape, path
    for k in ("d_skip", "dt_bias"):
        np.testing.assert_array_equal(mine["mamba_stack"][k].numpy(),
                                      np.asarray(jp["mamba_stack"][k]))
    jc = jtr.init_cache(jcfg, 2, 8)
    tc = ttr.init_cache(tcfg, 2, 8, device="cpu")
    assert {k: tuple(v.shape) for k, v in tc.items()} == \
        {k: v.shape for k, v in jc.items()}
    assert tc["k"].shape[0] == 2 and tc["ssm_h"].dtype == torch.float32
    # bf16 stacks with float32 leaves (a_log, d_skip, dt_bias) round-trip
    jb = jax.tree_util.tree_map(np.asarray, jtr.init_params(
        jcfg.scaled(dtype="bfloat16"), jax.random.PRNGKey(1)))
    tb = convert.params_from_numpy(jb, "cpu")
    assert tb["mamba_stack"]["in_proj"].dtype == torch.bfloat16
    assert tb["mamba_stack"]["a_log"].dtype == torch.float32
    back = convert.params_to_numpy(tb)
    for (path, a), b in zip(jax.tree_util.tree_flatten_with_path(back)[0],
                            jax.tree_util.tree_leaves(jb)):
        assert a.dtype == b.dtype, path
        np.testing.assert_array_equal(a, b, str(path))


def test_zamba2_decode_logits_step_by_step(zamba):
    """Four steps of three sequences: the logits within 1e-6 of the step's
    largest |logit| (tied std-1 embeddings put it near 33, where
    float32 roundoff reaches 1.8e-5), hidden states and every cache entry
    (``ssm_h``, ``ssm_conv``, the shared block's ``k`` / ``v``) within
    ``TOL``."""
    jcfg, jp, tcfg, tp = zamba
    rng = np.random.default_rng(6)
    jc = jtr.init_cache(jcfg, 3, 8)
    tc = ttr.init_cache(tcfg, 3, 8, device="cpu")
    fn = jax.jit(jmodel.decode_logits, static_argnums=1)
    for s in range(4):
        tok = rng.integers(0, jcfg.vocab_size, size=(3, 1)).astype(np.int32)
        jl, jc = fn(jp, jcfg, jnp.asarray(tok), jc)
        tl, tc = tmodel.decode_logits(tp, tcfg, _t(tok), tc)
        jl = np.asarray(jl)
        assert np.abs(tl.numpy() - jl).max() <= 1e-6 * np.abs(jl).max(), s
        assert set(tc) == set(jc)
        for k in jc:
            close(tc[k], jc[k], f"cache {k} step {s}")


def test_engine_and_launcher_refuse_zamba2(zamba):
    """No attention stack to page: the engine raises, and the launcher
    refuses the id as the reference's does."""
    _, _, tcfg, tp = zamba
    with pytest.raises(NotImplementedError, match="decode_logits"):
        ServingEngine(tp, tcfg, ServeConfig(max_seqs=2, n_pages=16,
                                            max_blocks=4))
    with pytest.raises(SystemExit, match="attention archs"):
        serve.main(["--arch", "zamba2-1.2b", "--device", "cpu"])
