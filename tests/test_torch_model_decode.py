"""Port vs reference: the decode half of the model (``configs``,
``models/layers.py``, ``models/attention.py``, ``models/transformer.py``,
``models/model.py``).

The same inputs, made from a seed with numpy (weights: the reference's
``transformer.init_params`` through ``convert.params_from_numpy``), go
through the JAX function and its counterpart in the port on the CPU.
Tolerance 1e-5 absolute and relative on float32 hidden states, logits and
attention outputs; configurations, flags and shapes exactly equal.  Seven
configurations: the reference serving tests' ``small``, the smoke configs
of ``qwen3-8b``, ``deepseek-67b``, ``gemma2-2b`` (local / global
alternation, both softcaps, a scaled embedding) and ``gemma3-27b`` (5:1
local / global, two rope thetas), one with a logit and an attention
softcap, ``local`` windows that bite, a scaled and untied embedding, and
one with the fused QKV / gate-up layouts.  Every configuration the port
registers equals the reference's field for field.  Each block family
(mamba2, RWKV6, experts, M-RoPE, the shared block, and attention mixed
with a recurrent block) decodes as the reference's on the ``small``
widths.  The logits of the three smoke configs added with them
(``deepseek``, ``gemma2``, ``gemma3``) are held within 1e-6 of the step's
largest |logit| instead of elementwise: their float32 roundoff reaches
1.02e-5 on a logit of 0.0056 (largest ~10), where an elementwise 1e-5
fails; their hidden states and caches keep the elementwise tolerance.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro import configs as jconfigs  # noqa: E402
from repro.configs.base import ArchConfig as JCfg  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.models import transformer as jtr  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs.base import ArchConfig as TCfg  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.models import transformer as ttr  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
SMALL = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
             vocab_size=256, dtype="float32", attn_chunk=32, loss_chunk=32)
# a str: the smoke config of that architecture
CONFIGS = {
    "small": ("t-serve", SMALL),
    "qwen3-smoke": "qwen3-8b",
    "deepseek-smoke": "deepseek-67b",
    "gemma2-smoke": "gemma2-2b",
    "gemma3-smoke": "gemma3-27b",
    "softcap-local": ("t-softcap", dict(
        SMALL, n_layers=3, block_pattern=("local", "attn"), window=3,
        attn_softcap=20.0, logit_softcap=30.0, embed_scale=True,
        tie_embeddings=False, rope_theta=10_000.0,
        rope_theta_global=1_000_000.0)),
    "fused": ("t-fused", dict(SMALL, fused_qkv=True, fused_gate_up=True,
                              qk_norm=True)),
}


def cfg_pair(name: str):
    if isinstance(CONFIGS[name], str):
        arch = CONFIGS[name]
        return jconfigs.get_smoke(arch), tconfigs.get_smoke(arch)
    arch, kw = CONFIGS[name]
    return JCfg(arch, "dense", **kw), TCfg(arch, "dense", **kw)


def params_pair(jcfg, seed: int = 0):
    jp = jtr.init_params(jcfg, jax.random.PRNGKey(seed))
    return jp, convert.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jp), "cpu")


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


# smoke configs whose logits are held relative to the step's largest
SCALED_LOGITS = ("deepseek-smoke", "gemma2-smoke", "gemma3-smoke")


def close_scaled(port: torch.Tensor, ref, what: str, frac: float = 1e-6):
    ref = np.asarray(ref, np.float32)
    diff = float(np.abs(port.numpy() - ref).max())
    assert diff <= frac * float(np.abs(ref).max()), (what, diff)


def close(port: torch.Tensor, ref, what: str):
    np.testing.assert_allclose(port.float().numpy(),
                               np.asarray(ref, np.float32), err_msg=what,
                               **TOL)


PORTED = ("qwen3-8b", "deepseek-67b", "gemma2-2b", "gemma3-27b",
          "arctic-480b", "llama4-scout-17b-a16e", "qwen2-vl-2b",
          "zamba2-1.2b", "rwkv6-3b")


def test_arch_config_and_registry_are_the_reference_s():
    for arch in PORTED:
        for getter in ("get_config", "get_smoke"):
            j = getattr(jconfigs, getter)(arch)
            t = getattr(tconfigs, getter)(arch)
            assert dataclasses.asdict(j) == dataclasses.asdict(t), \
                (arch, getter)
            assert j.blocks == t.blocks
            assert j.param_count() == t.param_count()
            assert j.param_count(True) == t.param_count(True)
            assert j.head_dim == t.head_dim
    for name in CONFIGS:
        j, t = cfg_pair(name)
        assert dataclasses.asdict(j) == dataclasses.asdict(t), name
        assert j.param_count() == t.param_count(), name
        assert dataclasses.asdict(j.scaled(n_layers=5)) == \
            dataclasses.asdict(t.scaled(n_layers=5))
    assert tconfigs.ARCH_IDS == PORTED
    assert tconfigs.get_config("dhash-paper").arch_id == "dhash-paper"
    assert set(tconfigs.WAITING) | set(PORTED) == set(jconfigs.ARCH_IDS)
    with pytest.raises(KeyError, match="ROADMAP A7"):
        tconfigs.get_config("hubert-xlarge")
    with pytest.raises(KeyError, match="unknown arch"):
        tconfigs.get_smoke("no-such-arch")


def test_the_configurations_that_still_wait():
    """One of the reference's architectures waits: the encoder-only
    ``hubert-xlarge``, which has no decode step, for the training forward
    (ROADMAP A7 f); its id raises naming the roadmap."""
    assert set(tconfigs.WAITING) == {"hubert-xlarge"}
    for arch in tconfigs.WAITING:
        for getter in (tconfigs.get_config, tconfigs.get_smoke):
            with pytest.raises(KeyError, match="ROADMAP A7"):
                getter(arch)


def test_layers_against_the_reference():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, 5, 16)).astype(np.float32)
    scale = rng.normal(size=(16,)).astype(np.float32) * 0.1
    close(tlayers.rms_norm(_t(x), _t(scale)),
          jlayers.rms_norm(jnp.asarray(x), jnp.asarray(scale)), "rms_norm")
    # bf16 in, bf16 out, computed in f32: equal to one bf16 ulp
    xb = jnp.asarray(x, jnp.bfloat16)
    yb = tlayers.rms_norm(_t(np.asarray(xb.astype(jnp.float32))).bfloat16(),
                          _t(scale).bfloat16())
    assert yb.dtype == torch.bfloat16
    np.testing.assert_allclose(
        yb.float().numpy(),
        np.asarray(jlayers.rms_norm(xb, jnp.asarray(scale, jnp.bfloat16))
                   .astype(jnp.float32)), rtol=2 ** -7, atol=2 ** -7)
    w = [rng.normal(size=s).astype(np.float32) * 0.2
         for s in ((16, 24), (16, 24), (24, 16))]
    close(tlayers.swiglu(_t(x), *map(_t, w)),
          jlayers.swiglu(jnp.asarray(x), *map(jnp.asarray, w)), "swiglu")
    np.testing.assert_array_equal(tlayers.rope_freqs(16, 1e4),
                                  jlayers.rope_freqs(16, 1e4))
    q = rng.normal(size=(2, 4, 3, 16)).astype(np.float32)
    pos = rng.integers(0, 200, size=(2, 4)).astype(np.int32)
    for theta in (1e4, 1e6):
        th32 = float(np.float32(theta))
        close(tlayers.apply_rope(_t(q), _t(pos), th32),
              jlayers.apply_rope(jnp.asarray(q), jnp.asarray(pos),
                                 jnp.float32(theta)), f"rope {theta}")
    table = rng.normal(size=(50, 16)).astype(np.float32)
    tok = rng.integers(0, 50, size=(3, 2)).astype(np.int32)
    for sc in (False, True):
        close(tlayers.embed(_t(tok), _t(table), scale=sc),
              jlayers.embed(jnp.asarray(tok), jnp.asarray(table), scale=sc),
              f"embed scale={sc}")


@pytest.mark.parametrize("qk_norm", [False, True])
def test_project_qkv_and_decode_attention(qk_norm):
    rng = np.random.default_rng(1)
    b, d, hq, hkv, hd, smax = 3, 32, 4, 2, 8, 12
    x = rng.normal(size=(b, 1, d)).astype(np.float32)
    ws = [rng.normal(size=(d, h, hd)).astype(np.float32) * d ** -0.5
          for h in (hq, hkv, hkv)]
    qkn = [rng.normal(size=(hd,)).astype(np.float32) * 0.1 for _ in "qk"]
    kw_t = dict(qk_norm_scale=tuple(map(_t, qkn)) if qk_norm else None)
    kw_j = dict(qk_norm_scale=tuple(map(jnp.asarray, qkn))
                if qk_norm else None)
    got = tattn.project_qkv(_t(x), *map(_t, ws), **kw_t)
    ref = jattn.project_qkv(jnp.asarray(x), *map(jnp.asarray, ws), **kw_j)
    for name, a, r in zip("qkv", got, ref):
        close(a, r, f"project_qkv {name}")
    kc = rng.normal(size=(b, smax, hkv, hd)).astype(np.float32)
    vc = rng.normal(size=(b, smax, hkv, hd)).astype(np.float32)
    clen = np.array([1, 7, 12], np.int32)
    for window in (0, 3):
        for softcap in (0.0, 2.0):
            close(tattn.decode_attention(got[0], _t(kc), _t(vc), _t(clen),
                                         window=window, softcap=softcap),
                  jattn.decode_attention(ref[0], jnp.asarray(kc),
                                         jnp.asarray(vc), jnp.asarray(clen),
                                         window=window, softcap=softcap),
                  f"decode_attention window={window} softcap={softcap}")


@pytest.mark.parametrize("name", list(CONFIGS))
def test_init_tree_and_flags_match_the_reference(name):
    jcfg, tcfg = cfg_pair(name)
    jp, tp = params_pair(jcfg)
    mine = ttr.init_params(tcfg, torch.Generator().manual_seed(0))
    flat_j = jax.tree_util.tree_flatten_with_path(jp)[0]
    assert len(flat_j) == sum(len(v) if isinstance(v, dict) else 1
                              for v in mine.values())
    for path, leaf in flat_j:
        keys = [k.key for k in path]
        node, conv = mine, tp
        for k in keys:
            node, conv = node[k], conv[k]
        assert tuple(node.shape) == leaf.shape, keys
        assert node.dtype == conv.dtype == torch.float32, keys
        np.testing.assert_array_equal(conv.numpy(), np.asarray(leaf))
    flags_j = jtr._attn_flags(jcfg)
    flags_t = ttr._attn_flags(tcfg)
    assert flags_t["window"] == np.asarray(flags_j["window"]).tolist()
    assert np.array_equal(np.asarray(flags_t["theta"], np.float32),
                          np.asarray(flags_j["theta"]))
    back = convert.params_to_numpy(tp)
    jax.tree_util.tree_map(np.testing.assert_array_equal, back,
                           jax.tree_util.tree_map(np.asarray, jp))
    # bfloat16 weights travel as their 16-bit words, both ways
    jb = jax.tree_util.tree_map(lambda x: np.asarray(x.astype(jnp.bfloat16)),
                                jp)
    tb = convert.params_from_numpy(jb, "cpu")
    assert tb["embed"].dtype == torch.bfloat16
    np.testing.assert_array_equal(tb["embed"].float().numpy(),
                                  jb["embed"].astype(np.float32))
    jax.tree_util.tree_map(np.testing.assert_array_equal,
                           convert.params_to_numpy(tb), jb)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_forward_decode_and_decode_logits_step_by_step(name):
    """Six decode steps of three sequences from an empty cache: hidden
    states, logits and the caches' K/V after every step."""
    jcfg, tcfg = cfg_pair(name)
    jp, tp = params_pair(jcfg, seed=2)
    rng = np.random.default_rng(3)
    b, smax, steps = 3, 8, 6
    toks = rng.integers(0, jcfg.vocab_size, size=(steps, b, 1)).astype(
        np.int32)
    jc = jtr.init_cache(jcfg, b, smax)
    tc = ttr.init_cache(tcfg, b, smax, device="cpu")
    tc2 = ttr.init_cache(tcfg, b, smax, device="cpu")
    fwd = jax.jit(jtr.forward_decode, static_argnums=1)
    logits_fn = jax.jit(jmodel.decode_logits, static_argnums=1)
    for s in range(steps):
        jh, jc_next = fwd(jp, jcfg, jnp.asarray(toks[s]), jc)
        th, tc = ttr.forward_decode(tp, tcfg, _t(toks[s]), tc)
        close(th, jh, f"{name} hidden step {s}")
        jl, jc = logits_fn(jp, jcfg, jnp.asarray(toks[s]), jc)
        tl, tc2 = tmodel.decode_logits(tp, tcfg, _t(toks[s]), tc2)
        assert tl.dtype == torch.float32 and tl.shape == (b, jcfg.vocab_size)
        (close_scaled if name in SCALED_LOGITS else close)(
            tl, jl, f"{name} logits step {s}")
        for k in ("k", "v"):
            close(tc[k], jc_next[k], f"{name} cache {k} step {s}")
            close(tc2[k], jc[k], f"{name} cache {k} step {s}")
        np.testing.assert_array_equal(tc["len"].numpy(), np.asarray(jc["len"]))
        assert (tl.argmax(-1).numpy() == np.asarray(jl).argmax(-1)).all()


@pytest.mark.parametrize("override,what", [
    (dict(block_pattern=("mamba2",)), "ssm"),
    (dict(block_pattern=("attn", "rwkv6")), "rwkv"),
    (dict(n_experts=4, top_k=2, moe_dff=32), "moe"),
    (dict(mrope_sections=(2, 3, 3)), "M-RoPE"),
    (dict(shared_attn_every=2, block_pattern=("mamba2",)), "shared"),
    (dict(block_pattern=("attn", "mamba2")), "attn+ssm"),
])
def test_block_families_decode_as_the_reference(override, what):
    """Every block family the port decodes, on the ``small`` widths: the
    port's own init has the reference's tree and shapes, and three steps
    of two sequences give the reference's logits and every cache entry
    within the module's tolerance.  ``rwkv`` and ``attn+ssm`` mix
    attention with a recurrent block and no shared block: the reference
    decodes only the recurrent stack there (its attention K/V stay zero),
    and so does the port (ROADMAP C)."""
    cfg = TCfg("t-family", "dense", **dict(SMALL, **override))
    jcfg = JCfg("t-family", "dense", **dict(SMALL, **override))
    mine = ttr.init_params(cfg, torch.Generator().manual_seed(0))
    jp, tp = params_pair(jcfg, seed=1)
    flat = jax.tree_util.tree_flatten_with_path(jp)[0]
    assert len(flat) == sum(len(v) if isinstance(v, dict) else 1
                            for v in mine.values())
    for path, leaf in flat:
        node = mine
        for k in path:
            node = node[k.key]
        assert tuple(node.shape) == leaf.shape, (what, path)
    if what == "moe":
        assert mine["attn_stack"]["we_g"].shape == (2, 4, 64, 32)
        assert "wg" not in mine["attn_stack"] and "hash_seeds" not in mine
    jc = jtr.init_cache(jcfg, 2, 4)
    tc = ttr.init_cache(cfg, 2, 4, device="cpu")
    assert {k: tuple(v.shape) for k, v in tc.items()} == \
        {k: v.shape for k, v in jc.items()}
    fn = jax.jit(jmodel.decode_logits, static_argnums=1)
    for s, tok in enumerate(([[3], [7]], [[7], [1]], [[250], [3]])):
        tok = np.asarray(tok, np.int32)
        jl, jc = fn(jp, jcfg, jnp.asarray(tok), jc)
        tl, tc = tmodel.decode_logits(tp, cfg, _t(tok), tc)
        close(tl, jl, f"{what} logits step {s}")
        for k in jc:
            close(tc[k], jc[k], f"{what} cache {k} step {s}")
    if what in ("rwkv", "attn+ssm"):
        assert not tc["k"].any() and not np.asarray(jc["k"]).any()


def test_encoder_only_waits_naming_the_roadmap():
    """The encoder-only configuration has no decode step: init and cache
    raise naming the training forward's roadmap item."""
    cfg = tconfigs.get_smoke("qwen3-8b").scaled(encoder_only=True,
                                                causal=False)
    for fn in (lambda: ttr.init_params(cfg, torch.Generator()),
               lambda: ttr.init_cache(cfg, 1, 4, device="cpu")):
        with pytest.raises(NotImplementedError, match="ROADMAP A7 f"):
            fn()


def test_random_init_is_seeded_and_fills_in_blocks(monkeypatch):
    """The port's own init: the same generator seed gives the same weights,
    bf16 weights come out bf16, and a stack is filled in blocks of layers
    (the float32 draw never spans the whole stack)."""
    cfg = tconfigs.get_smoke("qwen3-8b").scaled(dtype="bfloat16")
    monkeypatch.setattr(ttr, "_INIT_CHUNK", 64 * 16 * 16)
    drawn = []
    real = torch.randn

    def spy(*a, **kw):
        out = real(*a, **kw)
        drawn.append(out.numel())
        return out
    monkeypatch.setattr(torch, "randn", spy)
    a = ttr.init_params(cfg, torch.Generator().manual_seed(5))
    b = ttr.init_params(cfg, torch.Generator().manual_seed(5))
    assert a["attn_stack"]["wq"].dtype == torch.bfloat16
    assert torch.equal(a["attn_stack"]["wq"], b["attn_stack"]["wq"])
    assert torch.equal(a["embed"], b["embed"])
    assert max(drawn) <= 64 * 16 * 16
    assert not torch.equal(a["attn_stack"]["wq"][0],
                           a["attn_stack"]["wq"][1])
