"""Port vs reference: M-RoPE (``layers.apply_mrope``) and ``qwen2-vl-2b``,
its decode with the stubbed patch-embedding frontend and its service
through the paged engine.

The same inputs, made from a seed with numpy (weights: the reference's
``init_params`` through ``convert.params_from_numpy``), go through the JAX
function and its counterpart in the port on the CPU (``device="cpu"``).
Tolerance: ``TOL``, 1e-5 absolute and relative, in float32, unless a
test's docstring states another.  The reference's engine is run with each
decode step waited for (ROADMAP C, ``tests/test_torch_serving.py``).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro import configs as jconfigs  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.models import transformer as jtr  # noqa: E402
from repro.serving.engine import ServeConfig as JSC  # noqa: E402
from repro.serving.engine import ServingEngine as JEngine  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.models import transformer as ttr  # noqa: E402
from repro_torch.serving.engine import ServeConfig as TSC  # noqa: E402
from repro_torch.serving.engine import ServingEngine as TEngine  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


def close(port: torch.Tensor, ref, what: str):
    np.testing.assert_allclose(port.float().numpy(),
                               np.asarray(ref, np.float32), err_msg=what,
                               **TOL)


@pytest.mark.parametrize("sections", [(4, 2, 2), (2, 3, 3), (0, 4, 4)])
def test_apply_mrope_on_three_different_streams(sections):
    """t / h / w positions drawn apart, each stream's share of the pairs
    as ``sections`` says; the precomputed angles give the same result."""
    rng = np.random.default_rng(sum(sections[:2]))
    x = rng.normal(size=(2, 5, 3, 16)).astype(np.float32)
    pos = rng.integers(0, 4096, size=(3, 2, 5)).astype(np.int32)
    want = jlayers.apply_mrope(jnp.asarray(x), jnp.asarray(pos), 1e6,
                               sections)
    got = tlayers.apply_mrope(_t(x), _t(pos), 1e6, sections)
    close(got, want, f"apply_mrope {sections}")
    ang = tlayers.mrope_angles(_t(pos), 1e6, 16, sections)
    assert torch.equal(tlayers.apply_mrope(_t(x), _t(pos), 1e6, sections,
                                           ang), got)


def test_equal_streams_are_apply_rope_bit_for_bit():
    """A text token's three streams carry one position: ``apply_mrope``
    then IS ``apply_rope``, bit for bit (the paged engine's rotation), at
    qwen2-vl-2b's head width and sections, in float32 and bfloat16."""
    cfg = tconfigs.get_config("qwen2-vl-2b")
    rng = np.random.default_rng(0)
    x = _t(rng.normal(size=(4, 1, cfg.n_heads, cfg.head_dim)).astype(
        np.float32))
    pos = _t(rng.integers(0, 32768, size=(4, 1)).astype(np.int32))
    theta = float(np.float32(cfg.rope_theta))
    for dt in (torch.float32, torch.bfloat16):
        a = tlayers.apply_mrope(x.to(dt), pos.expand(3, 4, 1), theta,
                                cfg.mrope_sections)
        b = tlayers.apply_rope(x.to(dt), pos, theta)
        assert a.dtype == dt and torch.equal(a, b), dt


@pytest.fixture(scope="module")
def qwen2vl():
    jcfg, tcfg = jconfigs.get_smoke("qwen2-vl-2b"), \
        tconfigs.get_smoke("qwen2-vl-2b")
    jp = jtr.init_params(jcfg, jax.random.PRNGKey(3))
    return jcfg, jp, tcfg, convert.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jp), "cpu")


def test_decode_logits_tokens_and_patch_embeddings(qwen2vl):
    """Two steps of stub patch embeddings ([B, 1, D], the frontend's
    input), then three of tokens, three sequences: logits within 1e-6 of
    the step's largest |logit| (tied std-1 embeddings put it near 35,
    where float32 roundoff reaches 1.6e-5), K/V and ``len`` within
    ``TOL``."""
    jcfg, jp, tcfg, tp = qwen2vl
    rng = np.random.default_rng(4)
    jc = jtr.init_cache(jcfg, 3, 8)
    tc = ttr.init_cache(tcfg, 3, 8, device="cpu")
    fn = jax.jit(jmodel.decode_logits, static_argnums=1)
    inputs = [rng.normal(size=(3, 1, jcfg.d_model)).astype(np.float32)
              for _ in range(2)]
    inputs += [rng.integers(0, jcfg.vocab_size, size=(3, 1)).astype(np.int32)
               for _ in range(3)]
    for s, inp in enumerate(inputs):
        jl, jc = fn(jp, jcfg, jnp.asarray(inp), jc)
        tl, tc = tmodel.decode_logits(tp, tcfg, _t(inp), tc)
        jl = np.asarray(jl)
        assert np.abs(tl.numpy() - jl).max() <= 1e-6 * np.abs(jl).max(), s
        assert set(tc) == set(jc)
        for k in jc:
            close(tc[k], jc[k], f"cache {k} step {s}")


def test_paged_engine_serves_the_reference_s_tokens(qwen2vl, monkeypatch):
    """The paged engine on qwen2-vl-2b's smoke config gives the reference
    engine's tokens, rehash count and free pages (its page table fused,
    through a live rehash), and those tokens are dense greedy decode's
    through ``decode_logits`` (M-RoPE)."""
    jcfg, jp, tcfg, tp = qwen2vl
    sc = dict(max_seqs=2, page_size=4, n_pages=32, max_blocks=4,
              max_new_tokens=4, rehash_load_factor=0.001)
    monkeypatch.delenv("DHASH_FUSED", raising=False)
    je = JEngine(jp, jcfg, JSC(**sc))
    step = je._step
    je._step = lambda *a, **k: jax.block_until_ready(step(*a, **k))
    monkeypatch.setenv("DHASH_FUSED", "on")
    te = TEngine(tp, tcfg, TSC(**sc))
    monkeypatch.delenv("DHASH_FUSED")
    rng = np.random.default_rng(5)
    prompts = [rng.integers(1, jcfg.vocab_size - 1,
                            size=int(rng.integers(3, 7))).tolist()
               for _ in range(3)]
    ids = [(je.submit(p), te.submit(p)) for p in prompts]
    je.run()
    te.run()
    outs = [te.finished[t] for _, t in ids]
    assert outs == [je.finished[j] for j, _ in ids]
    assert te.rehashes == je.rehashes >= 1
    assert int(te.kv.free_top) == int(je.kv.free_top) == 32
    for prompt, out in zip(prompts, outs):
        seq = prompt + out
        cache = ttr.init_cache(tcfg, 1, len(seq), device="cpu")
        greedy = []
        for t in seq[:-1]:
            logits, cache = tmodel.decode_logits(tp, tcfg, _t([[t]]), cache)
            greedy.append(int(logits.argmax()))
        assert greedy[len(prompt) - 1:] == out
