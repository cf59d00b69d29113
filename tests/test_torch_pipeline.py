"""Port vs reference: the synthetic data pipeline and its DHash dedup
(``data/pipeline.py``).

The same configurations and steps go through the JAX functions and the
port's on the CPU.  Labels, loss masks, M-RoPE positions, fingerprints,
keep masks and the dedup table's key -> value map are exactly equal.
Tokens are equal except where the two packages' float32 ``pow`` may round
the zipf rank differently: only a token whose reference rank lies within
2 ulp of an integer (below the vocabulary clip) may differ, and the test
pins the count of such ranks and of differing tokens a batch
(``NEAR_AND_DIFFER``): of the 84,480 tokens drawn, 174 ranks lie that
close and 1 token differs (pipeline size, step 191: the reference's rank
is 158754.0 exactly, the port's ``pow`` one ulp below it, 158753).
"""
from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.core import dhash as jdhash  # noqa: E402
from repro.core import hashing as jhashing  # noqa: E402
from repro.data import pipeline as jpipe  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import dhash as tdhash  # noqa: E402
from repro_torch.data import pipeline as tpipe  # noqa: E402
from test_torch_convert import jax_state_tree  # noqa: E402
from test_torch_dhash import _content  # noqa: E402

SMALL = dict(vocab_size=1000, seq_len=256, global_batch=4, seed=1)
BIG = dict(vocab_size=202048, seq_len=4096, global_batch=64, seed=0)
# (config, step, shard, nshards, mrope)
BATCHES = {
    "small": (SMALL, 0, 0, 1, False),
    "small-step5-shard1of2": (SMALL, 5, 1, 2, False),
    "short-docs-mrope": (dict(SMALL, seed=7, mean_doc_len=16), 3, 0, 1,
                         True),
    "pipeline-size": (BIG, 191, 0, 4, False),
    # (step * global_batch + shard * b) * seq_len wraps int32
    "int32-wrap": (dict(BIG, global_batch=8, zipf_a=1.1), 2**21 + 3, 1, 2,
                   False),
}


# per batch: (reference ranks within 2 ulp of an integer below the clip,
# tokens that differ); every differing token is such a rank
NEAR_AND_DIFFER = {"small": (0, 0), "small-step5-shard1of2": (0, 0),
                   "short-docs-mrope": (0, 0), "pipeline-size": (129, 1),
                   "int32-wrap": (45, 0)}


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


def ref_rank(cfg, step: int, shard: int, nshards: int) -> np.ndarray:
    """The reference's float32 zipf rank of every token (its own ops)."""
    b, s = cfg.global_batch // nshards, cfg.seq_len
    fn = jhashing.HashFn(kind="mix32", seeds=jnp.asarray(
        [cfg.seed * 2654435761 % 2**32 or 1, 0x9E3779B9], jnp.uint32))
    base = (jnp.asarray(step, jnp.int32) * cfg.global_batch + shard * b) * s
    idx = base + jnp.arange(b, dtype=jnp.int32)[:, None] * s + \
        jnp.arange(s, dtype=jnp.int32)[None, :]
    u = jnp.clip(jpipe._u01(fn, idx), 1e-6, 1.0)
    return np.asarray(jnp.power(u, -1.0 / (cfg.zipf_a - 1.0)))


@pytest.mark.parametrize("name", list(BATCHES))
def test_synth_batch_against_the_reference(name):
    kw, step, shard, nshards, mrope = BATCHES[name]
    jcfg, tcfg = jpipe.DataConfig(**kw), tpipe.DataConfig(**kw)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    want = jpipe.synth_batch(jcfg, step, shard=shard, nshards=nshards,
                             mrope=mrope)
    got = tpipe.synth_batch(tcfg, step, shard=shard, nshards=nshards,
                            mrope=mrope, device="cpu")
    assert set(got) == set(want)
    for k in want:
        if k not in ("tokens", "labels"):
            np.testing.assert_array_equal(got[k].numpy(),
                                          np.asarray(want[k]), err_msg=k)
    tok, ref = got["tokens"].numpy(), np.asarray(want["tokens"])
    assert tok.dtype == ref.dtype == np.int32
    rank = ref_rank(jcfg, step, shard, nshards)
    # truncation decides the token only below the clip (an inf rank,
    # zipf_a 1.1, is clipped on both sides)
    with np.errstate(invalid="ignore"):
        near = (np.abs(rank - np.round(rank)) <= 2 * np.spacing(rank)) \
            & (rank < tcfg.vocab_size - 1)
    differ = tok != ref
    assert not (differ & ~near).any(), f"{name}: {differ.sum()} tokens"
    assert (int(near.sum()), int(differ.sum())) == NEAR_AND_DIFFER[name]
    # the labels are the tokens shifted: they differ where those do
    lab = got["labels"].numpy() != np.asarray(want["labels"])
    assert (lab[:, :-1] == differ[:, 1:]).all() and not lab[:, -1].any()
    # a real stream: zipf-skewed ids, EOS present, every id in range
    assert tok.min() >= 0 and tok.max() < tcfg.vocab_size
    assert (tok == tcfg.eos_id).any()


@pytest.mark.parametrize("block,seq_len", [(64, 256), (128, 256),
                                           (64, 200)])
def test_doc_fingerprints_exact(block, seq_len):
    cfg = jpipe.DataConfig(**dict(SMALL, seq_len=seq_len))
    tokens = np.array(jpipe.synth_batch(cfg, 2)["tokens"])
    tokens[1] = tokens[0]                      # a repeated document
    want = np.asarray(jpipe.doc_fingerprints(jnp.asarray(tokens),
                                             block=block))
    got = tpipe.doc_fingerprints(_t(tokens), block=block)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want >= 0).all() and (want[0] == want[1]).all()


def _stream(cfg):
    """(label, tokens): fresh batches, a batch seen before, a batch whose
    rows 0 and 1 are one document (duplicates within the batch), and a
    batch that repeats one earlier row."""
    batch = [np.array(jpipe.synth_batch(cfg, s)["tokens"])
             for s in range(6)]
    dup = batch[4].copy()
    dup[1] = dup[0]
    mixed = batch[5].copy()
    mixed[2] = batch[1][3]
    return [("b0", batch[0]), ("b1", batch[1]), ("b0 again", batch[0]),
            ("b2", batch[2]), ("b3", batch[3]), ("in-batch dup", dup),
            ("b1 again", batch[1]), ("mixed", mixed), ("b3 again", batch[3])]


@pytest.mark.parametrize("fused", [False, True])
def test_dedup_batch_stream_against_the_reference(fused):
    """Keep masks and the table's live key -> value map after every batch,
    through a live rebuild of the fingerprint table started at batch 3 and
    run to its epoch swap (6 transitions a batch on both sides)."""
    cfg = jpipe.DataConfig(**SMALL)
    jt = jdhash.make("linear", capacity=256, chunk=32, seed=0)
    tt = tdhash.make("linear", capacity=256, chunk=32, seed=0, fused=fused,
                     device="cpu")
    kept = 0
    for i, (label, tokens) in enumerate(_stream(cfg)):
        if i == 3:
            jt = jdhash.rebuild_start(jt, seed=9)
            tt = tdhash.rebuild_start(tt, seed=9)
        jt, jkeep = jpipe.dedup_batch(jt, jnp.asarray(tokens), block=64)
        tt, tkeep = tpipe.dedup_batch(tt, _t(tokens), block=64)
        np.testing.assert_array_equal(tkeep.numpy(), np.asarray(jkeep),
                                      err_msg=label)
        if label.endswith("again"):
            assert not tkeep.any(), label
        if label == "in-batch dup":    # seen read before the insert
            assert tkeep[0].all() and tkeep[1].all()
        kept += int(tkeep[:, ::64].sum())
        for _ in range(6 if i >= 3 else 0):
            jt = jdhash.rebuild_step(jt)
            tt = tdhash.rebuild_step(tt)
        jt = jdhash.finish_same_shape(jt)
        tt = tdhash.finish_same_shape(tt)
        tm = _content(convert.state_to_numpy(tt))
        assert tm == _content(jax_state_tree(jt)), label
        assert bool(tt.rebuilding) == bool(jt.rebuilding), label
    assert int(tt.epoch) == int(jt.epoch) == 1
    # one entry a distinct fingerprint: the four blocks repeated within a
    # batch are kept twice but inserted once
    assert len(tm) == kept - 4


def test_dedup_batch_drops_repeats():
    """The reference's ``tests/test_substrates.py::test_dedup_batch_drops_
    repeats`` on the port."""
    cfg = tpipe.DataConfig(vocab_size=1000, seq_len=256, global_batch=4,
                           seed=1)
    table = tdhash.make("linear", capacity=4096, chunk=64, seed=0,
                        device="cpu")
    batch = tpipe.synth_batch(cfg, 0, device="cpu")
    table, keep1 = tpipe.dedup_batch(table, batch["tokens"], block=64)
    assert bool(keep1.all()), "first sight: all kept"
    table, keep2 = tpipe.dedup_batch(table, batch["tokens"], block=64)
    assert not bool(keep2.any()), "second sight: all dropped"
    # a tail shorter than a block is always kept
    table, keep3 = tpipe.dedup_batch(table, batch["tokens"][:, :200],
                                     block=64)
    assert not keep3[:, :192].any() and keep3[:, 192:].all()


def test_synth_embeds_is_a_pure_function_of_seed_step_and_shard():
    cfg = tpipe.DataConfig(vocab_size=10, seq_len=5, global_batch=4, seed=3)
    a = tpipe.synth_embeds(cfg, 2, 8, shard=1, nshards=2, device="cpu")
    b = tpipe.synth_embeds(cfg, 2, 8, shard=1, nshards=2, device="cpu")
    c = tpipe.synth_embeds(cfg, 3, 8, shard=1, nshards=2, device="cpu")
    assert a.shape == (2, 5, 8) and a.dtype == torch.bfloat16
    assert torch.equal(a, b) and not torch.equal(a, c)
    f = tpipe.synth_embeds(cfg, 2, 8, dtype=torch.float32, device="cpu")
    assert f.dtype == torch.float32 and abs(float(f.std()) - 1) < 0.5
