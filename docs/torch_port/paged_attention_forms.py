"""Two forms of the paged decode attention, timed on the card.

``kvcache.paged_decode_attention`` gathers a layer's ``n_blocks`` pages at
once and sums the reference's block-by-block online softmax in closed
form.  ``blocks`` below is the reference's form: a loop over the blocks
with a running (max, denominator, accumulator), one gather a block.  The
script holds the two to each other on the same inputs and times them at
the serving path's shapes (``qwen3-8b`` at full width and depth in bf16,
``launch/serve.py``'s ServeConfig, 8 active sequences):

* one layer's call: host ms (to a synchronise) and device busy ms (the
  profiler's kernels);
* the engine's steady decode step (``ServingEngine._run_slots``), host
  clock to a synchronise, in turns closed, blocks, blocks, closed.

Run from the repository root on a machine with an NVIDIA GPU:

    python3 docs/torch_port/paged_attention_forms.py [--steps 12]

It exits non-zero without a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

F32, I32 = torch.float32, torch.int32


def blocks(kv, layer, q1, seq_ids, cache_len, n_blocks, *, window=0,
           softcap=0.0):
    """The reference's form (``src/repro/serving/kvcache.py``,
    ``paged_decode_attention``): a scan over the blocks, here a loop."""
    from repro_torch.serving import kvcache
    b, hq, hd = q1.shape
    hkv, ps = kv.kv_heads, kv.page_size
    g = hq // hkv
    scale = 1.0 / np.sqrt(hd)
    pages, found = kvcache.resolve_blocks(kv, seq_ids, n_blocks)
    qg = q1.reshape(b, hkv, g, hd)
    pool_k, pool_v = kv.pool_k[layer], kv.pool_v[layer]
    dev = q1.device
    m = torch.full((b, hkv, g), float("-inf"), dtype=F32, device=dev)
    l = torch.zeros((b, hkv, g), dtype=F32, device=dev)
    acc = torch.zeros((b, hkv, g, hd), dtype=F32, device=dev)
    ar = torch.arange(ps, dtype=I32, device=dev)[None, :]
    clen = cache_len[:, None]
    for blk in range(n_blocks):
        pg = pages[:, blk]
        idx = torch.where(pg >= 0, pg, 0).long()
        kb, vb = pool_k[idx], pool_v[idx]               # [B, ps, KV, HD]
        s = torch.einsum("bhgd,bphd->bhgp", qg, kb).to(F32) * scale
        if softcap > 0:
            s = torch.tanh(s / softcap) * softcap
        pos = blk * ps + ar
        ok = (pos < clen) & (found[:, blk] & (pg >= 0))[:, None]
        if window > 0:
            ok &= pos >= clen - window
        s = torch.where(ok[:, None, None, :], s, kvcache.NEG_INF)
        m2 = torch.maximum(m, s.amax(-1))
        w = torch.exp(s - m2[..., None])
        corr = torch.exp(m - m2)
        l = l * corr + w.sum(-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bhgp,bphd->bhgd", w.to(vb.dtype), vb).to(F32)
        m = m2
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(b, hq, hd).to(q1.dtype)


def device_busy_ms(fn, n: int) -> float:
    """Device busy time a call: the device time of every kernel, copy and
    fill the profiler saw over ``n`` calls, over ``n`` (a call launches
    too many kernels to queue a run of them ahead of the device, so CUDA
    events around each call would time the host)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    us = sum(getattr(e, "device_time_total", None) or e.cuda_time_total
             for e in prof.events() if e.device_type == DeviceType.CUDA)
    return us / n / 1e3


def host_ms(fn, reps: int) -> list:
    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=12,
                    help="timed engine steps a turn")
    ap.add_argument("--reps", type=int, default=50,
                    help="timed calls of one layer's attention")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("paged_attention_forms: no CUDA device", file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    sys.path.insert(0, os.path.join(root, "src"))
    from repro_torch import configs
    from repro_torch.models import transformer
    from repro_torch.serving import kvcache
    from repro_torch.serving.engine import ServeConfig, ServingEngine

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(card)
    device = torch.device("cuda", 0)
    cfg = configs.get_config("qwen3-8b")
    params = transformer.init_params(
        cfg, torch.Generator(device=device).manual_seed(args.seed))
    sc = ServeConfig(max_seqs=8, page_size=16, n_pages=1024, max_blocks=32,
                     max_new_tokens=10_000)
    eng = ServingEngine(params, cfg, sc)
    rng = np.random.default_rng(args.seed)
    for _ in range(sc.max_seqs):
        eng.submit(rng.integers(1, cfg.vocab_size - 1,
                                size=int(rng.integers(4, 9))).tolist())
    eng._admit()
    closed = kvcache.paged_decode_attention

    # one layer's call, both forms on the same inputs
    with torch.inference_mode():
        kv = eng.kv
        ids = torch.as_tensor(eng.seq_ids, device=device)
        clen = torch.as_tensor(eng.lengths, device=device) + 1
        q1 = torch.randn((sc.max_seqs, cfg.n_heads, cfg.head_dim),
                         generator=torch.Generator(device=device)
                         .manual_seed(args.seed + 1), device=device,
                         dtype=torch.bfloat16)
        call = {"closed": lambda: closed(kv, 0, q1, ids, clen,
                                         sc.max_blocks),
                "blocks": lambda: blocks(kv, 0, q1, ids, clen,
                                         sc.max_blocks)}
        o_closed = call["closed"]().float()
        diff = float((o_closed - call["blocks"]().float()).abs().max())
        top = float(o_closed.abs().max())
        layer = {}
        for name in ("closed", "blocks", "blocks", "closed"):
            r = layer.setdefault(name, {"device_busy_ms": [],
                                        "host_ms": []})
            r["device_busy_ms"].append(device_busy_ms(call[name], 5))
            r["host_ms"].append(statistics.median(
                host_ms(call[name], args.reps)))

    # the engine's steady decode step with each form
    step = {}
    try:
        for name in ("closed", "blocks", "blocks", "closed"):
            kvcache.paged_decode_attention = (closed if name == "closed"
                                              else blocks)
            eng._run_slots(sample=False)           # warm
            step.setdefault(name, []).extend(host_ms(
                lambda: eng._run_slots(sample=False), args.steps))
    finally:
        kvcache.paged_decode_attention = closed
    out = {
        "card": card,
        "shapes": dict(batch=sc.max_seqs, heads=cfg.n_heads,
                       kv_heads=cfg.n_kv_heads, head_dim=cfg.head_dim,
                       n_blocks=sc.max_blocks, page_size=sc.page_size,
                       layers=cfg.n_layers, dtype=cfg.dtype),
        "max_abs_diff_bf16": diff, "max_abs_out": top,
        "layer_call": {k: {f: statistics.median(v) for f, v in r.items()}
                       for k, r in layer.items()},
        "step_ms": {k: dict(median=statistics.median(v), min=min(v),
                            max=max(v), n=len(v)) for k, v in step.items()},
    }
    print(json.dumps(out))
    # the two forms weigh each block alike and differ only in the order of
    # their float32 sums: at most a bf16 ulp or two of the largest output
    ok = diff <= top / 64
    print("ok" if ok else "the two forms disagree")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
