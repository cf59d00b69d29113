"""Serving driver: ``python -m repro_torch.launch.serve --arch <id>``.

Continuous batching over the DHash-paged KV cache (``serving/engine.py``)
with live page-table rehash, on a reduced (smoke) configuration with
random weights made from ``--seed``.  It runs on the GPU unless ``--device
cpu`` is given.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import configs
from repro_torch.models import transformer
from repro_torch.serving.engine import ServeConfig, ServingEngine

# the configurations the paged engine may serve: not the experts (ROADMAP
# C); of these, one without an attention block is refused below, with the
# reference's message
SERVED = tuple(a for a in configs.ARCH_IDS
               if not configs.get_config(a).n_experts)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-8b", choices=SERVED)
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu for a machine "
                    "without a GPU)")
    args = ap.parse_args(argv)

    cfg = configs.get_smoke(args.arch)
    if not any(k in ("attn", "local") for k in cfg.blocks):
        raise SystemExit(f"{args.arch}: paged-KV serving engine targets "
                         "attention archs; decode SSM / RWKV models with "
                         "model.decode_logits")
    device = torch.device(args.device)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = transformer.init_params(cfg, gen)
    eng = ServingEngine(params, cfg, ServeConfig(
        max_seqs=8, page_size=16, n_pages=1024, max_blocks=32,
        max_new_tokens=args.max_new))

    rng = np.random.default_rng(args.seed)
    t0 = time.time()
    ids = [eng.submit(list(rng.integers(1, cfg.vocab_size - 1,
                                        size=rng.integers(4, 24))))
           for _ in range(args.requests)]
    steps = eng.run()
    dt = time.time() - t0
    done = sum(i in eng.finished for i in ids)
    toks = sum(len(v) for v in eng.finished.values())
    print(f"served {done}/{args.requests} requests, {toks} tokens, "
          f"{steps} engine steps, {dt:.1f}s ({toks/max(dt,1e-9):.1f} tok/s), "
          f"page-table rehashes: {eng.rehashes}")
    return eng


if __name__ == "__main__":
    main()
