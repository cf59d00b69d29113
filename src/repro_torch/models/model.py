"""The logits head on top of the transformer assembly: ``decode_logits``,
the dense decode the paged serving engine is held to.  The training loss
waits for the training forward (ROADMAP A7)."""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import transformer

F32 = torch.float32


@torch.inference_mode()
def decode_logits(params: dict, cfg: ArchConfig, tokens1, cache: dict,
                  router_table=None):
    """One decode step -> (logits [B,V] float32, cache').  ``router_table``:
    a hash router's DHash override table (``train_step.make_router_table``),
    looked up once a step."""
    hidden, cache = transformer.forward_decode(params, cfg, tokens1, cache,
                                               router_table)
    w = transformer.unembed_matrix(params, cfg)
    logits = (hidden @ w).to(F32)
    if cfg.logit_softcap > 0:
        logits = torch.tanh(logits / cfg.logit_softcap) * cfg.logit_softcap
    return logits[:, 0], cache
