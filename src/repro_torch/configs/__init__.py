"""Configurations of the port (own copies; nothing is imported from the
reference package) and the ``--arch <id>`` registry.

The registry lists only the configurations the port can run: the
``dhash-paper`` service, the dense attention models (``qwen3-8b``,
``deepseek-67b``, ``gemma2-2b``, ``gemma3-27b``), the hash-routed
mixtures of experts (``arctic-480b``, ``llama4-scout-17b-a16e``), M-RoPE
with a stubbed patch-embedding frontend (``qwen2-vl-2b``), mamba2 with a
weight-shared attention block (``zamba2-1.2b``) and RWKV6 (``rwkv6-3b``).
The reference's tenth architecture, the encoder-only ``hubert-xlarge``,
has no decode step and waits for the training forward (ROADMAP A7 f);
asking for it raises ``KeyError`` saying so.
"""
from __future__ import annotations

import importlib

_MODULES = {
    "qwen3-8b": "qwen3_8b",
    "deepseek-67b": "deepseek_67b",
    "gemma2-2b": "gemma2_2b",
    "gemma3-27b": "gemma3_27b",
    "arctic-480b": "arctic_480b",
    "llama4-scout-17b-a16e": "llama4_scout_17b",
    "qwen2-vl-2b": "qwen2_vl_2b",
    "zamba2-1.2b": "zamba2_1p2b",
    "rwkv6-3b": "rwkv6_3b",
    "dhash-paper": "dhash_paper",
}
# the reference's architectures that wait for the training forward
# (ROADMAP A7 f)
WAITING = ("hubert-xlarge",)

ARCH_IDS = tuple(k for k in _MODULES if k != "dhash-paper")
ALL_IDS = tuple(_MODULES)


def _mod(arch_id: str):
    if arch_id in WAITING:
        raise KeyError(f"arch {arch_id!r} is not ported yet (ROADMAP A7); "
                       f"the port runs {ALL_IDS}")
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; choose from {ALL_IDS}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[arch_id]}")


def get_config(arch_id: str):
    return _mod(arch_id).CONFIG


def get_smoke(arch_id: str):
    return _mod(arch_id).smoke()
