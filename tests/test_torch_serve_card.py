"""The serving entry point on the card.

``python -m repro_torch.launch.serve`` with no ``--device`` serves on the
GPU, and its DHash tables run the kernels with no variable set: the page
table is fused and the kernels' launch counters move.  Marked ``cuda``;
each test skips where there is no CUDA device.  Run on a GPU machine:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_serve_card.py

This file imports no JAX: the card's machine has none.
"""
from __future__ import annotations

import pytest

torch = pytest.importorskip("torch")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is "
                    "False)")


@pytest.mark.cuda
def test_launch_serve_runs_the_kernels_on_the_card(card, monkeypatch):
    from repro_torch.kernels import probe
    from repro_torch.launch import serve
    monkeypatch.delenv("DHASH_FUSED", raising=False)
    probe.reset_launches()
    eng = serve.main(["--requests", "4", "--max-new", "4"])
    counts = probe.launch_counts()
    assert eng.kv.table.fused
    assert eng.kv.free_stack.is_cuda
    assert sorted(len(v) for v in eng.finished.values()) == [4] * 4
    assert int(eng.kv.free_top) == eng.kv.n_pages
    for name in ("probe_lookup", "probe2", "probe_insert", "extract"):
        assert counts[name] > 0, (name, counts)


@pytest.mark.cuda
def test_prefix_cache_tables_run_the_kernels_on_the_card(card, monkeypatch):
    from repro_torch.serving import kvcache
    monkeypatch.delenv("DHASH_FUSED", raising=False)
    kv = kvcache.make(2, 16, 64, 2, 8, max_blocks=8, n_tenants=2,
                      prefix_cache=True, prefix_backend="chain",
                      device="cuda")
    assert [t.fused for t in (kv.table, kv.prefix.table, kv.prefix.rev)] \
        == [True] * 3
