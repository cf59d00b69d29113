"""Build and load the CUDA kernels (``csrc/*.cu``) at first use.

Each source is compiled by its own ``nvcc`` process — all started together —
for ``sm_90a`` into a shared library with a plain C interface, and loaded
with ``ctypes``.  Libraries are cached in a build directory (``build/`` at
the root of the checkout unless ``REPRO_TORCH_BUILD_DIR`` names another) under
a name that carries a hash of ALL sources, so an edit rebuilds.  Nothing here
runs when the module is imported; a machine without ``nvcc`` can import it and
gets a ``RuntimeError`` only when a kernel is actually needed.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("probe_lookup", "probe2", "probe_insert", "extract", "tc_lookup",
           "tc_insert", "tc_probe2", "chain_probe", "chain_probe2",
           "cuckoo_kick", "epoch_swap", "chain_compact")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# argument types of each C entry point (pointers and the stream as void*)
_ARGTYPES = {
    "dhash_probe_lookup": [_P, _P, _P, _I, _P, _P, _I, _P, _I, _I, _P, _P, _P,
                           _P],
    "dhash_probe2": [_P, _P, _P, _I, _P, _P, _P, _I, _P, _P, _P, _I,
                     _P, _P, _P, _I, _I, _P, _P, _P, _P, _P, _P, _I, _P, _P],
    "dhash_probe_insert": [_P, _P, _P, _I, _P, _P, _P, _P, _I, _I,
                           _P, _P, _P, _I, _P, _P, _P, _P, _P],
    "dhash_extract": [_P, _P, _P, _I, _P, _I] + [_P] * 9 + [_I, _I, _I, _P],
    "dhash_tc_lookup": [_P, _P, _P, _I, _P, _P, _P, _I, _P, _I, _I, _I, _P,
                        _I, _P, _P, _P, _P],
    "dhash_tc_insert": [_P, _P, _P, _P, _I, _P, _P, _P, _P, _P, _I, _I,
                        _P, _P, _P, _I, _I, _P, _I, _P, _I, _P, _I, _I, _I,
                        _P, _P, _P, _P, _P],
    "dhash_tc_probe2": [_P, _P, _P, _P, _P, _P, _I, _P, _P, _P, _I,
                        _P, _P, _P, _P, _P, _I, _P, _P, _P, _P, _P, _P, _I,
                        _P, _I, _I, _P],
    "dhash_chain_probe": [_P] * 5 + [_I] + [_P] * 6 + [_I] * 3 + [_P] * 4,
    "dhash_chain_probe2": ([_P] * 5 + [_I] + [_P] * 4) * 2 + [_P] * 3 + [_I]
    + [_P] * 3 + [_I] * 4 + [_P] * 7,
    "dhash_cuckoo_kick": [_P] * 3 + [_I] * 2 + [_P] * 7 + [_I] * 2
    + [_P, _I, _P, _I] + [_P] * 5,
    "dhash_epoch_swap": [_P, _I, _P, _I] + [_P] * 5 + [_L, _I, _I, _P, _I,
                                                      _P],
    "dhash_chain_compact": [_P] * 10 + [_I] * 3 + [_P, _P, _I, _P, _P],
}
_ENTRY = {s: f"dhash_{s}" for s in SOURCES}

_LIB: dict | None = None
build_seconds: float | None = None    # wall time of the last build (0 = cached)
build_log: str = ""                   # what nvcc printed (ptxas resource usage)


def build_dir() -> Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    return Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def find_nvcc() -> str:
    cands = [shutil.which("nvcc")]
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if root:
            cands.append(str(Path(root) / "bin" / "nvcc"))
    for c in cands:
        if c and Path(c).is_file():
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels of repro_torch are "
                       "built at first use and need the CUDA toolkit")


def _compile_missing(out: Path, tag: str) -> None:
    """One nvcc per missing library, all started together."""
    global build_seconds, build_log
    todo = [s for s in SOURCES if not (out / f"{s}-{tag}.so").is_file()]
    if not todo:
        build_seconds = 0.0
        return
    nvcc = find_nvcc()
    out.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = []
    for s in todo:
        tmp = out / f"{s}-{tag}.{os.getpid()}.tmp.so"
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / f"{s}.cu")]
        procs.append((s, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    logs, failed = [], []
    for s, tmp, p in procs:
        text, _ = p.communicate()
        logs.append(f"== {s}.cu ==\n{text}")
        if p.returncode != 0:
            failed.append(s)
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out / f"{s}-{tag}.so")
    build_log = "\n".join(logs)
    build_seconds = time.perf_counter() - t0
    if failed:
        raise RuntimeError(f"nvcc failed for {failed}:\n{build_log}")


def load() -> dict:
    """The C entry points by kernel name, building what is missing."""
    global _LIB
    if _LIB is None:
        out, tag = build_dir(), source_hash()
        _compile_missing(out, tag)
        lib = {}
        for s in SOURCES:
            fn = getattr(ctypes.CDLL(str(out / f"{s}-{tag}.so")), _ENTRY[s])
            fn.argtypes = _ARGTYPES[_ENTRY[s]]
            fn.restype = ctypes.c_int
            lib[s] = fn
        _LIB = lib
    return _LIB
