"""The port stands alone: it imports neither ``jax`` nor the reference
package (its CUDA sources include only CUDA and C++ headers and their own),
builds nothing when imported, refuses to carry on on the CPU when asked for
the GPU, and its GPU smoke script fails cleanly without a GPU."""
from __future__ import annotations

import ast
import os
import pathlib
import py_compile
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"
SMOKE = ROOT / "chip_smoke.py"
FORBIDDEN = {"jax", "jaxlib", "repro", "flax", "optax"}
MODULES = ["repro_torch", "repro_torch.convert",
           "repro_torch.configs.dhash_paper"] + [
    f"repro_torch.core.{m}" for m in
    ("struct_utils", "hashing", "buckets", "backend", "dhash", "engine",
     "policy", "distributed", "baselines")] + [
    f"repro_torch.kernels.{m}" for m in ("ref", "probe", "ops", "build")] + [
    "repro_torch.configs", "repro_torch.configs.base"] + [
    f"repro_torch.configs.{m}" for m in
    ("qwen3_8b", "deepseek_67b", "gemma2_2b", "gemma3_27b", "arctic_480b",
     "llama4_scout_17b", "qwen2_vl_2b", "zamba2_1p2b", "rwkv6_3b")] + [
    f"repro_torch.models.{m}" for m in
    ("layers", "attention", "moe", "ssm", "rwkv", "transformer",
     "model")] + [
    f"repro_torch.serving.{m}" for m in
    ("prefix_cache", "eviction", "kvcache", "engine")] + [
    "repro_torch.launch.serve", "repro_torch.train",
    "repro_torch.train.train_step", "repro_torch.data",
    "repro_torch.data.pipeline"]


def _sources():
    return sorted(PKG.rglob("*.py")) + [SMOKE]


CSRC = PKG / "kernels" / "csrc"
# what a kernel source may include: the CUDA runtime and cooperative groups,
# the C/C++ standard library, and its own headers
CUDA_HEADERS = {"cuda_runtime.h", "cooperative_groups.h", "stdint.h",
                "limits.h"}


def _imports(path: pathlib.Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_source_imports_neither_jax_nor_the_reference(path):
    bad = [m for m in _imports(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path} imports {bad}"


@pytest.mark.parametrize("path", sorted(CSRC.glob("*.cu*")),
                         ids=lambda p: p.name)
def test_kernel_source_includes_only_cuda_and_its_own_headers(path):
    import re
    incs = re.findall(r'^\s*#\s*include\s*[<"]([^>"]+)[>"]',
                      path.read_text(), re.M)
    own = {p.name for p in CSRC.glob("*.cuh")}
    bad = [h for h in incs if h not in CUDA_HEADERS | own]
    assert not bad, f"{path.name} includes {bad}"
    assert not re.search(r"\b(jax|repro|torch)\b", " ".join(incs))


def test_the_two_row_kernel_sources_exist_and_share_the_hazard_stage():
    for k in ("tc_lookup", "tc_insert", "tc_probe2"):
        src = (CSRC / f"{k}.cu").read_text()
        assert "__global__" in src and f'extern "C" int dhash_{k}(' in src, k
        assert "cudaGetLastError" in src and "DHASH_MAX_WIDTH" in src, k
    # probe2 and tc_probe2 both stage the hazard buffer as a hashed set
    # (dhash_common.cuh); neither stages it by itself, and the dense hazard
    # stage is gone
    for k in ("probe2", "tc_probe2"):
        src = (CSRC / f"{k}.cu").read_text()
        assert "dhash_set_stage(" in src and "dhash_set_find(" in src, k
        assert "dhash_hazard_find(" not in src, k
        assert "dhash_set_grid(" in src and "DHASH_SET_THREADS" in src, k
        assert "atomicMax" not in src and "atomicCAS" not in src, \
            f"{k} stages the hazard buffer itself"
    assert "dhash_hazard_stage" not in (CSRC / "dhash_common.cuh").read_text()
    # probe_insert resolves its claims without a grid barrier or claim words:
    # a read kernel and a write kernel, no cooperative launch
    src = (CSRC / "probe_insert.cu").read_text()
    for gone in ("grid.sync", "cudaLaunchCooperativeKernel",
                 "cooperative_groups", "remaining", "claim["):
        assert gone not in src, gone
    for kern in ("probe_insert_resolve<<<", "probe_insert_lockstep<<<",
                 "probe_insert_write<<<"):
        assert kern in src, kern
    from repro_torch.kernels import build, probe
    assert probe.KERNELS == tuple(build.KERNELS)
    assert set(build.SOURCES) == {s for s, _ in build.KERNELS.values()}


def test_the_nine_kernels_and_the_chain_sources():
    """The nine ported kernels and the three guarded ones (the cuckoo
    kick-out, the epoch swap, the chain compaction), one source each; the
    compaction takes its guard on the device and sorts no arena (a bucket's
    thread ranks its few tail nodes, the block of its tile the rest), scans
    the bucket totals over the grid (no one-block launch) and needs no
    memset; the chain kernels resolve every query in the kernel (tail set,
    segment scan, bounded walk); both stage their tail windows (and
    chain_probe2 the hazard buffer) as hashed sets, as tc_probe2 stages its
    hazard buffer, and the dense tail stage is gone."""
    from repro_torch.kernels import build, probe
    assert len(probe.KERNELS) == len(set(probe.KERNELS)) == 14
    assert probe.KERNELS == tuple(build.KERNELS)
    assert set(build._ENTRY.values()) == set(build._ARGTYPES)
    # the two walks of the comparison tables: one source, two entry points
    assert build.KERNELS["chain_walk"][0] == build.KERNELS["chain_tail"][0] \
        == "chain_walk"
    src = (CSRC / "chain_walk.cu").read_text()
    for entry in ('extern "C" int dhash_chain_walk(',
                  'extern "C" int dhash_chain_tail(', "dhash_chain_walk(a,"):
        assert entry in src, entry
    src = (CSRC / "chain_compact.cu").read_text()
    assert 'extern "C" int dhash_chain_compact(' in src
    assert src.count("if (!ctl[CC_GO]) return;") == 2
    assert "if (!run) return;" in src and "dirty > dirty_cap" in src
    assert "Sort" not in src and "<<<1," not in src
    assert "cudaMemset" not in src and "dhash_block_rank(" in src
    for k in ("chain_probe", "chain_probe2"):
        src = (CSRC / f"{k}.cu").read_text()
        assert "__global__" in src and f'extern "C" int dhash_{k}(' in src, k
        assert "cudaGetLastError" in src and "DHASH_MAX_DIRTY" in src, k
        for fn in ("dhash_chain_fast(", "dhash_chain_walk("):
            assert fn in src, (k, fn)
        assert "atomicMax" not in src and "atomicCAS" not in src, \
            f"{k} stages its buffers itself"
    # chain_probe finds a tail key through dhash_chain_fast, whose tail is
    # the staged set (dhash_tail_find -> dhash_set_find)
    src = (CSRC / "chain_probe.cu").read_text()
    for fn in ("dhash_tail_set_fill(", "dhash_set_index(", "dhash_set_grid(",
               "dhash_set_first(", "DHASH_SET_THREADS"):
        assert fn in src, fn
    src = (CSRC / "chain_probe2.cu").read_text()
    for fn in ("dhash_set_fill(", "dhash_tail_set_fill(", "dhash_set_index(",
               "dhash_set_find(", "dhash_set_grid("):
        assert fn in src, fn
    for k in ("chain_probe", "chain_probe2"):
        src = (CSRC / f"{k}.cu").read_text()
        for fn in ("dhash_hazard_stage(", "dhash_hazard_find(",
                   "dhash_tail_stage(", "dhash_stage_words("):
            assert fn not in src, (k, fn)
    # the staged set carries word offsets into one shared array, not
    # pointers (nvcc lost the shared state space of pointers kept in a
    # returned struct); the dense stage is gone
    common = (CSRC / "dhash_common.cuh").read_text()
    assert "extern __shared__ __align__(16) int dhash_smem[];" in common
    for fn in ("dhash_set_stage(", "DHASH_SET_RUN", "dhash_set_find(",
               "const DhashSetTail& t, int b,"):
        assert fn in common, fn
    for fn in ("dhash_stage(", "dhash_hazard_find(", "dhash_tail_stage(",
               "struct DhashTail ", "template <class Tail>"):
        assert fn not in common, fn


def test_chain_compact_scratch_is_the_layout_the_kernel_states():
    """The wrapper allocates the scratch the kernel source lays out: the
    formula of ``probe.compact_scratch_words`` and the one stated at the
    entry of ``chain_compact.cu`` agree, for arenas from one node to a
    full one, bucket counts on and off a tile's edge (a short scratch let
    the last word of a full arena's compaction land past it)."""
    import re
    from repro_torch.kernels import probe
    src = (CSRC / "chain_compact.cu").read_text()
    m = re.search(r"// scratch: (.+?) int32 words", src, re.S)
    assert m, "chain_compact.cu states no scratch layout"
    cu = " ".join(m.group(1).replace("//", " ").split()).replace("/", "//")
    assert re.fullmatch(r"[\d\s()+*/nb]+", cu), cu
    assert "#define CC_THREADS 256" in src
    fn = next(f for f in ast.walk(ast.parse(
        (PKG / "kernels" / "probe.py").read_text()))
        if isinstance(f, ast.FunctionDef) and f.name == "compact_scratch_words")
    py = ast.unparse(fn.body[-1].value)
    for n, nb in ((1, 1), (512, 32), (1 << 20, 1 << 16), (1000, 255),
                  (1000, 256), (1000, 257), (4 << 20, 3 * (1 << 16) + 1)):
        want = eval(cu, {"n": n, "nb": nb})
        assert eval(py, {"n": n, "nbuckets": nb}) == want, (n, nb)
        assert probe.compact_scratch_words(n, nb) == want, (n, nb)


def test_tc_insert_scratch_is_the_layout_the_kernel_states():
    """The cuckoo kick-out's scratch (its queries and three plan words a
    query) is carved from the one scratch ``tc_insert`` takes: the formula of
    ``probe.tc_scratch_words`` and the one stated in ``tc_insert.cu``
    agree, the C entry carves the regions that layout names, and the
    wrapper allocates the scratch from that function alone."""
    import re
    from repro_torch.kernels import probe
    src = (CSRC / "tc_insert.cu").read_text()
    m = re.search(r"// scratch: (.+?) int32 words", src, re.S)
    assert m, "tc_insert.cu states no scratch layout"
    cu = " ".join(m.group(1).replace("//", " ").split())
    assert re.fullmatch(r"[\d\s()+*<>Qmax_kick]+", cu), cu
    for carve in ("int* slot = scratch;", "int* list = scratch + Q;",
                  "int* count = scratch + 2 * (long long)Q;",
                  "int* work = max_kick > 0 ? count + 2 : nullptr;",
                  "int* plan = max_kick > 0 ? work + Q : nullptr;"):
        assert carve in src, carve
    fn = next(f for f in ast.walk(ast.parse(
        (PKG / "kernels" / "probe.py").read_text()))
        if isinstance(f, ast.FunctionDef) and f.name == "tc_scratch_words")
    py = ast.unparse(fn.body[-1].value)
    for q in (1, 33, 4096, 8192, 8197, 1 << 20):
        for k in (0, 1, 32):
            want = eval(cu, {"Q": q, "max_kick": k})
            assert eval(py, {"q": q, "max_kick": k}) == want, (q, k)
            assert probe.tc_scratch_words(q, k) == want, (q, k)
    launch = ast.unparse(next(
        f for f in ast.parse((PKG / "kernels" / "probe.py").read_text()).body
        if isinstance(f, ast.FunctionDef) and f.name == "_tc_launch"))
    assert "torch.empty(tc_scratch_words(q, max_kick)" in launch
    assert launch.count("torch.empty(") == 3      # ok, present, scratch


def test_no_wrapper_falls_back_to_its_plain_version_on_cuda_tensors():
    """Every kernel wrapper of ``probe.py`` (each function with a ``_plain``
    sibling) calls that plain version once, as the whole body of an ``if``
    on the device type being ``"cpu"``, catches nothing, and calls no other
    plain version; on tensors of another device (``meta`` here, as CUDA
    tensors there) the new wrappers raise before any plain version runs."""
    from repro_torch.core import hashing
    from repro_torch.kernels import probe
    tree = ast.parse((PKG / "kernels" / "probe.py").read_text())
    defs = {f.name: f for f in tree.body if isinstance(f, ast.FunctionDef)}
    wrappers = [n for n in defs if f"{n}_plain" in defs]
    assert set(probe.KERNELS) | {"probe_lookup_hashed", "cuckoo_insert",
                                 "transition"} <= set(wrappers)
    for name in wrappers:
        f = defs[name]
        assert not any(isinstance(n, ast.Try) for n in ast.walk(f)), name
        calls = [n for n in ast.walk(f) if isinstance(n, ast.Call)
                 and isinstance(n.func, ast.Name)
                 and n.func.id.endswith("_plain")]
        assert [c.func.id for c in calls] == [f"{name}_plain"], name
        guard = next(n for n in ast.walk(f) if isinstance(n, ast.If)
                     and any(c is calls[0] for c in ast.walk(n)))
        test = guard.test
        assert isinstance(test, ast.Compare) and isinstance(
            test.ops[0], ast.Eq), name
        assert isinstance(test.left, ast.Attribute) and \
            test.left.attr == "type", name
        assert ast.literal_eval(test.comparators[0]) == "cpu", name
        assert len(guard.body) == 1 and isinstance(guard.body[0], ast.Return) \
            and guard.body[0].value is calls[0] and not guard.orelse, name
    assert not any(isinstance(n, ast.Try) for n in ast.walk(defs["_launch"]))

    def refuse(*a, **k):
        raise AssertionError("a plain version ran for non-CPU tensors")
    m = lambda n, dt=torch.int32: torch.zeros(n, dtype=dt, device="meta")
    hfn = hashing.HashFn(kind="mix32", seeds=m(2, torch.int64))
    tab = [torch.zeros((8, 4), dtype=torch.int32, device="meta")
           for _ in range(3)]
    saved = {n: getattr(probe, n) for n in ("probe_lookup_hashed_plain",
                                            "cuckoo_insert_plain",
                                            "probe_lookup_plain",
                                            "tc_insert_plain",
                                            "cuckoo_kick_plain")}
    try:
        for n in saved:
            setattr(probe, n, refuse)
        with pytest.raises(ValueError):
            probe.probe_lookup_hashed(m(8), m(8), m(8), hfn, m(4), 4)
        with pytest.raises(ValueError):
            probe.cuckoo_insert(*tab, m(4), m(4), hfn, hfn, 4, m(4), m(4),
                                m(4, torch.bool), 8, m(8))
    finally:
        for n, f in saved.items():
            setattr(probe, n, f)
    assert probe.launch_counts() == dict.fromkeys(probe.KERNELS, 0)


def test_tc_insert_has_no_grid_barrier_and_no_kick_out_read_is_left():
    """tc_insert resolves its rounds without a cooperative launch or a
    grid-wide barrier (a bid and a resolve launch, then one block); the
    cuckoo kick-out runs in that block (a compile-time option of the
    resolve) and in a guarded kernel of its own, one body (any block size)
    shared by both, and the host reads that gated it
    (``kick_gate``, ``kick_pending``, the staged ``_kick_out``) are gone;
    extract and the epoch swap take their device flags: the rebuild step's
    decision is made in the transition kernel (extract.cu: the landing's
    ok / present in, go out), the exchange reads that go (no cooperative
    launch), and ``dhash.rebuild_step_`` issues no reduction or bitwise op
    on the hazard flags of its own."""
    from repro_torch.core import backend
    from repro_torch.kernels import probe
    src = (CSRC / "tc_insert.cu").read_text()
    for gone in ("cudaLaunchCooperativeKernel", "grid.sync",
                 "cooperative_groups", "this_grid"):
        assert gone not in src, gone
    for kern in ("tc_insert_bid<", "tc_insert_resolve<", "tc_rounds<"):
        assert kern in src, kern
    for name in ("kick_gate", "kick_pending", "kick_counts"):
        assert not hasattr(probe, name), name
    for name in ("KICK_STAGES", "_kick_out"):
        assert not hasattr(backend, name), name
    py = (PKG / "core" / "backend.py").read_text()
    assert "kick_gate" not in py and "kick_pending" not in py
    # the kick-out's body (its barriers, the victims' hashes) is shared by
    # the standalone kernel and tc_insert's resolve
    kick = (CSRC / "cuckoo_kick.cu").read_text()
    assert "__syncthreads()" in kick and "dhash_kick_rounds<" in kick
    assert "dhash_kick_rounds<" in src and "template <bool VEC, bool KICK>" \
        in src
    body = (CSRC / "dhash_common.cuh").read_text()
    body = body[body.index("void dhash_kick_plan("):]
    assert "__syncthreads_or(" in body and "dhash_bucket_of(" in body
    assert "blockDim.x" in body and "KICK_THREADS" not in body
    assert 'extern "C" int dhash_cuckoo_kick(' in kick
    swap = (CSRC / "epoch_swap.cu").read_text()
    assert 'extern "C" int dhash_epoch_swap(' in swap
    assert "cudaLaunchCooperativeKernel" not in swap
    assert "const uint8_t* __restrict__ go" in swap
    ext = (CSRC / "extract.cu").read_text()
    assert "const uint8_t* run, const uint8_t* hold" in ext
    for got in ("const uint8_t* __restrict__ ok", "__syncthreads_or(",
                "go[0] = swap", "go[1] = start"):
        assert got in ext, got
    import inspect

    from repro_torch.core import dhash
    fn = ast.parse(inspect.getsource(dhash.rebuild_step_)).body[0]
    step = "\n".join(ast.unparse(x) for x in fn.body[1:])  # no docstring
    assert ".any()" not in step and "hazard_live &" not in step
    assert "transition_fused(" in step


def test_the_eleven_modules_and_four_kernel_sources_exist():
    for m in MODULES:
        rel = m.replace(".", "/")
        assert (ROOT / "src" / f"{rel}.py").is_file() or \
            (ROOT / "src" / rel / "__init__.py").is_file(), m
    for k in ("probe_lookup", "probe2", "probe_insert", "extract"):
        src = (PKG / "kernels" / "csrc" / f"{k}.cu").read_text()
        assert "__global__" in src and 'extern "C"' in src, k
        assert "cudaGetLastError" in src, k


def _run(code: str, **env):
    e = {**os.environ, "PYTHONPATH": str(ROOT / "src"), **env}
    return subprocess.run([sys.executable, "-c", code], env=e, cwd=ROOT,
                          capture_output=True, text=True, timeout=300)


def test_import_leaves_jax_out_and_builds_nothing(tmp_path):
    code = (
        "import sys, importlib\n"
        f"mods = {MODULES!r}\n"
        "for m in mods: importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        f"{sorted(FORBIDDEN)!r}]\n"
        "assert not bad, bad\n"
        "from repro_torch.kernels import build\n"
        "assert build._LIB is None and build.build_seconds is None\n"
        "print('clean')\n")
    r = _run(code, REPRO_TORCH_BUILD_DIR=str(tmp_path / "kbuild"))
    assert r.returncode == 0 and "clean" in r.stdout, r.stderr
    assert not (tmp_path / "kbuild").exists(), "import built something"


def test_asking_for_the_gpu_without_one_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU")
    from repro_torch.core import dhash, hashing
    with pytest.raises((RuntimeError, AssertionError)):
        dhash.make("linear", capacity=16, chunk=4)          # device="cuda"
    with pytest.raises((RuntimeError, AssertionError)):
        hashing.fresh("mix32", 0)                           # device="cuda"
    from repro_torch import convert
    tree = convert.state_to_numpy(dhash.make("linear", capacity=16, chunk=4,
                                             device="cpu"))
    with pytest.raises((RuntimeError, AssertionError)):
        convert.state_from_numpy(tree)                      # device="cuda"


def test_kernel_build_needs_nvcc_and_says_so(tmp_path, monkeypatch):
    from repro_torch.kernels import build
    if build._LIB is not None:
        pytest.skip("kernels already built in this process")
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setenv("REPRO_TORCH_BUILD_DIR", str(tmp_path / "b"))
    if pathlib.Path("/usr/local/cuda/bin/nvcc").is_file():
        pytest.skip("this machine has the CUDA toolkit")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.load()
    assert len(build.source_hash()) == 16


def test_chip_smoke_compiles_and_fails_without_a_gpu(tmp_path):
    py_compile.compile(str(SMOKE), cfile=str(tmp_path / "s.pyc"), doraise=True)
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU")
    r = subprocess.run([sys.executable, str(SMOKE)], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout and "kernels" not in r.stdout
