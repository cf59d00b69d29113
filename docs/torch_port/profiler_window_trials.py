"""Where in its window does torch.profiler lose the kernels of a replayed
engine step?  Runs ``chip_smoke.phase_graph`` for each backend named (chain
by default) and, where it checks the credited launches against the
profiler, first traces the replayed steps ``T`` times with the window
unpadded and ``T`` times with a ~20 ms spin kernel at each end, in turns.
Each trace's port kernels, in device-time order, are held against the
pattern of one replay; the inexact ones are printed with what they lost.

    python3 docs/torch_port/profiler_window_trials.py [T] [backend ...]

Needs one CUDA card; builds the port's kernels first."""
import dataclasses
import os
import re
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

T = int(sys.argv[1]) if len(sys.argv) > 1 else 50


def trace(run, pad):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule
    sched = schedule(wait=1, warmup=1, active=1, repeat=1)
    with profile(activities=[ProfilerActivity.CUDA], schedule=sched) as prof:
        for _ in range(2):
            run()
            torch.cuda.synchronize()
            prof.step()
        if pad:
            torch.cuda._sleep(int(4e7))
        run()
        if pad:
            torch.cuda._sleep(int(4e7))
        torch.cuda.synchronize()
        prof.step()
    sources = cs.port_kernel_sources()
    ev = []
    for e in prof.events():
        m = re.match(r"(?:void )?(\w+)", e.name)
        if e.device_type == DeviceType.CUDA and m and m.group(1) in sources:
            ev.append((e.time_range.start, sources[m.group(1)]))
    return [k for _, k in sorted(ev)]


def wrapper(run, n, where):
    seqs = {False: [], True: []}
    for i in range(T):
        for pad in (False, True):
            seqs[pad].append(trace(run, pad))
    full = max(len(s) for s in seqs[False] + seqs[True])
    per = full // n
    for pad in (False, True):
        pat = next(s for s in seqs[pad] if len(s) == full)[:per]
        bad = []
        for i, s in enumerate(seqs[pad]):
            if s != pat * n:
                lost = full - len(s)
                head = s[:per] == pat
                tail = s[-per:] == pat
                bad.append(f"trial {i}: {lost} lost, first replay whole "
                           f"{head}, last whole {tail}, first kernels "
                           f"{s[:3]} (pattern {pat[:3]})")
        cs.log(f"  pad={pad}: {len(bad)} of {T} trials inexact")
        for b in bad:
            cs.log("   ", b)
    return orig(run, n, where)


orig = cs.credited_against_profiler
cs.credited_against_profiler = wrapper
from repro_torch.configs.dhash_paper import CONFIG  # noqa: E402
from repro_torch.kernels import build  # noqa: E402

cs.log(cs.card_line(), torch.__version__, torch.version.cuda)
build.load()
for name in sys.argv[2:] or ["chain"]:
    cs.log(f"== {name}")
    cs.phase_graph(torch.device("cuda", 0),
                   dataclasses.replace(CONFIG, backend=name))
