"""Which kernel records torch.profiler keeps, and whether idle host time
at the ends of the recorded cycle keeps them all.

chip_smoke.py's ``profiled`` traces a call in a two-cycle schedule (a
warm-up cycle, then the recorded one).  This script traces, in one
process, a short call (42 launches on a 4-MiB vector) and a long one
(20,000 launches on 4 KiB) in the same schedule: fresh, after 45 s idle,
after 45 s of untraced launches, after eight long traces, and then in
four rounds with 0, 0.02 and 0.2 s of idle host time before and after
the call inside the recorded cycle.  Each line prints how many traces
recorded no kernel, the kernel records each kept, and, for the traces
that also record the host, the first kernel's start and the last
kernel's end less the first and last launch call's, in microseconds
(tens of µs when the device and host clocks agree).

Run from the repository root on a machine with an H100:

    python tools/tracer_probe.py

It is a measurement tool, not part of the package: nothing imports it.
"""
from __future__ import annotations

import time

import torch
from torch.profiler import ProfilerActivity, profile, schedule

CUDA = torch.autograd.DeviceType.CUDA
LAUNCHES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
            "cuLaunchKernelEx")


def trace(fn, pad=0.0, cpu=False):
    """(kernel records kept, (start, end) offsets in µs or None)."""
    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if cpu else [])
    torch.cuda.synchronize()
    with profile(activities=acts, schedule=schedule(
            wait=0, warmup=1, active=1, repeat=1)) as prof:
        fn()
        torch.cuda.synchronize()
        prof.step()
        time.sleep(pad)
        fn()
        torch.cuda.synchronize()
        time.sleep(pad)
        prof.step()
    events = prof.events()
    kernels = [e for e in events if e.device_type == CUDA]
    launches = [e for e in events if e.name in LAUNCHES]
    off = None
    if kernels and launches:
        off = (min(e.time_range.start for e in kernels)
               - min(e.time_range.start for e in launches),
               max(e.time_range.end for e in kernels)
               - max(e.time_range.end for e in launches))
    return len(kernels), off


def main():
    t_start = time.perf_counter()
    x = torch.randn(1 << 20, device="cuda")

    def short():
        y = x
        for _ in range(20):
            y = y * 1.0001 + 0.5
        return y.sum()

    def long():
        y = x[:1024]
        for _ in range(10000):
            y = y * 1.0001 + 0.5
        return y

    def batch(tag, fn, n, pad=0.0, cpu=False):
        res = [trace(fn, pad, cpu) for _ in range(n)]
        print(f"[probe t={time.perf_counter() - t_start:.0f}s] {tag} "
              f"pad={pad} cpu={cpu}: lost {sum(r[0] == 0 for r in res)} of "
              f"{n}; kernels {[r[0] for r in res]}; offsets(us) "
              f"{[r[1] for r in res if r[1]][:4]}", flush=True)

    batch("fresh short", short, 6)
    batch("fresh short", short, 3, cpu=True)
    time.sleep(45)
    batch("after 45s idle", short, 6)
    batch("after 45s idle", short, 3, cpu=True)
    t = time.perf_counter()
    while time.perf_counter() - t < 45:
        long()
        torch.cuda.synchronize()
    batch("after 45s untraced work", short, 6)
    batch("after 45s untraced work", short, 3, cpu=True)
    for i in range(8):
        print(f"[probe t={time.perf_counter() - t_start:.0f}s] long trace "
              f"{i}: {trace(long)[0]} kernel records", flush=True)
    for r in range(4):
        for pad in (0.0, 0.02, 0.2):
            batch(f"round {r}", short, 4, pad=pad)
        batch(f"round {r}", short, 2, pad=0.0, cpu=True)
        batch(f"round {r}", short, 2, pad=0.2, cpu=True)
        print(f"long {trace(long)[0]}", flush=True)
        print(f"long padded {trace(long, pad=0.2)[0]}", flush=True)


if __name__ == "__main__":
    main()
