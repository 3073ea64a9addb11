#!/usr/bin/env python3
"""Kernel timings of two trees of this repository on one CUDA card, in turns.

    python ab_timings.py OTHER_TREE

Runs chip_smoke.py's build and timing phases (phase_build, phase_timings,
phase_timings_fused, and phase_timings_amp and phase_timings_fused_amp
where the tree has them) of OTHER_TREE (say, a `git archive` of the parent
commit unpacked into a gitignored directory) and of the tree this script
lies in, each run in a process of its own (the two trees' packages share a
name), in the order other, this, this, other.  Prints nvidia-smi's name and
power limit and every run's "[time..." lines tagged with the run, and exits
non-zero if a run fails.  Versions are compared only inside one such call:
two calls may land on two cards.
"""
import os
import subprocess
import sys

CODE = """
import torch, chip_smoke as c
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
c.phase_build(torch)
c.phase_timings(torch)
c.phase_timings_fused(torch)
torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
for name in ("phase_timings_amp", "phase_timings_fused_amp"):
    if hasattr(c, name):
        getattr(c, name)(torch)
"""


def main(argv):
    if len(argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    other = os.path.abspath(argv[1])
    this = os.path.dirname(os.path.abspath(__file__))
    for tree in (other, this):
        if not os.path.exists(os.path.join(tree, "chip_smoke.py")):
            print(f"ab_timings: no chip_smoke.py in {tree}", file=sys.stderr)
            return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(f"[ab] {smi.stdout.strip()}", flush=True)
    for i, (tag, tree) in enumerate((("other", other), ("this", this),
                                     ("this", this), ("other", other))):
        res = subprocess.run([sys.executable, "-c", CODE], cwd=tree,
                             capture_output=True, text=True)
        if res.returncode:
            print(res.stdout[-4000:], res.stderr[-4000:], file=sys.stderr)
            print(f"[ab] run {i} ({tag}, {tree}) failed", file=sys.stderr)
            return 1
        for line in res.stdout.splitlines():
            if line.startswith("[time"):
                print(f"[ab {i} {tag}] {line}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
