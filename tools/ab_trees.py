"""The shared runner of the kernel-variant tools (tools/flash_bwd_ab.py,
tools/lm_head_fwd_ab.py): one measurement run in several copies of this
repository, in turns, on one CUDA card.

Each TREE is a copy of the repository (say, one under the gitignored
build/ with a csrc source edited); list a tree twice to run it twice (as
base, variant, variant, base).  Each run is a process of its own in that
tree, with the tree first on the import path (the trees' packages share a
name), and builds its kernels under TREE/build.  The lines it prints with
one of the tool's tags are printed again, prefixed with the run's index
and tree, after the card's name and power limit.  Compare versions only
inside one call: two calls may land on two cards.
"""
import os
import subprocess
import sys


def run(trees, code, tags, doc, timeout=900):
    """Runs `code` (python -c) in each of `trees`; 2 without trees, 1 if a
    run fails or times out, else 0."""
    if not trees:
        print(doc, file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(f"[ab] {smi.stdout.strip()}", flush=True)
    for i, tree in enumerate(map(os.path.abspath, trees)):
        try:
            res = subprocess.run([sys.executable, "-c", code], cwd=tree,
                                 capture_output=True, text=True,
                                 timeout=timeout,
                                 env=dict(os.environ, PYTHONPATH=tree))
        except subprocess.TimeoutExpired as e:
            print(f"[ab] run {i} ({tree}) timed out:\n{e.stdout}",
                  file=sys.stderr)
            return 1
        for line in res.stdout.splitlines():
            if line.startswith(tuple(tags)):
                print(f"[ab {i} {os.path.relpath(tree)}] {line}", flush=True)
        if res.returncode:
            print(res.stdout[-3000:], res.stderr[-3000:], file=sys.stderr)
            print(f"[ab] run {i} ({tree}) failed", file=sys.stderr)
            return 1
    return 0
