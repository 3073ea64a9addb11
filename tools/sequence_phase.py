"""chip_smoke.py's phase 5o alone on one card: the CTC acoustic model's
card-vs-CPU step with its TF32 control and its training row, the sweep
of the sequence, LoD-array, CTC and sampling planes' ops, and the CTC
step's trace (trace_ctc), under the smoke's settings (TF32 off, the
Executor's gate in error mode).  About 75 s of command time, against the
whole smoke's ten minutes or more: the quick loop while working on
these planes.

Run from the repository root on a machine with an H100:

    python tools/sequence_phase.py

It is a measurement tool, not part of the package: nothing imports it.
"""
import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke as cs  # noqa: E402
import paddle_tpu_torch as ptt  # noqa: E402


def main():
    if not torch.cuda.is_available():
        print("sequence_phase: no CUDA device is visible", file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    cs.torch_settings(torch)
    cs.log(f"[device] {cs.nvidia_smi_line()}; torch {torch.__version__} "
           f"CUDA {torch.version.cuda}")
    ptt.flags.set_flag("verify_program", "error")
    cs.record_verifications()
    cs.VERIFY_PHASE[0] = "sequence"
    counts, row = cs.phase_sequence(torch)
    cs.log(f"[sequence] this repo's kernels by path "
           f"{ {k: sum(v.values()) for k, v in counts.items()} }")
    cs.trace_ctc(torch, row)
    cs.log(f"[sequence] done in {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
