"""Run ``chip_smoke.py``'s phase 14 alone on one CUDA card: the port's
convergence run (``ugaitnet_tpu_torch/eval/synthetic_rank1.py``) at 64
identities, the tiny twin and the flagship at full width, the bf16
re-encode, with phase 14's launch counts, kernel comparisons and limits.

    python3 tools/chip_phase14.py

Builds the three kernels the phase runs (in parallel), exits non-zero if a
check fails, writes each run's results under ``chiprun_out/phase14/`` and
prints the phase's results as one JSON line before the total time.
"""

import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import torch  # noqa: E402

import chip_smoke as C  # noqa: E402


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_phase14: no CUDA device")
    from ugaitnet_tpu_torch.ops.cuda import build
    t0 = time.perf_counter()
    sources = ("triplet_kernel", "stage_tail", "conv3x3")
    with ThreadPoolExecutor(len(sources)) as pool:
        list(pool.map(build.build, sources))
    for name in sources:
        build.load(name)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}; kernel build {time.perf_counter() - t0:.1f} s",
          flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    work = tempfile.mkdtemp(prefix="chip_phase14_")
    try:
        out = C.convergence_phase(card, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(json.dumps(out, default=str))
    print(f"total {time.perf_counter() - t0:.1f} s")


if __name__ == "__main__":
    main()
