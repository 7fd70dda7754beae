"""Build the conv and probe kernels and run ``chip_smoke.py``'s phases 1c
(the 3x3 conv against its plain version and cuDNN) and 1d (``mm_fwd``
against its plain version and cuBLAS, ``scale2`` against x * 2) alone on
one CUDA card: the short command for work on ``csrc/conv3x3.cu`` and
``csrc/probes.cu``.

    python3 tools/chip_kernels.py [--probes]

``--probes`` builds and runs the probes alone (phase 1d).  Prints the
card, the compiler's report per instantiation (registers, spills; a spill
fails the run), each phase's readings and times, and their results as one
JSON line; exits non-zero if a check fails.
"""

import argparse
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import torch  # noqa: E402

import chip_smoke as C  # noqa: E402

SOURCES = ("conv3x3", "probes")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--probes", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("chip_kernels: no CUDA device")
    from ugaitnet_tpu_torch.ops.cuda import build
    t0 = time.perf_counter()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sources = ("probes",) if args.probes else SOURCES
    with ThreadPoolExecutor(len(sources)) as pool:
        list(pool.map(build.build, sources))
    print(f"build ({', '.join(sources)}, in parallel): "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    res = {"card": card, "ptxas": C.ptxas_report(build.BUILD_DIR, sources)}
    if not args.probes:
        res["conv3x3"] = C.conv_phase(card)
    res["probes"] = C.probe_phase(card)
    print(json.dumps(res))
    print(f"total {time.perf_counter() - t0:.1f} s")


if __name__ == "__main__":
    main()
