"""Phase 4 of ``chip_smoke.py`` over many batches: how often the card and
the CPU take different sign_max picks on the flagship's forward, and what
each output reads with and without the CPU's picks.

Trains phase 3's seven Adam steps twice from the seed-0 flagship on one CUDA
card (deterministic cuDNN off, as phase 3 runs), reports how far the two
trained states lie apart, then runs phase 4's card vs CPU forward
(``chip_smoke.forward_readings``) on the first state for raw batches from
seeds 4 .. 4 + N - 1.

    python3 tools/chip_sign_max_ties.py [N]

Prints one JSON line per seed, then a summary line; exits non-zero if a
seed breaks ``chip_smoke.sign_max_rule`` with TF32 off.
"""

import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import torch  # noqa: E402

import chip_smoke as C  # noqa: E402


def train(mcfg, tcfg, mods, dcfg, nsteps=7):
    """Phase 3's steps: raw B = 40 (8 ids x 5), augmenting preprocess with
    expand 3, Adam from the seed-0 flagship."""
    from ugaitnet_tpu_torch.data.pipeline import preprocess_batch
    from ugaitnet_tpu_torch.models.network import UGaitNet
    from ugaitnet_tpu_torch.train.train_step import (Batch, init_state,
                                                     make_train_step)
    state = init_state(UGaitNet(mcfg, seed=0), tcfg)
    step = make_train_step(mcfg, tcfg)
    raw = C.raw_batch(40, 8, seed=2)
    mask_gen = torch.Generator().manual_seed(0)
    for i in range(nsteps):
        r = C.perturbed(raw, i)
        vols, flags, labels = preprocess_batch(r, *mods, 3, True, dcfg,
                                               generator=mask_gen)
        state, _ = step(state, Batch(tuple(vols), tuple(flags), labels))
    torch.cuda.synchronize()
    return state.model


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_sign_max_ties: no CUDA device")
    from ugaitnet_tpu_torch.core.config import DataConfig, TrainConfig
    from ugaitnet_tpu_torch.ops.cuda import build
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 20
    t0 = time.perf_counter()
    build.load("triplet_kernel")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dcfg = DataConfig()
    mods = C.PREPROCESS
    mcfg, tcfg = C.flagship_cfg(), TrainConfig()
    model = train(mcfg, tcfg, mods, dcfg)
    again = train(mcfg, tcfg, mods, dcfg).state_dict()
    apart = {k: float((v - again[k]).abs().max())
             for k, v in model.state_dict().items() if v.is_floating_point()}
    worst = max(apart, key=apart.get)
    print(f"two runs of phase 3's steps: {sum(v > 0 for v in apart.values())}"
          f" of {len(apart)} tensors differ, the most {apart[worst]:.3e} at "
          f"{worst}", flush=True)
    del again
    model.eval()
    broken = old_fail = tf32_held = near = 0
    for seed in range(4, 4 + n):
        res = C.forward_readings(model, mods, dcfg, seed=seed)
        off = res[False]
        row = {"seed": seed, **{f"tf32_{t}": {
            "branches": r["branches"], "switched": r["switched"],
            "near": r["near"], "tie": r["tie"], "raw": r["raw"],
            "forced": r["forced"]}
            for t, r in (("off", off), ("on", res[True]))}}
        print(json.dumps(row), flush=True)
        broken += not all(C.passes(off, k) for k in off["raw"])
        old_fail += any(v > C.CPU_REL for v in off["raw"].values())
        tf32_held += any(C.passes(res[True], k) for k in off["raw"])
        near += off["near"]
    print(f"{n} batches: raw reading over {C.CPU_REL} (the old check) "
          f"{old_fail}; sign_max_rule broken {broken}; TF32 passing the "
          f"rule {tf32_held}; picks within twice the merge inputs' error "
          f"of a tie, TF32 off, {near} in all; "
          f"{time.perf_counter() - t0:.1f} s [{card}]")
    sys.exit(1 if broken else 0)


if __name__ == "__main__":
    main()
