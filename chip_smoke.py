"""Drive the PyTorch port's main path on one CUDA card and hold its kernels
against their plain PyTorch versions.

    python3 chip_smoke.py

Run from the repository root; it needs one CUDA card and nvcc, and exits
non-zero without them.  It builds the kernels of ``ugaitnet_tpu_torch/csrc``
and runs, at the full width of the flagship (two GaitSet branches at
channels (32, 64, 128), part_dim 256, 62 parts, sign_max merge, 74 classes):

  1. kernels vs plain: the CUDA batch-all triplet forward and backward
     against ``ops/triplet.py`` on the same CUDA tensors, at the flagship
     (62, 120, 256), small, ragged (D not a multiple of the kernels'
     chunks, B not of 4) and degenerate cases, B = 256 and B = 512, and
     phase 7's two validation batches (62, 40, 256) with their labels
     (the second wrapped to full size, no P x K pattern); and
     the kernels against themselves, exactly: dist bitwise symmetric with
     a zero diagonal, the per-part counts equal to the active triplets
     torch counts over the kernel's own dist, and the kernel's g equal,
     bitwise, to those integer counts times the scale; dist against the
     plain pairwise_dist; kernel and plain times at the flagship shape,
     B = 256 and B = 512;
  2. embed: preprocess_batch on raw int16 OF / uint8 gray at B = 128, then
     the forward, in float32 and bfloat16 (inputs perturbed every batch);
  3. train (the main path): raw B = 40 (8 ids x 5) -> preprocess with the
     flagship's augmentation (shift/zoom/flip, brightness and channel
     shift, the OF clip coin) and expand 3 (B = 120) -> Adam steps with
     the batch_all kernel (2 warm-up steps, then the median of 5); launch
     counts are set to 0 just before and read just after; one step from
     the same state and the same augmented batch with the plain triplet
     must give the same losses and the same gradient at the signature;
  4. checks: use_flag = 0 equals a noise-filled input exactly, and the card's
     forward agrees with the CPU's on a small batch (and with TF32 on, does
     not);
  5. eval: a CASIA-B-shaped synthetic gallery and probe set (50 subjects x
     11 cameras x 2 videos, 1,100 clips each) encoded at B = 128 by the
     flagship with weights from seed 0 (gallery mirrored), the camera-pair
     protocol for every probe camera and the open-set protocol.  Checks:
     the kNN labels equal a float64 numpy brute force on the same codes
     (probes whose k-th and (k+1)-th distances lie within 1e-4 relative are
     counted, and must stay under 1 %); the first 128 gallery codes match
     the port on the CPU (max |d| <= 3e-4 max |CPU|); the padded tail batch
     gives the codes of an unpadded forward, and duplicate-row padding
     would not;
  6. serve: SignatureService with buckets (1, 8, 32, 128) over the
     synthetic gallery, identify_raw timed per bucket in float32 and
     bfloat16; 128 rows enrolled in place, one label removed, self-queries
     answered with their own labels; then a 65,536 x 15,872 random
     unit-norm gallery (4.2 GB) and identify_codes at bucket 128 against
     its bound;
  7. trainer (this slice's main path): a CASIA-B-train-shaped synthetic set
     (74 subjects x 4 videos x 2 subsequences, 592 clips) packed to disk;
     run A calls ``cli.train.main`` with the flagship's flags for 3 epochs
     (augmentation on, async checkpoints, validation every epoch), with
     deterministic cuDNN.  Checks: finite train losses, val loss and EER,
     ckpt/1..3, ckpt/best and controller.json, the native gather in use,
     the triplet kernels' launches inside fit (launch counts over the whole
     fit, and torch.profiler over epoch 1: forward = train steps +
     validation batches, backward = train steps), each validation batch's
     kernel triplet value on its signature, at margin 0.2 and at the
     batch's median distance (where it is not 0), against the plain
     reduction over the kernel's dist (rtol 1e-5), with exact counts and g
     and d^2 against the plain on the scale of the norms (labels equal to
     phase 1's validation cases), the state
     restored from ckpt/3 equal to fit's bitwise.  Run B runs the same CLI in a
     subprocess, is killed (SIGKILL) once ckpt/1 is published, restarts,
     must report resuming and land on run A's per-epoch train losses within
     1e-6.  Then ``cli.evaluate.main`` restores run A's 'best' and runs the
     camera-pair protocol over phase 5's sets, saved packed, and must
     report all 11 probe cameras.  Prints the steps per epoch, the fit's
     time per step against the isolated step, the blocking part of each
     async save and the validation time.

Gradient limits scale with each case, and every run reads planted faults
(a backward without the g^T term, with the negative role's sign flipped,
or returning zeros) against them: a limit that passes a fault fails the run.

The compiler's report (-Xptxas -v) is printed, and a kernel that spills
registers fails the run.

Prints the card (nvidia-smi name and power limit), one JSON line with every
kernel's launches, error, times and bound, and as the last line
{"ok": true, "device": {...}}.  Any failed check raises: exit code != 0.
TF32 is off for matmuls and convolutions throughout (parity), apart from
the one forward of phase 4 that shows the card-vs-CPU limit would catch it.
"""

import contextlib
import copy
import gc
import importlib.util
import io
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

# H100 SXM published peaks (NVIDIA data sheet, 700 W): HBM bytes/s and the
# float32 rate outside the tensor cores, which these kernels use.
PEAK_BYTES = 3.35e12
PEAK_FP32 = 67e12

VAL_RTOL = 1e-5                  # loss values: float32 sums in another order
# gradients, per case: max |kernel - plain| <= GRAD_REL * max |plain|.  The
# limit scales with the case, since batch-all gradients shrink as 1/count;
# every run also reads planted faults against it (analytic_grad) and fails
# unless each lies above it.
GRAD_REL = 1e-2
STEP_RTOL = 1e-5                 # train-step losses, kernel vs plain triplet
# kernel dist vs plain pairwise_dist (cuBLAS, TF32 off): max |kernel - plain|
# <= DIST_REL * max |plain|; both are float32 dot products summed in other
# orders, and the entries are O(10) on these random inputs
DIST_REL = 1e-5
# card vs CPU forward, float32 with TF32 off: max |card - CPU| <= CPU_REL *
# max |CPU| per output.  cuDNN's FFT and implicit-GEMM convolutions round
# differently from the CPU's direct sums; every run also reads the card with
# TF32 on and fails unless that lies above the limit.
CPU_REL = 3e-4
FAULTS = ("g^T dropped", "negative sign", "zeros")
# eval: a probe whose k-th and (k+1)-th float64 neighbor distances lie within
# KNN_TIE_REL of each other may rank them either way in float32.  Every
# other probe's label must equal the float64 brute force's.  Near ties are
# counted, and those whose vote changes when the two swap (the only ones
# whose label float32 rounding can move) must stay under KNN_TIE_SHARE.
KNN_TIE_REL = 1e-4
KNN_TIE_SHARE = 0.01
MODS = ("of", "gray")
BUCKETS = (1, 8, 32, 128)

# crash-resume: max |resumed - uninterrupted| per-epoch train loss (the JAX
# package's kill-and-resume test's limit)
RESUME_ATOL = 1e-6
FIT_EPOCHS = 3
VAL_PERC = 0.08
FLAGSHIP_FLAGS = ["--mod0", "of", "--mod1", "gray", "--nclasses", "74",
                  "--mergefun", "sign_max", "--bs", "40", "--lr", "1e-4",
                  "--margin", "0.2", "--wver", "1.0", "--wid", "0.1",
                  "--repetitions", "5", "--expandlevel", "3",
                  "--epochs", str(FIT_EPOCHS), "--savemodelfreq", "1",
                  "--valperc", str(VAL_PERC), "--asyncckpt"]
# the train CLI in a fresh process, with cuDNN's deterministic algorithms
# and TF32 off, as run A runs in this one
TRAIN_BOOT = """
import sys, torch
torch.backends.cudnn.deterministic = True
torch.backends.cudnn.benchmark = False
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
sys.path.insert(0, sys.argv[1])
from ugaitnet_tpu_torch.cli.train import main
main(sys.argv[2:])
"""
REPO = os.path.dirname(os.path.abspath(__file__))

SRC = "ugaitnet_tpu_torch/csrc/triplet_kernel.cu"
FWD_KERNELS = ("triplet_fwd_kernel",)
BWD_KERNELS = ("triplet_rows_kernel", "triplet_finish_kernel")
PALLAS = "ugaitnet_tpu/ops/pallas/triplet_kernel.py"


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def cuda_ms(fn, iters=20, warmup=3):
    """Mean device time of fn() in ms, by CUDA events around `iters` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def kernel_events(fn, iters):
    """Device events (name, us) of `iters` calls of fn() under
    torch.profiler, and the host-clock window they ran in (us)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e6
    events = [(e.name, e.time_range.elapsed_us()) for e in prof.events()
              if e.device_type == DeviceType.CUDA]
    return events, wall


def device_ms(fn, names, iters=20):
    """Device time per call (ms) of each kernel whose name contains one of
    `names` (the wrapper's host work excluded); {} if the profiler saw none
    of them."""
    events, _ = kernel_events(fn, iters)
    out = {}
    for k in names:
        us = sum(t for n, t in events if k in n)
        if us > 0:
            out[k] = us / iters / 1e3
    return out


def n_valid_triplets(labels, parts):
    """(a, p, n) with lab[p] == lab[a] (p == a included), lab[n] != lab[a]."""
    lab = labels.cpu().numpy()
    _, counts = np.unique(lab, return_counts=True)
    b = len(lab)
    return parts * int(np.sum(counts * counts * (b - counts)))


def bound(nbytes, nops):
    t_bytes, t_ops = nbytes / PEAK_BYTES, nops / PEAK_FP32
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def rel_err(got, want):
    """max |got - want| over max |want|."""
    return float((got - want).abs().max() / want.abs().max())


def analytic_grad(x, lab, fault=None, margin=0.2):
    """dL/dx of the batch-all loss in its analytic form, in torch ops, with
    one planted fault or none: the gradient a broken backward kernel would
    give.  g[a, m] = #active(a, p=m) - #active(a, n=m), scaled by
    1 / (count * P); dx_i = sum_j (g[i,j] + g[j,i]) / d[i,j] (x_i - x_j)."""
    from ugaitnet_tpu_torch.ops.triplet import pairwise_dist
    e = (x[None] if x.ndim == 2 else x.transpose(0, 1)).float()
    d = pairwise_dist(e)
    same = lab[:, None] == lab[None, :]
    valid = same[:, :, None] & ~same[:, None, :]
    act = ((margin + d[:, :, :, None] - d[:, :, None, :]) > 0) & valid
    cnt = act.sum((1, 2, 3)).float()
    scale = torch.where(cnt > 0, 1.0 / (cnt.clamp_min(1) * e.shape[0]),
                        torch.zeros_like(cnt))
    pos, neg = act.sum(3).float(), act.sum(2).float()
    g = (pos + neg if fault == "negative sign" else pos - neg)
    g = g * scale[:, None, None]
    w = g if fault == "g^T dropped" else g + g.transpose(1, 2)
    w = torch.where(d > 0, w / torch.where(d > 0, d, torch.ones_like(d)),
                    torch.zeros_like(w))
    dx = w.sum(-1, keepdim=True) * e - w @ e
    if fault == "zeros":
        dx = torch.zeros_like(dx)
    return dx[0] if x.ndim == 2 else dx.transpose(0, 1)


def fault_readings(x, lab, want):
    """rel_err against `want` of the analytic gradient, unfaulted (which
    must sit under GRAD_REL, or the fault model is wrong) and with each
    planted fault (each must sit above it)."""
    return {f or "none": rel_err(analytic_grad(x, lab, f), want)
            for f in (None,) + FAULTS}


def check_faults(name, kernel_err, faults):
    print(f"  {name}: kernel {kernel_err:.2e}, analytic {faults['none']:.2e}"
          f" <= {GRAD_REL}; planted faults "
          + ", ".join(f"{f} {faults[f]:.2e}" for f in FAULTS)
          + f" > {GRAD_REL}")
    check(kernel_err <= GRAD_REL and faults["none"] <= GRAD_REL,
          f"{name}: gradient")
    check(all(faults[f] > GRAD_REL for f in FAULTS),
          f"{name}: a planted fault reads under the limit")


def unit_scale(pcnt):
    """The backward's per-part scale for an upstream gradient of 1."""
    return torch.where(pcnt > 0, 1.0 / (pcnt.clamp_min(1.0) * pcnt.shape[0]),
                       torch.zeros_like(pcnt)).contiguous()


def exact_checks(x, lab, margin=0.2):
    """The kernels against themselves on their own dist: symmetry and
    diagonal, integer counts and g, bitwise.  Returns the kernel's dist and
    max |dist - plain| / max |plain|."""
    from ugaitnet_tpu_torch.ops.cuda import triplet_kernel as K
    from ugaitnet_tpu_torch.ops.triplet import pairwise_dist
    dist, _, pcnt = K.launch_fwd(x, lab, margin)
    scale = unit_scale(pcnt)
    _, g = K.launch_bwd(x, lab, dist, scale, margin)
    check(torch.equal(dist, dist.transpose(1, 2)),
          "dist is not bitwise symmetric")
    check(bool((torch.diagonal(dist, dim1=1, dim2=2) == 0).all()),
          "dist has a nonzero diagonal")
    same = lab[:, None] == lab[None, :]
    valid = same[:, :, None] & ~same[:, None, :]
    counts, g_want = [], []
    for d in dist:                       # act[a, j, k], one part at a time
        act = ((margin + d[:, :, None] - d[:, None, :]) > 0) & valid
        counts.append(act.sum())
        g_want.append(act.sum(2) - act.sum(1))   # as positive - as negative
    counts = torch.stack(counts)
    g_want = torch.stack(g_want).to(torch.float32) * scale[:, None, None]
    check(torch.equal(pcnt.to(torch.int64), counts),
          f"active counts {pcnt.tolist()} vs {counts.tolist()}")
    check(torch.equal(g, g_want), "g differs from counts x scale")
    e = x[None] if x.ndim == 2 else x.transpose(0, 1)
    return dist, rel_err(dist, pairwise_dist(e))


def sq_dist_err(dist, x):
    """max |d^2 - plain d^2| over 2 max |x_i|^2, the largest over parts.
    Both compute |x_i|^2 + |x_j|^2 - 2 x_i.x_j in float32, whose rounding
    scales with the norms, not with d: trained signatures with
    near-duplicate rows lose relative precision in small d in both alike."""
    from ugaitnet_tpu_torch.ops.triplet import pairwise_dist
    e = x.transpose(0, 1).to(torch.float32)
    plain = pairwise_dist(e)
    scale = 2.0 * (e * e).sum(-1).amax(-1)
    return float(((dist * dist - plain * plain).abs().amax((1, 2))
                  / scale).max())


def value_over_dist(dist, lab, margin):
    """The plain batch-all reduction (``ops/triplet.py``) over a given
    (P, B, B) dist: per part the mean hinge over active triplets, then the
    mean over parts."""
    same = lab[:, None] == lab[None, :]
    valid = (same[:, :, None] & ~same[:, None, :]).to(torch.float32)
    t = torch.clamp_min(margin + dist[:, :, :, None] - dist[:, :, None, :],
                        0.0) * valid
    s, n = t.sum((1, 2, 3)), (t > 0.0).to(torch.float32).sum((1, 2, 3))
    return float(torch.where(n > 0.0, s / n.clamp_min(1.0),
                             torch.zeros_like(s)).mean())


def median_ms(fn, n=5):
    """Median host-clock ms of n calls of fn() after one warm-up call; fn
    returns host data, so each call ends synchronized."""
    fn()
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def knn_float64(probes, gallery, labels, k):
    """Brute-force kNN in float64 numpy: stable sort, sklearn's vote
    (lowest label on ties).  Returns the labels, whether each probe's k-th
    and (k+1)-th distances lie within KNN_TIE_REL of each other, and whether
    swapping those two changes its vote."""
    p = probes.astype(np.float64)
    g = gallery.astype(np.float64)
    d = np.sqrt(np.maximum((p * p).sum(1)[:, None] + (g * g).sum(1)[None, :]
                           - 2.0 * p @ g.T, 0.0))
    order = np.argsort(d, axis=1, kind="stable")

    def vote(rows):
        labs, counts = np.unique(labels[rows], return_counts=True)
        return labs[np.argmax(counts)]

    pred = np.asarray([vote(r[:k]) for r in order])
    swapped = np.asarray([vote(np.r_[r[:k - 1], r[k]]) for r in order])
    kth = np.take_along_axis(d, order[:, k - 1:k + 1], 1)
    near_tie = kth[:, 1] - kth[:, 0] <= KNN_TIE_REL * kth[:, 0]
    return pred, near_tie, swapped != pred


def val_batch_labels():
    """Dense labels of the trainer's validation batches in phase 7: the
    train set's layout (74 subjects x 4 videos x 2 subsequences, in
    order), its video-grouped split and ``Trainer._val_metrics``'s fixed
    shuffle, the last batch wrapped to full size from the start."""
    from ugaitnet_tpu_torch.data.sampler import split_train_val_by_video
    labels = np.repeat(np.arange(74), 8)
    _, val = split_train_val_by_video(np.repeat(np.arange(74 * 4), 2),
                                      perc=VAL_PERC, seed=0)
    order = np.random.RandomState(1234).permutation(len(val))
    bs = min(len(val), 40)
    out = []
    for i in range(-(-len(val) // bs)):
        b = order[i * bs:(i + 1) * bs]
        out.append(labels[val[np.concatenate([b, order[:bs - len(b)]])]])
    return out


def casia_sets():
    """CASIA-B-shaped synthetic gallery and probe set: the test split's 50
    subjects, 11 cameras, 22 videos each (every camera twice), one clip per
    video; shared identities, different draws."""
    from ugaitnet_tpu_torch.data.synthetic import make_synthetic_dataset
    kw = dict(num_subjects=50, num_cams=11, videos_per_subject=22,
              subseqs_per_video=1, modalities=MODS, template_seed=0)
    return (make_synthetic_dataset(seed=1, name="casia_gallery", **kw),
            make_synthetic_dataset(seed=2, name="casia_probe", **kw))


def eval_phase(model, gallery_ds, probe_ds, card):
    """Encode, kNN and both open-world protocols at the flagship's width."""
    from ugaitnet_tpu_torch.core.config import EvalConfig
    from ugaitnet_tpu_torch.eval.encode import encode_dataset
    from ugaitnet_tpu_torch.eval.protocol import (EncodedSet, encode_set,
                                                  eval_camera_pairs,
                                                  eval_openset)
    from ugaitnet_tpu_torch.ops.knn import _knn_device, knn_predict
    cfg = EvalConfig(batch_size=128)
    dev = model.device
    b0 = model.config.branches[0]
    n = len(gallery_ds)
    nbatch = -(-n // cfg.batch_size)
    out = {"clips": n}
    t0 = time.perf_counter()
    gallery = encode_set(model, gallery_ds, MODS, cfg, mirror=True)
    t_gal = time.perf_counter() - t0
    t0 = time.perf_counter()
    probe = encode_set(model, probe_ds, MODS, cfg)
    t_probe = time.perf_counter() - t0
    code_dim = b0.num_parts * b0.part_dim
    check(gallery.codes.shape == (2 * n, code_dim)
          and probe.codes.shape == (n, code_dim), "encoded shapes")
    check(bool(np.isfinite(gallery.codes).all()
               and np.isfinite(probe.codes).all()), "codes not finite")
    out["encode_probe_ms_per_batch"] = t_probe * 1e3 / nbatch
    out["encode_probe_clips_per_s"] = n / t_probe
    out["encode_gallery_mirrored_ms_per_batch"] = t_gal * 1e3 / (2 * nbatch)
    out["encode_gallery_mirrored_clips_per_s"] = 2 * n / t_gal
    print(f"eval encode B=128 fp32 (host gather + preprocess + forward): "
          f"probe {out['encode_probe_ms_per_batch']:.2f} ms/batch, "
          f"{out['encode_probe_clips_per_s']:.1f} clips/s; mirrored gallery "
          f"{out['encode_gallery_mirrored_ms_per_batch']:.2f} ms/forward, "
          f"{out['encode_gallery_mirrored_clips_per_s']:.1f} codes/s [{card}]")

    # kNN over the mirrored gallery (G = 2,200), against float64 numpy
    pred = knn_predict(probe.codes, gallery.codes, gallery.labels, k=3,
                       device=dev)
    want, near_tie, fragile = knn_float64(probe.codes, gallery.codes,
                                          gallery.labels, 3)
    fragile &= near_tie
    bad = (pred != want) & ~near_tie
    out["knn_near_ties"] = int(near_tie.sum())
    out["knn_near_ties_vote_changing"] = int(fragile.sum())
    print(f"kNN labels vs float64 numpy brute force: {int(bad.sum())} of "
          f"{n - int(near_tie.sum())} differ outside near ties; near ties "
          f"(k-th and (k+1)-th distances within {KNN_TIE_REL} relative): "
          f"{int(near_tie.sum())} of {n}, of which {int(fragile.sum())} "
          f"change the vote when swapped (limit {KNN_TIE_SHARE:.0%} of the "
          f"probes) and {int((pred != want)[near_tie].sum())} differ")
    check(not bad.any(), "kNN labels differ from the float64 brute force")
    check(fragile.sum() < KNN_TIE_SHARE * n,
          "too many probes whose vote hangs on a near tie")
    out["knn_call_ms"] = median_ms(lambda: knn_predict(
        probe.codes, gallery.codes, gallery.labels, k=3, device=dev), 3)
    ulabs, dense = np.unique(gallery.labels, return_inverse=True)
    pd = torch.from_numpy(probe.codes).to(dev)
    gd = torch.from_numpy(gallery.codes).to(dev)
    ld = torch.from_numpy(dense.astype(np.int64)).to(dev)
    out["knn_device_ms"] = cuda_ms(lambda: _knn_device(pd, gd, ld, 3,
                                                        len(ulabs)), 10)
    p_, g_, d_ = pd.shape[0], gd.shape[0], gd.shape[1]
    out["knn_bound"] = bound(4 * (p_ + g_) * d_ + 8 * g_ + 8 * p_,
                             2 * p_ * g_ * d_)
    print(f"kNN P={p_} G={g_} D={d_}: knn_predict call {out['knn_call_ms']:.2f}"
          f" ms (median of 3, host copies included); device (distance "
          f"matmul + top-k + vote, CUDA events) {out['knn_device_ms']:.3f} "
          f"ms, bound {out['knn_bound'][0]:.3f} ms ({out['knn_bound'][1]}) "
          f"[{card}]")
    del pd, gd, ld

    cams = np.unique(gallery.cams).tolist()
    per_cam = {}
    for cam in np.unique(probe.cams):
        sel = probe.cams == cam
        sub = EncodedSet(probe.codes[sel], probe.labels[sel],
                         probe.video_ids[sel], probe.cams[sel])
        per_cam[int(cam)] = eval_camera_pairs(gallery, sub, int(cam), knn=3,
                                              cameras=cams, device=dev)
    out["camera_pairs"] = per_cam
    out["openset"] = eval_openset(gallery, probe, knn=3, device=dev)
    for r in list(per_cam.values()) + [out["openset"]]:
        check(all(0.0 <= v <= 1.0 for v in r.values()), f"Rank-1 {r}")
    mean_sub = np.mean([r["rank1_subseq"] for r in per_cam.values()])
    mean_vid = np.mean([r["rank1_video"] for r in per_cam.values()])
    print(f"camera-pair Rank-1 over {len(per_cam)} probe cameras (random "
          f"weights): subseq {mean_sub:.4f}, video vote {mean_vid:.4f}; "
          f"open set {out['openset']}")

    # the first batch on the CPU: the same 128 rows, the same weights
    first = min(cfg.batch_size, n)
    with torch.inference_mode():
        cpu_codes, _, _, _ = encode_dataset(
            copy.deepcopy(model).to("cpu"), gallery_ds, MODS,
            batch_size=first, indices=np.arange(first))
    cpu_err = rel_err(torch.from_numpy(gallery.codes[:first]),
                      torch.from_numpy(cpu_codes))
    out["card_vs_cpu_rel_err"] = cpu_err
    print(f"gallery codes 0-{first - 1}, card vs CPU: max |card - CPU| / max |CPU| "
          f"{cpu_err:.2e} <= {CPU_REL}")
    check(cpu_err <= CPU_REL, "gallery codes card vs CPU")

    # the padded tail batch (1,100 = 8 x 128 + 76) against an unpadded
    # forward of its rows, and duplicate-row padding as a planted fault
    tail = np.arange((nbatch - 1) * cfg.batch_size, n)
    alone, _, _, _ = encode_dataset(model, probe_ds, MODS,
                                    batch_size=len(tail), indices=tail)
    dup = np.concatenate([tail, np.full(cfg.batch_size - len(tail),
                                         tail[-1])])
    skewed, _, _, _ = encode_dataset(model, probe_ds, MODS,
                                     batch_size=cfg.batch_size, indices=dup)
    want_t = torch.from_numpy(alone)
    tail_err = rel_err(torch.from_numpy(probe.codes[tail]), want_t)
    dup_err = rel_err(torch.from_numpy(skewed[:len(tail)]), want_t)
    out["tail_rel_err"], out["tail_dup_padding_rel_err"] = tail_err, dup_err
    print(f"padded tail batch ({len(tail)} rows in 128) vs unpadded: "
          f"{tail_err:.2e} <= {CPU_REL} (bitwise: "
          f"{bool(np.array_equal(probe.codes[tail], alone))}); duplicate-row "
          f"padding reads {dup_err:.2e} > {CPU_REL}")
    check(tail_err <= CPU_REL, "padded tail batch")
    check(dup_err > CPU_REL, "duplicate-row padding passes the tail limit")
    return out


def serve_phase(make_model, gallery_ds, probe_ds, card, big=65536):
    """SignatureService at the flagship's width: identify per bucket,
    enroll/remove, and a gallery of `big` random codes.  make_model(dtype)
    builds the net."""
    from ugaitnet_tpu_torch.eval.serving import SignatureService
    out = {"identify_raw_ms": {}}
    vols = {m: probe_ds.modalities[m].volumes for m in MODS}

    def raw(idx):
        return {f"raw_{m}": vols[m][idx] for m in MODS}

    for dtype in ("float32", "bfloat16"):
        svc = SignatureService(make_model(dtype), MODS, knn=3,
                               buckets=BUCKETS)
        t0 = time.perf_counter()
        svc.build_gallery(gallery_ds, batch_size=128)
        svc.warmup()
        build_s = time.perf_counter() - t0
        feeds = {b: raw(np.arange(b)) for b in BUCKETS}
        times = {b: median_ms(lambda b=b: svc.identify_raw(feeds[b]))
                 for b in BUCKETS}
        out["identify_raw_ms"][dtype] = times
        print(f"serve {dtype}: build_gallery ({len(gallery_ds)} clips) + "
              f"warmup {build_s:.1f} s; identify_raw ms by bucket (median of"
              f" 5, host copies included) "
              + ", ".join(f"{b}: {t:.2f}" for b, t in times.items())
              + f" [{card}]")
        if dtype == "float32":
            fp32 = svc
    svc = fp32
    labels, dists = svc.identify_raw(raw(np.arange(128)))
    codes = svc.encode_raw(raw(np.arange(128)))
    check(np.array_equal(svc.identify_codes(codes)[0], labels),
          "identify_raw vs identify_codes of its own codes")
    check(bool(np.isfinite(dists).all()) and dists.shape == (128, 3),
          "identify distances")

    # enroll 64 probe codes twice (128 rows, in place), then remove a label
    new, new_labels = codes[:64], probe_ds.labels[:64]
    buf, cap = svc._gallery_codes, svc._capacity
    ptr, used = buf.data_ptr(), svc._rows_used
    svc.enroll(np.concatenate([new, new]), np.concatenate([new_labels,
                                                           new_labels]))
    check(svc._gallery_codes.data_ptr() == ptr and svc._capacity == cap,
          "enroll did not write in place")
    check(torch.equal(svc._gallery_codes[used:used + 128].cpu(),
                      torch.from_numpy(np.concatenate([new, new]))),
          "enrolled rows on the card")
    check(np.array_equal(svc.identify_codes(new)[0], new_labels),
          "self-queries after enroll")
    gone = int(new_labels[0])
    removed = svc.remove(gone)
    keep = new_labels != gone
    got = svc.identify_codes(new)[0]
    check(np.array_equal(got[keep], new_labels[keep]) and gone not in got,
          "self-queries after remove")
    out["enroll_remove"] = {"enrolled": 128, "removed_rows": removed,
                            "capacity": int(svc._capacity)}
    print(f"enroll 128 rows in place (capacity {svc._capacity}), remove "
          f"label {gone} ({removed} rows): {int(keep.sum())} self-queries "
          f"keep their labels, none returns {gone}")

    # a 65,536-code random unit-norm gallery (4.2 GB float32 on the card)
    g, d = big, codes.shape[1]
    gen = torch.Generator(device=svc.device).manual_seed(5)
    x = torch.randn(g, d, device=svc.device, generator=gen)
    x /= torch.linalg.vector_norm(x, dim=1, keepdim=True)
    big = x.cpu().numpy()
    del x
    big_labels = np.arange(g) % 1000
    t0 = time.perf_counter()
    svc.set_gallery(big, big_labels)
    set_s = time.perf_counter() - t0
    queries = big[:128] + 1e-4 * np.random.RandomState(0).randn(
        128, d).astype(np.float32)
    _, qd = svc.identify_codes(queries)
    check(bool((qd[:, 0] < 0.05).all() and (qd[:, 1] > 1.0).all()),
          "big gallery: each query's nearest row is its own")
    call_ms = median_ms(lambda: svc.identify_codes(queries))
    qdev = torch.from_numpy(queries).to(svc.device)
    with torch.no_grad():
        dev_ms = cuda_ms(lambda: svc._dist_vote(qdev, 3), 10)
    b_ms, b_by = bound(4 * g * d + 4 * 128 * d + 12 * g, 2 * 128 * g * d)
    out["big_gallery"] = {"G": g, "D": d, "set_gallery_s": set_s,
                          "identify_codes_ms": call_ms,
                          "device_ms": dev_ms, "bound_ms": b_ms,
                          "bound_by": b_by}
    print(f"identify_codes bucket 128 vs G={g} D={d}: call {call_ms:.2f} ms "
          f"(median of 5, host copies included), device (distances + top-k +"
          f" vote, CUDA events) {dev_ms:.3f} ms, bound {b_ms:.3f} ms "
          f"({b_by}); set_gallery {set_s:.1f} s [{card}]")
    return out


@contextlib.contextmanager
def wrapped(owner, name, make):
    """Replace owner.name by make(original) for the block (instrumentation
    of the trainer's methods; the package itself is unchanged)."""
    orig = owner.__dict__[name]
    setattr(owner, name, make(orig))
    try:
        yield
    finally:
        setattr(owner, name, orig)


def timed_calls(store):
    """A wrapper factory that appends each call's host seconds to store."""
    def make(fn):
        def call(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                store.append(time.perf_counter() - t0)
        return call
    return make


def flat_tensors(tree, prefix=""):
    if isinstance(tree, torch.Tensor):
        return {prefix: tree}
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(flat_tensors(v, f"{prefix}/{k}"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(flat_tensors(v, f"{prefix}/{i}"))
    return out


def epoch_losses(experdir, key="train/loss"):
    from ugaitnet_tpu_torch.obsv.logger import read_metrics
    return {int(r["step"]): r[key] for r in read_metrics(experdir)
            if key in r}


def trainer_phase(card, gallery_dir, probe_dir, isolated_step_ms, train_ms):
    """7. The trainer at the flagship's width through the CLIs."""
    from ugaitnet_tpu_torch.cli import evaluate as cli_eval
    from ugaitnet_tpu_torch.cli import train as cli_train
    from ugaitnet_tpu_torch.core import checkpoint as ckpt
    from ugaitnet_tpu_torch.core.config import load_json
    from ugaitnet_tpu_torch.data import native
    from ugaitnet_tpu_torch.data.sampler import split_train_val_by_video
    from ugaitnet_tpu_torch.data.synthetic import make_synthetic_dataset
    from ugaitnet_tpu_torch.models.network import UGaitNet
    from ugaitnet_tpu_torch.obsv.logger import MetricsLogger
    from ugaitnet_tpu_torch.ops.cuda import triplet_kernel as K
    from ugaitnet_tpu_torch.ops.triplet import (batch_all_triplet_loss,
                                                pairwise_dist)
    from ugaitnet_tpu_torch.train import trainer as TR
    from ugaitnet_tpu_torch.train.train_step import init_state
    from ugaitnet_tpu_torch.utils import net_utils
    out = {}
    work = tempfile.mkdtemp(prefix="chip_smoke_train_")
    proc = None
    try:
        t0 = time.perf_counter()
        ds = make_synthetic_dataset(num_subjects=74, videos_per_subject=4,
                                    subseqs_per_video=2, template_seed=0,
                                    seed=7, name="casia_train")
        data = os.path.join(work, "casia_train")
        ds.save(data)
        raw_mb = sum(s.volumes.nbytes for s in ds.modalities.values()) / 1e6
        tr_idx, val_idx = split_train_val_by_video(ds.video_ids,
                                                   perc=VAL_PERC, seed=0)
        steps = len(tr_idx) // 40
        val_bs = min(len(val_idx), 40)
        val_batches = -(-len(val_idx) // val_bs)
        out.update(clips=len(ds), raw_mb=raw_mb, steps_per_epoch=steps,
                   val_clips=len(val_idx), val_batches=val_batches)
        del ds
        print(f"trainer data: {out['clips']} clips ({raw_mb:.1f} MB raw "
              f"int16 OF + uint8 gray) packed in "
              f"{time.perf_counter() - t0:.1f} s; {len(tr_idx)} train / "
              f"{len(val_idx)} val clips, {steps} steps per epoch, "
              f"{val_batches} val batches")

        # ---- run A: cli.train in this process --------------------------
        torch.backends.cudnn.deterministic = True
        base_a = os.path.join(work, "A")
        flags_a = FLAGSHIP_FLAGS + ["--datadir", data, "--experdir", base_a]
        got, epoch_s, val_s, validate_s, save_s, write_s = {}, [], [], [], \
            [], []
        encode_s, export_s, filters_s = [], [], []
        prof = {}
        val_seen = []

        def kept_eval(eval_step):
            """eval_step, keeping each validation batch's triplet value (the
            kernel's), its signature and labels for the plain triplet."""
            def call(model, batch):
                store = {}
                hook = model.register_forward_hook(
                    lambda _m, _i, o: store.__setitem__(
                        "sig", o["signature"].detach().clone(
                            memory_format=torch.contiguous_format)))
                try:
                    metrics = eval_step(model, batch)
                finally:
                    hook.remove()
                val_seen.append((metrics["triplet"], store["sig"],
                                 batch.labels.clone()))
                return metrics
            return call

        def capture_fit(fit):
            def call(self, ds, **kw):
                got["trainer"] = self
                self.eval_step = kept_eval(self.eval_step)
                got["state"] = fit(self, ds, **kw)
                return got["state"]
            return call

        def profiled_epoch(run_epoch):
            """Times each epoch; profiles from the start of epoch 1 to the
            start of epoch 2 (epoch 1's steps and its validation)."""
            from torch.profiler import ProfilerActivity, profile

            def call(self, state, pipe, sampler, epoch, seed):
                if epoch == 0:
                    prof["p"] = profile(activities=[ProfilerActivity.CPU,
                                                    ProfilerActivity.CUDA])
                    prof["p"].__enter__()
                elif epoch == 1:
                    torch.cuda.synchronize()
                    prof["p"].__exit__(None, None, None)
                t0 = time.perf_counter()
                res = run_epoch(self, state, pipe, sampler, epoch, seed)
                epoch_s.append(time.perf_counter() - t0)
                return res
            return call

        K.reset_launch_counts()
        t0 = time.perf_counter()
        with wrapped(TR.Trainer, "fit", capture_fit), \
                wrapped(TR.Trainer, "_epoch", profiled_epoch), \
                wrapped(TR.Trainer, "_val_metrics", timed_calls(val_s)), \
                wrapped(TR.Trainer, "_validate", timed_calls(validate_s)), \
                wrapped(ckpt.AsyncCheckpointWriter, "save",
                        timed_calls(save_s)), \
                wrapped(ckpt, "_publish", timed_calls(write_s)), \
                wrapped(TR, "encode_dataset", timed_calls(encode_s)), \
                wrapped(MetricsLogger, "export_embeddings",
                        timed_calls(export_s)), \
                wrapped(net_utils, "save_filter_grid", timed_calls(filters_s)):
            exp_a = cli_train.main(flags_a)
        fit_s = time.perf_counter() - t0
        launches = {"triplet_fwd": K.fwd_launches,
                    "triplet_bwd": K.bwd_launches}
        out["launches_fit"] = launches
        want = {"triplet_fwd": FIT_EPOCHS * (steps + val_batches),
                "triplet_bwd": FIT_EPOCHS * steps}
        check(launches == want, f"fit launches {launches}, expected {want}")
        from torch.autograd import DeviceType
        names = [e.name for e in prof["p"].events()
                 if e.device_type == DeviceType.CUDA]
        seen = {k: sum(k in n for n in names) for k in
                FWD_KERNELS + BWD_KERNELS}
        out["profiler_epoch1_launches"] = seen
        check(seen == {"triplet_fwd_kernel": steps + val_batches,
                       "triplet_rows_kernel": steps,
                       "triplet_finish_kernel": steps},
              f"torch.profiler over epoch 1 saw {seen}")
        print(f"run A: cli.train {FIT_EPOCHS} epochs in {fit_s:.1f} s; "
              f"triplet kernel launches in fit {launches} (= epochs x "
              f"(steps + val batches), epochs x steps); torch.profiler over "
              f"epoch 1 saw {seen}")

        # validation's triplet, the kernel's, on each batch's signature: at
        # margin 0.2 and at the batch's median distance, where about half
        # the triplets are active, the kernels against themselves (exact
        # counts and g over their own dist), their d^2 against the plain
        # one on the scale of the norms, and the value against the plain
        # reduction over that dist.
        # The plain version's own value is printed beside it: a triplet
        # whose hinge lies within rounding of 0 may count on one side only,
        # which moves a part's mean by 1 / its active count.
        want_labels = val_batch_labels()
        check(len(val_seen) == FIT_EPOCHS * val_batches,
              f"{len(val_seen)} validation batches")
        val_rows = []
        for i, (k_fit, sig, lab) in enumerate(val_seen):
            check(np.array_equal(lab.cpu().numpy(),
                                 want_labels[i % val_batches]),
                  f"validation batch {i}: labels differ from phase 1's")
            med = float(pairwise_dist(sig.transpose(0, 1)).median())
            for m in (0.2, med):
                kv = (float(k_fit) if m == 0.2 else
                      float(K.batch_all_triplet_loss_cuda(sig, lab, m)))
                dist, derr = exact_checks(sig, lab, m)
                val_rows.append({"batch": i, "margin": m, "kernel": kv,
                                 "over_kernel_dist": value_over_dist(
                                     dist, lab, m),
                                 "plain": float(batch_all_triplet_loss(
                                     sig, lab, m)),
                                 "dist_rel_err": derr,
                                 "sq_dist_err": sq_dist_err(dist, sig)})
        out["val_triplet"] = val_rows
        print("validation triplet (kernel, plain over the kernel's dist, "
              "plain) by batch and margin: " + "; ".join(
                  f"{r['batch']} m={r['margin']:.4g}: {r['kernel']:.7g}, "
                  f"{r['over_kernel_dist']:.7g}, {r['plain']:.7g}"
                  for r in val_rows)
              + f"; dist vs plain: max |d - plain| / max |plain| <= "
              f"{max(r['dist_rel_err'] for r in val_rows):.2e}, max |d^2 - "
              f"plain d^2| / (2 max |x|^2) <= "
              f"{max(r['sq_dist_err'] for r in val_rows):.2e} (limit "
              f"{DIST_REL})")
        check(all(abs(r["kernel"] - r["over_kernel_dist"])
                  <= VAL_RTOL * abs(r["over_kernel_dist"])
                  for r in val_rows),
              "validation triplet vs the plain reduction over its dist")
        check(all(r["sq_dist_err"] <= DIST_REL for r in val_rows),
              "validation dist vs plain")
        check(all(r["kernel"] > 0 for r in val_rows if r["margin"] != 0.2),
              "no active triplet at the median margin")
        del val_seen[:]

        recs = {k: epoch_losses(exp_a, k) for k in
                ("train/loss", "val/loss", "val/eer")}
        for k, v in recs.items():
            check(sorted(v) == list(range(1, FIT_EPOCHS + 1)) and all(
                x is not None and np.isfinite(x) for x in v.values()),
                f"{k} per epoch: {v}")
        out["losses"] = recs
        ck = sorted(os.listdir(os.path.join(exp_a, "ckpt")))
        check(ck == [str(e) for e in range(1, FIT_EPOCHS + 1)] + ["best"]
              and os.path.exists(os.path.join(exp_a, "controller.json")),
              f"checkpoints {ck}")
        check(native.get_lib() is not None
              and os.path.exists(native.LIB_PATH),
              "the native gather library is not in use")
        print(f"run A per epoch: train/loss {recs['train/loss']}, val/loss "
              f"{recs['val/loss']}, val/eer {recs['val/eer']}; checkpoints "
              f"{ck} + controller.json; native gather {native.LIB_PATH}")

        # the state fit returned against the one restored from ckpt/3
        state = got["state"]
        cfg = load_json(os.path.join(exp_a, "config.json"))
        restored = ckpt.restore_checkpoint(exp_a, FIT_EPOCHS, init_state(
            UGaitNet(cfg["model"], seed=1), cfg["train"]))
        a = flat_tensors({"m": state.model.state_dict(),
                          "o": state.optimizer.state_dict()})
        b = flat_tensors({"m": restored.model.state_dict(),
                          "o": restored.optimizer.state_dict()})
        check(a.keys() == b.keys() and all(torch.equal(a[k].cpu(),
                                                       b[k].cpu())
                                           for k in a)
              and restored.step == state.step,
              "the state restored from the last checkpoint differs")
        ckpt_mb = sum(t.numel() * t.element_size() for t in a.values()) / 1e6
        nparams = sum(p.numel() for p in state.model.parameters())
        print(f"ckpt/{FIT_EPOCHS} restores fit's state bitwise "
              f"({len(a)} tensors, {nparams} parameters, {ckpt_mb:.1f} MB "
              f"with the optimizer's moments)")
        # run B's processes need the card's memory this one holds: objects
        # in reference cycles go first, then the allocator's cache
        del state, restored, a, b
        got.clear()
        gc.collect()
        torch.cuda.empty_cache()

        iso_ms = isolated_step_ms()
        fit_ms = [1e3 * t / steps for t in epoch_s]
        steady = float(np.mean(fit_ms[1:]))
        per_epoch_val = [v + w for v, w in zip(val_s, validate_s)]
        out.update(epoch_s=epoch_s, fit_ms_per_step=fit_ms,
                   fit_ms_per_step_steady=steady,
                   isolated_step_ms_deterministic=iso_ms,
                   isolated_step_ms_phase3=train_ms,
                   loop_overhead_ms=steady - iso_ms,
                   val_metrics_s=val_s, validate_s=validate_s,
                   validation_s=per_epoch_val, encode_s=encode_s,
                   export_embeddings_s=export_s, filter_png_s=filters_s,
                   pil=importlib.util.find_spec("PIL") is not None,
                   save_blocking_ms=[
                       1e3 * t for t in save_s],
                   write_ms=[1e3 * t for t in write_s],
                   ckpt_mb=ckpt_mb, parameters=nparams)
        print(f"fit: {steps} steps per epoch; ms per step by epoch "
              f"{[round(t, 2) for t in fit_ms]} (epoch 1 includes cuDNN "
              f"warm-up and the profiler); epochs 2-{FIT_EPOCHS} "
              f"{steady:.2f} ms/step against the isolated step, same "
              f"deterministic cuDNN, {iso_ms:.2f} ms (phase 3, default "
              f"cuDNN: {train_ms:.2f} ms): loop overhead "
              f"{steady - iso_ms:.2f} ms/step [{card}]")
        print(f"validation per epoch {[round(t, 3) for t in per_epoch_val]}"
              f" s (eval-step metrics {[round(t, 3) for t in val_s]} s + "
              f"encode, exports and EER {[round(t, 3) for t in validate_s]} "
              f"s, of which encode {[round(t, 3) for t in encode_s]} s, "
              f"projector + sprite export {[round(t, 3) for t in export_s]} "
              f"s, filter PNG {[round(t, 3) for t in filters_s]} s; PIL "
              f"{'present' if out['pil'] else 'missing'}); async "
              f"save blocking {[round(1e3 * t, 2) for t in save_s]} ms per "
              f"save() ({len(save_s)} saves), background writes "
              f"{[round(1e3 * t, 1) for t in write_s]} ms [{card}]")

        # ---- run B: killed once ckpt/1 is published, then restarted ------
        gc.collect()
        torch.cuda.empty_cache()
        free, total = torch.cuda.mem_get_info()
        print(f"card memory before run B: {free / 1e9:.1f} GB free of "
              f"{total / 1e9:.1f} GB ({torch.cuda.memory_allocated() / 1e9:.2f}"
              f" GB allocated, {torch.cuda.memory_reserved() / 1e9:.2f} GB "
              f"reserved by this process)")
        check(free > 0.7 * total, "this process holds the card's memory")
        base_b = os.path.join(work, "B")
        exp_b = os.path.join(base_b, os.path.basename(exp_a))
        cmd = [sys.executable, "-c", TRAIN_BOOT, REPO] + FLAGSHIP_FLAGS + [
            "--datadir", data, "--experdir", base_b]
        log = open(os.path.join(work, "run_b.log"), "w+")
        proc = subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT)
        deadline = time.time() + 600
        while (ckpt.latest_checkpoint_step(exp_b) or 0) < 1:
            if proc.poll() is not None or time.time() > deadline:
                log.seek(0)
                check(False, "run B ended or stalled before its first "
                      f"checkpoint:\n{log.read()[-3000:]}")
            time.sleep(0.1)
        proc.kill()
        proc.wait(timeout=60)
        killed_at = ckpt.latest_checkpoint_step(exp_b)
        check(killed_at < FIT_EPOCHS, f"run B finished ({killed_at}) "
                                      "before it was killed")
        res = subprocess.run(cmd, capture_output=True, text=True,
                             timeout=900)
        log.seek(0)
        check(res.returncode == 0, f"run B restart failed:\n"
              f"{log.read()[-2000:]}\n{res.stdout[-3000:]}"
              f"{res.stderr[-3000:]}")
        check(f"resumed from epoch {killed_at}" in res.stdout,
              f"run B did not report resuming: {res.stdout[-2000:]}")
        loss_b = epoch_losses(exp_b)
        diffs = {e: abs(loss_b[e] - v) for e, v in
                 recs["train/loss"].items() if e in loss_b}
        out["resume"] = {"killed_at": killed_at, "losses_b": loss_b,
                         "abs_diff": diffs}
        wb = ckpt.restore_raw(exp_b, FIT_EPOCHS)["model"]
        wa = ckpt.restore_raw(exp_a, FIT_EPOCHS)["model"]
        w_diff = max(float((wa[k] - wb[k]).abs().max()) for k in wa)
        print(f"run B: SIGKILL after ckpt/{killed_at}, restarted, resumed at "
              f"epoch {killed_at}; train/loss {loss_b}; |B - A| per epoch "
              f"{diffs} (limit {RESUME_ATOL}); final weights max |B - A| "
              f"{w_diff:.3e}")
        check(sorted(diffs) == list(range(1, FIT_EPOCHS + 1))
              and max(diffs.values()) <= RESUME_ATOL,
              "the resumed run left run A's losses")

        # ---- evaluate run A's best over phase 5's sets -----------------
        outfile = os.path.join(work, "results.json")
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            cli_eval.main(["--experdir", exp_a, "--epoch", "best",
                           "--gallery", gallery_dir, "--probes", probe_dir,
                           "--protocol", "casiab", "--knn", "3", "--bs",
                           "128", "--outfile", outfile])
        eval_s = time.perf_counter() - t0
        with open(outfile) as f:
            results = json.load(f)[os.path.basename(probe_dir)]
        cams = {k: v for k, v in results.items() if k != "confusions_file"}
        check(len(cams) == 11 and all(
            0.0 <= r[m] <= 1.0 for r in cams.values()
            for m in ("rank1_subseq", "rank1_video")),
            f"evaluate results for {sorted(cams)}")
        mean_sub = float(np.mean([r["rank1_subseq"] for r in cams.values()]))
        mean_vid = float(np.mean([r["rank1_video"] for r in cams.values()]))
        out["evaluate"] = {"probe_cameras": len(cams), "seconds": eval_s,
                           "mean_rank1_subseq": mean_sub,
                           "mean_rank1_video": mean_vid}
        print(f"cli.evaluate on run A's best ({FIT_EPOCHS} epochs of the "
              f"flagship on synthetic data): {len(cams)} probe cameras, mean "
              f"Rank-1 subseq {mean_sub:.4f}, video {mean_vid:.4f}, "
              f"{eval_s:.1f} s")
    finally:
        torch.backends.cudnn.deterministic = False
        if proc is not None and proc.poll() is None:
            proc.kill()
            proc.wait(timeout=60)
        shutil.rmtree(work, ignore_errors=True)
    return out


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device")
    t_start = time.perf_counter()
    from ugaitnet_tpu_torch.core.config import (BranchConfig, DataConfig,
                                                ModelConfig, TrainConfig)
    from ugaitnet_tpu_torch.data.pipeline import preprocess_batch
    from ugaitnet_tpu_torch.models.network import UGaitNet
    from ugaitnet_tpu_torch.ops.cuda import build
    from ugaitnet_tpu_torch.ops.cuda import triplet_kernel as K
    from ugaitnet_tpu_torch.ops.triplet import (batch_all_triplet_loss,
                                                pairwise_dist)
    from ugaitnet_tpu_torch.train.train_step import (Batch, init_state,
                                                     make_train_step)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")

    t0 = time.perf_counter()
    build.load("triplet_kernel")
    print(f"kernel build: {time.perf_counter() - t0:.1f} s")
    # the host gather's library, built here so no timed phase pays for it
    from ugaitnet_tpu_torch.data import native
    t0 = time.perf_counter()
    check(native.get_lib() is not None,
          "the native gather did not build (host C++ compiler)")
    print(f"native gather build: {time.perf_counter() - t0:.1f} s "
          f"({native.LIB_PATH})")
    with open(f"{build.BUILD_DIR}/triplet_kernel.log") as f:
        ptxas = [ln.strip() for ln in f if "registers" in ln or "spill" in ln
                 or "Compiling entry" in ln]
    print("ptxas: " + " | ".join(ptxas))
    spills = [ln for ln in ptxas if "spill" in ln]
    check(spills and all("0 bytes spill stores, 0 bytes spill loads" in ln
                         for ln in spills), "a kernel spills registers")

    # ---- 1. kernels vs plain ---------------------------------------------
    gen = torch.Generator(device=dev).manual_seed(0)

    def case(parts, b, d, labels):
        shape = (b, d) if parts is None else (b, parts, d)
        x = torch.randn(shape, device=dev, generator=gen)
        lab = torch.as_tensor(labels, dtype=torch.int32, device=dev)
        xp = x.clone().requires_grad_(True)
        vp = batch_all_triplet_loss(xp, lab)
        vp.backward()
        xk = x.clone().requires_grad_(True)
        vk = K.batch_all_triplet_loss_cuda(xk, lab)
        vk.backward()
        torch.cuda.synchronize()
        check(torch.isfinite(xk.grad).all(), "kernel gradient not finite")
        return x, lab, float(vp.detach()), float(vk.detach()), xk.grad, xp.grad

    def kernel_times(x, lab):
        """Device ms of each kernel (torch.profiler), the wrapper calls'
        CUDA-event ms, the plain version's ms and the bounds."""
        p_, b_, d_ = x.shape[1], x.shape[0], x.shape[2]
        dist, _, pcnt = K.launch_fwd(x, lab, 0.2)
        scale = unit_scale(pcnt)
        fwd = lambda: K.launch_fwd(x, lab, 0.2)
        bwd = lambda: K.launch_bwd(x, lab, dist, scale, 0.2)
        t = {"fwd_dev": device_ms(fwd, FWD_KERNELS),
             "bwd_dev": device_ms(bwd, BWD_KERNELS),
             "fwd_call_ms": cuda_ms(fwd), "bwd_call_ms": cuda_ms(bwd)}
        check(set(t["fwd_dev"]) == set(FWD_KERNELS) and
              set(t["bwd_dev"]) == set(BWD_KERNELS),
              f"the profiler saw no device time of some kernel: {t}")
        t["fwd_ms"] = sum(t["fwd_dev"].values())
        t["bwd_ms"] = sum(t["bwd_dev"].values())
        with torch.no_grad():
            t["plain_fwd_ms"] = cuda_ms(lambda: batch_all_triplet_loss(x, lab),
                                        10)
        xq = x.clone().requires_grad_(True)
        loss_q = batch_all_triplet_loss(xq, lab)
        t["plain_bwd_ms"] = cuda_ms(lambda: torch.autograd.grad(
            loss_q, xq, retain_graph=True), 10)
        nv = n_valid_triplets(lab, p_)
        xbytes = x.numel() * 4
        # forward: the symmetric half of the Gram matrix (its diagonal holds
        # the norms), 2 flops per multiply-add, + 3 per valid triplet
        t["fwd_bound"] = bound(xbytes + b_ * 4 + 4,
                               p_ * b_ * (b_ + 1) * d_ + 3 * nv)
        # backward: W x, a (B, B) by (B, D) product per part, + 2 per triplet
        t["bwd_bound"] = bound(2 * xbytes + p_ * b_ * b_ * 4 + b_ * 4,
                               2 * p_ * b_ * b_ * d_ + 2 * nv)
        t["valid_triplets"] = nv
        print(f"kernel times {tuple(x.shape)} ({nv} valid triplets): device "
              f"(torch.profiler) fwd {t['fwd_dev']} ms, bwd {t['bwd_dev']} ms;"
              f" wrapper call (CUDA events) fwd {t['fwd_call_ms']:.4f} ms, bwd"
              f" {t['bwd_call_ms']:.4f} ms; plain fwd {t['plain_fwd_ms']:.4f} "
              f"ms, plain bwd {t['plain_bwd_ms']:.4f} ms; bound fwd "
              f"{t['fwd_bound'][0]:.4f} ms ({t['fwd_bound'][1]}), bwd "
              f"{t['bwd_bound'][0]:.4f} ms ({t['bwd_bound'][1]}) [{card}]")
        return t

    pk = lambda n: np.repeat(np.arange(n[0]), n[1])          # P x K labels
    val1, val2 = val_batch_labels()
    cases = [("flagship", 62, 120, 256, pk((12, 10))),
             ("small", 1, 12, 8, pk((3, 4))),
             ("rank2", None, 10, 8, pk((5, 2))),
             ("ragged", 3, 50, 40, np.arange(50) % 7),
             ("odd", 2, 37, 10, np.arange(37) % 5),
             ("B256", 16, 256, 256, np.arange(256) % 10),
             ("B512", 4, 512, 256, np.arange(512) % 10),
             ("val batch 1", 62, 40, 256, val1),
             ("val batch 2 (wrapped)", 62, 40, 256, val2)]
    results, times = {}, {}
    dist_err = {}
    for name, parts, b, d, labels in cases:
        x, lab, vp, vk, gk, gp = case(parts, b, d, labels)
        rel = abs(vk - vp) / abs(vp)
        gerr = rel_err(gk, gp)
        dist_err[name] = exact_checks(x, lab)[1]
        print(f"kernel vs plain {name} {tuple(x.shape)}: value {vk:.7f} vs "
              f"{vp:.7f} (rel {rel:.2e}, tol {VAL_RTOL}); grad max abs err "
              f"{float((gk - gp).abs().max()):.2e}, max |grad| "
              f"{float(gp.abs().max()):.2e}; dist symmetric, zero diagonal, "
              f"counts and g exact; dist vs plain {dist_err[name]:.2e} "
              f"(limit {DIST_REL})")
        check(dist_err[name] <= DIST_REL, f"{name}: dist vs plain")
        results[name] = (vp, rel, gerr, fault_readings(x, lab, gp))
        if name == "flagship":
            fwd_err = abs(vk - vp)
            bwd_err = float((gk - gp).abs().max())
        if name in ("flagship", "B256", "B512"):
            times[name] = kernel_times(x, lab)
    print(f"gradient max |kernel - plain| / max |plain| (limit {GRAD_REL}), "
          "and what planted faults read:")
    for name, (vp, rel, gerr, faults) in results.items():
        check(vp > 0 and rel <= VAL_RTOL, f"{name}: value")
        check_faults(name, gerr, faults)
    for name, labels in (("all-same", np.zeros(6)), ("all-distinct",
                                                     np.arange(6))):
        x, lab, vp, vk, gk, _ = case(2, 6, 8, labels)
        print(f"kernel {name}: value {vk} (plain {vp}), grad max "
              f"{float(gk.abs().max())}")
        check(vk == 0.0 and vp == 0.0 and float(gk.abs().max()) == 0.0, name)
    flag_t = times["flagship"]

    # ---- full-width flagship ----------------------------------------------
    def flagship(dtype="float32"):
        return ModelConfig(
            branches=(BranchConfig(kind="gaitset", modality="of"),
                      BranchConfig(kind="gaitset", modality="gray")),
            merge="sign_max", nclasses=74, compute_dtype=dtype)

    dcfg = DataConfig()
    mods = (("of", "gray"), (2, 1), (100.0, 1.0), 2)

    def raw_batch(b, ids, seed):
        g = torch.Generator(device=dev).manual_seed(seed)
        return {
            "raw_of": torch.randint(-3000, 3000, (b, 50, 60, 60), device=dev,
                                    generator=g, dtype=torch.int16),
            "raw_gray": torch.randint(0, 255, (b, 25, 60, 60), device=dev,
                                      generator=g, dtype=torch.uint8),
            "present_of": torch.ones(b, device=dev),
            "present_gray": torch.ones(b, device=dev),
            "labels": torch.as_tensor(np.repeat(np.arange(ids), b // ids),
                                      dtype=torch.int32, device=dev),
        }

    # ---- 2. embed ------------------------------------------------------------
    raw = raw_batch(128, 1, seed=1)
    embed = {}
    for dtype in ("float32", "bfloat16"):
        model = UGaitNet(flagship(dtype), seed=0)
        model.eval()
        iters = 10

        def embed_once(i):
            r = dict(raw)
            r["raw_of"] = raw["raw_of"] ^ i
            r["raw_gray"] = raw["raw_gray"] ^ i
            vols, flags, _ = preprocess_batch(r, *mods, 1, False, dcfg)
            return model(vols, flags)["signature"]

        with torch.inference_mode():
            sig = embed_once(0)
            check(tuple(sig.shape) == (128, 62, 256), f"signature {sig.shape}")
            check(bool(torch.isfinite(sig).all()), "signature not finite")
            acc = torch.zeros((), device=dev)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for i in range(1, iters + 1):
                acc += embed_once(i).sum()
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3 / iters
        check(bool(torch.isfinite(acc)), "embed checksum")
        embed[dtype] = ms
        print(f"embed {dtype}: preprocess + forward B=128 {ms:.2f} ms/batch,"
              f" {128e3 / ms:.1f} clips/s [{card}]")
        del model

    # ---- 3. train: the main path -------------------------------------------
    mcfg, tcfg = flagship(), TrainConfig()
    check(tcfg.triplet_kind == "batch_all", "default triplet kind")
    model = UGaitNet(mcfg, seed=0)
    state = init_state(model, tcfg)
    step = make_train_step(mcfg, tcfg)
    raw = raw_batch(40, 8, seed=2)
    mask_gen = torch.Generator().manual_seed(0)
    warmup, nsteps = 2, 7
    step_ms, losses = [], []

    def capture(net, store):
        """Keep the signature of net's next forward and its gradient."""
        def hook(_mod, _inp, out):
            store["sig"] = out["signature"].detach()
            out["signature"].register_hook(
                lambda g: store.__setitem__("grad", g.detach().clone()))
        return net.register_forward_hook(hook)

    kstore, pstore = {}, {}
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    for i in range(nsteps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = dict(raw)
        r["raw_of"] = raw["raw_of"] ^ i
        r["raw_gray"] = raw["raw_gray"] ^ i
        vols, flags, labels = preprocess_batch(r, *mods, 3, True, dcfg,
                                               generator=mask_gen)
        batch = Batch(tuple(vols), tuple(flags), labels)
        if i == nsteps - 1:     # the state the plain step starts from
            before = (copy.deepcopy(state.model.state_dict()),
                      copy.deepcopy(state.optimizer.state_dict()))
            hook = capture(state.model, kstore)
        state, metrics = step(state, batch)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append({k: float(v) for k, v in metrics.items()})
    hook.remove()
    launches = {"triplet_fwd": K.fwd_launches, "triplet_bwd": K.bwd_launches}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    check(tuple(vols[0].shape) == (120, 25, 60, 60, 2), "train batch")
    for m in losses:
        check(all(np.isfinite(v) for v in m.values()), f"train metrics {m}")
    check(launches == {"triplet_fwd": nsteps, "triplet_bwd": nsteps},
          f"kernel launches {launches} over {nsteps} steps")
    train_ms = float(np.median(step_ms[warmup:]))
    print(f"train: {nsteps} steps B=120, losses "
          f"{[round(m['loss'], 6) for m in losses]}, launches {launches}, "
          f"step {train_ms:.2f} ms (median of steps {warmup + 1}-{nsteps}; "
          f"warm-up {[round(t, 1) for t in step_ms[:warmup]]} ms), peak "
          f"{peak_gb:.1f} GB [{card}]")

    plain_model = UGaitNet(mcfg, seed=0)
    plain_model.load_state_dict(before[0])
    plain_state = init_state(plain_model, tcfg)
    plain_state.optimizer.load_state_dict(before[1])
    plain_tcfg = TrainConfig(triplet_kind="batch_all_xla")
    hook = capture(plain_model, pstore)
    _, plain_metrics = make_train_step(mcfg, plain_tcfg)(plain_state, batch)
    hook.remove()
    for k in ("loss", "triplet"):
        kv, pv = losses[-1][k], float(plain_metrics[k])
        print(f"train step {k}: kernel {kv:.7f} plain {pv:.7f} "
              f"(rel {abs(kv - pv) / abs(pv):.2e}, tol {STEP_RTOL})")
        check(abs(kv - pv) <= STEP_RTOL * abs(pv), f"train step {k}")
    # d loss / d signature in the two steps; it holds the CE term too, so a
    # planted fault reads as (its triplet gradient - the plain one) against
    # the whole plain gradient
    g_total, sig = pstore["grad"], pstore["sig"]
    w_tri = tcfg.loss_weights[0]
    s_ = sig.clone().requires_grad_(True)
    g_tri = w_tri * torch.autograd.grad(
        batch_all_triplet_loss(s_, labels, tcfg.margin), s_)[0]
    sig_err = rel_err(kstore["grad"], g_total)
    sig_faults = {f or "none": rel_err(
        g_total - g_tri + w_tri * analytic_grad(sig, labels, f, tcfg.margin),
        g_total) for f in (None,) + FAULTS}
    print(f"train step d loss / d signature {tuple(sig.shape)}, kernel step "
          f"vs plain step: max |grad| {float(g_total.abs().max()):.2e}, of "
          f"which the triplet term {float(g_tri.abs().max()):.2e}")
    check_faults("signature gradient", sig_err, sig_faults)

    # where the time of a float32 step goes (launch counts already read)
    def one_step():
        step(state, batch)
    events, wall = kernel_events(one_step, 2)
    by_name = {}
    for n, t in events:
        by_name[n] = by_name.get(n, 0.0) + t
    busy = sum(by_name.values())
    tri = sum(t for n, t in by_name.items()
              if any(k in n for k in FWD_KERNELS + BWD_KERNELS))
    print(f"train step profile (2 steps, float32): device busy "
          f"{busy / 2e3:.2f} ms/step of {wall / 2e3:.2f} ms wall (idle share "
          f"{1 - busy / wall:.3f}); triplet kernels {tri / 2e3:.4f} ms/step")
    for n, t in sorted(by_name.items(), key=lambda kv: -kv[1])[:10]:
        print(f"  {t / 2e3:9.3f} ms/step {t / busy:6.1%}  {n[:90]}")

    bf_cfg = flagship("bfloat16")
    bf_state = init_state(UGaitNet(bf_cfg, seed=0), tcfg)
    bf_step = make_train_step(bf_cfg, tcfg)
    bf_ms = []
    for i in range(nsteps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, m = bf_step(bf_state, batch)
        torch.cuda.synchronize()
        bf_ms.append((time.perf_counter() - t0) * 1e3)
        check(np.isfinite(float(m["loss"])), "bf16 train loss")
    bf_train_ms = float(np.median(bf_ms[warmup:]))
    print(f"train bfloat16: step {bf_train_ms:.2f} ms (median of steps "
          f"{warmup + 1}-{nsteps}, same batch, preprocess excluded) [{card}]")
    del bf_state

    # ---- 4. checks on the full-width forward --------------------------------
    model = state.model
    model.eval()
    g = torch.Generator(device=dev).manual_seed(3)
    of = torch.randn(4, 25, 60, 60, 2, device=dev, generator=g)
    gray = torch.randn(4, 25, 60, 60, 1, device=dev, generator=g)
    off = [torch.ones(4, device=dev), torch.zeros(4, device=dev)]
    with torch.inference_mode():
        a = model([of, gray], off)["signature"]
        b = model([of, torch.full_like(gray, dcfg.noise)], off)["signature"]
        check(torch.equal(a, b), "use_flag=0 differs from noise input")
        print("missing modality: use_flag=0 signature == noise-input "
              "signature (exact)")
        small = preprocess_batch(raw_batch(4, 2, seed=4), *mods, 1, False,
                                 dcfg)
        cpu_model = copy.deepcopy(model).to("cpu")
        on_cpu = cpu_model([v.cpu() for v in small[0]],
                           [f.cpu() for f in small[1]])

    def card_vs_cpu(tf32):
        torch.backends.cuda.matmul.allow_tf32 = tf32
        torch.backends.cudnn.allow_tf32 = tf32
        with torch.inference_mode():
            out = model(small[0], small[1])
        return {k: rel_err(out[k].cpu(), on_cpu[k])
                for k in ("signature", "classprob_logits")}
    cpu_err, tf32_err = card_vs_cpu(False), card_vs_cpu(True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for k in cpu_err:
        print(f"card vs CPU forward {k}: max |card - CPU| / max |CPU| "
              f"{cpu_err[k]:.2e} <= {CPU_REL}; with TF32 on {tf32_err[k]:.2e}"
              f" > {CPU_REL}")
        check(cpu_err[k] <= CPU_REL, f"card vs CPU {k}")
        check(tf32_err[k] > CPU_REL, f"card vs CPU {k}: TF32 passes the limit")

    # ---- 5. eval and 6. serve (no kernel of this repo on these paths) ----
    del state, plain_state, plain_model, model, cpu_model, before
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    gallery_ds, probe_ds = casia_sets()
    print(f"synthetic CASIA-B-shaped sets: 2 x {len(gallery_ds)} clips in "
          f"{time.perf_counter() - t0:.1f} s")
    K.reset_launch_counts()
    eval_model = UGaitNet(flagship(), seed=0)
    eval_res = eval_phase(eval_model, gallery_ds, probe_ds, card)
    del eval_model
    serve_res = serve_phase(lambda dt: UGaitNet(flagship(dt), seed=0),
                            gallery_ds, probe_ds, card)
    print(f"triplet kernel launches during eval and serve: "
          f"{K.fwd_launches}, {K.bwd_launches} (not on these paths)")

    # ---- 7. the trainer through the CLIs ------------------------------------
    sets = tempfile.mkdtemp(prefix="chip_smoke_sets_")
    try:
        gallery_dir = os.path.join(sets, "casia_gallery")
        probe_dir = os.path.join(sets, "casia_probe")
        gallery_ds.save(gallery_dir)
        probe_ds.save(probe_dir)
        del gallery_ds, probe_ds
        gc.collect()
        torch.cuda.empty_cache()

        def isolated_step_ms():
            """Phase 3's step loop (raw batch on the card, augmenting
            preprocess, synchronized steps), median of steps 3-7."""
            st = init_state(UGaitNet(mcfg, seed=0), tcfg)
            fn = make_train_step(mcfg, tcfg)
            gen = torch.Generator().manual_seed(0)
            times = []
            for i in range(nsteps):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                r = dict(raw)
                r["raw_of"] = raw["raw_of"] ^ i
                r["raw_gray"] = raw["raw_gray"] ^ i
                v, f, lab = preprocess_batch(r, *mods, 3, True, dcfg,
                                             generator=gen)
                fn(st, Batch(tuple(v), tuple(f), lab))
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
            return float(np.median(times[warmup:]))

        trainer_res = trainer_phase(card, gallery_dir, probe_dir,
                                    isolated_step_ms, train_ms)
    finally:
        shutil.rmtree(sets, ignore_errors=True)

    # launches: the trainer's fit (this slice's main path); by path, phase
    # 3's train steps too
    fit_launches = trainer_res["launches_fit"]
    kernels = [
        {"name": "triplet_fwd", "route": "cuda", "source": SRC,
         "replaces": f"{PALLAS}:159", "launches": fit_launches["triplet_fwd"],
         "launches_by_path": {"train_step": launches["triplet_fwd"],
                              "fit": fit_launches["triplet_fwd"]},
         "max_abs_err": fwd_err, "ms": flag_t["fwd_ms"],
         "plain_ms": flag_t["plain_fwd_ms"],
         "bound_ms": flag_t["fwd_bound"][0],
         "bound_by": flag_t["fwd_bound"][1],
         "library_ms": None},
        {"name": "triplet_bwd", "route": "cuda", "source": SRC,
         "replaces": f"{PALLAS}:187", "launches": fit_launches["triplet_bwd"],
         "launches_by_path": {"train_step": launches["triplet_bwd"],
                              "fit": fit_launches["triplet_bwd"]},
         "max_abs_err": bwd_err, "ms": flag_t["bwd_ms"],
         "plain_ms": flag_t["plain_bwd_ms"],
         "bound_ms": flag_t["bwd_bound"][0],
         "bound_by": flag_t["bwd_bound"][1],
         "library_ms": None},
    ]
    print(json.dumps({"card": card, "embed_ms_per_batch": embed,
                      "train_step_ms": train_ms,
                      "train_step_bf16_ms": bf_train_ms,
                      "train_device_busy_ms": busy / 2e3,
                      "train_wall_ms": wall / 2e3,
                      "train_peak_gb": peak_gb,
                      "triplet_times": times,
                      "dist_rel_err": dist_err,
                      "grad_rel_err": {k: {"kernel": v[2], **v[3]}
                                       for k, v in results.items()},
                      "signature_grad_rel_err": {"kernel": sig_err,
                                                 **sig_faults},
                      "card_vs_cpu_rel_err": {"tf32_off": cpu_err,
                                              "tf32_on": tf32_err},
                      "eval": eval_res, "serve": serve_res,
                      "trainer": trainer_res}))
    print(f"wall time {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
