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
     chunks, B not of 4) and degenerate cases, B = 256 and B = 512; and
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
     its bound.

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

import copy
import json
import subprocess
import sys
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

    def unit_scale(pcnt):
        """The backward's per-part scale for an upstream gradient of 1."""
        return torch.where(pcnt > 0, 1.0 / (pcnt.clamp_min(1.0) *
                                             pcnt.shape[0]),
                           torch.zeros_like(pcnt)).contiguous()

    def exact_checks(x, lab, margin=0.2):
        """The kernels against themselves on their own dist: symmetry and
        diagonal, integer counts and g, bitwise; and max |dist - plain| /
        max |plain|."""
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
        plain = pairwise_dist(e)
        return rel_err(dist, plain)

    pk = lambda n: np.repeat(np.arange(n[0]), n[1])          # P x K labels
    cases = [("flagship", 62, 120, 256, pk((12, 10))),
             ("small", 1, 12, 8, pk((3, 4))),
             ("rank2", None, 10, 8, pk((5, 2))),
             ("ragged", 3, 50, 40, np.arange(50) % 7),
             ("odd", 2, 37, 10, np.arange(37) % 5),
             ("B256", 16, 256, 256, np.arange(256) % 10),
             ("B512", 4, 512, 256, np.arange(512) % 10)]
    results, times = {}, {}
    dist_err = {}
    for name, parts, b, d, labels in cases:
        x, lab, vp, vk, gk, gp = case(parts, b, d, labels)
        rel = abs(vk - vp) / abs(vp)
        gerr = rel_err(gk, gp)
        dist_err[name] = exact_checks(x, lab)
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

    kernels = [
        {"name": "triplet_fwd", "route": "cuda", "source": SRC,
         "replaces": f"{PALLAS}:159", "launches": launches["triplet_fwd"],
         "max_abs_err": fwd_err, "ms": flag_t["fwd_ms"],
         "plain_ms": flag_t["plain_fwd_ms"],
         "bound_ms": flag_t["fwd_bound"][0],
         "bound_by": flag_t["fwd_bound"][1],
         "library_ms": None},
        {"name": "triplet_bwd", "route": "cuda", "source": SRC,
         "replaces": f"{PALLAS}:187", "launches": launches["triplet_bwd"],
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
                      "eval": eval_res, "serve": serve_res}))
    print(f"wall time {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
