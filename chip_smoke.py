"""Drive the PyTorch port's main path on one CUDA card and hold its kernels
against their plain PyTorch versions.

    python3 chip_smoke.py

Run from the repository root; it needs one CUDA card and nvcc, and exits
non-zero without them.  It builds the kernels of ``ugaitnet_tpu_torch/csrc``
and runs, at the full width of the flagship (two GaitSet branches at
channels (32, 64, 128), part_dim 256, 62 parts, sign_max merge, 74 classes):

  1. kernels vs plain: the CUDA batch-all triplet forward and backward
     (the value against the plain reduction over the kernel's own dist, the
     dist against the plain one, the gradient against the plain backward)
     against ``ops/triplet.py`` on the same CUDA tensors, at the flagship
     (62, 120, 256), small, ragged (D not a multiple of the kernels'
     chunks, B not of 4) and degenerate cases, B = 256 and B = 512, the
     2D / 3D CNN nets' rank-2 (120, 512) signature with 8 x 15 labels, and
     phase 7's two validation batches (62, 40, 256) with their labels
     (the second wrapped to full size, no P x K pattern); and
     the kernels against themselves, exactly: dist bitwise symmetric with
     a zero diagonal, the per-part counts equal to the active triplets
     torch counts over the kernel's own dist, and the kernel's g equal,
     bitwise, to those integer counts times the scale; dist against the
     plain pairwise_dist; kernel and plain times at the flagship shape,
     B = 256 and B = 512;
 1b. the GaitSet stage tail (``csrc/stage_tail.cu``: 2x2 max pool, leaky
     ReLU, set max over T) against the plain chain (``ops/pooling.py:
     stage_tail``) on the same CUDA tensors, float32 and bfloat16: the
     forward bitwise (a and s) at the flagship's stage 1 and 2 (B = 120,
     with tied clips), the encode batch = the prototype's (64, 32) and
     (32, 64) and its (16, 128) (B = 128), ragged shapes (odd H and W; T =
     1 with W = 12; C = 7 with W = 6) and all-constant clips; the gradient
     against the plain autograd chain on tied inputs within 1e-6 of max
     (bitwise expected), with three planted faults (ties routed to the first
     max, the set max's gradient dropped, the negative slope alone at p ==
     0) that must read above it; kernel and plain times (CUDA events)
     against the bytes bound at the flagship's and the prototype's shapes;
 1c. the 3x3 conv kernel (``csrc/conv3x3.cu``, bf16 in and out, float32
     accumulation) against its plain version (``ops/conv3x3.py:conv3x3``)
     on the same CUDA tensors: the flagship's a_conv6 (3200, 128, 16, 16)
     and a_conv2 (3200, 32, 64, 64) with the seed-0 weights, their tensor-
     parallel halves (Ci 64 and 16), the tiny flagship's 8 -> 8 at 64x64
     and 16 -> 16 at 16x16, ragged shapes (Ci 7 -> Co 5 at 5x5, H != W,
     N = 1 with W > 128 and Co > 128) and all-zero and all-constant frames,
     each element within one bf16 ulp of the plain value plus CONV_SUM_REL
     x (|x| conv |w|); three planted faults (a border tap dropped, Ci and
     Co of the weight swapped, a tap shifted by a column) must read above
     that; kernel, plain and cuDNN (bf16 ``F.conv2d``, held to the same
     limit) times against the bound; the flagship shapes and their halves
     must take the Hopper variant (TMA ring + wgmma), the ragged ones the
     general one, as the per-variant launch counters read; each timed
     kernel line gives its share of the bound, its factor to cuDNN and the
     time of the general variant at the same shape (the earlier mma.sync
     kernel, held to the same limit), measured here as ``earlier_ms``;
 1d. the probes (``csrc/probes.cu``): mm_fwd at M = 262,144, K in (576,
     1152, 2304) against its plain version within the same limit, timed
     beside cuBLAS (bf16 ``torch.matmul``), with its share of the bound,
     its factor to cuBLAS and the earlier kernel's time, quoted
     (EARLIER_MM_MS: that kernel is no longer built); scale2 bitwise
     against x * 2 on the prototype's (T*32*32*32, 128) view of a (128, 25,
     32, 32, 32) bf16 tensor (the vec variant, as its counter must show),
     at an unaligned offset of x and y, and with x and y at offsets apart
     (the scalar variant); a planted fault must fail the check; timed in
     turns with x * 2 and the scalar variant, with its share of the bound,
     its factor to x * 2 and the earlier kernel's time, quoted
     (EARLIER_SCALE2_MS), and with the transpose;
 1e. the 3D CNN's first-conv weight gradient (``csrc/conv3d_wgrad.cu``,
     float32 FFMA) at its two shapes (120 x {2, 1} x 25 x 60 x 60 as the
     NDHWC view of the clip, 64 outputs, 3 x 5 x 5, stride 1 x 2 x 2):
     dW and db against the float64 plain version within WGRAD_REL of max,
     with gy as autograd hands it (NCDHW) and channels-last; three planted
     faults (a tap shifted, one (n, t) slab skipped, the bias left out)
     must read above it; two launches bitwise; kernel, plain (float32) and
     cuDNN (``convolution_backward``, dW and db alone) times against the
     bound;
  2. embed: preprocess_batch on raw int16 OF / uint8 gray at B = 128, then
     the forward, in float32 and bfloat16 (inputs perturbed every batch);
     the bf16 forward launches the conv kernel exactly 4 times (a_conv2
     and a_conv6 of both branches), the fp32 one never; the bf16
     signature against the same batch through the ``F.conv2d`` route
     (``cudnn_conv``), read through the sign_max merge within
     ROUTE_REL, and the bf16 ms both ways in turns;
  3. train (the main path): raw B = 40 (8 ids x 5) -> preprocess with the
     flagship's augmentation (shift/zoom/flip, brightness and channel
     shift, the OF clip coin) and expand 3 (B = 120) -> Adam steps with
     the batch_all kernel (2 warm-up steps, then the median of 5); launch
     counts are set to 0 just before and read just after (the stage tail
     exactly 4 + 4 per step: 2 branches x stages 1-2); one step from
     the same state and the same augmented batch with the plain triplet
     must give the same losses and the same gradient at the signature, and
     one with the plain stage tail (deterministic cuDNN) equal losses and
     every parameter gradient within 1e-2 of its max (bitwise expected);
     the fp32 and bf16 step ms and peak GB with the stage-tail kernels and
     with the plain tail, in turns; neither step launches the conv kernel
     (it has no backward);
  4. checks: use_flag = 0 equals a noise-filled input exactly, and the card's
     forward agrees with the CPU's on a small batch (and with TF32 on, does
     not), read through the sign_max merge (``sign_max_rule``): the merge's
     inputs, and the outputs with the CPU's picks, within 3e-4 of max;
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
     bfloat16 (the bf16 service launches the conv kernel 4 times per
     identify_raw, and its labels on 128 probes equal those of the
     ``F.conv2d`` route outside near ties); 128 rows enrolled in place, one
     label removed, self-queries
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
     async save and the validation time;
  8. int8 and export, over phase 5's sets (reloaded packed): the int8
     cross term (``torch._int_mm``) against an exact int64 CPU product at
     P = 128, 1 and 8 x G = 2,200 x D = 15,872; the card's int8 d^2 on the
     1,100 probes x 1,100 gallery codes against its formula on the CPU from
     the same int8 codes and scales (exact cross term): within 1e-6 of
     |p|^2 + |g|^2 with the CPU's norms, bitwise with the card's, and
     planted faults (|g|^2 from dequantized codes, scales 10 % off or per
     probe row, the two scales in the other order) that must not be;
     the int8-gallery service's
     identify_raw labels against the float32 service's, which must agree
     wherever the float64 k-th / (k+1)-th neighbor gap is wider than twice
     the probe's largest measured int8 d^2 error, with every d^2 inside its
     hard int8 bound, and a planted fault (the gallery's scales applied per
     probe row) that must break that rule; 128 rows enrolled in place into
     all three int8 buffers, a label removed, self-queries; identify_codes
     at bucket 128 on 65,536- and 262,144-row int8 galleries against
     their bound; quantized=True calibrated on 8 gallery clips: cosine
     >= 0.99 to the float32 codes on 128 probes, a_conv2's int32 sums card
     == CPU bitwise, identify_raw per bucket against phase 6; export_encoder
     of the float32 and the int8 service at buckets (1, 8, 32, 128), a
     fresh process that loads both artifacts without model code and must
     reproduce the services' codes (the fp32 artifact, whose program calls
     the stage-tail kernel through the custom op ugaitnet::stage_tail,
     bitwise, with its 4 launches per bucket-128 encode counted; the int8
     program calls no custom op), a CPU load of a cuda artifact that must
     raise, and cli.export_model on phase 7's 'best';
  9. the train CLI's 2D CNN (--no-gaitset) and 3D CNN (--no-gaitset
     --use3d) nets at full width: forward card vs CPU within 3e-4 (and not
     with TF32 on), 3 Adam steps at B = 120 with finite losses and their
     step times, the last step again with the plain triplet from the same
     state, batch and dropout masks (losses within 1e-5, the signature
     gradient against planted faults, as in phase 3), the Keras L2 term
     card vs CPU within 1e-6 relative, and
     the int8 encode's cosine to float32 >= 0.99 on 128 clips; the 3D
     CNN's steps launch the first-conv weight-gradient kernel (1e) exactly
     twice a step (conv0 of each branch), the 2D CNN's never;
 10. the rest of the model and loss surface at the flagship's width
     (deterministic cuDNN): casenet C with postriplet 2, aux heads and
     dropcode 0.4, 3 Adam steps at B = 120 through the triplet kernel
     at (62, 120, 256) on the per-row L2 code, the last again with the
     plain triplet (losses within 1e-6, the signature gradient against
     planted faults), then one postriplet-1 step likewise, with exact
     launch counts; the head alone (``_head_forward`` on the card's
     branch embeddings) card vs CPU within 3e-5 (and not with TF32 on);
     semi-hard and hard at (62, 120, 256), contrastive_aux at (120,
     15,872), focal at (120, 74) and verif_pair, each card vs CPU (value,
     gradient, near ties of the selecting kinds counted) and timed
     forward + backward; a flagship step with and without remat
     (gradients equal, peak memory and step ms); the Siamese pair step on
     the 2D CNN net, 2 x 60 clips, margin 0.5;
 11. joint training, warm starts and the sweep at the flagship's width, on
     phase 7's CASIA-B-shaped set and a TUM-GAID-shaped one (150 subjects x
     2 videos x 2 subsequences, gaits n / b / s): ``cli.train --datadir
     --datadir2 --normstats`` for 2 epochs with 224 classes (the joint
     set's labels, gaits, video ids and dataset_source against the +305 /
     +3 rule; norm_stats.npz with one row per source; one raw batch of both
     sources standardized card vs CPU within 1e-6, and not with the two
     source rows swapped; exact triplet launches; finite losses); a
     fine-tune on the CASIA-B-shaped set with ``--initnet <joint>
     --initepoch best --nclasses 74`` (branches equal the joint best
     bitwise, the 74-wide head the seed's init; the same command again
     resumes from ckpt/1 bitwise without a warm start); ``--initbranch
     gray=<joint>@of`` (the gray branch is the joint OF branch's where
     shapes match, the OF branch untouched); ``cli.sweep`` over
     lr=1e-4,5e-5 for 1 epoch each (each point's dir and its own records);
     ``cli.evaluate`` and ``cli.export_model`` of the joint best with its
     two-row standardization.
 12. multi-device training over torch.distributed (last): the global
     data-parallel form on a gloo world of 2 ranks sharing the card (asked
     for by an explicit device list), the flagship at B = 120 (60 rows per
     rank) from phase 3's first augmented batch and seed-0 state: losses
     within 1e-5 of the one-process step, the averaged gradient within
     1e-2 of its max (three planted faults must fail: the gather without
     autograd, the local L2 inside the global form, no world factor) and
     within 1e-4 of the one-process step made to take the ranks' sign_max
     picks (the gap's cause: a pick at a near tie, counted; the step fed
     the ranks' signatures and the hinges that change side read too), the
     ranks' parameters bitwise equal after 3 Adam steps, exactly 1 + 1
     triplet launches per rank per step at (62, 120, 256), step ms and
     peak GB per rank; the per-shard form differs from the global one
     under reference L2 and agrees within 1e-5 under feature L2; an NCCL
     world of 1 (a one-card machine holds no more NCCL ranks) bitwise
     equal to the one-process step; sequence parallelism at (dp, sp) =
     (1, 2), T 25 -> 26, against the one-process gradient; the MoE
     flagship (4 experts) in one process at B = 120 (step ms, aux), then
     expert parallelism at (1, 2) against the one-process MoE gradient at
     B = 40 (cut: both ranks hold the whole batch on the one card).
 13. tensor and pipeline parallelism, mesh serving, evaluate --dp and
     trace profiling (last): tensor parallelism at (dp, mp) = (1, 2) on a
     gloo world of 2 ranks sharing the card, each with half of every split
     conv, 31 of the 62 parts and half the classifier's rows, on phase 12's
     global batch: losses within 1e-5 of the one-process step, the whole
     gradient (shards joined) within 1e-2 of its max, and three planted
     faults above it (no all-reduce after the row-parallel convs, an
     identity backward in place of copy_in, the strip's triplet term
     without its 31/62 share); each rank's kernel value on its (31, 120,
     256) strip against the plain reduction over the kernel's own dist
     (1e-5), exactly 1 + 1 launches per rank per step.  Pipeline
     parallelism on [cuda:0, cuda:0] against the same step and limits, a
     planted fault (the branch gradient dropped), 1 + 1 launches at (62,
     120, 256).  Mesh serving and the sharded kNN on two gloo ranks over
     phase 6's 65,536-row gallery, float32 and int8: labels equal the
     one-card service's outside near ties, identify_codes device ms per
     rank beside the one card's.  cli.evaluate --dp 2 on phase 5's sets and
     phase 7's best: Rank-1 equal to phase 7's one-process evaluate, codes
     within 1e-5 of max off the elements where a rank's sign_max pick
     differs from the one process's, and a planted fault (batch-axis L2
     local to each rank) above it.  summarize_trace over two train
     steps, traced after a third that warms the profiler up: the top 10
     kernels, the three triplet kernels once each and the two stage-tail
     kernels 4 times each per step, as the launch counters count them.
 14. convergence to Rank-1 (last, seed 0 as the JAX artifact, so its
     datasets are the artifact's bitwise): the port's
     ``eval/synthetic_rank1.py:run`` on the card at 64 identities (576
     train and 576 eval clips, 192 probes), through ``Trainer.fit`` (P x K
     sampler, expand_level 2, plateau lr, early stop, checkpoints), the
     fp32 encode, and the camera-pair protocol with the pooled EER for the
     full / of_only / gray_only probe sweeps.  (a) The tiny twin
     (channels (8, 8, 16), part_dim 16, the JAX artifact's configuration,
     whose numbers are printed beside it, not held): Rank-1 subseq and
     video >= 0.9, EER finite and <= 0.25, the three sweeps, and a
     single-modality sweep's Rank-1 more than 0.02 below the full one's or
     its EER more than 0.02 above (``tests/test_convergence_rank1.py``'s
     limits).  (b) The flagship at full width: the same Rank-1 and EER
     limits (the sensitivity clause printed, not held), then its trained
     weights re-encoded in bf16 without autograd (the conv kernel's path)
     and held to the same limits, with the bf16 - fp32 difference of
     every sweep.  Launch counts exact on each path (counts set to 0 at
     the fit and at the encode): the triplet kernels once per train step
     and validation batch (backward once per step), the stage tail 2 per
     branch forward on the card and 4 per step backward, the conv kernel
     0 in every fit and fp32 encode and 4 per bf16 forward, at the variant
     ``plan`` chooses for a_conv2 and a_conv6; the kernels against their
     plain versions on the path's own inputs (the first of each shape:
     triplet values and gradient, stage tail bitwise and its gradient,
     conv per element within its limit).  Prints the per-epoch train and
     validation losses, the fit's ms per step, the train and encode
     seconds and the phase's; writes each run's results under
     ``chiprun_out/phase14/``.  Alone: ``python3 tools/chip_phase14.py``.

Gradient limits scale with each case, and every run reads planted faults
(a backward without the g^T term, with the negative role's sign flipped,
or returning zeros) against them: a limit that passes a fault fails the run.

The compiler's report (-Xptxas -v) is printed, registers and static shared
memory per instantiation as a table, and a kernel that spills registers
fails the run.

Stage-tail launches are counted on the main paths too: 2 per GaitSet branch
forward on the card in phase 5's encode and phase 7's fit (4 per train
step backward), 4 per identify_raw call in phase 6, 4 per encode of phase
8's fp32 artifact in a fresh process, 4 + 4 per step over phase 13's two
traced steps, in the counters and in the trace's own events, and in
phase 14's fits and encodes.  The model's
stage tails take the plain chain on the card only inside ``plain_tail()``
(the comparison runs above).

Prints the card (nvidia-smi name and power limit), one JSON line with every
kernel's launches, error, times and bound, and as the last line
{"ok": true, "device": {...}}.  Any failed check raises: exit code != 0.
TF32 is off for matmuls and convolutions throughout (parity), apart from
the one forward of phase 4 that shows the card-vs-CPU limit would catch it.
"""

import contextlib
import copy
import dataclasses
import gc
import importlib.util
import io
import json
import math
import os
import re
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
PEAK_INT8 = 1979e12             # dense int8 tensor-core ops/s

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
# int8 encode vs float32 codes: per-row cosine (the JAX package's limit,
# tests/test_quantize.py)
COS_MIN = 0.99
# int8 d^2 on the card vs its formula on the CPU from the same codes and
# scales: max |card - CPU| <= INT8_D2_REL (|p|^2 + |g|^2); the norms are
# float32 sums in another order, and d^2 is rounded on their scale
INT8_D2_REL = 1e-6
# an exported program's codes vs its service's encode_raw on the same feed:
# max |artifact - service| <= EXPORT_REL * max |service| (the same aten ops
# on the same weights; padding rows differ, which no code depends on).  The
# sign_max merge turns any rounding difference (TF32 left on, say) into an
# O(1) one wherever two branches' values nearly cancel, so this limit holds
# only for the same arithmetic: bitwise in practice.
EXPORT_REL = 1e-6
# a fresh process that loads exported artifacts without model code, encodes
# a saved feed with each (TF32 off, as this process runs the services) and
# prints the stage-tail launches of each encode (0 where the artifact calls
# no custom op, which leaves the op's module unimported) and the port
# modules it imported
EXPORT_BOOT = """
import json, os, sys
import numpy as np
import torch
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
sys.path.insert(0, sys.argv[1])
from ugaitnet_tpu_torch.eval.export import ExportedEncoder
raw = dict(np.load(sys.argv[2]))
launches = {}
for path in sys.argv[3:]:
    enc = ExportedEncoder(path)
    st = sys.modules.get("ugaitnet_tpu_torch.ops.cuda.stage_tail")
    if st is not None:
        st.reset_launch_counts()
    np.save(os.path.join(path, "codes.npy"), enc.encode(raw))
    torch.cuda.synchronize()
    launches[path] = [st.fwd_launches, st.bwd_launches] if st else [0, 0]
print(json.dumps(launches))
print(json.dumps(sorted(m for m in sys.modules
                        if m.startswith("ugaitnet_tpu_torch"))))
"""
# the port modules a loading process may import: the stage-tail op's
# module and what it imports (kernel code; no model code)
EXPORT_OP_MODULES = {"ugaitnet_tpu_torch.ops", "ugaitnet_tpu_torch.ops.cuda",
                     "ugaitnet_tpu_torch.ops.cuda.stage_tail",
                     "ugaitnet_tpu_torch.ops.cuda.build",
                     "ugaitnet_tpu_torch.ops.pooling"}

SRC = "ugaitnet_tpu_torch/csrc/triplet_kernel.cu"
FWD_KERNELS = ("triplet_fwd_kernel",)
BWD_KERNELS = ("triplet_rows_kernel", "triplet_finish_kernel")
PALLAS = "ugaitnet_tpu/ops/pallas/triplet_kernel.py"
TAIL_SRC = "ugaitnet_tpu_torch/csrc/stage_tail.cu"
TAIL_PALLAS = "benchmarks/proto_tail.py:38"
TAIL_FWD_KERNELS = ("stage_tail_fwd_kernel",)
TAIL_BWD_KERNELS = ("stage_tail_bwd_kernel",)
# the stage tail's gradient vs the plain autograd chain on the same inputs:
# max |kernel - plain| <= TAIL_GRAD_REL * max |plain|.  0 is expected in
# float32 and bfloat16 (the kernel rounds as torch's autograd formulas do,
# one rounding per op); each planted fault must read above the limit
TAIL_GRAD_REL = 1e-6
TAIL_FAULTS = ("ties to the first max", "g_s dropped", "x0.3 at p == 0")
TAIL_ALPHA = 0.3
CONV_SRC = "ugaitnet_tpu_torch/csrc/conv3x3.cu"
CONV_PALLAS = "benchmarks/proto_conv.py:50"        # _p1_kernel (a_conv6)
CONV_PALLAS_P2 = "benchmarks/proto_conv.py:135"    # _p2_kernel (a_conv2)
PROBES_SRC = "ugaitnet_tpu_torch/csrc/probes.cu"
MM_PALLAS = "benchmarks/proto_mm.py:33"
COPY_PALLAS = "benchmarks/proto_mm.py:72"
# the earlier mm_fwd kernel's times (mma.sync, synchronous staging; H100
# 80GB HBM3, 700 W, CUDA events over 20 launches, PERF.md section 6),
# quoted beside this run's in phase 1d's print lines and nowhere else
EARLIER_MM_MS = {576: 0.4055, 1152: 0.8410, 2304: 1.6006}
# the earlier scale2 kernel's time (a grid-stride loop over at most 8 CTAs
# an SM, one 16-byte load in flight a thread; H100 80GB HBM3, 700 W, CUDA
# events over 20 launches at the same shape, PERF.md section 6), quoted
# beside this run's in phase 1d's print line and nowhere else
EARLIER_SCALE2_MS = 0.1519
# the cases of phase 1c that must take the Hopper variant
HOPPER_CASES = ("a_conv6", "a_conv2", "a_conv6 TP half (Ci 64)",
                "a_conv2 TP half (Ci 16)")
CONV_KERNELS = ("conv3x3_fwd_kernel",)
WGRAD_SRC = "ugaitnet_tpu_torch/csrc/conv3d_wgrad.cu"
# phase 1e: the first-conv weight gradient against float64, per tensor:
# max |kernel - float64| <= WGRAD_REL * max |float64|.  float32 sums over
# up to 2.16 M positions read ~1e-6 (H100, PERF.md section 6); a tap
# shifted, a slab skipped or the bias left out read 1e-2 and more
WGRAD_REL = 1e-5
WGRAD_FAULTS = ("tap shifted", "slab skipped", "bias left out")
# the two first convs of the 3D CNN: input channels, and the shapes
WGRAD_CELL = {"of": 2, "gray": 1}
WGRAD_SHAPE = (120, 25, 60, 60, 64)         # N, T, H, W, Co
WGRAD_KERNEL, WGRAD_STRIDE = (3, 5, 5), (1, 2, 2)
PEAK_BF16 = 989e12              # dense bf16 tensor-core FLOP/s
# the conv kernel (and mm_fwd) against its plain version on the same
# inputs, per element: |kernel - plain| <= ulp(plain) + CONV_SUM_REL * S,
# S = (|x| conv |w|) at that element in float32.  Both sum exact bf16
# products in float32, in other orders: the sums differ by a few float32
# roundings of S (K <= 1,152 terms; K eps32 S is 7e-5 S at worst), and
# after the one rounding to bf16 by one ulp where that moves a value
# across a rounding boundary.  Each planted fault must read above it.
CONV_SUM_REL = 2.0 ** -12
CONV_FAULTS = ("border tap dropped", "Ci and Co swapped",
               "tap shifted a column")
# the bf16 forward through the conv kernel against the same forward
# through F.conv2d (cuDNN, bf16): the two may round a_conv2 and a_conv6
# apart by an ulp, and eight more bf16 layers carry that on; read through
# the sign_max merge (sign_max_rule) on the merge inputs and the outputs
# with the cuDNN route's picks, each within ROUTE_REL of max.  Measured:
# 0 on an H100 (the two routes gave the same bits at B = 128), 2.1e-3
# between the plain conv and F.conv2d on the CPU (tests/test_torch_
# conv3x3.py)
ROUTE_REL = 1e-2


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


def bound(nbytes, nops, peak_ops=PEAK_FP32):
    t_bytes, t_ops = nbytes / PEAK_BYTES, nops / peak_ops
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def bound_int8(nbytes, nops):
    return bound(nbytes, nops, PEAK_INT8)


def rel_err(got, want):
    """max |got - want| over max |want|."""
    return float((got - want).abs().max() / want.abs().max())


# card vs CPU through the flagship's sign_max merge.  The merge takes, per
# element, the branch value of the larger magnitude, and the two branches'
# values often have opposite signs.  Where the two magnitudes lie within
# rounding of a tie, the card and the CPU may take different branches: the
# element then moves by up to twice its value, and through the batch-axis
# L2 its whole column follows, so one such pick reads O(1) of max.  Phase
# 3's steps are not bitwise repeatable on the card, so phase 4's weights,
# and with them its near ties, differ from run to run.  A reading through
# the merge is therefore held in two parts, each within CPU_REL of max: the
# merge's inputs (the gated branch values) card vs CPU, and the card's
# outputs, its merge made to take the CPU's picks, against the CPU's.  A
# pick can then differ only where the CPU's two magnitudes lie within twice
# the inputs' limit of a tie; the readings say how near the switched ones
# lay.  With no pick switched, the forced forward is the plain one.
class SignMaxTap:
    """Stands in for the two-branch sign_max merge inside a ``with`` block:
    records each call's inputs and picks (True: the first branch) on the
    host, or, given ``force`` (one picks tensor per call), takes those
    picks in place of its own."""

    def __init__(self, force=None):
        self.calls, self.force = [], force

    def __enter__(self):
        from ugaitnet_tpu_torch.ops import fusion
        self._merges, self._merge = fusion.MERGES, fusion.MERGES["sign_max"]
        fusion.MERGES["sign_max"] = self._call
        return self

    def __exit__(self, *exc):
        self._merges["sign_max"] = self._merge

    def _call(self, embeddings):
        first, second = embeddings
        picks = first.abs() >= second.abs()
        if self.force is not None:
            picks = self.force[len(self.calls)].to(picks.device)
        self.calls.append((first.detach().cpu(), second.detach().cpu(),
                           picks.cpu()))
        return torch.where(picks, first, second)


def sign_max_rule(run_card, want, cpu_calls):
    """Card vs CPU through the sign_max merge, read in the two parts
    above.  ``want``: {output: CPU tensor}; ``cpu_calls``: the CPU
    forward's ``SignMaxTap`` calls; ``run_card()`` gives the card's outputs
    under the same keys.  Returns the readings; ``passes(r, k)`` is the
    rule for output k."""
    with SignMaxTap() as tap:
        got = run_card()
    with SignMaxTap(force=[c[2] for c in cpu_calls]):
        forced = run_card()
    r = {"raw": {k: rel_err(got[k].cpu(), v) for k, v in want.items()},
         "forced": {k: rel_err(forced[k].cpu(), v) for k, v in want.items()},
         "branches": 0.0, "tie": 0.0, "switched": 0, "picks": 0, "near": 0}
    for (a, b, p), (ga, gb, gp) in zip(cpu_calls, tap.calls):
        err = max(rel_err(ga, a), rel_err(gb, b))
        r["branches"] = max(r["branches"], err)
        gap = (a.abs() - b.abs()).abs() / torch.maximum(a.abs().max(),
                                                        b.abs().max())
        switched = gp != p
        r["switched"] += int(switched.sum())
        r["picks"] += p.numel()
        # picks that rounding of the merge inputs' size could switch
        r["near"] += int((gap <= 2 * err).sum())
        if switched.any():
            r["tie"] = max(r["tie"], float(gap[switched].max()))
    return r


def passes(r, k):
    return max(r["forced"][k], r["branches"]) <= CPU_REL


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


def capture(net, store):
    """Keep the signature of net's next forward and its gradient."""
    def hook(_mod, _inp, out):
        store["sig"] = out["signature"].detach()
        out["signature"].register_hook(
            lambda g: store.__setitem__("grad", g.detach().clone()))
    return net.register_forward_hook(hook)


def kernel_vs_plain_step(name, mcfg, tcfg, before, batch, kstore,
                         kernel_losses, rtol=STEP_RTOL):
    """One step with the plain triplet from the state a kernel step started
    from (``before``: model and optimizer state dicts, step count), on the
    same batch: the losses within ``rtol`` of the kernel step's, and
    d loss / d signature (held in ``kstore`` by ``capture``) against the
    plain step's, with planted faults read against GRAD_REL.  The gradient
    holds the CE term too, so a fault reads as (its triplet gradient - the
    plain one) against the whole plain gradient.  Returns (the kernel's
    error, the faults' readings)."""
    from ugaitnet_tpu_torch.models.network import UGaitNet
    from ugaitnet_tpu_torch.ops.triplet import batch_all_triplet_loss
    from ugaitnet_tpu_torch.train.train_step import (init_state,
                                                     make_train_step)
    net = UGaitNet(mcfg, seed=0)
    net.load_state_dict(before[0])
    state = init_state(net, tcfg)
    state.optimizer.load_state_dict(before[1])
    state.step = before[2]                  # the dropout masks' key
    pstore = {}
    hook = capture(net, pstore)
    plain_tcfg = dataclasses.replace(tcfg, triplet_kind="batch_all_xla")
    _, plain_metrics = make_train_step(mcfg, plain_tcfg)(state, batch)
    hook.remove()
    for k in ("loss", "triplet"):
        kv, pv = kernel_losses[k], float(plain_metrics[k])
        print(f"{name} step {k}: kernel {kv:.7f} plain {pv:.7f} "
              f"(rel {abs(kv - pv) / abs(pv):.2e}, tol {rtol})")
        check(abs(kv - pv) <= rtol * abs(pv), f"{name} step {k}")
    g_total, sig = pstore["grad"], pstore["sig"]
    w_tri = tcfg.loss_weights[0]
    s_ = sig.clone().requires_grad_(True)
    g_tri = w_tri * torch.autograd.grad(
        batch_all_triplet_loss(s_, batch.labels, tcfg.margin), s_)[0]
    sig_err = rel_err(kstore["grad"], g_total)
    sig_faults = {f or "none": rel_err(
        g_total - g_tri + w_tri * analytic_grad(sig, batch.labels, f,
                                                tcfg.margin),
        g_total) for f in (None,) + FAULTS}
    print(f"{name} step d loss / d signature {tuple(sig.shape)}, kernel "
          f"step vs plain step: max |grad| {float(g_total.abs().max()):.2e},"
          f" of which the triplet term {float(g_tri.abs().max()):.2e}")
    check_faults(f"{name} signature gradient", sig_err, sig_faults)
    return sig_err, sig_faults


@contextlib.contextmanager
def plain_tail():
    """Within the block the GaitSet branches' stage tails take the plain
    chain on the card (the comparison runs of phases 1b and 3 only; nothing
    on the main path does this)."""
    from ugaitnet_tpu_torch.models import gaitset as GS
    from ugaitnet_tpu_torch.ops.pooling import stage_tail
    orig = GS.stage_tail_cuda
    GS.stage_tail_cuda = stage_tail
    try:
        yield
    finally:
        GS.stage_tail_cuda = orig


@contextlib.contextmanager
def tail_counts(store):
    """The stage-tail launches of the block (counts set to 0 at its start)
    and the GaitSet branch forwards that ran on the card; fills ``store``
    with tail_fwd, tail_bwd and branch_forwards."""
    from ugaitnet_tpu_torch.models import gaitset as GS
    from ugaitnet_tpu_torch.ops.cuda import stage_tail as ST
    calls = [0]

    def make(forward):
        def call(self, x, *a, **kw):
            calls[0] += x.device.type == "cuda"
            return forward(self, x, *a, **kw)
        return call

    ST.reset_launch_counts()
    with wrapped(GS.GaitSetBranch, "forward", make):
        yield store
    store.update(tail_fwd=ST.fwd_launches, tail_bwd=ST.bwd_launches,
                 branch_forwards=calls[0])


def tail_with_fault(x, batch, fault, alpha=TAIL_ALPHA):
    """The plain stage tail with one planted fault in its gradient (the
    forward values are the plain ones): ties routed to one element, in the
    window (F.max_pool2d) and over T (max's index); the set max's gradient
    dropped; or the negative slope alone at p == 0."""
    import torch.nn.functional as F
    from ugaitnet_tpu_torch.ops.pooling import max_pool_2x2, stage_tail
    if fault is None:
        return stage_tail(x, batch, alpha)
    if fault == "ties to the first max":
        h, w = x.shape[-2:]
        p = F.max_pool2d(x[..., : h // 2 * 2, : w // 2 * 2], 2)
        a = torch.maximum(p, alpha * p)
        return a, a.reshape(batch, -1, *a.shape[1:]).max(dim=1).values
    p = max_pool_2x2(x)
    if fault == "g_s dropped":
        a = torch.maximum(p, alpha * p)
        return a, torch.amax(a.detach().reshape(batch, -1, *a.shape[1:]), 1)
    a = torch.where(p > 0, p, alpha * p)              # x0.3 at p == 0
    return a, torch.amax(a.reshape(batch, -1, *a.shape[1:]), 1)


def tail_grad(x, batch, g_a, g_s, fault="kernel"):
    """dL/dx of the stage tail for output gradients (g_a, g_s): through the
    kernels (``fault="kernel"``), the plain chain (None) or a planted
    fault."""
    from ugaitnet_tpu_torch.ops.cuda import stage_tail as ST
    xq = x.detach().clone().requires_grad_(True)
    a, s = (ST.stage_tail_cuda(xq, batch, TAIL_ALPHA) if fault == "kernel"
            else tail_with_fault(xq, batch, fault))
    outs, grads = zip(*[(o, g) for o, g in ((a, g_a), (s, g_s))
                        if o.requires_grad])      # s is detached in a fault
    return torch.autograd.grad(outs, xq, grads)[0]


def tail_bytes(x, batch):
    """Bytes of the forward (x read; a, s written) and of the backward (x,
    a, s, g_a, g_s read; dx written)."""
    n, c, h, w = x.shape
    e = x.element_size()
    xb = x.numel() * e
    ab = n * c * (h // 2) * (w // 2) * e
    sb = batch * c * (h // 2) * (w // 2) * e
    return xb + ab + sb, 2 * xb + 2 * ab + 2 * sb


def tail_phase(card):
    """1b. The stage-tail kernels against the plain chain on the card:
    forward bitwise at the flagship's stage shapes (B = 120), the encode
    batch and the prototype's shapes (B = 128), ragged and all-tied clips,
    float32 and bfloat16; the gradient against the plain autograd chain
    with three planted faults; times against the bytes bound."""
    from ugaitnet_tpu_torch.ops.cuda import stage_tail as ST
    from ugaitnet_tpu_torch.ops.pooling import stage_tail
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(11)
    f32, bf16 = torch.float32, torch.bfloat16
    out = {"forward": {}, "grad": {}, "times": {}}
    t_phase = time.perf_counter()

    def volume(b, t, c, h, w, dtype, tied=False):
        x = torch.randn((b * t, c, h, w), device=dev, generator=gen)
        if tied == "constant":
            x.fill_(0.37)
        elif tied:       # a constant clip, a zero clip (p == 0), repeated
            x[:t] = 0.37     # frames and zero windows: every tie rule
            x[t:2 * t] = 0.0
            x[2 * t:3 * t] = x[2 * t].clone()
            x[-1, :, :4, :4] = 0.0
        return x.to(dtype)

    # (name, B, T, C, H, W, tied): the flagship's stage 1 and 2 (B = 120),
    # the encode batch = the prototype's (64, 32) and (32, 64) (B = 128),
    # the prototype's (16, 128), ragged (odd H and W; T = 1 with W = 12, not
    # a multiple of bfloat16's 8-wide vectors; C = 7 with W = 6, not of
    # float32's 4), and all-tied clips
    fwd_cases = [("stage 1", 120, 25, 32, 64, 64, True),
                 ("stage 2", 120, 25, 64, 32, 32, True),
                 ("encode stage 1 = proto (64, 32)", 128, 25, 32, 64, 64,
                  False),
                 ("encode stage 2 = proto (32, 64)", 128, 25, 64, 32, 32,
                  False),
                 ("proto (16, 128)", 128, 25, 128, 16, 16, False),
                 ("odd H, W", 3, 5, 5, 7, 9, True),
                 ("T = 1, W = 12", 4, 1, 3, 10, 12, False),
                 ("C = 7, W = 6", 2, 3, 7, 6, 6, False),
                 ("all-constant clips", 2, 25, 32, 64, 64, "constant")]
    worst_fwd = 0.0
    for name, b, t, c, h, w, tied in fwd_cases:
        for dtype in (f32, bf16):
            x = volume(b, t, c, h, w, dtype, tied)
            ak, sk = ST.launch_fwd(x, b, TAIL_ALPHA)
            ap, sp = stage_tail(x, b, TAIL_ALPHA)
            err = max(float((ak.float() - ap.float()).abs().max()),
                      float((sk.float() - sp.float()).abs().max()))
            same = torch.equal(ak, ap) and torch.equal(sk, sp)
            worst_fwd = max(worst_fwd, err)
            out["forward"][f"{name} {str(dtype)[6:]}"] = {
                "shape": [b * t, c, h, w], "batch": b, "bitwise": same,
                "max_abs_err": err}
            check(same, f"stage tail forward {name} {dtype}: kernel != plain "
                        f"(max abs err {err})")
            del x, ak, sk, ap, sp
    print(f"stage tail forward, kernel vs plain: bitwise (torch.equal on a "
          f"and s) in float32 and bfloat16 at {len(fwd_cases)} shapes "
          f"({', '.join(c[0] for c in fwd_cases)}) [{card}]")

    # the gradient, with ties, against the plain chain and planted faults
    worst_bwd = 0.0
    for name, b, t, c, h, w in (("stage 1", 120, 25, 32, 64, 64),
                                ("stage 2", 120, 25, 64, 32, 32),
                                ("odd H, W", 3, 5, 5, 7, 9)):
        for dtype in (f32, bf16):
            x = volume(b, t, c, h, w, dtype, True)
            shape_a = (b * t, c, h // 2, w // 2)
            g_a = torch.randn(shape_a, device=dev, generator=gen).to(dtype)
            g_s = torch.randn((b,) + shape_a[1:], device=dev,
                              generator=gen).to(dtype)
            want = tail_grad(x, b, g_a, g_s, None).float()
            got = tail_grad(x, b, g_a, g_s).float()
            err = rel_err(got, want)
            abs_err = float((got - want).abs().max())
            worst_bwd = max(worst_bwd, abs_err)
            faults = {f: rel_err(tail_grad(x, b, g_a, g_s, f).float(), want)
                      for f in TAIL_FAULTS}
            key = f"{name} {str(dtype)[6:]}"
            out["grad"][key] = {"rel_err": err, "max_abs_err": abs_err,
                                "mismatched": int((got != want).sum()),
                                "faults": faults}
            print(f"stage tail gradient {key} {tuple(x.shape)}: max |kernel -"
                  f" plain| / max |plain| {err:.2e} (limit {TAIL_GRAD_REL}; "
                  f"{out['grad'][key]['mismatched']} elements differ); planted"
                  f" faults " + ", ".join(f"{f} {v:.3f}" for f, v in
                                          faults.items()))
            check(err <= TAIL_GRAD_REL, f"stage tail gradient {key}")
            check(all(v > TAIL_GRAD_REL for v in faults.values()),
                  f"stage tail gradient {key}: a planted fault passes")
            del x, g_a, g_s, want, got
    out["max_abs_err"] = {"tail_fwd": worst_fwd, "tail_bwd": worst_bwd}

    # times: CUDA events around 20 launches (the wrapper's calls), the
    # plain chain's forward and backward, and the bytes bound
    for name, b, t, c, h, w, dtype in (
            ("stage 1", 120, 25, 32, 64, 64, f32),
            ("stage 2", 120, 25, 64, 32, 32, f32),
            ("stage 1", 120, 25, 32, 64, 64, bf16),
            ("stage 2", 120, 25, 64, 32, 32, bf16),
            ("proto (64, 32)", 128, 25, 32, 64, 64, bf16),
            ("proto (32, 64)", 128, 25, 64, 32, 32, bf16),
            ("proto (16, 128)", 128, 25, 128, 16, 16, bf16)):
        x = volume(b, t, c, h, w, dtype)
        a, s = ST.launch_fwd(x, b, TAIL_ALPHA)
        g_a, g_s = torch.randn_like(a), torch.randn_like(s)
        r = {"shape": [b * t, c, h, w], "batch": b,
             "fwd_ms": cuda_ms(lambda: ST.launch_fwd(x, b, TAIL_ALPHA)),
             "bwd_ms": cuda_ms(lambda: ST.launch_bwd(x, a, s, g_a, g_s, b,
                                                     TAIL_ALPHA))}
        with torch.no_grad():
            r["plain_fwd_ms"] = cuda_ms(lambda: stage_tail(x, b, TAIL_ALPHA),
                                        10)
        xq = x.clone().requires_grad_(True)
        ap, sp = stage_tail(xq, b, TAIL_ALPHA)
        r["plain_bwd_ms"] = cuda_ms(lambda: torch.autograd.grad(
            (ap, sp), xq, (g_a, g_s), retain_graph=True), 10)
        fb, bb = tail_bytes(x, b)
        # operations: 3 + 1 + 1 compares and a multiply per a element
        # forward, ~20 backward; far below the bytes
        r["fwd_bound"] = bound(fb, 6 * a.numel())
        r["bwd_bound"] = bound(bb, 20 * a.numel())
        key = f"{name} {str(dtype)[6:]}"
        out["times"][key] = r
        print(f"stage tail times {key} {tuple(x.shape)}: kernel fwd "
              f"{r['fwd_ms']:.4f} ms, bwd {r['bwd_ms']:.4f} ms (CUDA events, "
              f"20 launches); plain fwd {r['plain_fwd_ms']:.4f} ms, bwd "
              f"{r['plain_bwd_ms']:.4f} ms; bound fwd {r['fwd_bound'][0]:.4f}"
              f" ms ({r['fwd_bound'][1]}, {fb / 1e9:.3f} GB), bwd "
              f"{r['bwd_bound'][0]:.4f} ms ({r['bwd_bound'][1]}, "
              f"{bb / 1e9:.3f} GB) [{card}]")
        if key == "stage 1 float32":      # the profiler's device time too
            r["fwd_dev"] = device_ms(lambda: ST.launch_fwd(x, b, TAIL_ALPHA),
                                     TAIL_FWD_KERNELS)
            r["bwd_dev"] = device_ms(lambda: ST.launch_bwd(
                x, a, s, g_a, g_s, b, TAIL_ALPHA), TAIL_BWD_KERNELS)
            check(set(r["fwd_dev"]) == set(TAIL_FWD_KERNELS) and
                  set(r["bwd_dev"]) == set(TAIL_BWD_KERNELS),
                  f"the profiler saw no stage tail kernel: {r}")
            print(f"  torch.profiler device ms: fwd {r['fwd_dev']}, bwd "
                  f"{r['bwd_dev']}")
        del x, a, s, g_a, g_s, xq, ap, sp
    torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"phase 1b: {out['phase_s']:.1f} s")
    return out


@contextlib.contextmanager
def cudnn_conv():
    """Within the block the GaitSet branches' a_conv2 and a_conv6 take
    ``F.conv2d`` (cuDNN, bf16) where they would take the conv kernel (the
    comparison runs of phases 2 and 6 only; nothing on the main path does
    this)."""
    import torch.nn.functional as F
    from ugaitnet_tpu_torch.models import gaitset as GS
    orig = GS.conv3x3_cuda
    GS.conv3x3_cuda = lambda x, w: F.conv2d(x, w, padding=1)
    try:
        yield
    finally:
        GS.conv3x3_cuda = orig


def route_readings(run):
    """The bf16 forward ``run()`` (its output dict) through the conv kernel
    against the same forward through ``F.conv2d`` (``cudnn_conv``), read by
    ``sign_max_rule`` with the cuDNN route in the CPU's place: the merge
    inputs, and the outputs with the cuDNN route's picks, within ROUTE_REL
    of max."""
    from ugaitnet_tpu_torch.ops.cuda import conv3x3 as CV
    keys = ("signature", "classprob_logits")
    CV.reset_launch_counts()
    with torch.inference_mode(), cudnn_conv(), SignMaxTap() as tap:
        out = run()
    want = {k: out[k].float().cpu() for k in keys}
    check(CV.launches == 0, f"the F.conv2d route launched conv3x3 "
          f"{CV.launches}x")

    def run_card():
        with torch.inference_mode():
            res = run()
        return {k: res[k].float() for k in keys}
    r = sign_max_rule(run_card, want, tap.calls)
    # sign_max_rule runs the kernel route twice (own picks, forced picks)
    check(CV.launches == 8, f"the kernel route launched conv3x3 "
          f"{CV.launches}x in two forwards")
    r["bitwise"] = r["branches"] == 0 and not any(r["raw"].values())
    print(f"bf16 forward, conv kernel vs the F.conv2d route (bitwise "
          f"{r['bitwise']}): merge inputs "
          f"{r['branches']:.2e} of max; sign_max picks switched "
          f"{r['switched']} of {r['picks']} ({r['near']} within twice that of"
          f" a tie; the switched nearest a tie {r['tie']:.2e}); outputs raw /"
          f" with the F.conv2d route's picks " + ", ".join(
              f"{k} {r['raw'][k]:.2e} / {r['forced'][k]:.2e}" for k in keys)
          + f" (limit {ROUTE_REL})")
    for k in keys:
        check(max(r["forced"][k], r["branches"]) <= ROUTE_REL,
              f"bf16 {k}: conv kernel vs the F.conv2d route")
    return r


def bf16_ulp(v):
    """The spacing of bfloat16 at |v| (0 at 0), in float32."""
    m, e = torch.frexp(v.float().abs())
    return torch.where(v == 0, torch.zeros_like(m),
                       torch.ldexp(torch.ones_like(m), e - 8))


def ulp_readings(got, want, s):
    """max |got - want| / (ulp(want) + CONV_SUM_REL * s) (the limit is 1),
    the largest error in bf16 ulps of want (where want != 0) and in units
    of s, and the elements that differ."""
    d = (got.float() - want.float()).abs()
    ulp = bf16_ulp(want)
    lim = ulp + CONV_SUM_REL * s
    zero = torch.zeros_like(d)
    return {"of_limit": float(torch.where(d == 0, zero, d / lim).max()),
            "ulps": float(torch.where((d == 0) | (ulp == 0), zero,
                                      d / ulp).max()),
            "of_s": float(torch.where(d == 0, zero, d / s).max()),
            "max_abs_err": float(d.max()), "differ": int((d != 0).sum())}


def conv_abs(x, w):
    """S = (|x| conv |w|) in float32: the scale of each output's sum."""
    import torch.nn.functional as F
    return F.conv2d(x.float().abs(), w.float().abs(), padding=1)


def conv_fault(x, w, fault):
    """The plain conv with one planted fault: output column 0 without its
    right-hand taps (dj = 2); the weight's Ci and Co swapped (Ci == Co);
    or the centre tap reading column j + 1."""
    import torch.nn.functional as F
    xf, wf = x.float(), w.float()
    if fault == "Ci and Co swapped":
        return F.conv2d(xf, wf.transpose(0, 1).contiguous(),
                        padding=1).to(torch.bfloat16)
    y = F.conv2d(xf, wf, padding=1)
    tap = torch.zeros_like(wf)
    if fault == "border tap dropped":
        tap[..., 2] = wf[..., 2]
        y[..., 0] -= F.conv2d(xf, tap, padding=1)[..., 0]
    else:
        tap[..., 1, 1] = wf[..., 1, 1]
        shifted = F.pad(xf[..., 1:], (0, 1))
        y += F.conv2d(shifted, tap, padding=1) - F.conv2d(xf, tap, padding=1)
    return y.to(torch.bfloat16)


def conv_phase(card):
    """1c. The conv kernel against its plain version on the card, per
    element within ulp + CONV_SUM_REL * S, at the flagship's a_conv6 and
    a_conv2 (seed-0 weights), their TP halves, the tiny flagship's shapes,
    ragged shapes and all-zero / all-constant frames; planted faults;
    kernel, plain and cuDNN times against the bound."""
    import torch.nn.functional as F
    from ugaitnet_tpu_torch.models.gaitset import glorot_
    from ugaitnet_tpu_torch.models.network import UGaitNet
    from ugaitnet_tpu_torch.ops.conv3x3 import conv3x3
    from ugaitnet_tpu_torch.ops.cuda import conv3x3 as CV
    dev = torch.device("cuda")
    bf16 = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(12)
    t_phase = time.perf_counter()
    branch = UGaitNet(flagship_cfg(dtype="bfloat16"), seed=0).branches[
        "branch_of"]
    w6 = branch.a_conv6.weight.detach().to(bf16).contiguous()
    w2 = branch.a_conv2.weight.detach().to(bf16).contiguous()
    del branch

    def glorot(ci, co):
        return glorot_(torch.empty((co, ci, 3, 3), device=dev), 9 * ci,
                       9 * co, gen).to(bf16)

    # (name, N, Ci, H, W, w, fill)
    cases = [("a_conv6", 3200, 128, 16, 16, w6, None),
             ("a_conv2", 3200, 32, 64, 64, w2, None),
             ("a_conv6 TP half (Ci 64)", 3200, 64, 16, 16,
              w6[:, :64].contiguous(), None),
             ("a_conv2 TP half (Ci 16)", 3200, 16, 64, 64,
              w2[:, :16].contiguous(), None),
             ("tiny 8 -> 8 at 64x64", 50, 8, 64, 64, glorot(8, 8), None),
             ("tiny 16 -> 16 at 16x16", 50, 16, 16, 16, glorot(16, 16), None),
             ("ragged (3, 7, 5, 5) -> 5", 3, 7, 5, 5, glorot(7, 5), None),
             ("H != W (4, 12, 9, 20) -> 40", 4, 12, 9, 20, glorot(12, 40),
              None),
             ("N = 1, W > 128 (1, 33, 17, 130) -> 130", 1, 33, 17, 130,
              glorot(33, 130), None),
             ("all-zero frames", 25, 32, 64, 64, w2, 0.0),
             ("all-constant frames", 25, 128, 16, 16, w6, 0.37)]
    out = {"cases": {}, "times": {}}
    worst = 0.0
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for name, n, ci, h, w, wt, fill in cases:
        x = torch.randn((n, ci, h, w), device=dev, generator=gen).to(bf16)
        if fill is not None:
            x.fill_(fill)
        p = CV.plan(n, ci, wt.shape[0], h, w, sms)
        before = dict(CV.variant_launches)
        got = CV.launch(x, wt)
        torch.cuda.synchronize()
        taken = [k for k in before
                 if CV.variant_launches[k] == before[k] + 1]
        check(taken == [p.variant], f"conv3x3 {name}: plan chose "
              f"{p.variant}, the counters read {CV.variant_launches}")
        if name in HOPPER_CASES:
            check(p.variant == "hopper",
                  f"conv3x3 {name} did not take the Hopper variant")
        want = conv3x3(x, wt)
        s = conv_abs(x, wt)
        r = ulp_readings(got, want, s)
        r["shape"] = [n, ci, h, w, wt.shape[0]]
        r["variant"] = p.variant
        r["plan"] = dataclasses.asdict(p)
        r["finite"] = bool(torch.isfinite(got.float()).all())
        r["bitwise"] = bool(torch.equal(got, want))
        worst = max(worst, r["max_abs_err"])
        if name in ("a_conv6", "a_conv2"):
            lib = F.conv2d(x, wt, padding=1)
            r["cudnn"] = ulp_readings(lib, want, s)
            r["kernel_vs_cudnn_differ"] = int((got != lib).sum())
            del lib
            r["faults"] = {f: ulp_readings(conv_fault(x, wt, f), want, s)[
                "of_limit"] for f in CONV_FAULTS}
        out["cases"][name] = r
        print(f"conv3x3 {name} x {tuple(x.shape)} w {tuple(wt.shape)} "
              f"[{p.variant}: tile {p.tr}x{p.tw}, BN {p.bn}, CC {p.cc}, "
              f"{p.stages} stages, grid {p.grid}, {p.smem} B shared]: "
              f"max |kernel - plain| {r['max_abs_err']:.3e} = "
              f"{r['of_limit']:.3f} of the limit (ulp + 2^-12 S), "
              f"{r['ulps']:.2f} ulp, {r['of_s']:.2e} S; {r['differ']} of "
              f"{got.numel()} elements differ"
              + (f"; cuDNN bf16 {r['cudnn']['of_limit']:.3f} of the limit "
                 f"({r['cudnn']['ulps']:.2f} ulp, {r['cudnn']['differ']} "
                 f"differ; kernel vs cuDNN: {r['kernel_vs_cudnn_differ']} "
                 f"differ); planted faults "
                 + ", ".join(f"{f} {v:.1f}" for f, v in r["faults"].items())
                 if "faults" in r else "") + f" [{card}]")
        check(r["finite"] and r["of_limit"] <= 1.0,
              f"conv3x3 {name}: kernel vs plain")
        if "faults" in r:
            check(r["cudnn"]["of_limit"] <= 1.0,
                  f"conv3x3 {name}: cuDNN vs plain")
            check(all(v > 1.0 for v in r["faults"].values()),
                  f"conv3x3 {name}: a planted fault passes the limit")
        if name in ("a_conv6", "a_conv2"):
            co = wt.shape[0]
            t = {"ms": cuda_ms(lambda: CV.launch(x, wt)),
                 "plain_ms": cuda_ms(lambda: conv3x3(x, wt), 10),
                 "library_ms": cuda_ms(lambda: F.conv2d(x, wt, padding=1))}
            nbytes = (x.numel() + wt.numel() + n * co * h * w) * 2
            t["bound_ms"], t["bound_by"] = bound(
                nbytes, 2 * n * h * w * co * ci * 9, PEAK_BF16)
            t["share_of_bound"] = t["bound_ms"] / t["ms"]
            t["factor_to_library"] = t["ms"] / t["library_ms"]
            t["variant"] = p.variant
            # the general variant (the earlier mma.sync kernel) at this
            # shape, held to the same limit and timed beside the Hopper one
            gen_y = CV.launch(x, wt, general=True)
            t["earlier_of_limit"] = ulp_readings(gen_y, want, s)["of_limit"]
            del gen_y
            check(t["earlier_of_limit"] <= 1.0,
                  f"conv3x3 {name}: the general variant vs plain")
            t["earlier_ms"] = cuda_ms(lambda: CV.launch(x, wt, general=True))
            if name == "a_conv6":      # the profiler's device time too
                t["dev"] = device_ms(lambda: CV.launch(x, wt), CONV_KERNELS)
                check(set(t["dev"]) == set(CONV_KERNELS),
                      f"the profiler saw no conv3x3 kernel: {t}")
            out["times"][name] = t
            print(f"conv3x3 times {name} {tuple(x.shape)} -> {co} "
                  f"[{p.variant}]: kernel {t['ms']:.4f} ms (CUDA events, 20 "
                  f"launches; the general variant {t['earlier_ms']:.4f}, "
                  f"{t['earlier_of_limit']:.3f} of the limit), plain "
                  f"{t['plain_ms']:.4f} ms, cuDNN bf16 F.conv2d "
                  f"{t['library_ms']:.4f} ms ({t['factor_to_library']:.2f}x"
                  f" of it), bound {t['bound_ms']:.4f} ms "
                  f"({t['bound_by']}, {nbytes / 1e9:.3f} GB, "
                  f"{2 * n * h * w * co * ci * 9 / 1e9:.1f} GFLOP; "
                  f"{t['share_of_bound']:.1%} of it)"
                  + (f"; torch.profiler device ms {t['dev']}"
                     if "dev" in t else "") + f" [{card}]")
        del x, got, want, s
    out["max_abs_err"] = worst
    out["variant_launches"] = dict(CV.variant_launches)
    torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"phase 1c: {out['phase_s']:.1f} s")
    return out


def scale2_readings(card, gen, pairs=3):
    """Phase 1d's scale2: bitwise against x * 2 on the prototype's (128,
    25, 32, 32, 32) bf16 tensor and its batch-minor view (the vec variant,
    as the counters must show), at an offset of 3 values on x and y (a
    head and a tail), and with y 3 values off x's offset (the scalar
    variant); a planted fault (the last 8 values left out of the launch,
    in a NaN-filled y) must fail the check.  Times by CUDA events after a
    discarded pass, in ``pairs`` pairs of turns (forward, then reversed):
    the vec variant, x * 2, and the scalar variant at the prototype's n
    with y one value off x's offset."""
    from ugaitnet_tpu_torch.ops.cuda import probes as PR
    dev = torch.device("cuda")
    b, t = 128, 25
    x = (torch.randn((b, t, 32, 32, 32), device=dev, generator=gen)
         * 0.1).to(torch.bfloat16)
    n = x.numel()

    def transposed():
        return x.permute(1, 2, 3, 4, 0).contiguous().view(t * 32 ** 3, b)

    xt = transposed()
    want = x * 2
    plan = PR.scale2_plan(n, PR.offset16(x), 0)
    before = dict(PR.scale2_variant_launches)
    got = PR.scale2(x)
    c = {"bitwise": bool(torch.equal(got, want)),
         "max_abs_err": float((got.float() - want.float()).abs().max()),
         "variant": plan.variant, "plan": dataclasses.asdict(plan)}
    del got
    c["took"] = [k for k, v in PR.scale2_variant_launches.items()
                 if v == before[k] + 1]
    c["bitwise_view"] = bool(torch.equal(PR.scale2(xt), PR.scale2_plain(xt)))
    # x and y 3 values past a 16-byte boundary: a head of 5 values and a
    # tail of 3; y at the boundary: the scalar variant
    xf, wf = x.reshape(-1), want.reshape(-1)
    buf = torch.empty(n + 8, dtype=x.dtype, device=dev)
    before = dict(PR.scale2_variant_launches)
    c["bitwise_offset"] = bool(torch.equal(PR.scale2(xf[3:], buf[3:n]),
                                           wf[3:]))
    c["bitwise_offsets_apart"] = bool(torch.equal(
        PR.scale2(xf[3:], buf[:n - 3]), wf[3:]))
    c["offset_variants"] = {k: v - before[k] for k, v in
                            PR.scale2_variant_launches.items()}
    # the planted fault: the launch stops 8 values short of the end
    y = torch.full_like(xf, float("nan"))
    PR.scale2(xf[:-8], y[:-8])
    c["fault_bitwise"] = bool(torch.equal(y, wf))
    c["fault_differ"] = int((y != wf).sum())
    del y, want, wf
    ys = buf[1:n + 1]
    fns = {"vec": lambda: PR.scale2(x), "x * 2": lambda: x * 2,
           "scalar": lambda: PR.scale2(xf, ys)}
    for fn in fns.values():      # a timed pass, discarded: the first
        cuda_ms(fn)              # timing of a run reads high
    turns = {k: [] for k in fns}
    for _ in range(pairs):
        for order in (list(fns), list(fns)[::-1]):
            for k in order:
                turns[k].append(cuda_ms(fns[k]))
    mean = {k: sum(v) / len(v) for k, v in turns.items()}
    c.update(ms=mean["vec"], library_ms=mean["x * 2"],
             scalar_ms=mean["scalar"], turns=turns,
             with_transpose_ms=cuda_ms(lambda: PR.scale2(transposed())),
             transpose_ms=cuda_ms(transposed),
             plain_ms=cuda_ms(lambda: PR.scale2_plain(xt)))
    c["bound_ms"], c["bound_by"] = bound(2 * n * 2, n)
    c["share_of_bound"] = c["bound_ms"] / c["ms"]
    c["factor_to_library"] = c["ms"] / c["library_ms"]
    print(f"scale2 on (T*32*32*32, B) = {tuple(xt.shape)} bf16 "
          f"[{c['variant']}: grid {plan.grid}; took {c['took']}]: bitwise "
          f"to x * 2 {c['bitwise']} (view {c['bitwise_view']}; x and y 3 "
          f"values off {c['bitwise_offset']}, y 3 values apart "
          f"{c['bitwise_offsets_apart']}: variants {c['offset_variants']});"
          f" planted fault (the last 8 values not launched): bitwise "
          f"{c['fault_bitwise']}, {c['fault_differ']} values differ; kernel "
          f"{c['ms']:.4f} ms, {c['share_of_bound']:.1%} of the bound, "
          f"{c['factor_to_library']:.3f}x torch x * 2 "
          f"{c['library_ms']:.4f} ms (the earlier kernel "
          f"{EARLIER_SCALE2_MS:.4f}, quoted, not measured here); the scalar "
          f"variant {c['scalar_ms']:.4f} ms; turns "
          f"{ {k: [round(v, 4) for v in vs] for k, vs in turns.items()} }; "
          f"with the transpose {c['with_transpose_ms']:.4f} ms (the "
          f"transpose alone {c['transpose_ms']:.4f}); bound "
          f"{c['bound_ms']:.4f} ms ({c['bound_by']}, {4 * n / 1e9:.4f} GB) "
          f"[{card}]")
    check(c["bitwise"] and c["bitwise_view"], "scale2 vs x * 2")
    check(c["took"] == ["vec"],
          f"scale2 at the prototype's shape took {c['took']}")
    check(c["bitwise_offset"] and c["bitwise_offsets_apart"]
          and c["offset_variants"] == {"vec": 1, "scalar": 1},
          f"scale2 at an offset: {c}")
    check(not c["fault_bitwise"] and c["fault_differ"] == 8,
          "the planted scale2 fault passes")
    del x, xt, xf, buf, ys
    return c


def probe_phase(card):
    """1d. mm_fwd against its plain version (ulp + CONV_SUM_REL * S) at
    the prototype's M and K, timed beside cuBLAS; scale2
    (``scale2_readings``)."""
    from ugaitnet_tpu_torch.ops.cuda import probes as PR
    dev = torch.device("cuda")
    bf16 = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(13)
    t_phase = time.perf_counter()
    PR.reset_launch_counts()
    out = {"mm": {}, "copy": {}}
    m = 262144
    for k in (576, 1152, 2304):
        x = (torch.randn((m, k), device=dev, generator=gen) * 0.1).to(bf16)
        w = (torch.randn((k // 128, 128, 128), device=dev, generator=gen)
             * 0.1).to(bf16)
        got = PR.mm_fwd(x, w)
        torch.cuda.synchronize()
        want = PR.mm_plain(x, w)
        # the prototype's kernel reads 128 (K // 128) columns of x
        kw = 128 * (k // 128)
        w2 = w.reshape(kw, 128)
        s = x[:, :kw].float().abs() @ w2.float().abs()
        r = ulp_readings(got, want, s)
        r["cublas"] = ulp_readings(torch.matmul(x[:, :kw], w2), want, s)
        r["ms"] = cuda_ms(lambda: PR.mm_fwd(x, w))
        r["plain_ms"] = cuda_ms(lambda: PR.mm_plain(x, w), 10)
        r["library_ms"] = cuda_ms(lambda: torch.matmul(x[:, :kw], w2))
        nbytes = (m * kw + kw * 128 + m * 128) * 2
        r["bound_ms"], r["bound_by"] = bound(nbytes, 2 * m * kw * 128,
                                             PEAK_BF16)
        r["share_of_bound"] = r["bound_ms"] / r["ms"]
        r["factor_to_library"] = r["ms"] / r["library_ms"]
        r["variant"] = "hopper"
        r["plan"] = dataclasses.asdict(PR.mm_plan(
            m, torch.cuda.get_device_properties(dev).multi_processor_count))
        out["mm"][k] = r
        print(f"mm_fwd M={m} K={k} [TMA ring + wgmma, grid "
              f"{r['plan']['grid']}]: max |kernel - plain| "
              f"{r['max_abs_err']:.3e} = {r['of_limit']:.3f} of the limit, "
              f"{r['ulps']:.2f} ulp, {r['differ']} differ (cuBLAS "
              f"{r['cublas']['of_limit']:.3f} of it); kernel {r['ms']:.4f} "
              f"ms (the earlier kernel {EARLIER_MM_MS[k]:.4f}, quoted, not "
              f"measured here), plain "
              f"{r['plain_ms']:.4f} ms, cuBLAS bf16 {r['library_ms']:.4f} ms "
              f"({r['factor_to_library']:.2f}x of it), bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']}; "
              f"{r['share_of_bound']:.1%} of it) [{card}]")
        check(bool(torch.isfinite(got.float()).all())
              and r["of_limit"] <= 1.0, f"mm_fwd K={k}: kernel vs plain")
        check(r["cublas"]["of_limit"] <= 1.0, f"mm_fwd K={k}: cuBLAS vs "
              f"plain")
        del x, w, w2, got, want, s
    out["copy"] = scale2_readings(card, gen)
    out["launches"] = {"mm_fwd": PR.mm_launches,
                       "scale2": PR.scale2_launches}
    out["scale2_variant_launches"] = dict(PR.scale2_variant_launches)
    torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"phase 1d: {out['phase_s']:.1f} s")
    return out


def wgrad_phase(card):
    """1e. The 3D CNN's first-conv weight gradient against float64 at its
    two shapes, planted faults, bitwise repeat, times beside cuDNN's and
    the plain version's."""
    from ugaitnet_tpu_torch.ops.cuda import conv3d_wgrad as CW
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(17)
    t_phase = time.perf_counter()
    CW.launches = 0
    n, t, h, w, co = WGRAD_SHAPE
    kern, stride = WGRAD_KERNEL, WGRAD_STRIDE
    out = {"by_shape": {}}
    for name, ci in WGRAD_CELL.items():
        x = torch.randn((n, t, h, w, ci), device=dev, generator=gen)
        x = x.permute(0, 4, 1, 2, 3)                  # the NDHWC view
        outs = CW.out_size((t, h, w), kern, stride)
        gy = torch.randn((n, co, *outs), device=dev, generator=gen)
        wt = torch.empty((co, ci, *kern), device=dev)
        rw, rb = CW.wgrad_plain(x.double(), gy.double(), kern, stride)

        def reading(dw, db):
            return max(rel_err(dw.double(), rw), rel_err(db.double(), rb))

        def cudnn():
            return torch.ops.aten.convolution_backward(
                gy, x, wt, [co], list(stride), [0, 0, 0], [1, 1, 1], False,
                [0, 0, 0], 1, [False, True, True])
        dw, db = CW.conv3d_wgrad(x, gy, kern, stride)
        dw2, db2 = CW.conv3d_wgrad(x, gy, kern, stride)
        gcl = gy.contiguous(memory_format=torch.channels_last_3d)
        gz = gy.clone()
        gz[7, :, 11] = 0                              # one (n, t) slab
        r = {"max_rel_err": reading(dw, db),
             "channels_last_gy": reading(*CW.conv3d_wgrad(x, gcl, kern,
                                                          stride)),
             "bitwise": bool(torch.equal(dw, dw2) and torch.equal(db, db2)),
             "cudnn_rel_err": reading(*cudnn()[1:]),
             "max_abs_err": max(float((dw.double() - rw).abs().max()),
                                float((db.double() - rb).abs().max())),
             "faults": {
                 "tap shifted": rel_err(dw[..., 1:].double(), rw[..., :-1]),
                 "slab skipped": reading(*CW.conv3d_wgrad(x, gz, kern,
                                                          stride)),
                 "bias left out": reading(dw, torch.zeros_like(db))}}
        del rw, rb, dw2, db2, gcl, gz
        r["ms"] = cuda_ms(lambda: CW.conv3d_wgrad(x, gy, kern, stride))
        r["plain_ms"] = cuda_ms(
            lambda: CW.wgrad_plain(x, gy, kern, stride), 3, 1)
        r["library_ms"] = cuda_ms(cudnn, 3, 1)
        taps = ci * math.prod(kern)
        positions = n * math.prod(outs)
        r["bound_ms"], r["bound_by"] = bound(
            4 * (x.numel() + gy.numel() + co * (taps + 1)),
            2 * co * positions * (taps + 1))
        r["share_of_bound"] = r["bound_ms"] / r["ms"]
        r["factor_to_library"] = r["ms"] / r["library_ms"]
        out["by_shape"][name] = r
        print(f"conv3d_wgrad {name} (N {n}, Ci {ci}, {t}x{h}x{w} -> "
              f"{'x'.join(map(str, outs))}, Co {co}): max rel err "
              f"{r['max_rel_err']:.2e} (channels-last gy "
              f"{r['channels_last_gy']:.2e}; cuDNN {r['cudnn_rel_err']:.2e})"
              f" <= {WGRAD_REL}; planted faults "
              + ", ".join(f"{f} {r['faults'][f]:.2e}" for f in WGRAD_FAULTS)
              + f" > {WGRAD_REL}; bitwise {r['bitwise']}; kernel {r['ms']:.4f} ms, plain "
              f"{r['plain_ms']:.4f} ms, cuDNN {r['library_ms']:.4f} ms "
              f"({r['factor_to_library']:.4f}x of it), bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']}; "
              f"{r['share_of_bound']:.1%} of it) [{card}]")
        check(r["max_rel_err"] <= WGRAD_REL
              and r["channels_last_gy"] <= WGRAD_REL,
              f"conv3d_wgrad {name}: kernel vs float64")
        check(r["bitwise"], f"conv3d_wgrad {name}: two launches differ")
        check(all(r["faults"][f] > WGRAD_REL for f in WGRAD_FAULTS),
              f"conv3d_wgrad {name}: a planted fault reads under the limit")
        del x, gy, wt, dw, db
        torch.cuda.empty_cache()
    by = out["by_shape"]
    for k in ("ms", "plain_ms", "library_ms", "bound_ms", "max_abs_err"):
        out[k] = (sum if k != "max_abs_err" else max)(
            v[k] for v in by.values())
    out["bound_by"] = by["of"]["bound_by"]
    out["share_of_bound"] = out["bound_ms"] / out["ms"]
    out["factor_to_library"] = out["ms"] / out["library_ms"]
    out["launches"] = CW.launches
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"conv3d_wgrad of + gray: kernel {out['ms']:.4f} ms, cuDNN "
          f"{out['library_ms']:.4f} ms, bound {out['bound_ms']:.4f} ms "
          f"({out['share_of_bound']:.1%}); {out['launches']} launches; "
          f"phase 1e: {out['phase_s']:.1f} s [{card}]")
    return out


def tail_vs_plain_step(mcfg, tcfg, before, batch):
    """Phase 3's step from the state ``before`` (model and optimizer state
    dicts, step count) on ``batch`` through the stage-tail kernels, and the
    same step with the plain tail, both with deterministic cuDNN: the
    kernel step launches exactly 4 + 4, the plain one none; losses equal;
    each parameter gradient within GRAD_REL of its max (bitwise
    expected)."""
    from ugaitnet_tpu_torch.models.network import UGaitNet
    from ugaitnet_tpu_torch.ops.cuda import stage_tail as ST
    from ugaitnet_tpu_torch.train.train_step import (init_state,
                                                     make_train_step)

    def run():
        net = UGaitNet(mcfg, seed=0)
        net.load_state_dict(before[0])
        state = init_state(net, tcfg)
        state.optimizer.load_state_dict(before[1])
        state.step = before[2]
        ST.reset_launch_counts()
        _, m = make_train_step(mcfg, tcfg)(state, batch)
        torch.cuda.synchronize()
        return ({k: float(v) for k, v in m.items()},
                {n: q.grad.detach().clone() for n, q in
                 net.named_parameters() if q.grad is not None},
                (ST.fwd_launches, ST.bwd_launches))

    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        mk, gk, lk = run()
        with plain_tail():
            mp, gp, lp = run()
    finally:
        torch.backends.cudnn.deterministic = det
    errs = {n: (rel_err(gk[n], gp[n]) if float(gp[n].abs().max()) > 0
                else float(gk[n].abs().max())) for n in gp}
    worst = max(errs, key=errs.get)
    out = {"launches": list(lk), "plain_launches": list(lp),
           "losses_equal": mk == mp, "loss": mk["loss"],
           "grad_rel_err_max": errs[worst], "worst_param": worst,
           "grads_bitwise": all(torch.equal(gk[n], gp[n]) for n in gp),
           "n_params": len(gp)}
    print(f"train step, stage-tail kernels vs the plain tail (same state and "
          f"batch, deterministic cuDNN): launches {lk} vs {lp}; losses "
          f"{mk} vs {mp}; parameter gradients: worst {errs[worst]:.2e} of "
          f"max at {worst} (limit {GRAD_REL}), bitwise "
          f"{out['grads_bitwise']} over {len(gp)} tensors")
    check(lk == (4, 4) and lp == (0, 0), f"tail launches {lk}, plain {lp}")
    check(set(gk) == set(gp) and mk == mp, "kernel-tail step losses")
    check(errs[worst] <= GRAD_REL, "kernel-tail step gradients")
    return out


def tail_ab_steps(cfgs, tcfg, batch, card, n=5, warm=2):
    """The train step's ms and peak with the stage-tail kernels and with
    the plain tail, in turns (kernel, plain, plain, kernel) from the seed-0
    state on one batch, per config; median of the steps after ``warm``.
    Peak: max_memory_allocated over the steps, absolute and above what was
    allocated before the state was built."""
    from ugaitnet_tpu_torch.models.network import UGaitNet
    from ugaitnet_tpu_torch.train.train_step import (init_state,
                                                     make_train_step)
    out = {}
    for label, cfg in cfgs.items():
        runs = {"kernel": [], "plain": []}
        for which in ("kernel", "plain", "plain", "kernel"):
            gc.collect()
            torch.cuda.empty_cache()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            ctx = plain_tail() if which == "plain" else \
                contextlib.nullcontext()
            with ctx:
                state = init_state(UGaitNet(cfg, seed=0), tcfg)
                step = make_train_step(cfg, tcfg)
                times = []
                for _ in range(n):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    step(state, batch)
                    torch.cuda.synchronize()
                    times.append((time.perf_counter() - t0) * 1e3)
            peak = torch.cuda.max_memory_allocated()
            runs[which].append({"ms": float(np.median(times[warm:])),
                                "peak_gb": peak / 1e9,
                                "step_peak_gb": (peak - base) / 1e9})
            del state, step
        out[label] = runs
        print(f"train step {label}, stage-tail kernels vs plain tail in turns"
              f" (kernel, plain, plain, kernel; median of steps {warm + 1}-"
              f"{n}, same batch): kernel "
              + ", ".join(f"{r['ms']:.2f} ms / {r['peak_gb']:.2f} GB" for r in
                          runs["kernel"])
              + "; plain " + ", ".join(f"{r['ms']:.2f} ms / "
                                       f"{r['peak_gb']:.2f} GB"
                                       for r in runs["plain"])
              + f" [{card}]")
    return out


def raw_batch(b, ids, seed, dev="cuda"):
    """b raw clips on the card (int16 OF planes, uint8 gray planes), all
    modalities present, labels ids x (b / ids), from a seeded generator
    (on ``dev``)."""
    dev = torch.device(dev)
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


def forward_readings(model, mods, dcfg, seed=4):
    """A raw B = 4 batch (2 ids) from ``seed`` through ``model`` on the card
    and through a CPU copy of it, read by ``sign_max_rule``: {tf32: readings}
    with TF32 off and on."""
    from ugaitnet_tpu_torch.data.pipeline import preprocess_batch
    keys = ("signature", "classprob_logits")
    vols, flags, _ = preprocess_batch(raw_batch(4, 2, seed=seed), *mods, 1,
                                      False, dcfg)
    cpu_model = copy.deepcopy(model).to("cpu")
    with torch.inference_mode(), SignMaxTap() as tap:
        out = cpu_model([v.cpu() for v in vols], [f.cpu() for f in flags])
    want = {k: out[k] for k in keys}

    def run_card():
        with torch.inference_mode():
            out = model(vols, flags)
        return {k: out[k] for k in keys}
    res = {}
    for tf32 in (False, True):
        torch.backends.cuda.matmul.allow_tf32 = tf32
        torch.backends.cudnn.allow_tf32 = tf32
        try:
            res[tf32] = sign_max_rule(run_card, want, tap.calls)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
    return res


def forward_vs_cpu(model, mods, dcfg):
    """Phase 4's card vs CPU forward: ``sign_max_rule`` must hold for every
    output with TF32 off, and fail for every output with TF32 on."""
    res = forward_readings(model, mods, dcfg)
    for tf32, r in res.items():
        print(f"card vs CPU forward, TF32 {'on' if tf32 else 'off'}: merge "
              f"inputs {r['branches']:.2e}; sign_max picks switched "
              f"{r['switched']} of {r['picks']} ({r['near']} within twice "
              f"that of a tie; the switched nearest a tie {r['tie']:.2e} of "
              f"max); outputs raw / with the CPU's picks "
              + ", ".join(f"{k} {r['raw'][k]:.2e} / {r['forced'][k]:.2e}"
                          for k in r["raw"]) + f" (limit {CPU_REL})")
    for k in res[False]["raw"]:
        check(passes(res[False], k), f"card vs CPU {k}")
        check(not passes(res[True], k),
              f"card vs CPU {k}: TF32 passes the limit")
    return res


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


def bf16_serve_checks(svc, raw):
    """The bf16 service: 4 conv3x3 launches per identify_raw (one per
    bucket), and its labels on 128 probes against the F.conv2d route's
    outside near ties: a probe whose 3rd and 4th float64 d^2 (the F.conv2d
    route's codes to the gallery) lie within twice the largest |d^2| the
    route moves for that probe may vote either way."""
    from ugaitnet_tpu_torch.ops.cuda import conv3x3 as CV
    CV.reset_launch_counts()
    for b in BUCKETS:
        svc.identify_raw(raw(np.arange(b)))
    calls = CV.launches
    check(calls == 4 * len(BUCKETS), f"bf16 identify_raw: {calls} conv3x3 "
          f"launches in {len(BUCKETS)} calls")
    feed = raw(np.arange(128))
    lab_k, _ = svc.identify_raw(feed)
    codes_k = svc.encode_raw(feed)
    with cudnn_conv():
        lab_c, _ = svc.identify_raw(feed)
        codes_c = svc.encode_raw(feed)
    check(svc._rows_used == len(svc._host_labels), "gallery rows")
    g = svc._gallery_codes[:svc._rows_used].double()

    def d2(codes):
        p = torch.from_numpy(codes).to(g.device).double()
        return ((p * p).sum(1, keepdim=True) + (g * g).sum(1)[None]
                - 2.0 * p @ g.T)
    d2_c, d2_k = d2(codes_c), d2(codes_k)
    # at least phase 5's near-tie width, for the float32 kNN's rounding
    fourth = torch.topk(d2_c, 4, dim=1, largest=False).values[:, 3]
    eps = torch.maximum((d2_k - d2_c).abs().amax(dim=1),
                        KNN_TIE_REL * fourth).cpu().numpy()
    firm, bad = labels_outside_near_ties(d2_c, svc._host_labels, lab_k, 3,
                                         eps)
    _, bad_c = labels_outside_near_ties(d2_c, svc._host_labels, lab_c, 3,
                                        eps)
    diff = lab_k != lab_c
    r = {"launches": calls, "calls": len(BUCKETS),
         "labels_differ": int(diff.sum()),
         "near_ties": int((~firm).sum()), "differ_off_near_ties": bad,
         "code_rel_err": float(np.abs(codes_k - codes_c).max()
                               / np.abs(codes_c).max())}
    print(f"bf16 serve: conv3x3 launches {calls} in {len(BUCKETS)} "
          f"identify_raw calls; labels of 128 probes vs the F.conv2d route: "
          f"{r['labels_differ']} differ, {r['near_ties']} near ties (3rd and "
          f"4th d^2 within twice the route's largest |d^2| change), "
          f"{bad} differ from the float64 vote off them (the F.conv2d route "
          f"{bad_c}); codes max |d| {r['code_rel_err']:.2e} of max")
    check(bad == 0 and bad_c == 0 and not (diff & firm).any(),
          "bf16 identify_raw labels: conv kernel vs F.conv2d off near ties")
    return r


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
        else:
            out["bf16_conv_route"] = bf16_serve_checks(svc, raw)
    svc = fp32
    # one identify_raw per bucket: one forward of each branch, 2 stage-tail
    # launches each
    from ugaitnet_tpu_torch.ops.cuda import stage_tail as ST
    ST.reset_launch_counts()
    for b in BUCKETS:
        svc.identify_raw(raw(np.arange(b)))
    tail = {"tail_fwd": ST.fwd_launches, "tail_bwd": ST.bwd_launches,
            "calls": len(BUCKETS)}
    out["tail_launches_identify_raw"] = tail
    print(f"stage-tail launches in {len(BUCKETS)} identify_raw calls (one "
          f"per bucket): {tail}")
    check(tail["tail_fwd"] == 4 * len(BUCKETS) and tail["tail_bwd"] == 0,
          f"identify_raw stage-tail launches {tail}")
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


def trainer_phase(card, work, gallery_dir, probe_dir, isolated_step_ms,
                  train_ms):
    """7. The trainer at the flagship's width through the CLIs, in the
    directory ``work`` (which the caller removes)."""
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
    proc = None
    os.makedirs(work, exist_ok=True)
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
        fit_tail = {}
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
                wrapped(net_utils, "save_filter_grid", timed_calls(filters_s)), \
                tail_counts(fit_tail):
            exp_a = cli_train.main(flags_a)
        fit_s = time.perf_counter() - t0
        launches = {"triplet_fwd": K.fwd_launches,
                    "triplet_bwd": K.bwd_launches}
        out["launches_fit"] = launches
        want = {"triplet_fwd": FIT_EPOCHS * (steps + val_batches),
                "triplet_bwd": FIT_EPOCHS * steps}
        check(launches == want, f"fit launches {launches}, expected {want}")
        # stage tail: 2 per branch forward on the card (train steps,
        # validation and the trainer's encodes), 4 per train step backward
        out["tail_launches_fit"] = fit_tail
        print(f"stage-tail launches in fit: {fit_tail} (2 per GaitSet branch "
              f"forward; backward 4 x {FIT_EPOCHS} epochs x {steps} steps)")
        check(fit_tail["tail_fwd"] == 2 * fit_tail["branch_forwards"]
              and fit_tail["branch_forwards"]
              >= 2 * FIT_EPOCHS * (steps + val_batches)
              and fit_tail["tail_bwd"] == 4 * FIT_EPOCHS * steps,
              f"fit stage-tail launches {fit_tail}")
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
        out["experdir"] = exp_a
        print(f"cli.evaluate on run A's best ({FIT_EPOCHS} epochs of the "
              f"flagship on synthetic data): {len(cams)} probe cameras, mean "
              f"Rank-1 subseq {mean_sub:.4f}, video {mean_vid:.4f}, "
              f"{eval_s:.1f} s")
    finally:
        torch.backends.cudnn.deterministic = False
        if proc is not None and proc.poll() is None:
            proc.kill()
            proc.wait(timeout=60)
    return out


def calib_volumes(ds, n=8):
    """The preprocessed float volumes of a set's first n clips (expand 1,
    no augmentation): the int8 encode's calibration batch."""
    from ugaitnet_tpu_torch.core.config import DataConfig
    from ugaitnet_tpu_torch.data.pipeline import preprocess_batch
    raw = {f"raw_{m}": np.ascontiguousarray(ds.modalities[m].volumes[:n])
           for m in MODS}
    raw.update({f"present_{m}": np.ones(n, np.float32) for m in MODS})
    raw["labels"] = np.zeros(n, np.int32)
    vols, _, _ = preprocess_batch(raw, MODS, (2, 1), (100.0, 1.0), 2, 1,
                                  False, DataConfig())
    return vols


def int8_error_bound(p, g, q_scale, p_scale):
    """Per pair, the most the int8 cross term can move d^2 (float64): with
    |x - q s| <= s / 2 per entry, |p.g - p^.g^| <= s_g |p|_1 / 2 + s_p
    (|g|_1 + D s_g / 2) / 2; d^2 moves by twice that, plus 1e-5 (|p|^2 +
    |g|^2) for the float32 norms and the int32 -> float32 conversion."""
    d = p.shape[1]
    p1, g1 = p.abs().sum(1), g.abs().sum(1)
    e = (0.5 * q_scale[None, :] * p1[:, None]
         + 0.5 * p_scale[:, None] * (g1[None, :] + 0.5 * d * q_scale[None, :]))
    return 2.0 * e + 1e-5 * ((p * p).sum(1)[:, None] + (g * g).sum(1)[None, :])


def int8_formula_checks(d2_card, codes, g, qp, ps, qg, gscale, g2, card):
    """The card's ``pairwise_l2_int8`` (P, G) against its formula on the
    CPU from the same int8 codes and scales: the cross term exact (float64
    sums of integer products stay below 2^53), rounded to float32, times
    the probe scales, then times the gallery scales, subtracted twice from
    |p|^2 + |g|^2.  With the norms summed on the CPU from the float codes,
    max |card - CPU| must stay within INT8_D2_REL (|p|^2 + |g|^2); with the
    card's own norms the two must agree bitwise.  Planted faults read
    against the same limit: |g|^2 from the dequantized codes, the gallery
    scales 10 % off, the scales per probe row; and, against bitwise, the
    two scales applied in the other order."""
    qp_c, ps_c = qp.cpu(), ps.cpu()
    qg_c, gs_c = qg.cpu(), gscale.cpu()
    codes_c, g_c = codes.cpu(), g.cpu()
    dot = (qp_c.double() @ qg_c.double().T).float()
    got = d2_card.cpu()

    def d2(p2, g2_, cross):
        return torch.clamp_min(p2[:, None] + g2_[None, :] - 2.0 * cross, 0.0)

    def rescale(ps_, gs_):
        return dot * ps_[:, None] * gs_[None, :]

    p2_c, g2_c = (codes_c * codes_c).sum(1), (g_c * g_c).sum(1)
    norm = p2_c[:, None] + g2_c[None, :]

    def over(want):
        return float(((got - want).abs() / norm).max())

    rel = over(d2(p2_c, g2_c, rescale(ps_c, gs_c)))
    own = d2((codes * codes).sum(1).cpu(), g2.cpu(), rescale(ps_c, gs_c))
    differ = int((got != own).sum())
    g2_deq = ((qg_c.float() * gs_c[:, None]) ** 2).sum(1)
    faults = {
        "|g|^2 from dequantized codes": over(d2(p2_c, g2_deq,
                                                rescale(ps_c, gs_c))),
        "gallery scales x 1.1": over(d2(p2_c, g2_c,
                                        rescale(ps_c, 1.1 * gs_c))),
        # (the gallery has at least as many rows as there are probes)
        "scales per probe row": over(d2(p2_c, g2_c, dot * ps_c[:, None]
                                        * gs_c[:len(ps_c), None]))}
    order = d2((codes * codes).sum(1).cpu(), g2.cpu(),
               dot * gs_c[None, :] * ps_c[:, None])
    order_differ = int((got != order).sum())
    print(f"int8 d^2 on the card vs its formula on the CPU ({tuple(got.shape)}"
          f", exact cross term): max |card - CPU| / (|p|^2 + |g|^2) "
          f"{rel:.2e} <= {INT8_D2_REL}; with the card's norms {differ} pairs"
          f" differ (bitwise required); planted faults "
          + ", ".join(f"{k} {v:.2e}" for k, v in faults.items())
          + f" > {INT8_D2_REL}; gallery scale before probe scale: "
          f"{order_differ} pairs not bitwise [{card}]")
    check(rel <= INT8_D2_REL, "int8 d^2 vs its CPU formula")
    check(differ == 0, f"int8 d^2 vs its CPU formula with the card's norms: "
          f"{differ} pairs not bitwise")
    check(all(v > INT8_D2_REL for v in faults.values()) and order_differ,
          "a planted int8 fault reads under the formula limit")
    return {"max_rel_err": rel, "pairs_not_bitwise": differ,
            "faults": faults, "swapped_order_pairs_not_bitwise":
            order_differ}


def labels_outside_near_ties(d2, labels, pred, k, eps):
    """Probes whose k-th and (k+1)-th float64 d^2 differ by more than 2 eps
    (eps: (P,) per probe, the int8 path's largest |d^2 error| over the
    gallery), a decision int8 resolution cannot move; and how many of
    those have pred != the float64 vote."""
    order = torch.argsort(d2, dim=1, stable=True).cpu().numpy()
    d2n = d2.cpu().numpy()
    want = []
    for r in order[:, :k]:
        labs, counts = np.unique(labels[r], return_counts=True)
        want.append(labs[np.argmax(counts)])
    want = np.asarray(want)
    kth = np.take_along_axis(d2n, order[:, k - 1:k + 1], 1)
    firm = kth[:, 1] - kth[:, 0] > 2.0 * eps
    return firm, int(((pred != want) & firm).sum())


def int8_phase(card, sets, gallery_dir, probe_dir, experdir, serve_res,
               bigs=(65536, 262144)):
    """8. The int8 gallery, the int8 encode and export at the flagship's
    width over phase 5's sets."""
    from ugaitnet_tpu_torch.cli import export_model
    from ugaitnet_tpu_torch.data.schema import GaitDataset
    from ugaitnet_tpu_torch.eval.export import ExportedEncoder, export_encoder
    from ugaitnet_tpu_torch.eval.serving import SignatureService
    from ugaitnet_tpu_torch.models.network import UGaitNet
    from ugaitnet_tpu_torch.ops.knn import (int8_mm, pairwise_l2_int8,
                                            quantize_rows)
    dev = torch.device("cuda")
    out = {}
    gallery_ds, probe_ds = GaitDataset.load(gallery_dir), \
        GaitDataset.load(probe_dir)
    vols = {m: probe_ds.modalities[m].volumes for m in MODS}

    def raw(idx):
        return {f"raw_{m}": np.ascontiguousarray(vols[m][idx]) for m in MODS}

    # -- the int32 cross term against an exact int64 product on the CPU
    rng = np.random.RandomState(8)
    gq = rng.randint(-127, 128, (2200, 15872)).astype(np.int8)
    g_cpu = torch.from_numpy(gq).long()
    g_dev = torch.from_numpy(gq).to(dev)
    for p in (128, 1, 8):
        pq = rng.randint(-127, 128, (p, 15872)).astype(np.int8)
        got = int8_mm(torch.from_numpy(pq).to(dev), g_dev).cpu()
        want = torch.from_numpy(pq).long() @ g_cpu.T
        check(got.dtype == torch.int32 and torch.equal(got.long(), want),
              f"int8 cross term P={p} differs from the int64 product")
    print("int8 cross term (cuBLASLt int8 GEMM, gallery rows as B = G^T) at "
          "P = 128, 1, 8 x G = 2,200 x D = 15,872: equal to the int64 CPU "
          f"product [{card}]")
    del g_cpu, g_dev

    model = UGaitNet(flagship_cfg(), seed=0)
    fp32 = SignatureService(model, MODS, knn=3, buckets=BUCKETS)
    fp32.build_gallery(gallery_ds, batch_size=128)
    svc = SignatureService(model, MODS, knn=3, buckets=BUCKETS,
                           gallery_dtype="int8")
    svc.set_gallery(fp32._host_codes, fp32._host_labels)
    n = len(probe_ds)
    lab_f, _ = fp32.identify_raw(raw(np.arange(n)))
    lab_q, dist_q = svc.identify_raw(raw(np.arange(n)))
    check(bool(np.isfinite(dist_q).all()), "int8 identify distances")

    # the rule: labels equal the fp32 service's wherever the float64
    # decision (k-th vs (k+1)-th neighbor) is wider than twice the int8
    # path's measured d^2 error; every d^2 within its hard bound
    codes = torch.from_numpy(fp32.encode_raw(raw(np.arange(n)))).to(dev)
    g = torch.from_numpy(fp32._host_codes).to(dev)
    rows = len(g)
    d2_64 = torch.clamp_min(
        (codes.double() ** 2).sum(1)[:, None]
        + (g.double() ** 2).sum(1)[None, :]
        - 2.0 * codes.double() @ g.double().T, 0.0)
    qg, sg, g2 = svc._gallery_codes, svc._gallery_scale, svc._gallery_sq
    d2_q32 = pairwise_l2_int8(codes, qg, sg, g2)[:, :rows]
    d2_q = d2_q32.double()
    qp, ps = quantize_rows(codes, xla_scale=True)
    formula = int8_formula_checks(d2_q32, codes, g, qp, ps, qg[:rows],
                                  sg[:rows], g2[:rows], card)
    out["int8_formula"] = formula
    lim = int8_error_bound(codes.double(), g.double(), sg[:rows].double(),
                           ps.double())
    err = (d2_q - d2_64).abs()
    eps_p = err.amax(dim=1).cpu().numpy()        # per probe
    eps = float(eps_p.max())
    check(bool((err <= lim).all()), "int8 d^2 outside its hard bound")
    ulabs = np.unique(fp32._host_labels)
    firm, bad = labels_outside_near_ties(d2_64, fp32._host_labels, lab_q, 3,
                                         eps_p)
    fbad = int(((lab_f != lab_q) & firm).sum())
    check(bad == 0 and fbad == 0,
          f"int8 labels differ outside near ties: {bad} vs float64, {fbad} "
          "vs the fp32 service")

    # planted fault: the gallery's per-row scales applied along the probe
    # axis of the cross term (per row of d^2) instead of per gallery row
    dot = int8_mm(qp, qg).float() * ps[:, None] * sg[:n, None]
    d2_f = torch.clamp_min((codes * codes).sum(1)[:, None] + g2[None, :]
                           - 2.0 * dot, 0.0)[:, :rows].double()
    ferr = (d2_f - d2_64).abs()
    fault_over = int((ferr > lim).sum())
    top = torch.topk(d2_f, 3, largest=False).indices.cpu().numpy()
    fault_pred = np.asarray([ulabs[np.argmax(np.bincount(
        np.searchsorted(ulabs, fp32._host_labels[r]),
        minlength=len(ulabs)))] for r in top])
    _, fault_bad = labels_outside_near_ties(d2_64, fp32._host_labels,
                                            fault_pred, 3, eps_p)
    out["identify_rule"] = {
        "probes": n, "max_abs_d2_err": eps,
        "max_err_over_bound": float((err / lim).max()),
        "near_ties": int((~firm).sum()),
        "labels_differ_from_fp32": int((lab_f != lab_q).sum()),
        "fault_pairs_over_bound": fault_over,
        "fault_max_abs_d2_err": float(ferr.max()),
        "fault_labels_off_outside_near_ties": fault_bad}
    print(f"int8 gallery identify_raw ({n} probes vs {rows} rows, k = 3): "
          f"labels differ from fp32 on {int((lab_f != lab_q).sum())}, all "
          f"within near ties ({int((~firm).sum())} probes whose k-th and "
          f"(k+1)-th float64 d^2 lie within twice the probe's measured max "
          f"|d^2 int8 - d^2 float64|, at most {eps:.3e}, median "
          f"{float(np.median(eps_p)):.3e}); every pair within its hard bound "
          f"(max error / bound {float((err / lim).max()):.3f}); planted "
          f"fault (scales per probe row): {fault_over} pairs over the bound, "
          f"max |d^2 err| {float(ferr.max()):.3e}, {fault_bad} labels off "
          f"outside near ties [{card}]")
    check(fault_over > 0 or fault_bad > 0,
          "the planted scale fault passes the int8 rule")
    del d2_64, d2_q, d2_f, err, ferr, lim, g

    # -- enroll in place (all three buffers), remove, self-queries
    new = codes[:64].cpu().numpy()
    new_labels = probe_ds.labels[:64]
    bufs = (svc._gallery_codes, svc._gallery_scale, svc._gallery_sq)
    ptrs, cap, used = [b.data_ptr() for b in bufs], svc._capacity, \
        svc._rows_used
    svc.enroll(np.concatenate([new, new]), np.concatenate([new_labels,
                                                           new_labels]))
    now = (svc._gallery_codes, svc._gallery_scale, svc._gallery_sq)
    check([b.data_ptr() for b in now] == ptrs and svc._capacity == cap,
          "int8 enroll did not write in place")
    qn, sn = quantize_rows(torch.from_numpy(np.concatenate([new, new]))
                           .to(dev))
    check(torch.equal(svc._gallery_codes[used:used + 128], qn)
          and torch.equal(svc._gallery_scale[used:used + 128], sn),
          "enrolled int8 rows on the card")
    check(np.array_equal(svc.identify_codes(new)[0], new_labels),
          "int8 self-queries after enroll")
    gone = int(new_labels[0])
    removed = svc.remove(gone)
    keep = new_labels != gone
    got = svc.identify_codes(new)[0]
    check(np.array_equal(got[keep], new_labels[keep]) and gone not in got,
          "int8 self-queries after remove")
    out["enroll_remove"] = {"enrolled": 128, "removed_rows": removed,
                            "capacity": int(svc._capacity)}
    print(f"int8 enroll 128 rows in place (codes, scales and |g|^2 keep "
          f"their storage; capacity {svc._capacity}), remove label {gone} "
          f"({removed} rows): {int(keep.sum())} self-queries keep their "
          f"labels, none returns {gone} [{card}]")
    del svc

    # -- identify_codes on large int8 galleries
    d = codes.shape[1]
    big = np.empty((max(bigs), d), np.float32)
    gen = torch.Generator(device=dev).manual_seed(5)
    for s0 in range(0, len(big), 32768):
        x = torch.randn(min(32768, len(big) - s0), d, device=dev,
                        generator=gen)
        x /= torch.linalg.vector_norm(x, dim=1, keepdim=True)
        big[s0:s0 + len(x)] = x.cpu().numpy()
    del x
    queries = big[:128] + 1e-4 * np.random.RandomState(0).randn(
        128, d).astype(np.float32)
    qdev = torch.from_numpy(queries).to(dev)
    out["big_gallery"] = {}
    for gsize in bigs:
        svc = SignatureService(model, MODS, knn=3, buckets=BUCKETS,
                               gallery_dtype="int8")
        t0 = time.perf_counter()
        svc.set_gallery(big[:gsize], np.arange(gsize) % 1000)
        torch.cuda.synchronize()
        set_s = time.perf_counter() - t0
        _, qd = svc.identify_codes(queries)
        check(bool((qd[:, 0] < 0.05).all() and (qd[:, 1] > 1.0).all()),
              f"int8 gallery G={gsize}: each query's nearest row is its own")
        call_ms = median_ms(lambda: svc.identify_codes(queries))
        with torch.no_grad():
            dev_ms = cuda_ms(lambda: svc._dist_vote(qdev, 3), 10)
        nbytes = gsize * d + 20 * gsize + 4 * 128 * d
        b_ms, b_by = bound_int8(nbytes, 2 * 128 * gsize * d)
        out["big_gallery"][gsize] = {
            "G": gsize, "D": d, "gallery_gb": gsize * d / 1e9,
            "set_gallery_s": set_s, "identify_codes_ms": call_ms,
            "device_ms": dev_ms, "bound_ms": b_ms, "bound_by": b_by}
        print(f"int8 identify_codes bucket 128 vs G={gsize} D={d} "
              f"({gsize * d / 1e9:.2f} GB int8): call {call_ms:.2f} ms "
              f"(median of 5), device (int8 cross term + rescale + top-k + "
              f"vote, CUDA events) {dev_ms:.3f} ms, bound {b_ms:.3f} ms "
              f"({b_by}); set_gallery {set_s:.1f} s [{card}]")
        del svc
        gc.collect()
        torch.cuda.empty_cache()
    f32 = serve_res["big_gallery"]
    print(f"  float32 at G={f32['G']} (phase 6): device {f32['device_ms']:.3f}"
          f" ms, bound {f32['bound_ms']:.3f} ms [{card}]")
    del big

    # -- quantized=True: the int8 encode, calibrated on 8 gallery clips
    svcq = SignatureService(model, MODS, knn=3, buckets=BUCKETS,
                            quantized=True,
                            calib_volumes=calib_volumes(gallery_ds))
    probes = raw(np.arange(128))
    q_codes = svcq.encode_raw(probes)
    f_codes = fp32.encode_raw(probes)
    cos = (q_codes * f_codes).sum(1) / (np.linalg.norm(q_codes, axis=1)
                                        * np.linalg.norm(f_codes, axis=1))
    out["int8_encode_cosine_min"] = float(cos.min())
    print(f"int8 encode (quantized=True) vs fp32 codes, 128 probes: cosine "
          f"min {cos.min():.5f}, mean {cos.mean():.5f} (limit {COS_MIN}) "
          f"[{card}]")
    check(cos.min() >= COS_MIN, "int8 encode cosine")
    conv = svcq._qnet.branches["branch_of"].a_conv2
    a1 = torch.from_numpy(np.random.RandomState(9).randint(
        -127, 128, (50, 64, 64, conv.cin)).astype(np.int8))
    acc_card = conv(a1.to(dev), lambda y: y).cpu()
    acc_cpu = copy.deepcopy(conv).cpu()(a1, lambda y: y)
    check(torch.equal(acc_card, acc_cpu),
          "a_conv2's int32 accumulators differ between card and CPU")
    print(f"branch_of.a_conv2 int32 accumulators ({tuple(acc_cpu.shape)}): "
          f"card == CPU, bitwise [{card}]")
    svcq.set_gallery(fp32._host_codes, fp32._host_labels)
    svcq.warmup()
    feeds = {b: raw(np.arange(b)) for b in BUCKETS}
    times = {b: median_ms(lambda b=b: svcq.identify_raw(feeds[b]))
             for b in BUCKETS}
    out["identify_raw_ms_int8_encode"] = times
    ref = serve_res["identify_raw_ms"]
    print("identify_raw ms by bucket (median of 5), int8 encode / fp32 / "
          "bf16 (phase 6): " + ", ".join(
              f"{b}: {times[b]:.2f} / {ref['float32'][b]:.2f} / "
              f"{ref['bfloat16'][b]:.2f}" for b in BUCKETS) + f" [{card}]")

    # -- export both services; a fresh process loads and encodes
    art = {}
    for name, s_ in (("fp32", fp32), ("int8", svcq)):
        art[name] = os.path.join(sets, f"artifact_{name}")
        t0 = time.perf_counter()
        sizes = export_encoder(s_, art[name], buckets=BUCKETS)
        out[f"export_{name}_s"] = time.perf_counter() - t0
        out[f"export_{name}_mb"] = {b: v / 1e6 for b, v in sizes.items()}
    print(f"export_encoder buckets {BUCKETS}: fp32 "
          f"{out['export_fp32_s']:.1f} s ({out['export_fp32_mb']} MB), int8"
          f" {out['export_int8_s']:.1f} s ({out['export_int8_mb']} MB) "
          f"[{card}]")
    feed = os.path.join(sets, "probes128.npz")
    np.savez(feed, **probes)
    res = subprocess.run([sys.executable, "-c", EXPORT_BOOT, REPO, feed]
                         + [art["fp32"], art["int8"]], capture_output=True,
                         text=True, timeout=600)
    check(res.returncode == 0, f"export subprocess:\n{res.stderr[-3000:]}")
    lines = res.stdout.strip().splitlines()
    boot_launches, mods = json.loads(lines[-2]), json.loads(lines[-1])
    check("ugaitnet_tpu_torch.eval.export" in mods and not any(
        m.startswith(("ugaitnet_tpu_torch.models", "ugaitnet_tpu_torch.ops"))
        and m not in EXPORT_OP_MODULES for m in mods),
        f"the loading process imported {mods}")
    # one encode at bucket 128: each branch's two stage tails in the fp32
    # program; the int8 program keeps its integer tail
    want_ops = {"fp32": (["ugaitnet::stage_tail"], [4, 0]),
                "int8": ([], [0, 0])}
    out["export_tail_launches"] = {}
    for name, want in (("fp32", f_codes), ("int8", q_codes)):
        got = np.load(os.path.join(art[name], "codes.npy"))
        e = float(np.abs(got - want).max() / np.abs(want).max())
        with open(os.path.join(art[name], "meta.json")) as f:
            ops = json.load(f)["custom_ops"]
        n = boot_launches[art[name]]
        out[f"export_{name}_rel_err"] = e
        out["export_tail_launches"][name] = n
        same = bool(np.array_equal(got, want))
        print(f"artifact {name} in a fresh process ({len(mods)} port modules"
              f", no models; custom ops {ops}, stage-tail launches {n}): 128 "
              f"probes, max |artifact - service| / max |service| {e:.2e} "
              f"(limit {EXPORT_REL}; bitwise {same}) [{card}]")
        check(got.shape == want.shape and e <= EXPORT_REL,
              f"artifact {name} vs its service")
        check((ops, n) == want_ops[name],
              f"artifact {name}: custom ops {ops}, launches {n}")
        if name == "fp32":      # the same kernel serves both
            check(np.array_equal(got, want), "the fp32 artifact differs from"
                  " the kernel-served service's codes")
    try:
        ExportedEncoder(art["fp32"], device="cpu")
    except RuntimeError as e:
        check("cli/export_model.py" in str(e), f"platform guard: {e}")
    else:
        check(False, "a device='cpu' load of the cuda artifact did not raise")

    # -- the export CLI on phase 7's best
    cli_out = os.path.join(sets, "artifact_cli")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        export_model.main(["--experdir", experdir, "--epoch", "best",
                           "--out", cli_out, "--buckets", "1", "8"])
    enc = ExportedEncoder(cli_out)
    codes5 = enc.encode(raw(np.arange(5)))
    check(codes5.shape == (5, 62 * 256) and np.isfinite(codes5).all(),
          "the export CLI's artifact")
    print(f"cli.export_model on phase 7's best -> buckets {enc.buckets}, "
          f"5 probes encode to {codes5.shape}, finite [{card}]")
    return out


BRANCH_STEPS = 3


def branch_phase(card):
    """9. The train CLI's --no-gaitset (2D CNN) and --no-gaitset --use3d
    (3D CNN) nets at full width: forward card vs CPU, Adam steps, the last
    of them against a step with the plain triplet, the Keras L2 term card
    vs CPU, int8 encode."""
    from ugaitnet_tpu_torch.cli import train as cli_train
    from ugaitnet_tpu_torch.core.config import DataConfig
    from ugaitnet_tpu_torch.data.pipeline import preprocess_batch
    from ugaitnet_tpu_torch.models.network import UGaitNet
    from ugaitnet_tpu_torch.ops.cuda import conv3d_wgrad as CW
    from ugaitnet_tpu_torch.ops.quantize import (encode_int8,
                                                 quantize_model_params)
    from ugaitnet_tpu_torch.train.train_step import (Batch, init_state,
                                                     l2_regularization,
                                                     make_train_step)
    dcfg = DataConfig()
    mods = (MODS, (2, 1), (100.0, 1.0), 2)
    out = {}

    for name, flags in (("conv2d", ["--no-gaitset"]),
                        ("conv3d", ["--no-gaitset", "--use3d"])):
        args = cli_train.build_parser().parse_args(
            ["--mod0", "of", "--mod1", "gray", "--nclasses", "74"] + flags)
        mcfg, _, tcfg = cli_train.configs_from_args(args)
        model = UGaitNet(mcfg, seed=0)
        cpu = UGaitNet(mcfg, device="cpu", seed=1)
        cpu.load_state_dict({k: v.cpu() for k, v in
                             model.state_dict().items()})
        res = {"parameters": sum(p.numel() for p in model.parameters())}

        # forward, card vs CPU (TF32 off; on, it must fail the limit)
        small, flg, _ = preprocess_batch(raw_batch(4, 2, seed=11), *mods, 1,
                                         False, dcfg)
        with torch.inference_mode():
            on_cpu = cpu([v.cpu() for v in small], [f.cpu() for f in flg],
                         train=False)

        def card_vs_cpu(tf32):
            torch.backends.cuda.matmul.allow_tf32 = tf32
            torch.backends.cudnn.allow_tf32 = tf32
            with torch.inference_mode():
                o = model(small, flg, train=False)
            return {k: rel_err(o[k].cpu(), on_cpu[k])
                    for k in ("signature", "classprob_logits")}
        err, tf32_err = card_vs_cpu(False), card_vs_cpu(True)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        res["card_vs_cpu"], res["card_vs_cpu_tf32"] = err, tf32_err
        for k in err:
            print(f"{name} forward {k}: card vs CPU {err[k]:.2e} <= "
                  f"{CPU_REL}; with TF32 on {tf32_err[k]:.2e} > {CPU_REL} "
                  f"[{card}]")
            check(err[k] <= CPU_REL, f"{name} card vs CPU {k}")
            check(tf32_err[k] > CPU_REL,
                  f"{name} card vs CPU {k}: TF32 passes the limit")

        # Adam steps on B = 120 (40 raw x expand 3, augmentation on)
        state = init_state(model, tcfg)
        step = make_train_step(mcfg, tcfg)
        raw = raw_batch(40, 8, seed=12)
        gen = torch.Generator().manual_seed(0)
        step_ms, losses, kstore = [], [], {}
        CW.launches = 0
        for i in range(BRANCH_STEPS):
            r = dict(raw)
            r["raw_of"] = raw["raw_of"] ^ i
            r["raw_gray"] = raw["raw_gray"] ^ i
            if i == BRANCH_STEPS - 1:   # the state the plain step starts from
                before = (copy.deepcopy(state.model.state_dict()),
                          copy.deepcopy(state.optimizer.state_dict()),
                          state.step)
                hook = capture(state.model, kstore)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            v, f, lab = preprocess_batch(r, *mods, 3, True, dcfg,
                                         generator=gen)
            batch = Batch(tuple(v), tuple(f), lab)
            _, m = step(state, batch)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            losses.append({k: float(x) for k, x in m.items()})
        hook.remove()
        # conv0 of each 3D branch takes the hand weight gradient
        res["wgrad_launches"] = CW.launches
        want = 2 * BRANCH_STEPS if name == "conv3d" else 0
        print(f"{name}: conv3d_wgrad launches in {BRANCH_STEPS} steps "
              f"{CW.launches} (expected {want}) [{card}]")
        check(CW.launches == want, f"{name}: conv3d_wgrad launched "
              f"{CW.launches}x in {BRANCH_STEPS} steps, expected {want}")
        check(tuple(v[0].shape)[0] == 120, "B = 120")
        check(all(np.isfinite(x) for m in losses for x in m.values()),
              f"{name} losses {losses}")
        # the last step again with the plain triplet: same state, same
        # augmented batch, same dropout masks
        res["sig_grad_rel_err"] = kernel_vs_plain_step(
            name, mcfg, tcfg, before, batch, kstore, losses[-1])
        del before
        cpu.load_state_dict({k: x.cpu() for k, x in
                             model.state_dict().items()})
        with torch.no_grad():
            reg_card = float(l2_regularization(model, mcfg))
            reg_cpu = float(l2_regularization(cpu, mcfg))
        reg_rel = abs(reg_card - reg_cpu) / reg_cpu
        res.update(losses=losses, step_ms=step_ms, reg=reg_card,
                   reg_rel=reg_rel)
        print(f"{name}: {BRANCH_STEPS} Adam steps B=120, losses "
              f"{[round(m['loss'], 6) for m in losses]}, reg card "
              f"{reg_card:.7g} vs CPU {reg_cpu:.7g} (rel {reg_rel:.1e}, "
              f"limit 1e-6), step ms {[round(t, 2) for t in step_ms]} "
              f"(first includes cuDNN warm-up) [{card}]")
        check(reg_rel <= 1e-6, f"{name} reg card vs CPU")

        # int8 encode against the float net (per-sample L2)
        model.eval()
        calib, _, _ = preprocess_batch(raw_batch(8, 2, seed=13), *mods, 1,
                                       False, dcfg)
        qnet = quantize_model_params(model, mcfg, calib)
        probe, pf, _ = preprocess_batch(raw_batch(128, 8, seed=14), *mods, 1,
                                        False, dcfg)
        with torch.no_grad():
            q = encode_int8(qnet, probe, pf, mcfg)
            fl = model(probe, pf, train=False)["flatten"]
        cos = (q * fl).sum(1) / (q.norm(dim=1) * fl.norm(dim=1))
        res["int8_cosine_min"] = float(cos.min())
        print(f"{name} int8 encode vs fp32, 128 clips: cosine min "
              f"{float(cos.min()):.5f} (limit {COS_MIN}) [{card}]")
        check(float(cos.min()) >= COS_MIN, f"{name} int8 encode cosine")
        out[name] = res
        del model, cpu, state, qnet
        torch.cuda.empty_cache()
    return out



SURFACE_STEPS = 3
# phase 10: the head alone (``_head_forward`` on the same branch
# embeddings), card vs CPU: max |card - CPU| <= HEAD_CPU_REL * max |CPU| per
# tap.  The head is three float32 GEMMs and elementwise ops, so the two
# differ only in summation order (~1e-6 expected), ten times inside phase
# 4's CPU_REL; TF32 rounds the GEMMs' inputs to 10 mantissa bits (~4e-4 of
# each product), which must fail it.
HEAD_CPU_REL = 3e-5
# phase 10's losses, card vs CPU on the same inputs: values within
# LOSS_RTOL (float32 sums in another order, ~1e-7 expected); gradients
# max |card - CPU| <= LOSS_GRAD_REL * max |CPU| (the distances behind them
# differ by the Gram formula's rounding, ~1e-7 relative).  The semi-hard and
# hard kinds select by comparing distances: where two compared distances of
# the CPU lie within twice the largest card - CPU distance gap, the card may
# select the other way.  Those near ties are counted; the value may move by
# what each could change, and the gradient is held on the (sample, part)
# entries no near tie touches.  On the card's own distances, card and CPU
# select alike: value and gradient within SAME_DIST_REL.
LOSS_RTOL = 1e-5
LOSS_GRAD_REL = 1e-4
SAME_DIST_REL = 1e-6
# phase 10's kernel step vs the plain-triplet step from the same state
SURFACE_STEP_RTOL = 1e-6
# remat vs no remat, same state and batch: gradients max |delta| <=
# REMAT_REL * max |grad| per parameter (the same ops re-executed; bitwise
# under deterministic cuDNN)
REMAT_REL = 1e-6


def semi_hard_ties(d, lab, w, margin):
    """Near ties of the semi-hard selection on (P, B, B) distances ``d`` at
    window ``w``, per (part, anchor a, positive q): a negative within w of
    d(a, q) (outside on one device, not on the other), the two nearest
    outside candidates within w of each other, the two farthest negatives
    within w where the inside fallback applies, or the hinge within w of 0.
    Returns (count, the most the value can move, a (B, P) mask of the
    gradient entries a tie can move: a, q, the three nearest candidates and
    the two farthest negatives)."""
    b, parts = lab.shape[0], d.shape[0]
    same = lab[:, None] == lab[None, :]
    neg = ~same
    pos = same & ~torch.eye(b, dtype=torch.bool, device=d.device)
    num_pos = int(pos.sum())
    inf = torch.tensor(float("inf"), device=d.device)
    count, change = 0, 0.0
    touched = torch.zeros(b, parts, dtype=torch.bool, device=d.device)
    for p, dp in enumerate(d):
        dn, dq = dp[:, None, :], dp[:, :, None]        # [a, q, n]
        boundary = (((dn - dq).abs() < w) & neg[:, None, :]).any(2)
        # every negative that is outside on either device, nearest first
        cand = torch.where(neg[:, None, :] & (dn > dq - w), dn, inf)
        near, nidx = torch.topk(cand, 3, dim=2, largest=False)
        far, fidx = torch.topk(torch.where(neg, dp, -inf), 2, dim=1)
        no_outside = torch.isinf(near[..., 0])
        second = (near[..., 1] - near[..., 0]) < w
        inside = no_outside & ((far[:, 0] - far[:, 1]) < w)[:, None]
        sel = torch.where(no_outside, far[:, :1], near[..., 0])
        hinge = (margin + dp - sel).abs() < w
        tied = (boundary | second | inside | hinge) & pos
        if not bool(tied.any()):
            continue
        a, q = torch.nonzero(tied, as_tuple=True)
        count += len(a)
        # the selected negative moves at most from the nearest candidate to
        # the third; without three candidates, at most by the largest d
        span = near[a, q, 2] - near[a, q, 0]
        span = torch.where(torch.isfinite(span), span, dp.max())
        change += float((span + w).sum()) / (num_pos * parts)
        for j in (a, q, nidx[a, q].reshape(-1), fidx[a].reshape(-1)):
            touched[j, p] = True
    return count, change, touched


def hard_ties(d, lab, w, margin):
    """Near ties of the hard selection: per (part, anchor) the two farthest
    positives, or the two nearest negatives, within w; or the hinge within w
    of 0.  Returns (count, the value's possible change, (B, P) mask)."""
    b = lab.shape[0]
    same = lab[:, None] == lab[None, :]
    pos = same & ~torch.eye(b, dtype=torch.bool, device=d.device)
    inf = torch.tensor(float("inf"), device=d.device)
    pv, pi = torch.topk(torch.where(pos, d, -inf), 2, dim=2)
    nv, ni = torch.topk(torch.where(~same, d, inf), 2, dim=2, largest=False)
    tied = (((pv[..., 0] - pv[..., 1]) < w) | ((nv[..., 1] - nv[..., 0]) < w)
            | ((pv[..., 0] - nv[..., 0] + margin).abs() < w))     # (P, B)
    touched = torch.zeros(b, d.shape[0], dtype=torch.bool, device=d.device)
    for p, a in torch.nonzero(tied).tolist():
        touched[[a] + pi[p, a].tolist() + ni[p, a].tolist(), p] = True
    count = int(tied.sum())
    return count, count * w / (b * d.shape[0]), touched


def surface_phase(card, kernel_ms):
    """10. The rest of the model and loss surface at the flagship's width:
    casenet C with postriplet 2, aux heads and dropcode through the triplet
    kernel (and one postriplet-1 step); the head alone card vs CPU; the
    semi-hard, hard, contrastive, focal and pair losses card vs CPU; remat
    against no remat; the Siamese pair step on the 2D CNN net."""
    from ugaitnet_tpu_torch.cli import train as cli_train
    from ugaitnet_tpu_torch.core.config import (BranchConfig, DataConfig,
                                                ModelConfig, TrainConfig)
    from ugaitnet_tpu_torch.data.pipeline import preprocess_batch
    from ugaitnet_tpu_torch.models.network import (UGaitNet, _head_forward,
                                                   branch_input)
    from ugaitnet_tpu_torch.ops import losses as L
    from ugaitnet_tpu_torch.ops import triplet as TT
    from ugaitnet_tpu_torch.ops.cuda import triplet_kernel as K
    from ugaitnet_tpu_torch.train.train_step import (
        Batch, PairBatch, embed_pair_side, init_state, make_pair_train_step,
        make_train_step, pair_keys)
    dev = torch.device("cuda")
    dcfg = DataConfig()
    mods = (MODS, (2, 1), (100.0, 1.0), 2)
    base = ModelConfig(
        branches=(BranchConfig(kind="gaitset", modality="of"),
                  BranchConfig(kind="gaitset", modality="gray")),
        merge="sign_max", nclasses=74)
    tcfg = TrainConfig()
    out = {}
    torch.backends.cudnn.deterministic = True

    # ---- (a) casenet C, postriplet 2, aux heads, dropcode 0.4 -------------
    mcfg = dataclasses.replace(base, extra_dense=(256,), postriplet=2,
                               aux_losses=True, dropout_code=0.4)
    state = init_state(UGaitNet(mcfg, seed=0), tcfg)
    step = make_train_step(mcfg, tcfg)
    raw = raw_batch(40, 8, seed=21)
    gen = torch.Generator().manual_seed(0)
    losses, step_ms, kstore = [], [], {}
    K.reset_launch_counts()
    for i in range(SURFACE_STEPS):
        r = dict(raw)
        r["raw_of"] = raw["raw_of"] ^ i
        r["raw_gray"] = raw["raw_gray"] ^ i
        v, f, lab = preprocess_batch(r, *mods, 3, True, dcfg, generator=gen)
        batch = Batch(tuple(v), tuple(f), lab)
        if i == SURFACE_STEPS - 1:   # the state the plain step starts from
            before = (copy.deepcopy(state.model.state_dict()),
                      copy.deepcopy(state.optimizer.state_dict()),
                      state.step)
            hook = capture(state.model, kstore)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, m = step(state, batch)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append({k: float(x) for k, x in m.items()})
    hook.remove()
    launches = {"triplet_fwd": K.fwd_launches, "triplet_bwd": K.bwd_launches}
    check(launches == {"triplet_fwd": SURFACE_STEPS,
                       "triplet_bwd": SURFACE_STEPS},
          f"casenet C steps: triplet launches {launches}")
    check(tuple(kstore["sig"].shape) == (120, 62, 256),
          f"postriplet 2 signature {tuple(kstore['sig'].shape)}")
    check(all(np.isfinite(x) for m in losses for x in m.values())
          and {"aux_ce_0", "aux_ce_1"} <= set(losses[-1]),
          f"casenet C losses {losses}")
    print(f"casenet C postriplet 2 + aux + dropcode 0.4: {SURFACE_STEPS} "
          f"Adam steps B=120, losses "
          f"{[round(m['loss'], 6) for m in losses]}, triplet launches "
          f"{launches}, step ms {[round(t, 2) for t in step_ms]} (the "
          f"first after a new config) [{card}]")
    pt2 = dict(losses=losses, step_ms=step_ms, launches=launches)
    pt2["sig_grad_rel_err"] = kernel_vs_plain_step(
        "casenet C pt2", mcfg, tcfg, before, batch, kstore, losses[-1],
        rtol=SURFACE_STEP_RTOL)
    del before

    # the head alone, on the card's branch embeddings, card vs CPU
    net = state.model
    net.eval()
    with torch.inference_mode():
        emb = [net.branches[f"branch_{b.modality}"](branch_input(b, x))
               for b, x in zip(mcfg.branches, batch.volumes)]
    cpu_net = copy.deepcopy(net).to("cpu")
    with torch.inference_mode():
        on_cpu = _head_forward(mcfg, [e.cpu() for e in emb],
                               [f.cpu() for f in batch.use_flags], cpu_net)

    def head_err(tf32):
        torch.backends.cuda.matmul.allow_tf32 = tf32
        torch.backends.cudnn.allow_tf32 = tf32
        with torch.inference_mode():
            o = _head_forward(mcfg, emb, batch.use_flags, net)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        err = {k: rel_err(o[k].cpu(), on_cpu[k]) for k in
               ("signature", "code", "flatten", "classprob_logits")}
        for i, al in enumerate(o["aux_logits"]):
            err[f"aux_logits_{i}"] = rel_err(al.cpu(), on_cpu["aux_logits"][i])
        return err
    head, head_tf32 = head_err(False), head_err(True)
    print(f"head alone (B=120), card vs CPU, max |d| / max |CPU| (limit "
          f"{HEAD_CPU_REL}): " + ", ".join(f"{k} {v:.2e}" for k, v in
                                            head.items())
          + f"; with TF32 on, largest {max(head_tf32.values()):.2e} [{card}]")
    check(max(head.values()) <= HEAD_CPU_REL, "head alone card vs CPU")
    check(max(head_tf32.values()) > HEAD_CPU_REL,
          "head alone: TF32 passes the limit")
    pt2.update(head_card_vs_cpu=head, head_card_vs_cpu_tf32=head_tf32)
    out["casenet_c_pt2"] = pt2
    del state, net, cpu_net, emb

    # one step at postriplet 1
    mcfg1 = dataclasses.replace(mcfg, postriplet=1)
    state = init_state(UGaitNet(mcfg1, seed=0), tcfg)
    before = (copy.deepcopy(state.model.state_dict()),
              copy.deepcopy(state.optimizer.state_dict()), state.step)
    kstore = {}
    hook = capture(state.model, kstore)
    K.reset_launch_counts()
    _, m = make_train_step(mcfg1, tcfg)(state, batch)
    launches1 = {"triplet_fwd": K.fwd_launches,
                 "triplet_bwd": K.bwd_launches}
    hook.remove()
    check(launches1 == {"triplet_fwd": 1, "triplet_bwd": 1},
          f"postriplet 1 step: triplet launches {launches1}")
    pt1_losses = {k: float(x) for k, x in m.items()}
    check(all(np.isfinite(x) for x in pt1_losses.values()),
          f"postriplet 1 losses {pt1_losses}")
    out["casenet_c_pt1"] = dict(
        losses=pt1_losses, launches=launches1,
        sig_grad_rel_err=kernel_vs_plain_step(
            "casenet C pt1", mcfg1, tcfg, before, batch, kstore, pt1_losses,
            rtol=SURFACE_STEP_RTOL))
    del state, before
    out["launches"] = {k: launches[k] + launches1[k] for k in launches}

    # ---- (b) the losses, card vs CPU -----------------------------------
    g = torch.Generator(device=dev).manual_seed(22)
    lab = torch.as_tensor(np.repeat(np.arange(8), 15), dtype=torch.int32,
                          device=dev)
    x = torch.randn(120, 62, 256, device=dev, generator=g)
    margin = tcfg.margin

    def value_grad(fn, *args):
        """fn's value and its gradients w.r.t. the floating args."""
        leaves = [a.detach().clone().requires_grad_(True)
                  if a.is_floating_point() else a for a in args]
        v = fn(*leaves)
        grads = torch.autograd.grad(
            v, [a for a in leaves if a.requires_grad])
        return float(v.detach()), grads

    def timed(fn, *args):
        """Forward + backward ms on the card (CUDA events)."""
        leaves = [a.detach().clone().requires_grad_(True)
                  if a.is_floating_point() else a for a in args]
        diff = [a for a in leaves if a.requires_grad]
        return cuda_ms(lambda: torch.autograd.grad(fn(*leaves), diff), 10)

    loss_res = {}
    d_card = TT.pairwise_dist(x.transpose(0, 1))
    d_cpu = TT.pairwise_dist(x.cpu().transpose(0, 1))
    w = 2.0 * float((d_card.cpu() - d_cpu).abs().max())
    for kind, from_dist, ties in (
            ("semi_hard", TT.semi_hard_from_dist, semi_hard_ties),
            ("hard", TT.hard_from_dist, hard_ties)):
        fn = TT.make_triplet_loss(kind, margin)
        vc, (gc_,) = value_grad(fn, x, lab)
        vp, (gp,) = value_grad(fn, x.cpu(), lab.cpu())
        # on the card's own distances: the same selection on both devices
        vdc, (gdc,) = value_grad(lambda d, l: from_dist(d, l, margin),
                                 d_card, lab)
        vdp, (gdp,) = value_grad(lambda d, l: from_dist(d, l, margin),
                                 d_card.cpu(), lab.cpu())
        same_v = abs(vdc - vdp) / abs(vdp)
        same_g = rel_err(gdc.cpu(), gdp)
        n_ties, change, touched = ties(d_cpu.to(dev), lab, w, margin)
        keep = ~touched.cpu()
        g_err = rel_err(gc_.cpu()[keep], gp[keep])
        ms = timed(fn, x, lab)
        loss_res[kind] = dict(value=vc, cpu=vp, rel=abs(vc - vp) / abs(vp),
                              allowance=change, near_ties=n_ties,
                              entries_touched=int(touched.sum()),
                              grad_rel_err_untouched=g_err,
                              same_dist_rel=same_v, same_dist_grad=same_g,
                              ms=ms)
        print(f"{kind} (62, 120, 256), card vs CPU: value {vc:.7f} vs "
              f"{vp:.7f} (|d| {abs(vc - vp):.2e} <= {LOSS_RTOL} |v| + "
              f"{change:.2e} for {n_ties} near ties at window {w:.2e}); "
              f"gradient {g_err:.2e} <= {LOSS_GRAD_REL} on the "
              f"{int(keep.sum())} of {keep.numel()} (sample, part) entries "
              f"no near tie touches; on the card's distances value "
              f"{same_v:.2e}, gradient {same_g:.2e} <= {SAME_DIST_REL}; "
              f"fwd + bwd {ms:.3f} ms (triplet kernel fwd + bwd "
              f"{kernel_ms:.3f} ms) [{card}]")
        check(abs(vc - vp) <= LOSS_RTOL * abs(vp) + change, f"{kind} value")
        check(g_err <= LOSS_GRAD_REL, f"{kind} gradient")
        check(same_v <= SAME_DIST_REL and same_g <= SAME_DIST_REL,
              f"{kind} on the same distances")
        check(keep.float().mean() >= 0.5,
              f"{kind}: near ties touch most gradient entries")

    flat = torch.randn(120, 15872, device=dev, generator=g)
    coded = lab * 100 + torch.randint(0, 11, (120,), device=dev,
                                      generator=g, dtype=torch.int32)
    probs = torch.softmax(3.0 * torch.randn(120, 74, device=dev,
                                            generator=g), dim=-1)
    onehot = torch.nn.functional.one_hot(lab.long(), 74).float()
    e1, e2 = flat[:60] / 100.0, flat[60:] / 100.0
    pair = (lab[:60] == lab[torch.randperm(120, device=dev,
                                           generator=g)[60:]]).int()
    res2 = ((e1 - e2) ** 2).sum(1)
    # a margin past the pooled negative residual, so both terms are active
    pair_margin = 1.5 * float(res2[pair == 0].sum().sqrt())
    for name, fn, args in (
            ("contrastive_aux", TT.contrastive_aux_loss, (flat, coded)),
            ("focal", L.sigmoid_focal_crossentropy, (probs, onehot)),
            ("verif_pair", lambda a, b, l: L.verif_pair_loss(
                a, b, l, pair_margin), (e1, e2, pair))):
        vc, gcs = value_grad(fn, *args)
        vp, gps = value_grad(fn, *[a.cpu() for a in args])
        rel = abs(vc - vp) / abs(vp)
        g_err = max(rel_err(a.cpu(), b) for a, b in zip(gcs, gps))
        ms = timed(fn, *args)
        loss_res[name] = dict(value=vc, cpu=vp, rel=rel, grad_rel_err=g_err,
                              ms=ms)
        print(f"{name} {tuple(args[0].shape)}, card vs CPU: value {vc:.7g} "
              f"vs {vp:.7g} (rel {rel:.2e} <= {LOSS_RTOL}), gradient "
              f"{g_err:.2e} <= {LOSS_GRAD_REL}; fwd + bwd {ms:.3f} ms "
              f"[{card}]")
        check(rel <= LOSS_RTOL and g_err <= LOSS_GRAD_REL, f"{name} card vs CPU")
    out["losses"] = loss_res

    # ---- (c) remat ---------------------------------------------------------
    remat_res, grads = {}, {}
    for remat in (False, True):
        gc.collect()
        torch.cuda.empty_cache()
        cfg = dataclasses.replace(base, remat=remat)
        st = init_state(UGaitNet(cfg, seed=0), tcfg)
        fn = make_train_step(cfg, tcfg)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times = []
        for i in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, m = fn(st, batch)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            if i == 0:
                peak = torch.cuda.max_memory_allocated() / 1e9
                grads[remat] = {k: p.grad.detach().clone()
                                for k, p in st.model.named_parameters()}
                loss0 = float(m["loss"])
        remat_res[remat] = dict(peak_gb=peak, step_ms=times, loss=loss0)
        del st, fn
    diff = max(float((grads[True][k] - g0).abs().max() / g0.abs().max())
               for k, g0 in grads[False].items())
    bitwise = all(torch.equal(grads[True][k], g0)
                  for k, g0 in grads[False].items())
    print(f"remat: gradients max |d| / max |grad| {diff:.2e} (limit "
          f"{REMAT_REL}; bitwise {bitwise}), loss "
          f"{remat_res[False]['loss']:.7f} vs {remat_res[True]['loss']:.7f};"
          f" peak {remat_res[False]['peak_gb']:.2f} GB -> "
          f"{remat_res[True]['peak_gb']:.2f} GB; step ms "
          f"{[round(t, 2) for t in remat_res[False]['step_ms']]} -> "
          f"{[round(t, 2) for t in remat_res[True]['step_ms']]} [{card}]")
    check(diff <= REMAT_REL, "remat gradients")
    check(remat_res[True]["peak_gb"] < remat_res[False]["peak_gb"],
          "remat does not lower the peak")
    out["remat"] = dict(grad_rel_diff=diff, bitwise=bitwise,
                        off=remat_res[False], on=remat_res[True])
    del grads

    # ---- (d) the pair step on the 2D CNN net ------------------------------
    args = cli_train.build_parser().parse_args(
        ["--mod0", "of", "--mod1", "gray", "--nclasses", "74",
         "--no-gaitset", "--margin", "0.5"])
    cnn_cfg, _, cnn_tcfg = cli_train.configs_from_args(args)
    st = init_state(UGaitNet(cnn_cfg, seed=0), cnn_tcfg)
    pstep = make_pair_train_step(cnn_tcfg)
    perm = torch.as_tensor(np.random.RandomState(0).permutation(120),
                           device=dev)

    def side(idx):
        return Batch(tuple(v[idx] for v in batch.volumes),
                     tuple(f[idx] for f in batch.use_flags),
                     batch.labels[idx])
    pb = PairBatch(side(perm[:60]), side(perm[60:]),
                   (batch.labels[perm[:60]] == batch.labels[perm[60:]]).int())
    pair_losses, pair_ms = [], []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, m = pstep(st, pb)
        torch.cuda.synchronize()
        pair_ms.append((time.perf_counter() - t0) * 1e3)
        pair_losses.append(float(m["pair_loss"]))
    check(all(np.isfinite(pair_losses)), f"pair losses {pair_losses}")
    k1, k2 = pair_keys(st.step)
    with torch.no_grad():
        pe = [embed_pair_side(st.model, b, k)
              for b, k in ((pb.batch1, k1), (pb.batch2, k2))]
    vc, gcs = value_grad(lambda a, b, l: L.verif_pair_loss(a, b, l, 0.5),
                         pe[0], pe[1], pb.pair_labels)
    vp, gps = value_grad(lambda a, b, l: L.verif_pair_loss(a, b, l, 0.5),
                         pe[0].cpu(), pe[1].cpu(), pb.pair_labels.cpu())
    rel = abs(vc - vp) / abs(vp)
    g_err = max(rel_err(a.cpu(), b) for a, b in zip(gcs, gps))
    print(f"pair step, 2D CNN, 2 x 60 clips ({int(pb.pair_labels.sum())} "
          f"same pairs), margin 0.5: losses {[round(v, 6) for v in pair_losses]}"
          f", step ms {[round(t, 2) for t in pair_ms]}; loss on the card's "
          f"embeddings card vs CPU rel {rel:.2e} <= {LOSS_RTOL}, gradient "
          f"{g_err:.2e} <= {LOSS_GRAD_REL} [{card}]")
    check(rel <= LOSS_RTOL and g_err <= LOSS_GRAD_REL, "pair loss card vs CPU")
    out["pair_step"] = dict(losses=pair_losses, step_ms=pair_ms, rel=rel,
                            grad_rel_err=g_err)
    torch.backends.cudnn.deterministic = False
    return out


# phase 11: the standardized volumes of one raw joint batch, card vs CPU:
# max |card - CPU| <= NORM_REL * max |CPU| (float64 x * scale - mean, then
# a float32 divide, the same IEEE operations on both devices; the limit of
# tests/test_torch_cuda.py's augmenting preprocess).  Every run also reads
# the card with the two dataset-source rows swapped, which must lie above it.
NORM_REL = 1e-6
JOINT_EPOCHS = 2
TUM_SHAPE = dict(num_subjects=150, videos_per_subject=2, subseqs_per_video=2,
                 num_cams=1, template_seed=1, seed=8, name="tum_train")


def joint_phase(card, work, casia_dir, gallery_dir, probe_dir, fit7_ms):
    """11. Joint two-dataset training, warm starts, the sweep, and evaluate
    and export of a two-source run, through the CLIs at the flagship's
    width, in the directory ``work`` (which the caller removes)."""
    from ugaitnet_tpu_torch.cli import evaluate as cli_eval
    from ugaitnet_tpu_torch.cli import export_model as cli_export
    from ugaitnet_tpu_torch.cli import sweep as cli_sweep
    from ugaitnet_tpu_torch.cli import train as cli_train
    from ugaitnet_tpu_torch.core import checkpoint as ckpt
    from ugaitnet_tpu_torch.core.config import DataConfig
    from ugaitnet_tpu_torch.data import pipeline as PL
    from ugaitnet_tpu_torch.data.sampler import split_train_val_by_video
    from ugaitnet_tpu_torch.data.schema import GaitDataset
    from ugaitnet_tpu_torch.data.synthetic import make_synthetic_dataset
    from ugaitnet_tpu_torch.eval.export import ExportedEncoder
    from ugaitnet_tpu_torch.models.network import UGaitNet
    from ugaitnet_tpu_torch.obsv.logger import read_metrics
    from ugaitnet_tpu_torch.ops.cuda import triplet_kernel as K
    from ugaitnet_tpu_torch.train import trainer as TR
    out = {}
    os.makedirs(work, exist_ok=True)

    # ---- data: a TUM-GAID-shaped set beside phase 7's CASIA-B-shaped one --
    t0 = time.perf_counter()
    tum = make_synthetic_dataset(**TUM_SHAPE)
    # TUM-GAID's walking conditions n / b / s over the two videos of each
    # subject (the synthetic set cycles one fixed order per video)
    tum.gaits = (((tum.labels - 1) + tum.video_ids % 2) % 3).astype(np.int32)
    tum_dir = os.path.join(work, "tum_train")
    tum.save(tum_dir)
    casia = GaitDataset.load(casia_dir)
    mb = {n: sum(s.volumes.nbytes for s in d.modalities.values()) / 1e6
          for n, d in (("tum", tum), ("casia", casia))}
    print(f"joint data: TUM-GAID-shaped {len(tum)} clips ({mb['tum']:.1f} MB"
          f" raw) made and packed in {time.perf_counter() - t0:.1f} s; "
          f"CASIA-B-shaped {len(casia)} clips ({mb['casia']:.1f} MB) from "
          "phase 7")
    out.update(clips={"tum": len(tum), "casia": len(casia)}, raw_mb=mb)

    # ---- 1. the joint run --------------------------------------------------
    got = {}

    def capture_fit(fit):
        def call(self, ds, **kw):
            got["ds"], got["trainer"] = ds, self
            return fit(self, ds, **kw)
        return call

    stats_s, epoch_s = [], []

    def timed_epoch(run_epoch):
        def call(self, *a):
            t0 = time.perf_counter()
            res = run_epoch(self, *a)
            epoch_s.append(time.perf_counter() - t0)
            return res
        return call

    n_cls = len(np.unique(tum.labels)) + len(np.unique(casia.labels))
    torch.backends.cudnn.deterministic = True
    joint_flags = FLAGSHIP_FLAGS + [
        "--datadir", tum_dir, "--datadir2", casia_dir, "--normstats",
        "--nclasses", str(n_cls), "--epochs", str(JOINT_EPOCHS),
        "--experdir", os.path.join(work, "joint")]
    K.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        with wrapped(TR.Trainer, "fit", capture_fit), \
                wrapped(TR.Trainer, "_epoch", timed_epoch), \
                wrapped(PL, "compute_normalization_stats",
                        timed_calls(stats_s)):
            exp_j = cli_train.main(joint_flags)
    finally:
        torch.backends.cudnn.deterministic = False
    joint_s = time.perf_counter() - t0
    launches = {"triplet_fwd": K.fwd_launches, "triplet_bwd": K.bwd_launches}
    ds = got["ds"]
    n_t = len(tum)
    want_cols = {
        "labels": np.concatenate([tum.labels, casia.labels + 305]),
        "gaits": np.concatenate([tum.gaits, casia.gaits + 3]),
        "video_ids": np.concatenate(
            [tum.video_ids, casia.video_ids + tum.video_ids.max() + 1]),
        "dataset_source": np.repeat(np.int32([0, 1]),
                                    [n_t, len(casia)])}
    for k, v in want_cols.items():
        check(np.array_equal(getattr(ds, k), v),
              f"joint set's {k} differs from the +305 / +3 rule")
    check(len(np.unique(ds.labels)) == n_cls == 224,
          f"joint set's label count {n_cls}")
    tr_idx, val_idx = split_train_val_by_video(ds.video_ids, perc=VAL_PERC,
                                               seed=0)
    steps = len(tr_idx) // 40
    val_batches = -(-len(val_idx) // min(len(val_idx), 40))
    want = {"triplet_fwd": JOINT_EPOCHS * (steps + val_batches),
            "triplet_bwd": JOINT_EPOCHS * steps}
    check(launches == want, f"joint run launches {launches}, expected "
                            f"{want}")
    losses = {k: epoch_losses(exp_j, k) for k in ("train/loss", "val/loss")}
    for k, v in losses.items():
        check(sorted(v) == list(range(1, JOINT_EPOCHS + 1)) and all(
            x is not None and np.isfinite(x) for x in v.values()),
            f"joint {k} per epoch: {v}")
    z = np.load(os.path.join(exp_j, "norm_stats.npz"))
    shapes = {k: z[k].shape for k in z.files}
    check(shapes == {"mean_of": (2, 50), "std_of": (2, 50),
                     "mean_gray": (2, 25), "std_gray": (2, 25)},
          f"norm_stats.npz rows {shapes}")
    fit_ms = [1e3 * t / steps for t in epoch_s]
    out.update(launches=launches, steps_per_epoch=steps,
               val_batches=val_batches, losses=losses, seconds=joint_s,
               normstats_s=sum(stats_s), fit_ms_per_step=fit_ms)
    print(f"joint run: cli.train --datadir2 --normstats, {len(ds)} clips, "
          f"{n_cls} classes, {JOINT_EPOCHS} epochs of {steps} steps in "
          f"{joint_s:.1f} s; labels, gaits, video ids and dataset_source "
          f"equal the +305 / +3 rule; norm_stats.npz {shapes}; launches "
          f"{launches} (= epochs x (steps + {val_batches} val batches), "
          f"epochs x steps); train/loss {losses['train/loss']}, val/loss "
          f"{losses['val/loss']} [{card}]")
    print(f"joint fit ms per step by epoch {[round(t, 2) for t in fit_ms]} "
          f"(epoch 1 includes cuDNN warm-up) beside phase 7's "
          f"{fit7_ms:.2f} ms/step; two-source --normstats host time "
          f"{sum(stats_s):.3f} s over {len(ds)} clips ({len(stats_s)} calls)"
          f" [{card}]")

    # one raw batch with both sources, standardized on the card and on the
    # CPU, and on the card with the source rows swapped (a planted fault)
    stats = got["trainer"].norm_stats
    mods = tuple(MODS)
    idx = np.concatenate([np.arange(0, 20), np.arange(n_t, n_t + 20)])
    dcfg = DataConfig(augment=False)
    labmap = ds.label_map()

    def standardized(device, norm):
        pipe = PL.GaitPipeline(ds, dcfg, mods, labmap=labmap, augment=False,
                               norm_stats=norm, device=device)
        vols, _, _ = pipe.preprocess(pipe.gather(idx), expand=1)
        return [v.float().cpu() for v in vols]

    swapped = {m: (s[0][::-1].copy(), s[1][::-1].copy())
               for m, s in stats.items()}
    on_cpu = standardized("cpu", stats)
    norm_err = {m: rel_err(a, b) for m, a, b in
                zip(mods, standardized("cuda", stats), on_cpu)}
    swap_err = {m: rel_err(a, b) for m, a, b in
                zip(mods, standardized("cuda", swapped), on_cpu)}
    print(f"standardized joint batch (20 + 20 clips of the two sources), "
          f"card vs CPU: {norm_err} <= {NORM_REL}; with the source rows "
          f"swapped {swap_err} > {NORM_REL}")
    check(all(v <= NORM_REL for v in norm_err.values()),
          "standardized volumes, card vs CPU")
    check(all(v > NORM_REL for v in swap_err.values()),
          "swapped source rows pass the standardization limit")
    out.update(norm_rel_err=norm_err, swapped_rows_rel_err=swap_err)
    del got["ds"], got["trainer"], ds
    gc.collect()
    torch.cuda.empty_cache()

    # ---- 2. fine-tune on CASIA-B with --initnet, head surgery 224 -> 74 ---
    inits, hook_ms = [], []

    def capture_init(init_or_resume):
        def call(self, seed=0):
            state, start = init_or_resume(self, seed)
            inits.append((start, {k: v.detach().cpu().clone() for k, v in
                                  state.model.state_dict().items()},
                          copy.deepcopy(state.optimizer.state_dict()),
                          state.step))
            return state, start
        return call

    def timed_hook(make):
        def call(args, mcfg):
            fn = make(args, mcfg)
            if fn is None:
                return None

            def hook(sd):
                t0 = time.perf_counter()
                try:
                    return fn(sd)
                finally:
                    hook_ms.append(1e3 * (time.perf_counter() - t0))
            return hook
        return call

    ft_flags = FLAGSHIP_FLAGS + [
        "--datadir", casia_dir, "--epochs", "1", "--initnet", exp_j,
        "--initepoch", "best", "--experdir", os.path.join(work, "ft")]
    K.reset_launch_counts()
    with wrapped(TR.Trainer, "init_or_resume", capture_init), \
            wrapped(cli_train, "make_warm_start", timed_hook):
        exp_ft = cli_train.main(ft_flags)
        ft_launches = (K.fwd_launches, K.bwd_launches)
        exp_again = cli_train.main(ft_flags)
    check(exp_again == exp_ft, "the fine-tune reran elsewhere")
    src = ckpt.restore_raw(exp_j, "best")["model"]
    start0, sd0, _, _ = inits[0]
    fresh = UGaitNet(cli_train.configs_from_args(
        cli_train.build_parser().parse_args(ft_flags))[0], seed=0,
        device="cpu").state_dict()
    branch = [k for k in sd0 if k.startswith("branches.")]
    check(start0 == 0 and branch and all(torch.equal(sd0[k], src[k])
                                         for k in branch),
          "the warm-started branches differ from the joint run's best")
    check(src["classprob.weight"].shape[0] == n_cls
          and sd0["classprob.weight"].shape[0] == 74
          and all(torch.equal(sd0[k], fresh[k])
                  for k in ("classprob.weight", "classprob.bias")),
          "the 74-wide head is not the seed's fresh init")
    start1, sd1, opt1, step1 = inits[1]
    saved = ckpt.restore_raw(exp_ft, 1)
    a = flat_tensors({"m": sd1, "o": opt1})
    b = flat_tensors({"m": saved["model"], "o": saved["optimizer"]})
    check(start1 == 1 and len(hook_ms) == 1 and step1 == saved["step"]
          and a.keys() == b.keys()
          and all(torch.equal(a[k].cpu(), b[k].cpu()) for k in a),
          "the rerun did not resume from ckpt/1 without a warm start")
    ft_loss = epoch_losses(exp_ft)
    check(list(ft_loss) == [1] and np.isfinite(ft_loss[1]),
          f"fine-tune loss {ft_loss}")
    print(f"fine-tune: --initnet <joint> --initepoch best --nclasses 74: "
          f"{len(branch)} branch tensors equal the joint best bitwise, the "
          f"74-wide head equals the seed's init; warm-start load "
          f"{hook_ms[0]:.1f} ms; 1 epoch, train/loss {ft_loss[1]:.6f}, "
          f"launches {ft_launches}; the same command again resumed at "
          f"epoch {start1} with the state of ckpt/1 bitwise and no warm "
          f"start [{card}]")
    out.update(warm_start_ms=hook_ms[0], finetune_loss=ft_loss[1],
               finetune_launches=ft_launches)

    # --initbranch gray=<joint>@of: a start without training (0 epochs)
    del inits[:]
    ib_flags = FLAGSHIP_FLAGS + [
        "--datadir", casia_dir, "--epochs", "0", "--initbranch",
        f"gray={exp_j}@of", "--initepoch", "best",
        "--experdir", os.path.join(work, "initbranch")]
    with wrapped(TR.Trainer, "init_or_resume", capture_init):
        cli_train.main(ib_flags)
    _, sd2, _, _ = inits[0]
    pre_of, pre_gray = "branches.branch_of.", "branches.branch_gray."
    copied = kept = 0
    for k, v in sd2.items():
        if k.startswith(pre_gray):
            s = src[pre_of + k[len(pre_gray):]]
            if s.shape == v.shape:
                check(torch.equal(v, s), f"{k} is not the OF branch's")
                copied += 1
            else:
                check(torch.equal(v, fresh[k]), f"{k} is not the seed's")
                kept += 1
        elif k.startswith(pre_of):
            check(torch.equal(v, fresh[k]), f"{k} was touched")
    check(copied > 0 and kept == 1, f"gray from OF: {copied} copied, "
                                    f"{kept} kept")
    print(f"--initbranch gray=<joint>@of: {copied} gray tensors equal the "
          f"joint OF branch bitwise, {kept} (the first conv, 1 vs 2 input "
          "channels) keeps the seed's init; the OF branch is untouched")
    gc.collect()
    torch.cuda.empty_cache()

    # ---- 3. the sweep ------------------------------------------------------
    sweep_s = []

    def timed_main(main):
        def call(argv=None):
            t0 = time.perf_counter()
            try:
                return main(argv)
            finally:
                sweep_s.append(time.perf_counter() - t0)
        return call

    sweep_root = os.path.join(work, "sweep")
    with wrapped(cli_train, "main", timed_main), \
            contextlib.redirect_stdout(io.StringIO()):
        results = cli_sweep.main(
            ["--grid", "lr=1e-4,5e-5", "--"] + FLAGSHIP_FLAGS
            + ["--datadir", casia_dir, "--epochs", "1",
               "--experdir", sweep_root])
    check([r["point"] for r in results] == [{"lr": "1e-4"}, {"lr": "5e-5"}],
          f"sweep points {[r['point'] for r in results]}")
    for r in results:
        own = {}
        for rec in read_metrics(r["experdir"]):
            own.update({k: v for k, v in rec.items()
                        if k not in ("step", "time")})
        check(os.path.dirname(r["experdir"]) == sweep_root
              and os.path.basename(r["experdir"]).startswith(
                  f"sweep_lr{r['point']['lr']}_")
              and ckpt.latest_checkpoint_step(r["experdir"]) == 1
              and r["final_metrics"] == own
              and np.isfinite(own["train/loss"]),
              f"sweep point {r['point']}: {r['experdir']}")
    print(f"sweep lr=1e-4,5e-5 (1 epoch each): {[round(t, 1) for t in sweep_s]}"
          f" s per point; final train/loss "
          f"{[r['final_metrics']['train/loss'] for r in results]} from each "
          f"point's own records [{card}]")
    out.update(sweep_s=sweep_s)

    # ---- 4. evaluate and export the joint run's best ----------------------
    # phase 5's CASIA-B-shaped sets as the joint run's second source: each
    # clip standardized by row 1
    src_sets = {}
    for name, d in (("gallery", gallery_dir), ("probe", probe_dir)):
        s = GaitDataset.load(d)
        s.dataset_source = np.ones(len(s), np.int32)
        src_sets[name] = os.path.join(work, f"casia_{name}_src1")
        s.save(src_sets[name])
    outfile = os.path.join(work, "joint_results.json")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli_eval.main(["--experdir", exp_j, "--epoch", "best", "--gallery",
                       src_sets["gallery"], "--probes", src_sets["probe"],
                       "--protocol", "casiab", "--knn", "3", "--bs", "128",
                       "--outfile", outfile])
    check("using persisted norm_stats.npz" in buf.getvalue(),
          "evaluate did not use the joint run's norm_stats.npz")
    with open(outfile) as f:
        res = json.load(f)[os.path.basename(src_sets["probe"])]
    cams = {k: v for k, v in res.items() if k != "confusions_file"}
    check(len(cams) == 11 and all(0.0 <= r["rank1_subseq"] <= 1.0
                                  for r in cams.values()),
          f"joint evaluate results for {sorted(cams)}")
    art = os.path.join(work, "joint_art")
    with contextlib.redirect_stdout(io.StringIO()):
        cli_export.main(["--experdir", exp_j, "--epoch", "best", "--out",
                         art, "--buckets", "8"])
    with open(os.path.join(art, "meta.json")) as f:
        meta = json.load(f)
    check(meta["normalized"] and meta["norm_sources"] == 2,
          f"export meta {meta}")
    g = GaitDataset.load(src_sets["probe"])
    raw = {f"raw_{m}": np.array(g.modalities[m].volumes[:8]) for m in mods}
    raw.update({f"present_{m}": np.ones(8, np.float32) for m in mods})
    enc = ExportedEncoder(art)
    c1 = enc.encode(dict(raw, source=np.ones(8, np.int32)))
    c0 = enc.encode(dict(raw, source=np.zeros(8, np.int32)))
    check(np.isfinite(c1).all() and not np.allclose(c0, c1),
          "the artifact does not select the stats row by source")
    mean_r1 = float(np.mean([r["rank1_subseq"] for r in cams.values()]))
    print(f"cli.evaluate on the joint best (2-row norm_stats.npz, source "
          f"1): 11 probe cameras, mean Rank-1 subseq {mean_r1:.4f}; "
          f"cli.export_model: norm_sources {meta['norm_sources']}, codes "
          "differ by source row")
    out.update(evaluate_mean_rank1_subseq=mean_r1, export_meta=meta)
    return out


# ---- phase 12: multi-device training over torch.distributed ------------
# Two gloo ranks share the one card (devices passed explicitly): rank 0
# and rank 1 each hold half of the global batch.  Limits: losses against
# the one-process step within P12_LOSS_RTOL (float32 sums over other
# batch splits); gradients, averaged over the ranks, max |ranks - one
# process| <= P12_GRAD_REL * max |one process| over the whole gradient.
# The ranks' set streams and part projections run over 60 rows, not 120,
# and round apart from the one process's; where the two branches' values
# tie within that rounding, the sign_max merge may take the other branch,
# and that element's gradient then reaches the other branch's parameters
# whole.  So the limit is phase 1's GRAD_REL.  Every run shows that this
# is the gap: the one-process step made to take the ranks' sign_max picks
# must hold the ranks' gradient within P12_FED_REL.  It also runs the
# one-process step fed the ranks' gathered signatures (the triplet's
# inputs bitwise the ranks'), and counts the triplets whose hinge changes
# side: an H100 (700 W) reads 1 switched pick of 1,904,640, 1.68e-3
# unforced and fed, 6.0e-5 forced, and no hinge that changes side.  The
# forced 6.0e-5 is not a fault of the step (tools/chip_p12_conv.py): the
# branches' cuDNN convs round apart at 60 rows (1.6e-6 at b_conv3), max
# and leaky ReLU switches carry that into the cotangents, and the forced
# step with every branch run on the ranks' 60-row halves reads 2.4e-7
# (ROADMAP section 3).
# Every run also reads three planted faults against P12_GRAD_REL (the
# gather without its autograd, own rows only; the local L2 inside the
# global form; gradients summed, not averaged).
P12_LOSS_RTOL = 1e-5
P12_GRAD_REL = GRAD_REL
P12_FED_REL = 1e-4
P12_NEAR = 1e-6                  # a hinge this close to 0 is counted
P12_STEPS = 3
P12_FAULTS = ("gather without autograd", "local L2 in the global form",
              "no world factor")


def _grad_err(grads, ref, rows=None, worst=None):
    """max |g - ref| over max |ref|, over every leaf; ``rows`` maps a leaf
    to the slice of the reference it holds (expert shards).  ``worst``
    (a dict) receives the leaf where the max lies."""
    rows = rows or {}
    errs = {k: float((g.cpu() - ref[k][rows.get(k, slice(None))])
                     .abs().max()) for k, g in grads.items()}
    k = max(errs, key=errs.get)
    if worst is not None:
        worst["leaf"] = k
    return errs[k] / max(float(r.abs().max()) for r in ref.values())


def _p12_fault(name):
    """Context that plants one of P12_FAULTS in this rank's modules."""
    import torch.distributed as dist
    from ugaitnet_tpu_torch.ops import fusion
    from ugaitnet_tpu_torch.ops.collectives import gather_rows_nograd
    from ugaitnet_tpu_torch.train import train_step as TS

    def own_rows_only(x, group):
        full = gather_rows_nograd(x.detach(), group)
        i, b = dist.get_rank(group), x.shape[0]
        return torch.cat([full[:i * b], x, full[(i + 1) * b:]])
    sig = fusion.signature
    avg = TS.average_gradients

    def summed(model, mesh):
        avg(model, mesh)
        for p in model.parameters():
            if p.grad is not None:
                p.grad.mul_(mesh.world)
    target = {
        "gather without autograd": (TS, "all_gather_rows", own_rows_only),
        "local L2 in the global form": (
            fusion, "signature",
            lambda fused, l2_mode="reference", group=None:
            sig(fused, l2_mode)),
        "no world factor": (TS, "average_gradients", summed),
    }[name]

    @contextlib.contextmanager
    def planted():
        mod, attr, fn = target
        old = getattr(mod, attr)
        setattr(mod, attr, fn)
        try:
            yield
        finally:
            setattr(mod, attr, old)
    return planted()


class _Substitute(torch.autograd.Function):
    """Forward: ``values``; backward: the cotangent goes to ``x``, the
    tensor they stand in for."""

    @staticmethod
    def forward(ctx, x, values):
        return values.clone()

    @staticmethod
    def backward(ctx, g):
        return g, None


def _p12_flips(sig_a, sig_b, labels, margin):
    """Batch-all triplets (a == p included, as the loss counts them) under
    two (B, P, D) signatures, part by part with the plain pairwise_dist:
    (hinges on other sides of 0, valid triplets, active under ``sig_a``,
    |hinge| < P12_NEAR under ``sig_a``)."""
    from ugaitnet_tpu_torch.ops.triplet import pairwise_dist
    same = labels[:, None] == labels[None, :]
    valid = same[:, :, None] & ~same[:, None, :]
    flips = active = near = 0
    for p in range(sig_a.shape[1]):
        h = [margin + d[:, :, None] - d[:, None, :]
             for d in (pairwise_dist(s[:, p]) for s in (sig_a, sig_b))]
        flips += int((((h[0] > 0) != (h[1] > 0)) & valid).sum())
        active += int(((h[0] > 0) & valid).sum())
        near += int(((h[0].abs() < P12_NEAR) & valid).sum())
    return flips, int(valid.sum()) * sig_a.shape[1], active, near


def _p12_picks(out):
    """The sign_max merge's picks of a two-branch forward's outputs: 1
    where the first gated branch's value is taken (uint8, (B, P, D))."""
    first, second = out["branches"]
    return (first.detach().abs() >= second.detach().abs()).to(torch.uint8)


def _p12_cause(work, mcfg, tcfg, one, dev):
    """The global form's gap to the one-process gradient, accounted for.
    The one-process step is run twice more and held to the ranks'
    averaged gradient: with its signature's values replaced by the ranks'
    gathered ones (its own backward), and with its sign_max merge taking
    the ranks' picks.  Beside it, how far the ranks' signatures (global
    form and SP) lie from the one process's, how many triplet hinges
    change side, and how many sign_max picks differ."""
    from ugaitnet_tpu_torch.ops import fusion
    from ugaitnet_tpu_torch.train.train_step import make_train_step
    dp = torch.load(os.path.join(work, "dp.pt"), weights_only=True)
    sig_dp, picks_dp = dp["sig"].to(dev), dp["picks"].to(dev).bool()
    batch = _p12_load(work, "batch.pt", dev)

    def substitute(mod, args, out):
        out = dict(out)
        out["signature"] = _Substitute.apply(out["signature"], sig_dp)
        return out
    res = {}
    sign_max = fusion.MERGES["sign_max"]
    for name in ("signatures_fed", "picks_forced"):
        probe = _p12_probe(mcfg)
        hooks = []
        if name == "signatures_fed":
            hooks.append(probe.model.register_forward_hook(substitute))
        else:
            fusion.MERGES["sign_max"] = lambda embs: torch.where(
                picks_dp, embs[0], embs[1])
        try:
            make_train_step(mcfg, tcfg)(probe, batch)
        finally:
            fusion.MERGES["sign_max"] = sign_max
            for h in hooks:
                h.remove()
        worst = {}
        res[name] = _grad_err(_p12_grads(probe), dp["grads"], worst=worst)
        res[name + "_leaf"] = worst["leaf"]
        del probe
        gc.collect()
        torch.cuda.empty_cache()
    res["pick_switches"] = int((picks_dp != one["picks"].to(dev).bool())
                               .sum())
    sig_one = one["sig"].to(dev)
    sig_sp = torch.load(os.path.join(work, "sp_sig.pt"),
                        weights_only=True).to(dev)
    for name, sig in (("dp", sig_dp), ("sp", sig_sp)):
        flips, valid, active, near = _p12_flips(sig_one, sig, batch.labels,
                                                tcfg.margin)
        res[name] = {"sig_max_abs_diff": float((sig - sig_one).abs().max()),
                     "flips": flips, "valid": valid, "active": active,
                     "near": near}
    return res


def _p12_setup():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False


def _p12_load(work, name, dev):
    from ugaitnet_tpu_torch.train.train_step import Batch
    d = torch.load(os.path.join(work, name), weights_only=True)
    return Batch(tuple(v.to(dev) for v in d["volumes"]),
                 tuple(f.to(dev) for f in d["flags"]), d["labels"].to(dev))


def _p12_probe(mcfg, mesh=None, seed=0):
    """A seed-0 state whose optimizer leaves the parameters as they are (SGD
    at lr 0): its steps leave the averaged gradient in .grad."""
    from ugaitnet_tpu_torch.core.config import TrainConfig
    from ugaitnet_tpu_torch.models.network import UGaitNet
    from ugaitnet_tpu_torch.train.train_step import init_state
    return init_state(UGaitNet(mcfg, seed=seed, mesh=mesh),
                      TrainConfig(optimizer="sgd", lr=0.0))


def _p12_grads(state):
    return {k: p.grad.detach().clone() for k, p in
            state.model.named_parameters() if p.grad is not None}


def _p12_timed(step, probe, batch, n=2):
    """The host ms of each of ``n`` synchronized steps (the parameters stay
    as they are: lr 0), and the last step's metrics."""
    ms = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, m = step(probe, batch)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    return ms, m


def _p12_rank(rank, work):
    """One rank of phase 12's gloo world of 2 on cuda:0."""
    import torch.distributed as dist
    from ugaitnet_tpu_torch.core.config import TrainConfig
    from ugaitnet_tpu_torch.ops.cuda import build
    from ugaitnet_tpu_torch.ops.cuda import triplet_kernel as K
    from ugaitnet_tpu_torch.models.network import UGaitNet
    from ugaitnet_tpu_torch.ops.collectives import gather_rows_nograd
    from ugaitnet_tpu_torch.parallel import sharding as S
    from ugaitnet_tpu_torch.parallel.expert import (make_ep_train_step,
                                                     make_mesh_dpep,
                                                     place_ep_model)
    from ugaitnet_tpu_torch.parallel.sequence import (make_mesh_dpsp,
                                                       make_sp_train_step,
                                                       shard_batch_sp,
                                                       sp_model_config)
    from ugaitnet_tpu_torch.train.train_step import init_state
    _p12_setup()
    build.load("triplet_kernel")      # the parent built it
    dev = torch.device("cuda", 0)
    devices = [dev, dev]
    ref = torch.load(os.path.join(work, "ref.pt"), weights_only=True)
    batch = _p12_load(work, "batch.pt", dev)
    mcfg = flagship_cfg()
    tcfg = TrainConfig()
    res = {"rank": rank}
    torch.cuda.reset_peak_memory_stats()

    # 1. the global form, world 2
    mesh = S.make_mesh(2, devices)
    local = S.shard_batch(batch, mesh)
    step = S.make_sharded_train_step(mcfg, tcfg, mesh)
    shapes = []
    launch_fwd = K.launch_fwd

    def recording(x, labels, margin):
        shapes.append(tuple(x.shape))
        return launch_fwd(x, labels, margin)
    probe = _p12_probe(mcfg)
    taps = []
    hook = probe.model.register_forward_hook(
        lambda mod, args, out: taps.append(out))
    K.reset_launch_counts()
    K.launch_fwd = recording
    try:
        _, m = step(probe, local)
    finally:
        K.launch_fwd = launch_fwd
        hook.remove()
    res["launches"] = [K.fwd_launches, K.bwd_launches]
    # the gathered signatures and sign_max picks and the averaged gradient,
    # for the parent's account of the gap to the one-process gradient
    group = mesh.group("data")
    gathered = {"sig": gather_rows_nograd(taps[0]["signature"].detach(),
                                          group),
                "picks": gather_rows_nograd(_p12_picks(taps[0]), group)}
    if rank == 0:
        torch.save({**{k: v.cpu() for k, v in gathered.items()},
                    "grads": {k: g.cpu() for k, g in
                              _p12_grads(probe).items()}},
                   os.path.join(work, "dp.pt"))
    del taps, gathered
    res["shapes"] = shapes
    res["loss"] = {k: float(v) for k, v in m.items()}
    res["worst"] = {}
    res["grad_err"] = _grad_err(_p12_grads(probe), ref["grads"],
                                worst=res["worst"])
    res["faults"] = {}
    for name in P12_FAULTS:
        probe = _p12_probe(mcfg)
        with _p12_fault(name):
            step(probe, local)
        res["faults"][name] = _grad_err(_p12_grads(probe), ref["grads"])
    del probe
    state = init_state(UGaitNet(mcfg, seed=0), tcfg)
    times = []
    for _ in range(P12_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(state, local)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    res["step_ms"] = times
    flat = torch.cat([p.detach().reshape(-1)
                      for p in state.model.parameters()])
    mine = flat.clone()
    dist.broadcast(flat, src=0)
    res["params_equal_rank0"] = bool(torch.equal(flat, mine))
    res["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    del state, flat, mine
    torch.cuda.empty_cache()

    # 2. per-shard vs global form: reference L2 must differ; feature L2
    # with no dropout (the flagship has none) must agree
    res["forms"] = {}
    for l2 in ("reference", "feature"):
        cfg = dataclasses.replace(mcfg, l2_mode=l2)
        losses = []
        for make in (S.make_sharded_train_step, S.make_shardmap_train_step):
            _, m = make(cfg, tcfg, mesh)(_p12_probe(cfg), local)
            losses.append(float(m["loss"]))
        res["forms"][l2] = losses
    torch.cuda.empty_cache()

    # 4. sequence parallelism (dp, sp) = (1, 2): T 25 -> 26
    mesh_sp = make_mesh_dpsp(1, 2, devices)
    sp_batch = shard_batch_sp(batch, mesh_sp)
    probe = _p12_probe(sp_model_config(mcfg), mesh_sp)
    sigs = []
    hook = probe.model.register_forward_hook(
        lambda mod, args, out: sigs.append(out["signature"].detach()))
    ms, m = _p12_timed(make_sp_train_step(mcfg, tcfg, mesh_sp), probe,
                       sp_batch)
    hook.remove()
    if rank == 0:
        torch.save(sigs[-1].cpu(), os.path.join(work, "sp_sig.pt"))
    del sigs
    res["sp"] = {"ms": ms,
                 "frames": list(sp_batch.volumes[0].shape),
                 "loss": float(m["loss"]),
                 "grad_err": _grad_err(_p12_grads(probe), ref["grads"])}
    del probe, sp_batch
    torch.cuda.empty_cache()

    # 5. expert parallelism (dp, ep) = (1, 2), 4 experts, B = 40
    moe_cfg = flagship_cfg(experts=4)
    mesh_ep = make_mesh_dpep(1, 2, devices)
    small = _p12_load(work, "batch40.pt", dev)
    model = UGaitNet(moe_cfg, seed=0)
    place_ep_model(model, mesh_ep)
    probe = init_state(model, TrainConfig(optimizer="sgd", lr=0.0))
    ms, m = _p12_timed(make_ep_train_step(moe_cfg, tcfg, mesh_ep), probe,
                       S.shard_batch(small, mesh_ep))
    rows = {f"branches.{n}.expert_proj": slice(
        br.expert_start, br.expert_start + br.expert_proj.shape[0])
        for n, br in model.branches.items()}
    res["ep"] = {"ms": ms,
                 "loss": float(m["loss"]), "moe_aux": float(m["moe_aux"]),
                 "expert_rows": {k: [v.start, v.stop]
                                 for k, v in rows.items()},
                 "grad_err": _grad_err(_p12_grads(probe), ref["moe_grads"],
                                       rows)}
    with open(os.path.join(work, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)


def _p12_nccl_rank(rank, work):
    """One step of the global form on an NCCL world of 1."""
    from ugaitnet_tpu_torch.core.config import TrainConfig
    from ugaitnet_tpu_torch.ops.cuda import build
    from ugaitnet_tpu_torch.parallel import sharding as S
    _p12_setup()
    build.load("triplet_kernel")
    dev = torch.device("cuda", 0)
    ref = torch.load(os.path.join(work, "ref.pt"), weights_only=True)
    batch = _p12_load(work, "batch.pt", dev)
    mesh = S.make_mesh(1, [dev])
    probe = _p12_probe(flagship_cfg())
    _, m = S.make_sharded_train_step(flagship_cfg(), TrainConfig(), mesh)(
        probe, S.shard_batch(batch, mesh))
    grads = _p12_grads(probe)
    res = {"backend": mesh.backend, "loss": float(m["loss"]),
           "loss_equal": float(m["loss"]) == ref["loss"]["loss"],
           "grads_equal": all(torch.equal(g.cpu(), ref["grads"][k])
                              for k, g in grads.items()),
           "grad_err": _grad_err(grads, ref["grads"])}
    with open(os.path.join(work, "nccl.json"), "w") as f:
        json.dump(res, f)


def flagship_cfg(experts=0, dtype="float32"):
    """The flagship (``__graft_entry__.py:_flagship_cfg``), with ``experts``
    MoE experts per branch (0: the per-part projection)."""
    from ugaitnet_tpu_torch.core.config import BranchConfig, ModelConfig
    return ModelConfig(
        branches=(BranchConfig(kind="gaitset", modality="of",
                               moe_experts=experts),
                  BranchConfig(kind="gaitset", modality="gray",
                               moe_experts=experts)),
        merge="sign_max", nclasses=74, compute_dtype=dtype)


def parallel_phase(card, work):
    """Phase 12: the multi-device training forms over torch.distributed."""
    from ugaitnet_tpu_torch.core.config import DataConfig, TrainConfig
    from ugaitnet_tpu_torch.data.pipeline import preprocess_batch
    from ugaitnet_tpu_torch.models.network import UGaitNet
    from ugaitnet_tpu_torch.parallel import sharding as S
    from ugaitnet_tpu_torch.train.train_step import (Batch, init_state,
                                                     make_train_step)
    t_phase = time.perf_counter()
    os.makedirs(work, exist_ok=True)
    _p12_setup()
    mods = (("of", "gray"), (2, 1), (100.0, 1.0), 2)
    # phase 3's first augmented batch (raw B = 40, expand 3) and seed-0 state
    vols, flags, labels = preprocess_batch(
        raw_batch(40, 8, seed=2), *mods, 3, True, DataConfig(),
        generator=torch.Generator().manual_seed(0))
    batch = Batch(tuple(vols), tuple(flags), labels)
    for name, rows in (("batch.pt", slice(None)), ("batch40.pt",
                                                    slice(0, 40))):
        torch.save({"volumes": [v[rows].cpu() for v in vols],
                    "flags": [f[rows].cpu() for f in flags],
                    "labels": labels[rows].cpu()},
                   os.path.join(work, name))
    small = Batch(tuple(v[:40] for v in vols), tuple(f[:40] for f in flags),
                  labels[:40])
    check(len(set(labels[:40].tolist())) > 1, "B = 40 batch: one id")
    mcfg, moe_cfg, tcfg = flagship_cfg(), flagship_cfg(experts=4), \
        TrainConfig()
    probe = _p12_probe(mcfg)
    taps = []
    hook = probe.model.register_forward_hook(
        lambda mod, args, out: taps.append(
            {"sig": out["signature"].detach().cpu(),
             "picks": _p12_picks(out).cpu()}))
    _, m = make_train_step(mcfg, tcfg)(probe, batch)
    hook.remove()
    one = taps[0]
    ref = {"loss": {k: float(v) for k, v in m.items()},
           "grads": {k: g.cpu() for k, g in _p12_grads(probe).items()}}
    del probe, taps
    # the MoE flagship: one process at B = 120 (time, aux), the reference
    # gradient at B = 40
    moe_state = init_state(UGaitNet(moe_cfg, seed=0), tcfg)
    moe_step = make_train_step(moe_cfg, tcfg)
    moe_ms, moe_aux = [], []
    torch.cuda.reset_peak_memory_stats()
    for _ in range(P12_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, m = moe_step(moe_state, batch)
        torch.cuda.synchronize()
        moe_ms.append((time.perf_counter() - t0) * 1e3)
        moe_aux.append(float(m["moe_aux"]))
        check(np.isfinite(float(m["loss"])), f"MoE step loss {m}")
    moe_peak = torch.cuda.max_memory_allocated() / 1e9
    del moe_state
    probe = _p12_probe(moe_cfg)
    _, m = make_train_step(moe_cfg, tcfg)(probe, small)
    ref["moe_loss"] = float(m["loss"])
    ref["moe_grads"] = {k: g.cpu() for k, g in _p12_grads(probe).items()}
    check(all(k in ref["moe_grads"] and
              float(ref["moe_grads"][k].abs().max()) > 0 for k in
              ("branches.branch_of.router", "branches.branch_gray.router")),
          "MoE: no gradient reaches a router")
    torch.save(ref, os.path.join(work, "ref.pt"))
    del probe, batch, small, vols, flags, labels
    gc.collect()
    torch.cuda.empty_cache()
    print(f"phase 12 shapes: global batch B = 120 (raw 40 x expand 3), 2 "
          f"ranks x 60 rows; SP (1, 2): each rank B = 120 x 13 of 26 "
          f"frames; MoE (4 experts): one process B = 120, EP (1, 2) at B "
          f"= 40 (cut from 120: both ranks hold the whole batch on one "
          f"card) [{card}]")
    print(f"MoE flagship one process B = 120: step ms "
          f"{[round(t, 2) for t in moe_ms]}, aux {moe_aux}, peak "
          f"{moe_peak:.2f} GB [{card}]")

    t0 = time.perf_counter()
    S.spawn(_p12_rank, 2, args=(work,), devices=["cuda:0", "cuda:0"])
    world2_s = time.perf_counter() - t0
    ranks = [json.load(open(os.path.join(work, f"rank{r}.json")))
             for r in range(2)]
    t0 = time.perf_counter()
    S.spawn(_p12_nccl_rank, 1, args=(work,), devices=["cuda:0"])
    nccl_s = time.perf_counter() - t0
    nccl = json.load(open(os.path.join(work, "nccl.json")))
    t0 = time.perf_counter()
    cause = _p12_cause(work, mcfg, tcfg, one, torch.device("cuda"))
    cause_s = time.perf_counter() - t0

    for r in ranks:
        tag = f"rank {r['rank']}"
        ref_form, feat_form = r["forms"]["reference"], r["forms"]["feature"]
        sp, ep = r["sp"], r["ep"]
        print(f"{tag}: global form loss {r['loss']['loss']:.7f} (one process"
              f" {ref['loss']['loss']:.7f}), gradient err {r['grad_err']:.2e}"
              f" at {r['worst']['leaf']} (limit {P12_GRAD_REL}); faults "
              + ", ".join(f"{k} {v:.2e}" for k, v in r["faults"].items())
              + f"; launches fwd/bwd {r['launches']} at (P, B, D) "
              f"{[(s[1], s[0], s[2]) for s in r['shapes']]}; {P12_STEPS} "
              f"Adam steps {[round(t, 2) for t in r['step_ms']]} ms; params"
              f" == rank 0's: {r['params_equal_rank0']}; peak "
              f"{r['peak_gb']:.2f} GB [{card}]")
        print(f"{tag}: reference L2 global {ref_form[0]:.7f} vs per-shard "
              f"{ref_form[1]:.7f}; feature L2 {feat_form[0]:.7f} vs "
              f"{feat_form[1]:.7f}")
        print(f"{tag}: SP (1, 2) frames {sp['frames']}, loss "
              f"{sp['loss']:.7f}, gradient err {sp['grad_err']:.2e}, steps "
              f"{[round(t, 2) for t in sp['ms']]} ms; EP (1, 2) experts "
              f"{ep['expert_rows']}, loss {ep['loss']:.7f} (one process "
              f"{ref['moe_loss']:.7f}), aux {ep['moe_aux']:.6f}, gradient "
              f"err {ep['grad_err']:.2e}, steps "
              f"{[round(t, 2) for t in ep['ms']]} ms [{card}]")
    print(f"NCCL world 1 ({nccl['backend']}): loss bitwise "
          f"{nccl['loss_equal']}, gradients bitwise {nccl['grads_equal']} "
          f"(max err {nccl['grad_err']:.2e}); the only NCCL coverage on a "
          "one-card machine (NCCL refuses two ranks on one card)")
    dpc, spc = cause["dp"], cause["sp"]
    print(f"global form gap accounted for: the one-process step reads "
          f"{ranks[0]['grad_err']:.2e} from the ranks' gradient; fed the "
          f"ranks' gathered signatures {cause['signatures_fed']:.2e}; with "
          f"the ranks' sign_max picks {cause['picks_forced']:.2e} at "
          f"{cause['picks_forced_leaf']} (limit {P12_FED_REL}); "
          f"{cause['pick_switches']} of "
          f"{120 * 62 * 256} picks differ; signatures max |ranks - one "
          f"process| {dpc['sig_max_abs_diff']:.2e}, {dpc['flips']} of "
          f"{dpc['valid']} valid triplets change side ({dpc['active']} "
          f"active in the one process, {dpc['near']} with |hinge| < "
          f"{P12_NEAR}); SP signatures {spc['sig_max_abs_diff']:.2e}, "
          f"{spc['flips']} change side; {cause_s:.1f} s [{card}]")
    check(cause["picks_forced"] <= P12_FED_REL,
          "the one-process step with the ranks' sign_max picks differs "
          "from the ranks' gradient")
    for r in ranks:
        tag = f"rank {r['rank']}"
        for k in ("loss", "triplet", "id_ce"):
            check(abs(r["loss"][k] - ref["loss"][k])
                  <= P12_LOSS_RTOL * abs(ref["loss"][k]),
                  f"{tag}: global form {k} vs one process")
        check(r["grad_err"] <= P12_GRAD_REL, f"{tag}: global form gradient")
        check(r["grad_err"] <= P12_FED_REL or cause["pick_switches"] > 0,
              f"{tag}: a gradient gap no switched sign_max pick accounts "
              "for")
        for k, v in r["faults"].items():
            check(v > P12_GRAD_REL, f"{tag}: planted fault '{k}' passes")
        check(r["launches"] == [1, 1], f"{tag}: launches {r['launches']}")
        check([tuple(s) for s in r["shapes"]] == [(120, 62, 256)],
              f"{tag}: kernel shapes {r['shapes']}")
        check(r["params_equal_rank0"], f"{tag}: params differ from rank 0's")
        ref_form, feat_form = r["forms"]["reference"], r["forms"]["feature"]
        check(abs(ref_form[0] - ref_form[1]) > 1e-5 * abs(ref_form[0]),
              f"{tag}: per-shard form equals the global one under "
              "reference L2")
        check(abs(feat_form[0] - feat_form[1]) <= 1e-5 * abs(feat_form[0]),
              f"{tag}: forms differ under feature L2")
        sp, ep = r["sp"], r["ep"]
        check(sp["frames"][1] == 13, "SP frames per rank")
        check(abs(sp["loss"] - ref["loss"]["loss"])
              <= P12_LOSS_RTOL * abs(ref["loss"]["loss"]), f"{tag}: SP loss")
        check(sp["grad_err"] <= P12_GRAD_REL, f"{tag}: SP gradient")
        check(abs(ep["loss"] - ref["moe_loss"])
              <= P12_LOSS_RTOL * abs(ref["moe_loss"]), f"{tag}: EP loss")
        check(ep["grad_err"] <= P12_GRAD_REL, f"{tag}: EP gradient")
    check(nccl["backend"] == "nccl", "world 1 did not take NCCL")
    check(nccl["loss_equal"] and nccl["grads_equal"],
          "NCCL world 1 differs from the one-process step")
    phase_s = time.perf_counter() - t_phase
    print(f"phase 12: {phase_s:.1f} s (world 2: {world2_s:.1f} s, NCCL "
          f"world 1: {nccl_s:.1f} s) [{card}]")
    return {"ranks": ranks, "nccl": nccl, "moe_step_ms": moe_ms,
            "moe_aux": moe_aux, "moe_peak_gb": moe_peak,
            "world2_s": world2_s, "nccl_s": nccl_s, "phase_s": phase_s,
            "gap_cause": cause,
            "launches": {"triplet_fwd": ranks[0]["launches"][0],
                         "triplet_bwd": ranks[0]["launches"][1]}}


# ---- phase 13: tensor and pipeline parallelism, mesh serving, the
# data-parallel evaluate and trace profiling ------------------------------
# TP (1, 2): two gloo ranks share the card, each with half of every split
# conv, 31 parts and half the classifier's rows, on phase 12's global batch
# (P13_TP_ROWS rows).  Limits as phase 12's: losses against the one-process
# step within P13_LOSS_RTOL, the whole gradient (shards joined) within
# GRAD_REL of its largest entry; each rank's kernel value on its strip
# against the plain reduction over the kernel's own dist within VAL_RTOL.
# Three planted faults must exceed the gradient limit.  PP on [cuda:0,
# cuda:0]: the same limits, one planted fault (the second slot's branch
# gradient dropped).  Mesh serving: two gloo ranks, each holding half of
# phase 6's 65,536-row random gallery (float32 and int8), and the sharded
# kNN on it, against the one-card service: labels equal except where the
# one card's 3rd and 4th neighbors lie within P13_TIE_REL of each other.
# evaluate --dp 2 on phase 5's sets and phase 7's best: Rank-1 equal to
# phase 7's one-process evaluate; codes within P13_CODE_REL of max |code|
# except at the elements where a rank's sign_max pick differs from the one
# process's.  Each rank's convolutions run on 64 clips, not 128, and round
# apart (an H100 at 700 W reads 3.7e-6 of max on seed-0 weights, hence
# 1e-5 and not 1e-6), so a pick at a near tie may switch and that element
# take the other branch's value, of the same magnitude and perhaps the
# other sign.  The ranks' picks are those of the CLI's own encode; the one
# process's come from its forward on the same batch again, whose codes must
# equal the cached ones bitwise.  A planted fault, the batch-axis L2 local
# to each rank, is read by the same rule and must fail it.
P13_LOSS_RTOL = 1e-5
P13_GRAD_REL = GRAD_REL
P13_TP_ROWS = 120
P13_TIE_REL = 1e-5
P13_CODE_REL = 1e-5
def _p13_whole_grads(state):
    """Every gradient, shards joined whole over their model group; a
    parameter without one reads 0."""
    from ugaitnet_tpu_torch.ops.collectives import gather_along
    out = {}
    for k, p in state.model.named_parameters():
        g = p.grad if p.grad is not None else torch.zeros_like(p)
        spec = getattr(p, "shard_spec", None)
        out[k] = g.detach() if spec is None else \
            gather_along(g.detach(), spec.group, spec.dim)
    return out


def _p13_tp_rank(rank, work):
    """One rank of the TP (1, 2) world on cuda:0."""
    from ugaitnet_tpu_torch.core.config import TrainConfig
    from ugaitnet_tpu_torch.models.network import UGaitNet
    from ugaitnet_tpu_torch.ops.cuda import build
    from ugaitnet_tpu_torch.ops.cuda import triplet_kernel as K
    from ugaitnet_tpu_torch.parallel import sharding as S
    from ugaitnet_tpu_torch.parallel.faults import TP_FAULTS, tp_planted
    from ugaitnet_tpu_torch.parallel.tensor import (make_mesh2d,
                                                     make_tp_train_step,
                                                     place_tp_model)
    from ugaitnet_tpu_torch.train.train_step import init_state
    _p12_setup()
    build.load("triplet_kernel")      # the parent built it
    dev = torch.device("cuda", 0)
    ref = torch.load(os.path.join(work, "p13_ref.pt"), weights_only=True)
    batch = _p12_load(work, "p13_batch.pt", dev)
    mcfg, tcfg = flagship_cfg(), TrainConfig()
    mesh = make_mesh2d(1, 2, [dev, dev])
    local = S.shard_batch(batch, mesh)
    step = make_tp_train_step(mcfg, tcfg, mesh)

    def probe():
        model = UGaitNet(mcfg, seed=0)
        place_tp_model(model, mesh)
        return init_state(model, TrainConfig(optimizer="sgd", lr=0.0))
    res = {"rank": rank}
    seen = []
    launch_fwd = K.launch_fwd

    def recording(x, labels, margin):
        seen.append((x.detach().clone(), labels.clone()))
        return launch_fwd(x, labels, margin)
    st = probe()
    res["shapes"] = {k: list(p.shape) for k, p in
                     st.model.named_parameters()
                     if k.startswith("branches.branch_of.a_conv")
                     or k.endswith("part_proj") or k == "classprob.weight"}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    K.launch_fwd = recording
    t0 = time.perf_counter()
    try:
        _, m = step(st, local)
    finally:
        K.launch_fwd = launch_fwd
    torch.cuda.synchronize()
    res["step_ms"] = (time.perf_counter() - t0) * 1e3
    res["launches"] = [K.fwd_launches, K.bwd_launches]
    res["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    res["loss"] = {k: float(v) for k, v in m.items()}
    res["worst"] = {}
    res["grad_err"] = _grad_err(_p13_whole_grads(st), ref["grads"],
                                worst=res["worst"])
    # the kernel on this rank's strip against the plain reduction over the
    # kernel's own dist (a launch made to compare: after the counts)
    x, lab = seen[0]
    res["kernel_shape"] = [x.shape[1], x.shape[0], x.shape[2]]
    dist, s, c = launch_fwd(x, lab, tcfg.margin)
    res["kernel_value"] = float(K.combine(s, c))
    res["plain_over_kernel_dist"] = value_over_dist(dist, lab, tcfg.margin)
    del seen, x, dist, st
    torch.cuda.empty_cache()
    # the faults on the first 40 rows, against their own one-process step
    ref40 = torch.load(os.path.join(work, "p13_ref40.pt"), weights_only=True)
    local40 = S.shard_batch(_p12_load(work, "p13_batch40.pt", dev), mesh)
    res["faults"] = {}
    for name in TP_FAULTS:
        st = probe()
        with tp_planted(name):
            step(st, local40)
        res["faults"][name] = _grad_err(_p13_whole_grads(st),
                                        ref40["grads"])
        del st
        torch.cuda.empty_cache()
    with open(os.path.join(work, f"p13_tp{rank}.json"), "w") as f:
        json.dump(res, f)


def _p13_gallery(dev, g=65536, d=15872):
    """Phase 6's random unit-norm gallery and its 128 queries."""
    gen = torch.Generator(device=dev).manual_seed(5)
    x = torch.randn(g, d, device=dev, generator=gen)
    x /= torch.linalg.vector_norm(x, dim=1, keepdim=True)
    big = x.cpu().numpy()
    del x
    queries = big[:128] + 1e-4 * np.random.RandomState(0).randn(
        128, d).astype(np.float32)
    return big, np.arange(g) % 1000, queries


def _p13_serve(big, labels, queries, mesh=None):
    """identify_codes of the queries on a float32 and an int8 service (on
    ``mesh`` or one card), their device ms at bucket 128, and kNN labels
    (``knn_predict_sharded`` on a mesh, ``knn_predict`` on one card)."""
    from ugaitnet_tpu_torch.eval.serving import SignatureService
    from ugaitnet_tpu_torch.models.network import UGaitNet
    from ugaitnet_tpu_torch.ops.knn import (knn_predict, knn_predict_sharded,
                                            nearest)
    dev = torch.device("cuda", 0)
    model = UGaitNet(flagship_cfg(), seed=0)
    qdev = torch.from_numpy(queries).to(dev)
    out = {}
    for dt in ("float32", "int8"):
        svc = SignatureService(model, MODS, knn=3, buckets=BUCKETS,
                               gallery_dtype=dt, mesh=mesh)
        svc.set_gallery(big, labels)
        lab, dists = svc.identify_codes(queries)
        with torch.no_grad():
            ms = cuda_ms(lambda: svc._dist_vote(qdev, 3), 10)
            rec = {"labels": lab.tolist(), "dists": dists.tolist(),
                   "device_ms": ms, "rows": int(svc._gallery_codes.shape[0])}
            if mesh is None:
                d2 = svc._distances(qdev) + svc._gallery_bias[None, :]
                rec["d2_4"] = nearest(d2, 4)[0].cpu().tolist()
        out[dt] = rec
        del svc
        gc.collect()
        torch.cuda.empty_cache()
    for dt in ("float32", "int8"):
        got = (knn_predict_sharded(queries, big, labels, mesh, k=3,
                                   gallery_dtype=dt) if mesh is not None
               else knn_predict(queries, big, labels, k=3)
               if dt == "float32" else None)
        out[dt]["knn"] = None if got is None else got.tolist()
    return out


def _p13_serve_rank(rank, work):
    """One rank of the mesh-serving world of 2 on cuda:0."""
    from ugaitnet_tpu_torch.parallel import sharding as S
    _p12_setup()
    dev = torch.device("cuda", 0)
    mesh = S.make_mesh(2, [dev, dev])
    res = _p13_serve(*_p13_gallery(dev), mesh=mesh)
    with open(os.path.join(work, f"p13_serve{rank}.json"), "w") as f:
        json.dump(res, f)


@contextlib.contextmanager
def _p13_recording(sink):
    """While open, every UGaitNet forward in this process appends its
    sign_max picks (uint8 (B, P * D), on the host) to ``sink[-1]``."""
    from ugaitnet_tpu_torch.models.network import UGaitNet
    forward = UGaitNet.forward

    def recording(self, *args, **kwargs):
        out = forward(self, *args, **kwargs)
        sink[-1].append(_p12_picks(out).reshape(len(out["fused"]), -1).cpu())
        return out
    UGaitNet.forward = recording
    try:
        yield
    finally:
        UGaitNet.forward = forward


def _p13_encode(args, ds_dir, batches, mesh=None):
    """{batch: (codes, picks)} for each of ``batches`` of the set at
    ``ds_dir``, encoded as ``cli.evaluate`` with ``args`` encodes it (the
    same rows, tail padding and batch size; on ``mesh``, data-parallel):
    the codes on the host, and the sign_max picks of its forward (a mesh
    rank's rows only)."""
    from ugaitnet_tpu_torch.cli.evaluate import load_experiment
    from ugaitnet_tpu_torch.data.pipeline import load_norm_stats
    from ugaitnet_tpu_torch.data.schema import GaitDataset
    from ugaitnet_tpu_torch.eval.encode import encode_dataset
    model, _, mcfg, _ = load_experiment(
        args.experdir, args.epoch,
        device=args.device if mesh is None else mesh.device)
    mods = tuple(b.modality for b in mcfg.branches)
    norm = load_norm_stats(args.experdir, mods)
    ds = GaitDataset.load(ds_dir)
    out = {}
    for bi in batches:
        sink = [[]]
        with _p13_recording(sink):
            codes = encode_dataset(
                model, ds, mods, typecode=args.typecode,
                batch_size=args.bs, norm_stats=norm, mesh=mesh,
                indices=np.arange(bi * args.bs,
                                  min((bi + 1) * args.bs, len(ds))))[0]
        out[int(bi)] = (codes, sink[0][0])
    return out


def _p13_eval_rank(rank, argv, work):
    """One rank of ``cli.evaluate --dp 2`` in a world started here.  The
    sign_max picks of its encode's forwards (this rank's rows of every
    batch) are saved per code cache file for the codes check.  Then the
    probe set's first batch is encoded again on the same ranks with the
    signature's batch-axis L2 local to each rank: a planted fault that the
    codes check must catch."""
    from ugaitnet_tpu_torch.cli import evaluate as cli_eval
    from ugaitnet_tpu_torch.eval import protocol
    from ugaitnet_tpu_torch.ops import fusion
    from ugaitnet_tpu_torch.parallel import sharding as S
    _p12_setup()
    sink, files, encode_set = [[]], [], protocol.encode_set

    def tagged(*a, cache_path=None, **kw):
        files.append(os.path.basename(cache_path))
        sink.append([])
        return encode_set(*a, cache_path=cache_path, **kw)
    protocol.encode_set = tagged
    try:
        with _p13_recording(sink), contextlib.redirect_stdout(io.StringIO()):
            cli_eval.main(argv)
    finally:
        protocol.encode_set = encode_set
    torch.save(dict(zip(files, sink[1:])),
               os.path.join(work, f"p13_picks{rank}.pt"))
    args = cli_eval.build_parser().parse_args(argv)
    mesh = S.make_mesh(args.dp, S.rank_devices(args.device))
    signature = fusion.signature
    fusion.signature = lambda fused, l2_mode="reference", group=None: \
        signature(fused, l2_mode)
    try:
        codes = _p13_encode(args, args.probes[0], [0], mesh)[0][0]
    finally:
        fusion.signature = signature
    if rank == 0:
        np.save(os.path.join(work, "p13_dp_fault.npy"), codes)


def _p13_code_err(a, b, switched):
    """(max |a - b| / max |a|, the same off ``switched``, elements over
    P13_CODE_REL of max off ``switched``) of codes ``a`` and ``b``."""
    diff = np.abs(a - b) / float(np.abs(a).max())
    off = diff[~switched]
    return (float(diff.max()), float(off.max()),
            int((off > P13_CODE_REL).sum()))


def _p13_evaluate_dp(work, experdir, gallery_dir, probe_dir, one_results,
                     devices):
    """``cli.evaluate --dp 2`` on two ranks over ``devices``, held to the one-process evaluate whose codes are cached in
    ``experdir`` and whose results are ``one_results``."""
    from ugaitnet_tpu_torch.cli import evaluate as cli_eval
    from ugaitnet_tpu_torch.parallel import sharding as S
    keep = os.path.join(experdir, "one_process_codes")
    os.makedirs(keep, exist_ok=True)
    cached = [f for f in os.listdir(experdir) if f.startswith("codes_")]
    for f in cached:
        os.replace(os.path.join(experdir, f), os.path.join(keep, f))
    outfile = os.path.join(work, "p13_eval_dp.json")
    argv = ["--experdir", experdir, "--epoch", "best", "--gallery",
            gallery_dir, "--probes", probe_dir, "--protocol", "casiab",
            "--knn", "3", "--bs", "128", "--dp", "2", "--outfile", outfile]
    S.spawn(_p13_eval_rank, 2, args=(argv, work), devices=devices)
    with open(outfile) as f:
        dp_res = json.load(f)[os.path.basename(probe_dir)]
    # the elements where a rank's sign_max pick (saved by the CLI's encode)
    # differs from the one process's, in the batches with an element over
    # the limit; the one process's picks from its forward on each such
    # batch again, whose codes must equal phase 7's cached ones bitwise
    args = cli_eval.build_parser().parse_args(argv)
    bs = args.bs
    rank_picks = [torch.load(os.path.join(work, f"p13_picks{r}.pt"))
                  for r in range(2)]
    fault = np.load(os.path.join(work, "p13_dp_fault.npy"))
    code_err = {}
    for f in cached:
        a = np.load(os.path.join(keep, f))["codes"]
        b = np.load(os.path.join(experdir, f))["codes"]
        check(a.shape == b.shape, f"{f}: dp codes {b.shape} vs {a.shape}")
        kind = f.split("_")[1]
        nb = -(-len(a) // bs)
        check(all(len(p[f]) == nb for p in rank_picks),
              f"{f}: the ranks' encode ran {[len(p[f]) for p in rank_picks]}"
              f" forwards, not {nb}")
        rows, _ = np.nonzero(np.abs(a - b)
                             > P13_CODE_REL * float(np.abs(a).max()))
        batches = set(rows // bs) | ({0} if kind == "probe" else set())
        switched = np.zeros(a.shape, bool)
        for bi, (codes, picks) in _p13_encode(
                args, gallery_dir if kind == "gallery" else probe_dir,
                sorted(batches)).items():
            real = slice(bi * bs, bi * bs + len(codes))
            check(np.array_equal(codes, a[real]),
                  f"{f}: batch {bi} encoded again in one process differs "
                  "from the cached codes")
            ranks = torch.cat([p[f][bi] for p in rank_picks])
            check(picks.shape == ranks.shape == (bs, a.shape[1]),
                  f"{f}: picks {tuple(picks.shape)} vs codes {a.shape}")
            switched[real] = (picks != ranks)[:len(codes)].numpy()
        err = _p13_code_err(a, b, switched)
        code_err[kind] = {"max_rel": err[0], "max_rel_off_switches": err[1],
                          "over_limit_off_switches": err[2],
                          "over_limit": int(len(rows)),
                          "switched_elements": int(switched.sum()),
                          "batches_encoded_again": len(batches)}
        if kind == "probe":
            err = _p13_code_err(a[:len(fault)], fault, switched[:len(fault)])
            code_err["fault_local_l2"] = {
                "max_rel": err[0], "max_rel_off_switches": err[1],
                "over_limit_off_switches": err[2]}
    rank1 = {c: (dp_res[c], one_results[c]) for c in one_results
             if c != "confusions_file"}
    return {"code_rel_err": code_err, "cached": cached,
            "rank1_equal": all(a == b for a, b in rank1.values())}


def _p13_firm(one, k=3):
    """Queries whose one-card 3rd and 4th d^2 are more than P13_TIE_REL
    apart (a decision rounding cannot move)."""
    d = np.asarray(one["d2_4"])
    return d[:, k] - d[:, k - 1] > P13_TIE_REL * d[:, k]


P13_COUNTED = "p13_counted_steps"


def counted_trace(logdir, marker):
    """Writes ``counted.json`` beside ``<logdir>/trace.json``, holding the
    trace's events that start at or after the host range ``marker`` (the
    card was synchronized just before it, so every earlier kernel has
    ended).  Returns {"path": its path, "before": the kernel events left
    out}."""
    with open(os.path.join(logdir, "trace.json")) as f:
        trace = json.load(f)
    evs = trace["traceEvents"]
    t0 = min(e["ts"] for e in evs if e.get("name") == marker
             and e.get("ph") == "X")
    kept = [e for e in evs if float(e.get("ts", t0)) >= t0]
    before = sum(1 for e in evs if e.get("ph") == "X"
                 and e.get("cat") == "kernel" and float(e["ts"]) < t0)
    trace["traceEvents"] = kept
    path = os.path.join(logdir, "counted.json")
    with open(path, "w") as f:
        json.dump(trace, f)
    return {"path": path, "before": before}


def tp_pp_phase(card, work, experdir, gallery_dir, probe_dir, one_results):
    """Phase 13: TP and PP against the one-process step, mesh serving and
    the sharded kNN, evaluate --dp 2, and a trace of two train steps."""
    from ugaitnet_tpu_torch.core.config import TrainConfig
    from ugaitnet_tpu_torch.models.network import UGaitNet
    from ugaitnet_tpu_torch.obsv.logger import profile
    from ugaitnet_tpu_torch.obsv.profiling import summarize_trace
    from ugaitnet_tpu_torch.ops.cuda import stage_tail as ST
    from ugaitnet_tpu_torch.ops.cuda import triplet_kernel as K
    from ugaitnet_tpu_torch.parallel import pipeline as PP
    from ugaitnet_tpu_torch.parallel import sharding as S
    from ugaitnet_tpu_torch.train.train_step import (Batch, init_state,
                                                     make_train_step)
    t_phase = time.perf_counter()
    _p12_setup()
    dev = torch.device("cuda", 0)
    mcfg, tcfg = flagship_cfg(), TrainConfig()
    out = {"tp_rows": P13_TP_ROWS}
    # phase 12's global batch (phase 3's first augmented one), first rows
    full = torch.load(os.path.join(work, "batch.pt"), weights_only=True)
    for name, n in (("", P13_TP_ROWS), ("40", 40)):
        torch.save({"volumes": [v[:n] for v in full["volumes"]],
                    "flags": [f[:n] for f in full["flags"]],
                    "labels": full["labels"][:n]},
                   os.path.join(work, f"p13_batch{name}.pt"))
        probe = _p12_probe(mcfg)
        _, m = make_train_step(mcfg, tcfg)(
            probe, _p12_load(work, f"p13_batch{name}.pt", dev))
        ref = {"loss": {k: float(v) for k, v in m.items()},
               "grads": {k: g.cpu() for k, g in _p12_grads(probe).items()}}
        torch.save(ref, os.path.join(work, f"p13_ref{name}.pt"))
        del probe
    del full
    ref = torch.load(os.path.join(work, "p13_ref.pt"), weights_only=True)
    batch = _p12_load(work, "p13_batch.pt", dev)

    # ---- PP on [cuda:0, cuda:0], in this process
    pp = {}
    for fault in (False, True):
        probe = _p12_probe(mcfg)
        step = PP.make_pipeline_train_step(probe.model, probe.optimizer,
                                           mcfg, tcfg, [dev, dev])
        K.reset_launch_counts()
        with wrapped(PP, "add_branch_grads", lambda f: (lambda *a: None)) \
                if fault else contextlib.nullcontext():
            _, m = step(probe, batch)
        grads = {k: (p.grad if p.grad is not None else torch.zeros_like(p))
                 for k, p in probe.model.named_parameters()}
        if fault:
            pp["fault_branch_grad_dropped"] = _grad_err(grads, ref["grads"])
        else:
            pp["launches"] = [K.fwd_launches, K.bwd_launches]
            pp["loss"] = {k: float(v) for k, v in m.items()}
            pp["grad_err"] = _grad_err(grads, ref["grads"])
            pp["step_ms"], _ = _p12_timed(step, probe, batch)
        del probe, step, grads
        gc.collect()
        torch.cuda.empty_cache()
    out["pp"] = pp

    # ---- trace profiling: two of phase 3's steps (Adam, seed-0 state)
    state = init_state(UGaitNet(mcfg, seed=0), tcfg)
    step = make_train_step(mcfg, tcfg)
    step(state, batch)                       # warm-up, outside the trace
    logdir = os.path.join(work, "p13_trace")
    torch.cuda.synchronize()
    with profile(logdir):
        # the profiler loses kernel events of the first step it traces;
        # one step warms it up, and only the kernels that start after it
        # are summarized
        step(state, batch)
        torch.cuda.synchronize()
        ST.reset_launch_counts()
        with torch.profiler.record_function(P13_COUNTED):
            for _ in range(2):
                step(state, batch)
            torch.cuda.synchronize()
    out["tail_launches_traced"] = [ST.fwd_launches, ST.bwd_launches]
    counted = counted_trace(logdir, P13_COUNTED)
    out["trace_kernels_warm_step"] = counted["before"]
    prof = summarize_trace(counted["path"], iters=2)
    out["profile_top10"] = [list(r) for r in prof[:10]]
    out["profile_triplet"] = {
        k: sum(r.count for r in prof if k in r.name) / 2
        for k in FWD_KERNELS + BWD_KERNELS}
    out["profile_tail"] = {
        k: sum(r.count for r in prof if k in r.name) / 2
        for k in TAIL_FWD_KERNELS + TAIL_BWD_KERNELS}
    # where the trace's stage-tail events fall among its kernel events, in
    # time order (the trace may miss kernels the counters saw launch)
    with open(counted["path"]) as f:
        kev = sorted((e["ts"], e["name"]) for e in json.load(f)["traceEvents"]
                     if e.get("ph") == "X" and e.get("cat") == "kernel")
    out["trace_positions"] = {
        k: [i for i, (_, n) in enumerate(kev) if k in n]
        for k in TAIL_FWD_KERNELS + TAIL_BWD_KERNELS + FWD_KERNELS}
    out["trace_kernels"] = len(kev)
    del state, step, batch
    gc.collect()
    torch.cuda.empty_cache()

    # ---- TP (1, 2): two gloo ranks on the card
    t0 = time.perf_counter()
    S.spawn(_p13_tp_rank, 2, args=(work,), devices=[dev, dev])
    out["tp_s"] = time.perf_counter() - t0
    out["tp"] = [json.load(open(os.path.join(work, f"p13_tp{r}.json")))
                 for r in range(2)]

    # ---- mesh serving and the sharded kNN
    t0 = time.perf_counter()
    big, labels, queries = _p13_gallery(dev)
    one = _p13_serve(big, labels, queries)
    del big
    gc.collect()
    torch.cuda.empty_cache()
    S.spawn(_p13_serve_rank, 2, args=(work,), devices=[dev, dev])
    out["serve_s"] = time.perf_counter() - t0
    served = [json.load(open(os.path.join(work, f"p13_serve{r}.json")))
              for r in range(2)]
    out["serve"] = {"one_card": {dt: {"device_ms": one[dt]["device_ms"]}
                                 for dt in one},
                    "ranks": [{dt: {"device_ms": s[dt]["device_ms"],
                                    "rows": s[dt]["rows"]} for dt in s}
                              for s in served]}

    # ---- evaluate --dp 2 on phase 5's sets and phase 7's best
    t0 = time.perf_counter()
    out["evaluate_dp"] = _p13_evaluate_dp(work, experdir, gallery_dir,
                                          probe_dir, one_results, [dev, dev])
    out["eval_s"] = time.perf_counter() - t0
    out["phase_s"] = time.perf_counter() - t_phase

    # ---- report, then check
    for r in out["tp"]:
        print(f"TP (1, 2) rank {r['rank']}: loss {r['loss']['loss']:.7f} (one "
              f"process {ref['loss']['loss']:.7f}), gradient err "
              f"{r['grad_err']:.2e} at {r['worst']['leaf']} (limit "
              f"{P13_GRAD_REL}); faults " + ", ".join(
                  f"{k} {v:.2e}" for k, v in r["faults"].items())
              + f" (at B = 40); kernel at (P, B, D) {r['kernel_shape']}: value "
              f"{r['kernel_value']:.7f}, plain over its dist "
              f"{r['plain_over_kernel_dist']:.7f}; launches fwd/bwd "
              f"{r['launches']}; step {r['step_ms']:.1f} ms; peak "
              f"{r['peak_gb']:.2f} GB; shards {r['shapes']} [{card}]")
    print(f"PP [cuda:0, cuda:0]: loss {pp['loss']['loss']:.7f}, gradient err"
          f" {pp['grad_err']:.2e} (limit {P13_GRAD_REL}); fault (branch "
          f"gradient dropped) {pp['fault_branch_grad_dropped']:.2e}; "
          f"launches fwd/bwd {pp['launches']} at (62, {P13_TP_ROWS}, 256); "
          f"steps {[round(t, 1) for t in pp['step_ms']]} ms [{card}]")
    for dt in ("float32", "int8"):
        firm = _p13_firm(one[dt])
        for r, s in enumerate(served):
            diff = np.asarray(s[dt]["labels"]) != np.asarray(one[dt]["labels"])
            print(f"mesh serving {dt} rank {r}: {s[dt]['rows']} of 65536 rows,"
                  f" identify_codes bucket 128 device {s[dt]['device_ms']:.3f}"
                  f" ms (CUDA events, the gloo merge included; one card "
                  f"{one[dt]['device_ms']:.3f} ms); labels differ on "
                  f"{int(diff.sum())} queries ({int((~firm).sum())} near ties"
                  f") [{card}]")
            check(not (diff & firm).any(),
                  f"mesh serving {dt} rank {r}: labels differ off near ties")
            knn = np.asarray(s[dt]["knn"])
            want = np.asarray(one["float32"]["knn"]) if dt == "float32" \
                else np.asarray(one["int8"]["labels"])
            check(not ((knn != want) & firm).any(),
                  f"sharded kNN {dt} rank {r} differs off near ties")
    ed = out["evaluate_dp"]
    print(f"evaluate --dp 2: Rank-1 equal to phase 7's one process: "
          f"{ed['rank1_equal']}; codes: max |dp - one| / max |one|, the same"
          f" off the elements where a rank's sign_max pick differs from the "
          f"one process's, and elements over {P13_CODE_REL} of max off them;"
          f" the planted fault (batch-axis L2 local to each rank, the probe "
          f"set's first batch) read by the same rule: {ed['code_rel_err']}; "
          f"{out['eval_s']:.1f} s [{card}]")
    print(f"trace of 2 train steps (summarize_trace, kernel events), top 10:")
    for ms, n, name in out["profile_top10"]:
        print(f"  {ms:9.3f} ms/step x{n:3d}  {name[:90]}")
    print(f"triplet kernels per step in the trace: {out['profile_triplet']};"
          f" stage-tail kernels {out['profile_tail']} (launch counters over "
          f"the 2 traced steps: {out['tail_launches_traced']}); positions "
          f"among the 2 steps' {out['trace_kernels']} kernel events: "
          f"{out['trace_positions']}; the warm-up step inside the trace: "
          f"{out['trace_kernels_warm_step']} kernel events")
    print(f"phase 13: {out['phase_s']:.1f} s (TP {out['tp_s']:.1f} s, serving"
          f" {out['serve_s']:.1f} s, evaluate {out['eval_s']:.1f} s) [{card}]")
    for r in out["tp"]:
        tag = f"TP rank {r['rank']}"
        for k in ("loss", "triplet", "id_ce"):
            check(abs(r["loss"][k] - ref["loss"][k])
                  <= P13_LOSS_RTOL * abs(ref["loss"][k]), f"{tag}: {k}")
        check(r["grad_err"] <= P13_GRAD_REL, f"{tag}: gradient")
        for k, v in r["faults"].items():
            check(v > P13_GRAD_REL, f"{tag}: planted fault '{k}' passes")
        check(r["launches"] == [1, 1], f"{tag}: launches {r['launches']}")
        check(r["kernel_shape"] == [31, P13_TP_ROWS, 256],
              f"{tag}: kernel shape {r['kernel_shape']}")
        check(abs(r["kernel_value"] - r["plain_over_kernel_dist"])
              <= VAL_RTOL * abs(r["plain_over_kernel_dist"]),
              f"{tag}: kernel value on the strip")
    for k in ("loss", "triplet", "id_ce"):
        check(abs(pp["loss"][k] - ref["loss"][k])
              <= P13_LOSS_RTOL * abs(ref["loss"][k]), f"PP: {k}")
    check(pp["grad_err"] <= P13_GRAD_REL, "PP: gradient")
    check(pp["fault_branch_grad_dropped"] > P13_GRAD_REL,
          "PP: the planted fault passes")
    check(pp["launches"] == [1, 1], f"PP launches {pp['launches']}")
    check(ed["rank1_equal"], "evaluate --dp 2: Rank-1 differs")
    errs = ed["code_rel_err"]
    check(set(errs) == {"gallery", "probe", "fault_local_l2"} and all(
        errs[k]["over_limit_off_switches"] == 0 for k in ("gallery", "probe")),
        f"evaluate --dp 2: codes off switched picks {errs}")
    check(errs["fault_local_l2"]["over_limit_off_switches"] > 0,
          "evaluate --dp 2: the planted local L2 passes the codes check")
    check(all(v == 1 for v in out["profile_triplet"].values()),
          f"trace: triplet kernels per step {out['profile_triplet']}")
    check(out["tail_launches_traced"] == [8, 8],
          f"stage-tail launches over 2 traced steps "
          f"{out['tail_launches_traced']}")
    check(all(v == 4 for v in out["profile_tail"].values()),
          f"trace: stage-tail kernels per step {out['profile_tail']}")
    out["launches"] = {"tp_rank_step": out["tp"][0]["launches"],
                       "pp_step": pp["launches"]}
    return out


# ---- 14. convergence to Rank-1 ---------------------------------------------

P14_IDS = 64                     # identities (chance 1 / 64), the artifact's
P14_SEED = 0                     # the JAX artifact's seed: its data, bitwise
# epochs of the tiny twin (the JAX script's) and of the full-width run
P14_EPOCHS = {"tiny": 20, "full": 20}
RANK1_MIN = 0.9                  # tests/test_convergence_rank1.py:33-34
EER_MAX = 0.25                   # :36
SENS_GAP = 0.02                  # :50-54, the sensitivity clause
SYN_ARTIFACT = "benchmarks/results_synthetic_rank1.json"
P14_RESULTS = os.path.join("chiprun_out", "phase14")
P14_FITS = ("tiny_fit", "full_fit")


@contextlib.contextmanager
def path_counts(store):
    """The launches of every hand kernel of the block, counts set to 0 at
    its start, and the GaitSet branch forwards on the card: fills store
    with triplet_fwd, triplet_bwd, tail_fwd, tail_bwd, conv3x3,
    conv_variants and branch_forwards."""
    from ugaitnet_tpu_torch.ops.cuda import conv3x3 as CV
    from ugaitnet_tpu_torch.ops.cuda import triplet_kernel as K
    K.reset_launch_counts()
    CV.reset_launch_counts()
    with tail_counts(store):
        yield store
    store.update(triplet_fwd=K.fwd_launches, triplet_bwd=K.bwd_launches,
                 conv3x3=CV.launches, conv_variants=dict(CV.variant_launches))


def keep_first(store, key):
    """A wrapper factory that keeps a copy of the arguments of the first
    call for each key(args) (the kernels' inputs on the main path, for
    their comparison with the plain versions after it)."""
    def make(fn):
        def call(*a, **kw):
            k = key(*a)
            if k not in store:
                store[k] = tuple(v.detach().clone() if isinstance(
                    v, torch.Tensor) else v for v in a)
            return fn(*a, **kw)
        return call
    return make


def sweep_limits(res):
    """The readings the phase holds a result to."""
    sw = res["sweeps"]
    return {"rank1_subseq": res["rank1_subseq"] >= RANK1_MIN,
            "rank1_video": res["rank1_video"] >= RANK1_MIN,
            "eer": bool(np.isfinite(res["eer"])) and res["eer"] <= EER_MAX,
            "sweeps": set(sw) == {"full", "of_only", "gray_only"}}


def sensitivity(sw):
    """tests/test_convergence_rank1.py:50-54: a single-modality sweep
    visibly below the full one."""
    return (min(sw["of_only"]["rank1_subseq"], sw["gray_only"]["rank1_subseq"])
            < sw["full"]["rank1_subseq"] - SENS_GAP
            or max(sw["of_only"]["eer"], sw["gray_only"]["eer"])
            > sw["full"]["eer"] + SENS_GAP)


def fmt_sweeps(sw):
    return "; ".join(f"{s} Rank-1 {v['rank1_subseq']:.4f} / video "
                     f"{v['rank1_video']:.4f}, EER {v['eer']:.4f}"
                     for s, v in sw.items())


def triplet_vs_plain(x, lab):
    """The triplet kernels against the plain version at a signature of the
    path and its labels.  On the signature itself, at margin 0.2 and at
    the batch's median distance: the value against the plain reduction
    over the kernel's dist (rtol VAL_RTOL), counts and g exact, d^2 on the
    scale of the norms (DIST_REL).  The gradient against the plain
    autograd (GRAD_REL, with phase 1's planted faults) on a seeded normal
    tensor of the same shape and labels, as phase 1 holds it: a trained
    signature holds hinges within float32 rounding of 0, which the two
    dists put on different sides."""
    from ugaitnet_tpu_torch.ops.cuda import triplet_kernel as K
    from ugaitnet_tpu_torch.ops.triplet import (batch_all_triplet_loss,
                                                pairwise_dist)
    x = x.detach().float().contiguous()
    name = f"phase 14 triplet {tuple(x.shape)}"
    med = float(pairwise_dist(x.transpose(0, 1)).median())
    out = {"shape": list(x.shape), "median_margin": med}
    for key, m in (("0.2", 0.2), ("median", med)):
        kv = float(K.batch_all_triplet_loss_cuda(x, lab, m))
        dist, _ = exact_checks(x, lab, m)
        vo = value_over_dist(dist, lab, m)
        out[key] = {"kernel": kv, "over_kernel_dist": vo,
                    "plain": float(batch_all_triplet_loss(x, lab, m)),
                    "sq_dist_err": sq_dist_err(dist, x),
                    "value_rel": abs(kv - vo) / abs(vo) if vo else abs(kv)}
        check(out[key]["value_rel"] <= VAL_RTOL, f"{name} m={m}: value")
        check(out[key]["sq_dist_err"] <= DIST_REL, f"{name} m={m}: dist")
    gen = torch.Generator(device=x.device).manual_seed(14)
    r = torch.randn(x.shape, device=x.device, generator=gen)
    xk = r.clone().requires_grad_(True)
    K.batch_all_triplet_loss_cuda(xk, lab).backward()
    xp = r.clone().requires_grad_(True)
    batch_all_triplet_loss(xp, lab).backward()
    out["grad_rel"] = rel_err(xk.grad, xp.grad)
    out["grad_max_abs_err"] = float((xk.grad - xp.grad).abs().max())
    out["grad_faults"] = fault_readings(r, lab, xp.grad)
    check_faults(name, out["grad_rel"], out["grad_faults"])
    return out


def tail_vs_plain(x, batch, alpha, grad):
    """The stage tail against the plain chain on an input of the path:
    forward bitwise; where the path runs the backward, the gradient within
    TAIL_GRAD_REL of max."""
    from ugaitnet_tpu_torch.ops.cuda import stage_tail as ST
    from ugaitnet_tpu_torch.ops.pooling import stage_tail
    ak, sk = ST.launch_fwd(x, batch, alpha)
    ap, sp = stage_tail(x, batch, alpha)
    out = {"shape": list(x.shape), "dtype": str(x.dtype)[6:],
           "bitwise": torch.equal(ak, ap) and torch.equal(sk, sp),
           "max_abs_err": max(float((ak.float() - ap.float()).abs().max()),
                              float((sk.float() - sp.float()).abs().max()))}
    check(out["bitwise"], f"phase 14 stage tail {tuple(x.shape)} "
                          f"{x.dtype}: forward")
    if grad:
        gen = torch.Generator(device=x.device).manual_seed(14)
        g_a = torch.randn(ak.shape, device=x.device, generator=gen).to(
            x.dtype)
        g_s = torch.randn(sk.shape, device=x.device, generator=gen).to(
            x.dtype)
        want = tail_grad(x, batch, g_a, g_s, None).float()
        got = tail_grad(x, batch, g_a, g_s).float()
        out["grad_rel"] = rel_err(got, want)
        out["grad_max_abs_err"] = float((got - want).abs().max())
        check(out["grad_rel"] <= TAIL_GRAD_REL,
              f"phase 14 stage tail {tuple(x.shape)}: gradient")
    return out


def conv_vs_plain(x, w):
    """The conv kernel on an input of the path, per element within ulp +
    CONV_SUM_REL * S of its plain version and of the float64 convolution
    rounded once to bf16.  The plain version's float32 F.conv2d runs
    without cuDNN (float32 GEMMs over im2col): on trained a_conv6 inputs
    (values ~3e5) cuDNN's float32 algorithms have read 1.1-1.5 of the
    limit from the kernel, whose reading from float64 stayed under 1
    (PERF.md section 6, PR 14).  cuDNN's plain, deterministic off and on,
    is read against float64 and the kernel, not held."""
    import torch.nn.functional as F
    from ugaitnet_tpu_torch.ops.conv3x3 import conv3x3
    from ugaitnet_tpu_torch.ops.cuda import conv3x3 as CV
    got = CV.conv3x3_cuda(x, w)
    s = conv_abs(x, w)
    exact = F.conv2d(x.double(), w.double(), padding=1).to(torch.bfloat16)
    with torch.backends.cudnn.flags(enabled=False, allow_tf32=False):
        plain = conv3x3(x, w)
    r = ulp_readings(got, plain, s)
    r["shape"] = list(x.shape) + [w.shape[0]]
    r["vs_float64"] = ulp_readings(got, exact, s)["of_limit"]
    r["plain_vs_float64"] = ulp_readings(plain, exact, s)["of_limit"]
    for det in (False, True):
        with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                        deterministic=det, allow_tf32=False):
            cudnn = conv3x3(x, w)
        key = "cudnn_deterministic" if det else "cudnn"
        r[f"{key}_vs_float64"] = ulp_readings(cudnn, exact, s)["of_limit"]
        r[f"kernel_vs_{key}"] = ulp_readings(got, cudnn, s)["of_limit"]
    print(f"  conv {tuple(x.shape)} -> {w.shape[0]}, of the limit: kernel vs "
          f"plain {r['of_limit']:.3f}, vs float64 {r['vs_float64']:.3f}; "
          f"plain vs float64 {r['plain_vs_float64']:.3f}; cuDNN's plain "
          f"(deterministic off / on) vs float64 "
          f"{r['cudnn_vs_float64']:.3f} / "
          f"{r['cudnn_deterministic_vs_float64']:.3f}, vs the kernel "
          f"{r['kernel_vs_cudnn']:.3f} / "
          f"{r['kernel_vs_cudnn_deterministic']:.3f}")
    check(r["of_limit"] <= 1.0 and r["vs_float64"] <= 1.0,
          f"phase 14 conv {tuple(x.shape)}: {r['of_limit']:.3f} of the "
          f"limit from the plain version, {r['vs_float64']:.3f} from "
          f"float64")
    return r


def convergence_phase(card, work, device="cuda"):
    """14. The port's convergence run (``eval/synthetic_rank1.py:run``) on
    the card at 64 identities, in the directory ``work`` (which the caller
    removes): the tiny twin (the JAX artifact's configuration) and the
    flagship at full width, each through ``Trainer.fit``, the fp32 encode
    and the three probe sweeps; then the full-width weights re-encoded in
    bf16 without autograd (the conv kernel's path).  Exact launch counts
    on each path, the kernels against their plain versions on the path's
    own inputs, the Rank-1 and EER limits, the results under
    ``chiprun_out/phase14/``."""
    from ugaitnet_tpu_torch.data.sampler import split_train_val_by_video
    from ugaitnet_tpu_torch.eval import synthetic_rank1 as SR
    from ugaitnet_tpu_torch.models import gaitset as GS
    from ugaitnet_tpu_torch.models.network import UGaitNet
    from ugaitnet_tpu_torch.obsv.logger import MetricsLogger
    from ugaitnet_tpu_torch.ops.cuda import conv3x3 as CV
    from ugaitnet_tpu_torch.ops.cuda import triplet_kernel as K
    from ugaitnet_tpu_torch.train import trainer as TR
    t_phase = time.perf_counter()
    # a user's settings (phases 12 and 13 leave deterministic cuDNN on)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = False
    torch.backends.cudnn.benchmark = False
    dev = torch.device(device)
    res_dir = os.path.join(REPO, P14_RESULTS)
    os.makedirs(res_dir, exist_ok=True)
    with open(os.path.join(REPO, SYN_ARTIFACT)) as f:
        artifact = json.load(f)

    # the datasets, made once for both runs (a pure function of the
    # identities and the seed; ~13 s on the host), and the step counts the
    # launches follow from
    data = SR.datasets(P14_IDS, P14_SEED)
    train_ds, eval_ds = data
    _, dcfg, _, ecfg = SR.recipe(P14_IDS, 1)
    tr_idx, val_idx = split_train_val_by_video(train_ds.video_ids, perc=0.15,
                                               seed=P14_SEED)
    steps = len(tr_idx) // dcfg.batch_size
    val_batches = -(-len(val_idx) // min(len(val_idx), dcfg.batch_size))
    val_encode = -(-len(val_idx) // max(dcfg.batch_size, 32))
    sweep_batches = len(SR.SWEEPS) * -(-len(eval_ds.labels) // ecfg.batch_size)
    n_train = len(train_ds.labels)
    out = {"num_subjects": P14_IDS, "seed": P14_SEED,
           "steps_per_epoch": steps, "val_clips": len(val_idx),
           "val_batches": val_batches, "val_encode_batches": val_encode,
           "encode_batches": sweep_batches, "epochs": dict(P14_EPOCHS),
           "runs": {}, "kernels_vs_plain": {}}
    print(f"phase 14 data: {P14_IDS} identities, {n_train} "
          f"train and {len(eval_ds.labels)} eval clips; {len(tr_idx)} train / "
          f"{len(val_idx)} val clips, {steps} steps of {dcfg.batch_size} x "
          f"expand {dcfg.expand_level} rows, {val_batches} val batches, "
          f"{val_encode} val encode batches; {sweep_batches} encode batches "
          f"over the {len(SR.SWEEPS)} sweeps")
    kept_trip, kept_tail, kept_conv = {}, {}, {}
    launches = {}

    def one(name, full_width):
        epochs = P14_EPOCHS[name]
        experdir = os.path.join(work, name)
        got, counts = {}, {"fit": {}, "encode": {}}
        epoch_s, val_s, validate_s, export_s, lens = [], [], [], [], []

        def counted_fit(fit):
            def call(self, ds, **kw):
                with path_counts(counts["fit"]):
                    got["state"] = fit(self, ds, **kw)
                return got["state"]
            return call

        def counted_score(score):
            def call(*a, **kw):
                with path_counts(counts["encode"]):
                    return score(*a, **kw)
            return call

        def timed_epoch(run_epoch):
            def call(self, state, pipe, sampler, epoch, seed):
                lens.append(len(sampler))
                t0 = time.perf_counter()
                res = run_epoch(self, state, pipe, sampler, epoch, seed)
                epoch_s.append(time.perf_counter() - t0)
                return res
            return call

        def made_once(datasets):
            def call(num_subjects, seed):
                check((num_subjects, seed) == (P14_IDS, P14_SEED),
                      f"phase 14 datasets {num_subjects}, {seed}")
                return data
            return call

        trip_key = lambda x, lab, *a: (name, tuple(x.shape), x.requires_grad)
        tail_key = lambda x, *a: (name, tuple(x.shape), x.dtype,
                                  torch.is_grad_enabled() and x.requires_grad)
        t0 = time.perf_counter()
        with wrapped(TR.Trainer, "fit", counted_fit), \
                wrapped(SR, "score", counted_score), \
                wrapped(SR, "datasets", made_once), \
                wrapped(TR.Trainer, "_epoch", timed_epoch), \
                wrapped(TR.Trainer, "_val_metrics", timed_calls(val_s)), \
                wrapped(TR.Trainer, "_validate", timed_calls(validate_s)), \
                wrapped(MetricsLogger, "export_embeddings",
                        timed_calls(export_s)), \
                wrapped(K, "batch_all_triplet_loss_cuda",
                        keep_first(kept_trip, trip_key)), \
                wrapped(GS, "stage_tail_cuda",
                        keep_first(kept_tail, tail_key)):
            res = SR.run(experdir, num_subjects=P14_IDS, epochs=epochs,
                         seed=P14_SEED, device=dev, full_width=full_width)
        wall = time.perf_counter() - t0
        state = got.pop("state")
        recs = {k: epoch_losses(experdir, k) for k in
                ("train/loss", "train/acc", "val/loss", "val/eer")}
        ran, nval = len(epoch_s), len(val_s)
        with open(os.path.join(experdir, "controller.json")) as f:
            stopped = json.load(f)["early_stopped"]
        check(lens == [steps] * ran, f"phase 14 {name}: sampler lengths "
                                     f"{lens}, expected {steps}")
        check(sorted(recs["train/loss"]) == list(range(1, ran + 1))
              and len(recs["val/loss"]) == nval == len(validate_s)
              and (ran == epochs or (ran < epochs and stopped)),
              f"phase 14 {name}: {ran} epochs of {epochs} (early stop "
              f"{stopped}), {nval} validations, records {recs}")
        check(all(np.isfinite(v) for k in ("train/loss", "val/loss")
                  for v in recs[k].values()), f"phase 14 {name}: losses")
        # launches: the triplet once per train step and validation batch
        # (backward once per step); the stage tail 2 per GaitSet branch
        # forward on the card (train steps, validation batches, the
        # trainer's validation encode; 2 branches each), 4 per step
        # backward; no conv kernel in fp32
        fwd = ran * steps + nval * (val_batches + val_encode)
        want_fit = {"triplet_fwd": ran * steps + nval * val_batches,
                    "triplet_bwd": ran * steps, "tail_fwd": 4 * fwd,
                    "tail_bwd": 4 * ran * steps, "conv3x3": 0,
                    "branch_forwards": 2 * fwd}
        want_enc = {"triplet_fwd": 0, "triplet_bwd": 0,
                    "tail_fwd": 4 * sweep_batches, "tail_bwd": 0,
                    "conv3x3": 0, "branch_forwards": 2 * sweep_batches}
        for path, want in (("fit", want_fit), ("encode", want_enc)):
            have = {k: counts[path][k] for k in want}
            check(have == want, f"phase 14 {name} {path} launches {have}, "
                                f"expected {want}")
        launches[f"{name}_fit"] = counts["fit"]
        launches[f"{name}_encode"] = counts["encode"]
        fit_ms = [1e3 * t / steps for t in epoch_s]
        r = {"result": res, "wall_s": wall, "epochs_run": ran,
             "early_stopped": stopped, "validations": nval,
             "losses": recs, "epoch_s": epoch_s, "fit_ms_per_step": fit_ms,
             "fit_ms_per_step_steady": float(np.mean(fit_ms[1:] or fit_ms)),
             "val_metrics_s": val_s, "validate_s": validate_s,
             "export_embeddings_s": export_s, "launches": counts,
             "limits": sweep_limits(res),
             "sensitivity": sensitivity(res["sweeps"])}
        print(f"phase 14 {name} ({'full width' if full_width else 'tiny'}, "
              f"{epochs} epochs): {ran} epochs run (early stop {stopped}), "
              f"fit {res['train_seconds']} s, encode + score "
              f"{res['encode_eval_seconds']} s, run {wall:.1f} s [{card}]")
        print(f"  train/loss by epoch {recs['train/loss']}")
        print(f"  train/acc by epoch {recs['train/acc']}")
        print(f"  val/loss {recs['val/loss']}, val/eer {recs['val/eer']}")
        val_total = [round(a + b, 3) for a, b in zip(val_s, validate_s)]
        print(f"  fit ms per step (epochs 2-{ran}) "
              f"{r['fit_ms_per_step_steady']:.2f} (epoch 1 "
              f"{fit_ms[0]:.2f}); validation s {val_total} (sprite export "
              f"{[round(e, 3) for e in export_s]})")
        print(f"  launches fit {counts['fit']}, encode {counts['encode']}")
        print(f"  {fmt_sweeps(res['sweeps'])}; sensitivity clause "
              f"{'holds' if r['sensitivity'] else 'does not hold'}")
        return r, state

    # (a) the tiny twin: the JAX artifact's configuration
    tiny, state = one("tiny", False)
    del state
    gc.collect()
    print(f"  the JAX package's CPU artifact ({SYN_ARTIFACT}, its own init "
          f"and dropout streams; beside it, not a check): "
          f"{fmt_sweeps(artifact['sweeps'])}")
    out["runs"]["tiny"] = tiny
    check(all(tiny["limits"].values()), f"phase 14 tiny: {tiny['limits']}")
    check(tiny["sensitivity"], "phase 14 tiny: no single-modality sweep "
                               "below the full one")
    torch.cuda.empty_cache()

    # (b) the flagship at full width, then its weights re-encoded in bf16
    full, state = one("full", True)
    out["runs"]["full"] = full
    check(all(full["limits"].values()), f"phase 14 full: {full['limits']}")
    mcfg = SR.recipe(P14_IDS, P14_EPOCHS["full"], True)[0]
    bf = UGaitNet(dataclasses.replace(mcfg, compute_dtype="bfloat16"),
                  device=dev)
    bf.load_state_dict(state.model.state_dict())
    del state
    gc.collect()
    conv_key = lambda x, w: (tuple(x.shape), tuple(w.shape))
    bf_counts = {}
    t0 = time.perf_counter()
    with path_counts(bf_counts), \
            wrapped(GS, "conv3x3_cuda", keep_first(kept_conv, conv_key)), \
            wrapped(GS, "stage_tail_cuda", keep_first(kept_tail, lambda x, *a:
                                                      ("bf16", tuple(x.shape),
                                                       x.dtype, False))):
        bf_sweeps, _ = SR.score(bf, eval_ds, ecfg, dev)
    bf_s = time.perf_counter() - t0
    del bf
    launches["bf16_encode"] = bf_counts
    # 4 conv launches per two-branch forward (a_conv2 and a_conv6 of each),
    # each at the variant plan chooses for its shape
    c1, _, c3 = mcfg.branches[0].gaitset_channels
    n = ecfg.batch_size * 25
    plans = {"a_conv2": CV.plan(n, c1, c1, 64, 64).variant,
             "a_conv6": CV.plan(n, c3, c3, 16, 16).variant}
    want_var = {k: 0 for k in CV.variant_launches}
    for v in plans.values():
        want_var[v] += 2 * sweep_batches
    want_bf = {"triplet_fwd": 0, "triplet_bwd": 0,
               "tail_fwd": 4 * sweep_batches, "tail_bwd": 0,
               "conv3x3": 4 * sweep_batches, "conv_variants": want_var,
               "branch_forwards": 2 * sweep_batches}
    have = {k: bf_counts[k] for k in want_bf}
    check(have == want_bf, f"phase 14 bf16 encode launches {have}, "
                           f"expected {want_bf}")
    bf_res = dict(full["result"], sweeps=bf_sweeps,
                  rank1_subseq=bf_sweeps["full"]["rank1_subseq"],
                  rank1_video=bf_sweeps["full"]["rank1_video"],
                  eer=bf_sweeps["full"]["eer"], encode_eval_seconds=bf_s)
    diff = {s: {k: bf_sweeps[s][k] - full["result"]["sweeps"][s][k]
                for k in ("rank1_subseq", "rank1_video", "eer")}
            for s in bf_sweeps}
    out["bf16"] = {"result": bf_res, "conv_variant_by_layer": plans,
                   "launches": bf_counts, "minus_fp32": diff,
                   "limits": sweep_limits(bf_res),
                   "sensitivity": sensitivity(bf_sweeps), "seconds": bf_s}
    print(f"phase 14 bf16 re-encode of the full-width weights (no autograd):"
          f" {fmt_sweeps(bf_sweeps)}; {bf_s:.1f} s; launches {bf_counts}; "
          f"conv variants by layer {plans} [{card}]")
    print("  bf16 - fp32: " + "; ".join(
        f"{s} Rank-1 {d['rank1_subseq']:+.4f} / video "
        f"{d['rank1_video']:+.4f}, EER {d['eer']:+.4f}"
        for s, d in diff.items()))
    print(f"  full width sensitivity clause (printed, not held): fp32 "
          f"{'holds' if full['sensitivity'] else 'does not hold'}, bf16 "
          f"{'holds' if out['bf16']['sensitivity'] else 'does not hold'}")
    check(all(out["bf16"]["limits"].values()),
          f"phase 14 bf16: {out['bf16']['limits']}")
    out["launches"] = launches

    # the kernels against their plain versions on the path's own inputs
    # (these launches are not counted)
    kvp = out["kernels_vs_plain"]
    for (run, shape, train), (x, lab, *_) in sorted(kept_trip.items(),
                                                    key=str):
        kvp[f"triplet {run} {'train' if train else 'val'} {shape}"] = \
            triplet_vs_plain(x, lab)
    for (run, shape, dtype, grad), (x, b, alpha) in sorted(kept_tail.items(),
                                                           key=str):
        kvp[f"stage tail {run} {shape} {str(dtype)[6:]}"
            f"{' with backward' if grad else ''}"] = tail_vs_plain(
            x, b, alpha, grad)
    for shape, (x, w) in sorted(kept_conv.items()):
        kvp[f"conv {shape[0]} -> {shape[1][0]}"] = conv_vs_plain(x, w)
    # each run's train step (triplet, stage tail with its backward) and
    # the bf16 encode's two conv shapes
    check(len(kept_conv) == 2 and all(
        any(k[0] == run and k[2] for k in kept_trip)
        and sum(k[0] == run and k[3] for k in kept_tail) == 2
        for run in ("tiny", "full")), f"phase 14 kernel inputs: {list(kvp)}")
    kept_trip.clear(), kept_tail.clear(), kept_conv.clear()
    for k, v in kvp.items():
        print(f"  kernel vs plain, {k}: " + ", ".join(
            f"{f} {v[f]:.3g}" if isinstance(v[f], float) else f"{f} {v[f]}"
            for f in v if f in ("grad_rel", "max_abs_err", "of_limit",
                                "bitwise", "median_margin", "vs_float64")))
    for name, r in out["runs"].items():
        with open(os.path.join(res_dir, f"{name}.json"), "w") as f:
            json.dump(r, f, indent=1, default=str)
    with open(os.path.join(res_dir, "bf16.json"), "w") as f:
        json.dump(out["bf16"], f, indent=1, default=str)
    torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"phase 14: {out['phase_s']:.1f} s; results in {P14_RESULTS}/ "
          f"[{card}]")
    return out


def _demangle(names):
    """``name<template args>`` of each mangled kernel symbol, by the
    toolkit's ``cu++filt`` (beside nvcc), without its namespace, return
    type and parameter list."""
    from ugaitnet_tpu_torch.ops.cuda.build import nvcc_path
    if not names:
        return names
    filt = os.path.join(os.path.dirname(nvcc_path()), "cu++filt")
    out = subprocess.run([filt, *names], capture_output=True, text=True,
                         check=True).stdout.splitlines()
    check(len(out) == len(names), f"cu++filt gave {out} for {names}")
    short = []
    for d in out:
        d = re.sub(r"^void |<unnamed>::|\(anonymous namespace\)::|"
                   r"\((?:unsigned )?(?:int|long|bool)\)", "", d.strip())
        depth = 0
        for i, ch in enumerate(d):     # the parameter list starts at the
            depth += {"<": 1, ">": -1}.get(ch, 0)   # first "(" outside <>
            if ch == "(" and depth == 0:
                d = d[:i]
                break
        short.append(d)
    return short


def ptxas_report(build_dir, sources):
    """The -Xptxas -v report of each source's build (``<name>.log``) as a
    table: registers, static shared memory and spill bytes per kernel
    instantiation (the dynamic shared memory is plan()'s, printed with each
    launch), and ptxas's performance warnings (wgmma serialisation) as
    they are.  Fails the run if an instantiation spills; returns the
    rows."""
    rows, warnings = [], []
    for name in sources:
        with open(os.path.join(build_dir, f"{name}.log")) as f:
            for ln in f:
                m = re.search(r"Compiling entry function '([^']+)'", ln)
                if m:
                    rows.append({"kernel": m.group(1),
                                 "registers": None, "smem": 0, "spill": None})
                    continue
                m = re.search(r"Used (\d+) registers", ln)
                if m and rows:
                    rows[-1]["registers"] = int(m.group(1))
                    s = re.search(r"(\d+) bytes smem", ln)
                    rows[-1]["smem"] = int(s.group(1)) if s else 0
                m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                              r"loads", ln)
                if m and rows:
                    rows[-1]["spill"] = int(m.group(1)) + int(m.group(2))
                if "Performance" in ln:
                    warnings.append(ln.strip())
    for r, name in zip(rows, _demangle([r["kernel"] for r in rows])):
        r["kernel"] = name
    print("ptxas per instantiation (registers, static shared memory bytes, "
          "spill bytes):")
    for r in rows:
        print(f"  {r['kernel']:40s} {r['registers']:4d} regs "
              f"{r['smem']:7d} B smem  spill {r['spill']}")
    for w in warnings:
        print(f"  ptxas: {w}")
    check(rows and all(r["spill"] == 0 for r in rows),
          "a kernel spills registers")
    return rows


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device")
    t_start = time.perf_counter()
    from ugaitnet_tpu_torch.core.config import DataConfig, TrainConfig
    from ugaitnet_tpu_torch.data.pipeline import preprocess_batch
    from ugaitnet_tpu_torch.models.network import UGaitNet
    from ugaitnet_tpu_torch.ops.cuda import build
    from ugaitnet_tpu_torch.ops.cuda import conv3x3 as CV
    from ugaitnet_tpu_torch.ops.cuda import stage_tail as ST
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
    # one nvcc per source, all started together, then load them
    from concurrent.futures import ThreadPoolExecutor
    sources = ("triplet_kernel", "stage_tail", "conv3x3", "probes",
               "conv3d_wgrad")
    with ThreadPoolExecutor(len(sources)) as pool:
        list(pool.map(build.build, sources))
    for name in sources:
        build.load(name)
    print(f"kernel build ({', '.join(sources)}, in parallel): "
          f"{time.perf_counter() - t0:.1f} s")
    # the host gather's library, built here so no timed phase pays for it
    from ugaitnet_tpu_torch.data import native
    t0 = time.perf_counter()
    check(native.get_lib() is not None,
          "the native gather did not build (host C++ compiler)")
    print(f"native gather build: {time.perf_counter() - t0:.1f} s "
          f"({native.LIB_PATH})")
    ptxas_report(build.BUILD_DIR, sources)

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
             ("val batch 2 (wrapped)", 62, 40, 256, val2),
             # the 2D / 3D CNN nets' (B, ndense) signature (phase 9); last,
             # so the cases above keep their draws from the generator
             ("conv branch", None, 120, 512, pk((8, 15))),
             # a TP (1, 2) rank's strip of parts (phase 13), after those
             ("tp strip", 31, 120, 256, pk((12, 10)))]
    results, times = {}, {}
    dist_err = {}
    for name, parts, b, d, labels in cases:
        x, lab, vp, vk, gk, gp = case(parts, b, d, labels)
        rel = abs(vk - vp) / abs(vp)
        gerr = rel_err(gk, gp)
        kdist, dist_err[name] = exact_checks(x, lab)
        # the value against the plain reduction over the kernel's own dist
        # (as phase 7 holds validation's): a triplet whose hinge lies within
        # rounding of 0 may count in one dist and not in the other, which
        # moves the plain value by ~1e-5 on some draws; the dist itself is
        # held to the plain one just below
        v_own = value_over_dist(kdist, lab, 0.2)
        own_rel = abs(vk - v_own) / abs(v_own) if v_own else abs(vk)
        print(f"kernel vs plain {name} {tuple(x.shape)}: value {vk:.7f}, "
              f"plain over the kernel's dist {v_own:.7f} (rel {own_rel:.2e},"
              f" tol {VAL_RTOL}), plain {vp:.7f} (rel {rel:.2e}); grad max "
              f"abs err {float((gk - gp).abs().max()):.2e}, max |grad| "
              f"{float(gp.abs().max()):.2e}; dist symmetric, zero diagonal, "
              f"counts and g exact; dist vs plain {dist_err[name]:.2e} "
              f"(limit {DIST_REL})")
        check(dist_err[name] <= DIST_REL, f"{name}: dist vs plain")
        results[name] = (vp, own_rel, gerr, fault_readings(x, lab, gp))
        if name == "flagship":
            fwd_err = abs(vk - vp)
            bwd_err = float((gk - gp).abs().max())
        if name in ("flagship", "B256", "B512", "tp strip"):
            times[name] = kernel_times(x, lab)
    print(f"gradient max |kernel - plain| / max |plain| (limit {GRAD_REL}), "
          "and what planted faults read:")
    for name, (vp, own_rel, gerr, faults) in results.items():
        check(vp > 0 and own_rel <= VAL_RTOL, f"{name}: value")
        check_faults(name, gerr, faults)
    for name, labels in (("all-same", np.zeros(6)), ("all-distinct",
                                                     np.arange(6))):
        x, lab, vp, vk, gk, _ = case(2, 6, 8, labels)
        print(f"kernel {name}: value {vk} (plain {vp}), grad max "
              f"{float(gk.abs().max())}")
        check(vk == 0.0 and vp == 0.0 and float(gk.abs().max()) == 0.0, name)
    flag_t = times["flagship"]

    # ---- 1b. the stage tail kernels vs plain -------------------------------
    tail_res = tail_phase(card)

    # ---- 1c. the conv kernel vs plain; 1d. the probes ----------------------
    conv_res = conv_phase(card)
    probe_res = probe_phase(card)

    # ---- 1e. the 3D CNN's first-conv weight gradient vs float64 -----------
    wgrad_res = wgrad_phase(card)

    # ---- full-width flagship ----------------------------------------------
    dcfg = DataConfig()
    mods = (("of", "gray"), (2, 1), (100.0, 1.0), 2)

    # ---- 2. embed ------------------------------------------------------------
    raw = raw_batch(128, 1, seed=1)
    embed, embed_conv = {}, {}
    iters = 10
    for dtype in ("float32", "bfloat16"):
        model = UGaitNet(flagship_cfg(dtype=dtype), seed=0)
        model.eval()

        def embed_once(i, out="signature"):
            r = dict(raw)
            r["raw_of"] = raw["raw_of"] ^ i
            r["raw_gray"] = raw["raw_gray"] ^ i
            vols, flags, _ = preprocess_batch(r, *mods, 1, False, dcfg)
            res = model(vols, flags)
            return res[out] if out else res

        def embed_ms():
            with torch.inference_mode():
                acc = torch.zeros((), device=dev)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for i in range(1, iters + 1):
                    acc += embed_once(i).sum()
                torch.cuda.synchronize()
                ms = (time.perf_counter() - t0) * 1e3 / iters
            check(bool(torch.isfinite(acc)), "embed checksum")
            return ms

        CV.reset_launch_counts()
        with torch.inference_mode():
            sig = embed_once(0)
            check(tuple(sig.shape) == (128, 62, 256), f"signature {sig.shape}")
            check(bool(torch.isfinite(sig).all()), "signature not finite")
        ms = embed_ms()
        # a_conv2 and a_conv6 of both branches, in bf16 only
        embed_conv[dtype] = CV.launches
        want_conv = 4 * (iters + 1) if dtype == "bfloat16" else 0
        check(CV.launches == want_conv, f"embed {dtype}: {CV.launches} "
              f"conv3x3 launches over {iters + 1} forwards, not {want_conv}")
        # the flagship's shapes take the Hopper variant
        check(CV.variant_launches["hopper"] == want_conv,
              f"embed {dtype}: conv3x3 variants {CV.variant_launches}")
        embed[dtype] = ms
        print(f"embed {dtype}: preprocess + forward B=128 {ms:.2f} ms/batch,"
              f" {128e3 / ms:.1f} clips/s; conv3x3 launches "
              f"{CV.launches} over {iters + 1} forwards "
              f"({CV.variant_launches}) [{card}]")
        if dtype == "bfloat16":
            route = route_readings(lambda: embed_once(0, None))
            ab = {"kernel": [], "cudnn": []}
            for which in ("kernel", "cudnn", "cudnn", "kernel"):
                with (cudnn_conv() if which == "cudnn"
                      else contextlib.nullcontext()):
                    ab[which].append(embed_ms())
            route["ab_ms"] = ab
            embed_route = route
            print(f"embed bfloat16 in turns (kernel, F.conv2d, F.conv2d, "
                  f"kernel): conv kernel {ab['kernel']} ms/batch, F.conv2d "
                  f"{ab['cudnn']} ms/batch [{card}]")
        del model

    # ---- 3. train: the main path -------------------------------------------
    mcfg, tcfg = flagship_cfg(), TrainConfig()
    check(tcfg.triplet_kind == "batch_all", "default triplet kind")
    model = UGaitNet(mcfg, seed=0)
    state = init_state(model, tcfg)
    step = make_train_step(mcfg, tcfg)
    raw = raw_batch(40, 8, seed=2)
    mask_gen = torch.Generator().manual_seed(0)
    warmup, nsteps = 2, 7
    step_ms, losses = [], []

    kstore = {}
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    ST.reset_launch_counts()
    CV.reset_launch_counts()
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
                      copy.deepcopy(state.optimizer.state_dict()),
                      state.step)
            hook = capture(state.model, kstore)
        state, metrics = step(state, batch)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append({k: float(v) for k, v in metrics.items()})
    hook.remove()
    launches = {"triplet_fwd": K.fwd_launches, "triplet_bwd": K.bwd_launches,
                "tail_fwd": ST.fwd_launches, "tail_bwd": ST.bwd_launches,
                "conv3x3": CV.launches}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    check(tuple(vols[0].shape) == (120, 25, 60, 60, 2), "train batch")
    for m in losses:
        check(all(np.isfinite(v) for v in m.values()), f"train metrics {m}")
    # 2 branches x stages 1-2: 4 stage-tail launches each way per step
    check(launches == {"triplet_fwd": nsteps, "triplet_bwd": nsteps,
                       "tail_fwd": 4 * nsteps, "tail_bwd": 4 * nsteps,
                       "conv3x3": 0},
          f"kernel launches {launches} over {nsteps} steps")
    train_ms = float(np.median(step_ms[warmup:]))
    print(f"train: {nsteps} steps B=120, losses "
          f"{[round(m['loss'], 6) for m in losses]}, launches {launches}, "
          f"step {train_ms:.2f} ms (median of steps {warmup + 1}-{nsteps}; "
          f"warm-up {[round(t, 1) for t in step_ms[:warmup]]} ms), peak "
          f"{peak_gb:.1f} GB [{card}]")

    sig_err, sig_faults = kernel_vs_plain_step(
        "train", mcfg, tcfg, before, batch, kstore, losses[-1])
    tail_step = tail_vs_plain_step(mcfg, tcfg, before, batch)

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

    bf_cfg = flagship_cfg(dtype="bfloat16")
    bf_state = init_state(UGaitNet(bf_cfg, seed=0), tcfg)
    bf_step = make_train_step(bf_cfg, tcfg)
    bf_ms = []
    CV.reset_launch_counts()
    for i in range(nsteps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, m = bf_step(bf_state, batch)
        torch.cuda.synchronize()
        bf_ms.append((time.perf_counter() - t0) * 1e3)
        check(np.isfinite(float(m["loss"])), "bf16 train loss")
    bf_train_ms = float(np.median(bf_ms[warmup:]))
    bf_conv = CV.launches
    print(f"train bfloat16: step {bf_train_ms:.2f} ms (median of steps "
          f"{warmup + 1}-{nsteps}, same batch, preprocess excluded); conv3x3"
          f" launches {bf_conv} [{card}]")
    check(bf_conv == 0, f"the bf16 train step launched conv3x3 {bf_conv}x")
    del bf_state
    tail_ab = tail_ab_steps({"float32": mcfg, "bfloat16": bf_cfg}, tcfg,
                            batch, card)

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
    fwd = forward_vs_cpu(model, mods, dcfg)

    # ---- 5. eval and 6. serve (no kernel of this repo on these paths) ----
    del state, model, before
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    gallery_ds, probe_ds = casia_sets()
    print(f"synthetic CASIA-B-shaped sets: 2 x {len(gallery_ds)} clips in "
          f"{time.perf_counter() - t0:.1f} s")
    K.reset_launch_counts()
    eval_model = UGaitNet(flagship_cfg(), seed=0)
    encode_tail = {}
    with tail_counts(encode_tail):
        eval_res = eval_phase(eval_model, gallery_ds, probe_ds, card)
    print(f"stage-tail launches in phase 5 (encode): {encode_tail}")
    check(encode_tail["branch_forwards"] > 0 and encode_tail["tail_bwd"] == 0
          and encode_tail["tail_fwd"] == 2 * encode_tail["branch_forwards"],
          f"phase 5 stage-tail launches {encode_tail}")
    eval_res["tail_launches"] = encode_tail
    del eval_model
    serve_res = serve_phase(lambda dt: UGaitNet(flagship_cfg(dtype=dt),
                                                seed=0),
                            gallery_ds, probe_ds, card)
    print(f"triplet kernel launches during eval and serve: "
          f"{K.fwd_launches}, {K.bwd_launches} (not on these paths)")
    serve_tail = serve_res["tail_launches_identify_raw"]

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

        trainer_res = trainer_phase(card, os.path.join(sets, "train"),
                                    gallery_dir, probe_dir,
                                    isolated_step_ms, train_ms)
        gc.collect()
        torch.cuda.empty_cache()

        # ---- 8. int8 gallery, int8 encode and export -------------------------
        int8_res = int8_phase(card, sets, gallery_dir, probe_dir,
                              trainer_res["experdir"], serve_res)
        gc.collect()
        torch.cuda.empty_cache()

        # ---- 9. the 2D and 3D CNN branch families at full width ----------
        K.reset_launch_counts()
        branch_res = branch_phase(card)
        conv_launches = {"triplet_fwd": K.fwd_launches,
                         "triplet_bwd": K.bwd_launches}
        check(conv_launches == {"triplet_fwd": 2 * BRANCH_STEPS,
                                "triplet_bwd": 2 * BRANCH_STEPS},
              f"triplet launches in phase 9's steps: {conv_launches}")
        gc.collect()
        torch.cuda.empty_cache()

        # ---- 10. the rest of the model and loss surface -------------------
        surface_res = surface_phase(card, flag_t["fwd_call_ms"]
                                    + flag_t["bwd_call_ms"])
        surface_launches = surface_res["launches"]
        gc.collect()
        torch.cuda.empty_cache()

        # ---- 11. joint training, warm starts, the sweep (last, so the
        # draws of phases 1-10 do not move) ----------------------------
        t0 = time.perf_counter()
        joint_res = joint_phase(
            card, os.path.join(sets, "joint"),
            os.path.join(sets, "train", "casia_train"), gallery_dir,
            probe_dir, trainer_res["fit_ms_per_step_steady"])
        joint_res["phase_s"] = time.perf_counter() - t0
        joint_launches = joint_res["launches"]
        print(f"phase 11: {joint_res['phase_s']:.1f} s; triplet launches in "
              f"the joint run {joint_launches} [{card}]")
        gc.collect()
        torch.cuda.empty_cache()

        # ---- 12. multi-device training over torch.distributed (ranks in
        # processes of their own; this one holds no model while they run)
        parallel_res = parallel_phase(card, os.path.join(sets, "parallel"))
        parallel_launches = parallel_res["launches"]
        gc.collect()
        torch.cuda.empty_cache()

        # ---- 13. tensor and pipeline parallelism, mesh serving, evaluate
        # --dp, trace profiling (last; reuses phase 12's batch)
        with open(os.path.join(sets, "train", "results.json")) as f:
            one_eval = json.load(f)[os.path.basename(probe_dir)]
        tp_res = tp_pp_phase(card, os.path.join(sets, "parallel"),
                             trainer_res["experdir"], gallery_dir, probe_dir,
                             one_eval)
        tp_launches = tp_res["launches"]
        gc.collect()
        torch.cuda.empty_cache()

        # ---- 14. convergence to Rank-1: the tiny twin and the flagship
        # trained on synthetic identities, scored through the open-world
        # protocol (last, with its own seeds)
        p14 = convergence_phase(card, os.path.join(sets, "convergence"))
        p14_launches = p14["launches"]
    finally:
        shutil.rmtree(sets, ignore_errors=True)

    # launches: the trainer's fit (this slice's main path); by path, phase
    # 3's train steps too
    fit_launches = trainer_res["launches_fit"]
    kernels = [
        {"name": "triplet_fwd", "route": "cuda", "source": SRC,
         "replaces": f"{PALLAS}:159", "launches": fit_launches["triplet_fwd"],
         "launches_by_path": {"train_step": launches["triplet_fwd"],
                              "fit": fit_launches["triplet_fwd"],
                              "conv_branch_steps":
                                  conv_launches["triplet_fwd"],
                              "surface_steps":
                                  surface_launches["triplet_fwd"],
                              "joint_fit": joint_launches["triplet_fwd"],
                              "parallel_rank_step":
                                  parallel_launches["triplet_fwd"],
                              "tp_rank_step":
                                  tp_launches["tp_rank_step"][0],
                              "pp_step": tp_launches["pp_step"][0],
                              "convergence_phase": {
                                  p: p14_launches[p]["triplet_fwd"]
                                  for p in P14_FITS}},
         "max_abs_err": fwd_err, "ms": flag_t["fwd_ms"],
         "plain_ms": flag_t["plain_fwd_ms"],
         "bound_ms": flag_t["fwd_bound"][0],
         "bound_by": flag_t["fwd_bound"][1],
         "library_ms": None},
        {"name": "triplet_bwd", "route": "cuda", "source": SRC,
         "replaces": f"{PALLAS}:187", "launches": fit_launches["triplet_bwd"],
         "launches_by_path": {"train_step": launches["triplet_bwd"],
                              "fit": fit_launches["triplet_bwd"],
                              "conv_branch_steps":
                                  conv_launches["triplet_bwd"],
                              "surface_steps":
                                  surface_launches["triplet_bwd"],
                              "joint_fit": joint_launches["triplet_bwd"],
                              "parallel_rank_step":
                                  parallel_launches["triplet_bwd"],
                              "tp_rank_step":
                                  tp_launches["tp_rank_step"][1],
                              "pp_step": tp_launches["pp_step"][1],
                              "convergence_phase": {
                                  p: p14_launches[p]["triplet_bwd"]
                                  for p in P14_FITS}},
         "max_abs_err": bwd_err, "ms": flag_t["bwd_ms"],
         "plain_ms": flag_t["plain_bwd_ms"],
         "bound_ms": flag_t["bwd_bound"][0],
         "bound_by": flag_t["bwd_bound"][1],
         "library_ms": None},
    ]
    # the stage tail: times at the flagship's stage 1 in float32 (every
    # shape and dtype under "by_shape"); launches of the fit, by path phase
    # 3's steps, phase 5's encode, phase 6's identify_raw (one per bucket)
    # and phase 8's fp32 artifact (one bucket-128 encode, a fresh process)
    fit_tail = trainer_res["tail_launches_fit"]
    art_tail = int8_res["export_tail_launches"]["fp32"]
    s1 = tail_res["times"]["stage 1 float32"]
    for d in ("fwd", "bwd"):
        kernels.append({
            "name": f"tail_{d}", "route": "cuda", "source": TAIL_SRC,
            "replaces": TAIL_PALLAS, "launches": fit_tail[f"tail_{d}"],
            "launches_by_path": {
                "train_step": launches[f"tail_{d}"],
                "fit": fit_tail[f"tail_{d}"],
                "encode": encode_tail[f"tail_{d}"],
                "identify_raw": serve_tail[f"tail_{d}"],
                "artifact_encode": art_tail[0 if d == "fwd" else 1],
                "convergence_phase": {p: v[f"tail_{d}"]
                                      for p, v in p14_launches.items()}},
            "max_abs_err": tail_res["max_abs_err"][f"tail_{d}"],
            "ms": s1[f"{d}_ms"], "plain_ms": s1[f"plain_{d}_ms"],
            "bound_ms": s1[f"{d}_bound"][0], "bound_by": s1[f"{d}_bound"][1],
            "library_ms": None,
            "by_shape": {k: {"ms": v[f"{d}_ms"],
                             "plain_ms": v[f"plain_{d}_ms"],
                             "bound_ms": v[f"{d}_bound"][0]}
                         for k, v in tail_res["times"].items()}})
    # the conv kernel: times at a_conv6 (the _p1_kernel shape; a_conv2's,
    # the _p2_kernel shape, under "by_shape"); launches of phase 2's bf16
    # embed (the main path of this slice), by path the train steps and the
    # bf16 service's identify_raw (one per bucket)
    c6 = conv_res["times"]["a_conv6"]
    kernels.append({
        "name": "conv3x3_fwd", "route": "cuda", "source": CONV_SRC,
        "replaces": CONV_PALLAS, "also_replaces": CONV_PALLAS_P2,
        "launches": embed_conv["bfloat16"],
        "launches_by_path": {
            "embed_bf16": embed_conv["bfloat16"],
            "embed_fp32": embed_conv["float32"],
            "embed_forwards": iters + 1,
            "train_step": launches["conv3x3"],
            "train_step_bf16": bf_conv,
            "identify_raw_bf16": serve_res["bf16_conv_route"]["launches"],
            "identify_raw_calls": serve_res["bf16_conv_route"]["calls"],
            "convergence_phase": {p: v["conv3x3"]
                                  for p, v in p14_launches.items()}},
        "max_abs_err": conv_res["max_abs_err"], "ms": c6["ms"],
        "plain_ms": c6["plain_ms"], "bound_ms": c6["bound_ms"],
        "bound_by": c6["bound_by"], "library_ms": c6["library_ms"],
        "share_of_bound": c6["share_of_bound"],
        "factor_to_library": c6["factor_to_library"],
        "variant": c6["variant"],
        "variant_launches": conv_res["variant_launches"],
        "earlier_ms": c6["earlier_ms"],
        "by_shape": conv_res["times"]})
    mm = probe_res["mm"][1152]
    kernels.append({
        "name": "mm_fwd", "route": "cuda", "source": PROBES_SRC,
        "replaces": MM_PALLAS,
        "launches": probe_res["launches"]["mm_fwd"],
        "launches_by_path": {"probe_phase": probe_res["launches"]["mm_fwd"]},
        "max_abs_err": mm["max_abs_err"], "ms": mm["ms"],
        "plain_ms": mm["plain_ms"], "bound_ms": mm["bound_ms"],
        "bound_by": mm["bound_by"], "library_ms": mm["library_ms"],
        "share_of_bound": mm["share_of_bound"],
        "factor_to_library": mm["factor_to_library"],
        "variant": mm["variant"],
        "by_shape": {f"K={k}": {f: v[f] for f in (
            "ms", "plain_ms", "bound_ms", "library_ms", "share_of_bound",
            "factor_to_library")}
            for k, v in probe_res["mm"].items()}})
    cp = probe_res["copy"]
    kernels.append({
        "name": "scale2", "route": "cuda", "source": PROBES_SRC,
        "replaces": COPY_PALLAS,
        "launches": probe_res["launches"]["scale2"],
        "launches_by_path": {"probe_phase": probe_res["launches"]["scale2"]},
        "max_abs_err": cp["max_abs_err"], "ms": cp["ms"],
        "plain_ms": cp["plain_ms"], "bound_ms": cp["bound_ms"],
        "bound_by": cp["bound_by"], "library_ms": cp["library_ms"],
        "share_of_bound": cp["share_of_bound"],
        "factor_to_library": cp["factor_to_library"],
        "variant": cp["variant"],
        "variant_launches": probe_res["scale2_variant_launches"],
        "scalar_ms": cp["scalar_ms"],
        "with_transpose_ms": cp["with_transpose_ms"]})
    # the 3D CNN's first-conv weight gradient: times of the two first convs
    # together (each under "by_shape"); launches of phase 9's 3D CNN steps
    wg3 = branch_res["conv3d"]["wgrad_launches"]
    kernels.append({
        "name": "conv3d_wgrad", "route": "cuda", "source": WGRAD_SRC,
        "replaces": None, "launches": wg3,
        "launches_by_path": {"branch_phase_3d_steps": wg3,
                             "wgrad_phase": wgrad_res["launches"]},
        "max_abs_err": wgrad_res["max_abs_err"], "ms": wgrad_res["ms"],
        "plain_ms": wgrad_res["plain_ms"],
        "bound_ms": wgrad_res["bound_ms"],
        "bound_by": wgrad_res["bound_by"],
        "library_ms": wgrad_res["library_ms"],
        "share_of_bound": wgrad_res["share_of_bound"],
        "factor_to_library": wgrad_res["factor_to_library"],
        "by_shape": {k: {f: v[f] for f in (
            "ms", "plain_ms", "bound_ms", "library_ms", "share_of_bound",
            "factor_to_library", "max_rel_err")}
            for k, v in wgrad_res["by_shape"].items()}})
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
                      "card_vs_cpu": {"tf32_off": fwd[False],
                                      "tf32_on": fwd[True]},
                      "eval": eval_res, "serve": serve_res,
                      "trainer": trainer_res, "int8": int8_res,
                      "branches": branch_res, "surface": surface_res,
                      "joint": joint_res, "parallel": parallel_res,
                      "tp_pp": tp_res, "convergence": p14,
                      "stage_tail": tail_res,
                      "conv3x3": conv_res, "probes": probe_res,
                      "conv3d_wgrad": wgrad_res,
                      "embed_bf16_route": embed_route,
                      "train_tail_step": tail_step,
                      "train_tail_ab": tail_ab}))
    print(f"wall time {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
