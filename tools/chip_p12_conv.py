"""Locate phase 12's forced-pick residual in ``branch_of.b_conv3``.

``chip_smoke.py`` phase 12 holds the data-parallel gradient (the global
form, two gloo ranks of 60 rows sharing the card) to the one-process step
forced to the ranks' ``sign_max`` picks within P12_FED_REL, and reads its
largest gap at ``branches.branch_of.b_conv3.weight``.  This script makes
phase 12's batch (phase 3's first augmented batch, B = 120) and seed-0
flagship, runs both steps with hooks on that layer (its input, output and
output gradient, and each rank's weight gradient before the ranks'
average), and then, on the one process's own tensors, runs the layer's
forward and weight gradient at one 120-row batch and at two 60-row halves
(the data-parallel sum), each against a float64 weight gradient, with
``torch.backends.cudnn.deterministic`` on (phase 12's setting) and off;
and the averaged gradient against the layer's weight gradient rebuilt
from the ranks' own tensors.  On the way back to the layer it compares
the ranks' cotangents with the one process's at the signature, the
branch's parts and ``b_conv4``'s output, and counts the places where a
rounding difference can move a gradient by a whole element: leaky ReLU
inputs of another sign, pyramid strips whose max moved, triplets whose
hinge changed side.  The positive control (``control``) runs the forced
one-process step again as the ranks split it and reads its gap to the
ranks' gradient: with every branch on the two 60-row halves of the batch
(the row count the ranks' convs see; autograd sums the halves'
gradients), with the signature's batch-axis sum of squares summed over
the halves (as the ranks' all-reduce sums theirs), and with both.

    python3 tools/chip_p12_conv.py [--device cpu --tiny] [--out FILE]

``--device cpu --tiny`` rehearses it on the CPU at a tiny flagship (channels
(4, 4, 8), part_dim 8, raw B = 8).  Prints the readings, each as max |a -
b| over max |one process's gradient| (every leaf, as phase 12 reads it) or
over the named tensor's max, and writes them as JSON to ``--out``
(default ``build/p12_conv.json``, under the repo).
"""

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

import chip_smoke as C  # noqa: E402

LAYER = "branches.branch_of.b_conv3"
# the cotangents read on the way back to LAYER, last first
UPSTREAM = {"g_parts": "branches.branch_of",
            "g_b_conv4": "branches.branch_of.b_conv4"}


def _cfg(tiny):
    cfg = C.flagship_cfg()
    if tiny:
        cfg = dataclasses.replace(cfg, branches=tuple(
            dataclasses.replace(b, gaitset_channels=(4, 4, 8), part_dim=8)
            for b in cfg.branches))
    return cfg


def _probe(mcfg, dev):
    """A seed-0 state whose steps leave the gradient in .grad (SGD, lr 0),
    as chip_smoke.py's _p12_probe, on ``dev``."""
    from ugaitnet_tpu_torch.core.config import TrainConfig
    from ugaitnet_tpu_torch.models.network import UGaitNet
    from ugaitnet_tpu_torch.train.train_step import init_state
    return init_state(UGaitNet(mcfg, device=dev, seed=0),
                      TrainConfig(optimizer="sgd", lr=0.0))


def _record(model, rec):
    """Hooks on LAYER (its input ``x``, output ``y`` and output gradient
    ``gy``), on ``b_conv4``'s output ``y4`` and, upstream of LAYER, on the
    cotangents of ``b_conv4``'s output, the branch's parts and the net's
    signature (the ``g_*`` entries); and, through ``models.gaitset._hpp``,
    the two maps the branch's pyramid pools (``fmap_sa``, ``fmap_sb``).
    Returns an undo function."""
    from ugaitnet_tpu_torch.models import gaitset as G
    conv = model.get_submodule(LAYER)
    hpp, maps = G._hpp, []

    def recording_hpp(fmap, num_bin):
        if len(maps) < 2:          # branch_of's first bin: sa, then sb
            maps.append(fmap.detach().clone())
            rec[("fmap_sa", "fmap_sb")[len(maps) - 1]] = maps[-1]
        return hpp(fmap, num_bin)
    G._hpp = recording_hpp

    def fwd(mod, args, out):
        rec["x"], rec["y"] = args[0].detach().clone(), out.detach().clone()

    def fwd4(mod, args, out):
        rec["y4"] = out.detach().clone()

    def cotangent(name):
        def bwd(mod, grad_in, grad_out):
            rec[name] = grad_out[0].detach().clone()
        return bwd

    def signature(mod, args, out):
        rec["sig"] = out["signature"].detach().clone()
        out["signature"].register_hook(
            lambda g: rec.__setitem__("g_signature", g.detach().clone()))
    hooks = [conv.register_forward_hook(fwd),
             conv.register_full_backward_hook(cotangent("gy")),
             model.get_submodule(UPSTREAM["g_b_conv4"]).register_forward_hook(
                 fwd4)] + [
        model.get_submodule(m).register_full_backward_hook(cotangent(n))
        for n, m in UPSTREAM.items()] + [
        model.register_forward_hook(signature)]

    def undo():
        G._hpp = hpp
        for h in hooks:
            h.remove()
    return undo


def _split_branches(model, parts):
    """Each branch of ``model`` run on ``parts`` equal row blocks of its
    batch, its outputs joined: the row count a data-parallel rank's convs
    and projections see, in one process (the GaitSet branch has no
    dropout and couples no rows).  Returns an undo function."""
    branches = list(model.branches.values())
    for br in branches:
        def split(x, *args, fwd=br.forward):
            return torch.cat([fwd(xi, *args) for xi in x.chunk(parts)])
        br.forward = split

    def undo():
        for br in branches:
            del br.forward
    return undo


def _split_l2(parts):
    """The signature's batch-axis sum of squares summed over ``parts``
    equal row blocks, as the global form's all-reduce sums the ranks'
    sums, each block's sum taken in the (P, B, D)-major layout in which a
    rank's part projection gives its rows (a reduction's order follows
    the layout).  Returns an undo function."""
    from ugaitnet_tpu_torch.ops import fusion
    signature = fusion.signature

    def split(fused, l2_mode="reference", group=None):
        if fused.ndim != 3 or l2_mode != "reference":
            return signature(fused, l2_mode, group)
        blocks = [f.transpose(0, 1).contiguous().transpose(0, 1)
                  for f in fused.chunk(parts)]
        sq = sum(torch.sum(f * f, dim=0, keepdim=True) for f in blocks)
        return fused * torch.rsqrt(torch.clamp_min(sq, 1e-12))
    fusion.signature = split

    def undo():
        fusion.signature = signature
    return undo


def _both(*hooks):
    def apply(model):
        undos = [h(model) for h in hooks]
        return lambda: [u() for u in undos]
    return apply


def _switches(mine, ref):
    """Where rounding can move a gradient by a whole element: pre-
    activations whose sign differs (the leaky ReLU after b_conv3 and
    b_conv4), and pyramid strips (bins 1 to 16) whose max lies at a
    position of another value, in the rows ``mine`` holds of ``ref``'s."""
    out = {k: int(((mine[k] > 0) != (ref[k] > 0)).sum())
           for k in ("y", "y4")}
    for k in ("fmap_sa", "fmap_sb"):
        b, c, h, w = mine[k].shape
        out[k] = 0
        for nb in (1, 2, 4, 8, 16):
            m, r = (t.reshape(b, c, nb, -1) for t in (mine[k], ref[k]))
            am, ar = m.argmax(-1, keepdim=True), r.argmax(-1, keepdim=True)
            # a move between positions the reference holds equal is a tie,
            # whose gradient the max splits alike either way
            out[k] += int((r.gather(-1, am) != r.gather(-1, ar)).sum())
    return out


def _rank(rank, work, dev_name, tiny):
    """One rank of the global form on a gloo world of 2: saves LAYER's
    tensors, its weight gradient before and after the ranks' average, the
    whole averaged gradient and (rank 0) the gathered sign_max picks."""
    from ugaitnet_tpu_torch.core.config import TrainConfig
    from ugaitnet_tpu_torch.ops.collectives import gather_rows_nograd
    from ugaitnet_tpu_torch.parallel import sharding as S
    from ugaitnet_tpu_torch.train import train_step as TS
    C._p12_setup()
    dev = torch.device(dev_name)
    if dev.type == "cuda":
        from ugaitnet_tpu_torch.ops.cuda import build
        build.load("triplet_kernel")      # the parent built it
    mcfg = _cfg(tiny)
    batch = C._p12_load(work, "batch.pt", dev)
    mesh = S.make_mesh(2, [dev, dev])
    step = S.make_sharded_train_step(mcfg, TrainConfig(), mesh)
    probe = _probe(mcfg, dev)
    rec, taps = {}, []
    undo = _record(probe.model, rec)
    tap = probe.model.register_forward_hook(
        lambda mod, args, out: taps.append(out))
    weight = probe.model.get_submodule(LAYER).weight
    avg = TS.average_gradients

    def recording(model, m):
        rec["w_local"] = weight.grad.detach().clone()
        avg(model, m)
    TS.average_gradients = recording
    try:
        step(probe, S.shard_batch(batch, mesh))
    finally:
        TS.average_gradients = avg
        undo()
        tap.remove()
    picks = gather_rows_nograd(C._p12_picks(taps[0]), mesh.group("data"))
    rec["grads"] = C._p12_grads(probe)
    if rank == 0:
        rec["picks"] = picks
    torch.save({k: ({n: g.cpu() for n, g in v.items()} if k == "grads"
                    else v.cpu()) for k, v in rec.items()},
               os.path.join(work, f"rank{rank}.pt"))


def _wgrad(x, gy, w):
    return torch.nn.grad.conv2d_weight(x, w.shape, gy, padding=1)


def _rel(a, b, scale):
    return float((a.double() - b.double()).abs().max()) / scale


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--out", default=os.path.join("build", "p12_conv.json"))
    args = ap.parse_args()
    dev = torch.device(args.device)
    if dev.type == "cpu":
        torch.set_num_threads(1)     # as each rank: the same sum orders
    if dev.type == "cuda" and not torch.cuda.is_available():
        sys.exit("chip_p12_conv: no CUDA device")
    if dev.type == "cuda":
        dev = torch.device("cuda", 0)    # both ranks share card 0
    from ugaitnet_tpu_torch.core.config import DataConfig, TrainConfig
    from ugaitnet_tpu_torch.data.pipeline import preprocess_batch
    from ugaitnet_tpu_torch.ops import fusion
    from ugaitnet_tpu_torch.parallel import sharding as S
    from ugaitnet_tpu_torch.train.train_step import make_train_step
    t0 = time.perf_counter()
    card = "cpu"
    if dev.type == "cuda":
        from ugaitnet_tpu_torch.ops.cuda import build
        build.load("triplet_kernel")
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    C._p12_setup()
    work = tempfile.mkdtemp(prefix="chip_p12_conv_")
    raw_b, ids = (8, 4) if args.tiny else (40, 8)
    vols, flags, labels = preprocess_batch(
        C.raw_batch(raw_b, ids, seed=2, dev=dev), C.MODS, (2, 1),
        (100.0, 1.0), 2, 3, True, DataConfig(),
        generator=torch.Generator().manual_seed(0), device=dev)
    torch.save({"volumes": [v.cpu() for v in vols],
                "flags": [f.cpu() for f in flags], "labels": labels.cpu()},
               os.path.join(work, "batch.pt"))
    del vols, flags, labels
    mcfg = _cfg(args.tiny)
    S.spawn(_rank, 2, args=(work, str(dev), args.tiny), devices=[dev, dev])
    ranks = [torch.load(os.path.join(work, f"rank{r}.pt"),
                        weights_only=True) for r in range(2)]

    # the one-process step forced to the ranks' sign_max picks
    batch = C._p12_load(work, "batch.pt", dev)
    picks = ranks[0]["picks"].to(dev).bool()
    sign_max = fusion.MERGES["sign_max"]

    def forced_step(hooks):
        probe = _probe(mcfg, dev)
        undo = hooks(probe.model)
        fusion.MERGES["sign_max"] = lambda embs: torch.where(
            picks, embs[0], embs[1])
        try:
            make_train_step(mcfg, TrainConfig())(probe, batch)
        finally:
            fusion.MERGES["sign_max"] = sign_max
            undo()
        return probe, {k: g.cpu() for k, g in C._p12_grads(probe).items()}

    one = {}
    probe, grads = forced_step(lambda m: _record(m, one))
    # the positive control: the same forced step with every branch run on
    # the ranks' two halves of the batch (autograd sums their gradients),
    # with the signature's sum of squares summed over the halves, and with
    # both
    controls = {
        "branches": lambda m: _split_branches(m, 2),
        "l2": lambda m: _split_l2(2),
        "both": _both(lambda m: _split_branches(m, 2),
                      lambda m: _split_l2(2))}
    split_grads = {k: forced_step(h)[1] for k, h in controls.items()}
    w = probe.model.get_submodule(LAYER).weight.detach()
    key = LAYER + ".weight"
    gmax = max(float(g.abs().max()) for g in grads.values())
    worst = {}
    res = {"card": card, "layer": LAYER,
           "forced_gap": C._grad_err(ranks[0]["grads"], grads, worst=worst),
           "forced_gap_leaf": worst["leaf"],
           "rows": batch.labels.shape[0]}
    res["control"] = {}
    for k, g in split_grads.items():
        gap = C._grad_err(ranks[0]["grads"], g, worst=worst)
        res["control"][k] = {"forced_gap": gap, "leaf": worst["leaf"],
                             "vs_one": C._grad_err(g, grads)}
    w_one, w_dp = grads[key], ranks[0]["grads"][key]
    res["layer_gap"] = _rel(w_dp, w_one, gmax)
    res["layer_gap_of_layer_max"] = _rel(w_dp, w_one,
                                         float(w_one.abs().max()))
    for k, g in split_grads.items():
        res["control"][k]["layer_gap"] = _rel(w_dp, g[key], gmax)
    h = res["rows"] // 2
    # the signatures the triplet sees, and the triplets whose hinge changes
    # side between them
    sig_dp = torch.cat([d["sig"] for d in ranks])
    flips, valid, active, near = C._p12_flips(
        one["sig"].cpu(), sig_dp, batch.labels.cpu(), TrainConfig().margin)
    res["signature"] = {
        "max_abs_diff": _rel(sig_dp, one["sig"].cpu(), 1.0),
        "flips": flips, "valid": valid, "active": active, "near": near}
    x1, y1, gy1 = (one[k].cpu() for k in ("x", "y", "gy"))
    res["ranks"] = []
    for r, d in enumerate(ranks):
        rows = slice(r * h, (r + 1) * h)
        res["ranks"].append({
            "x": _rel(d["x"], x1[rows], float(x1.abs().max())),
            "y": _rel(d["y"], y1[rows], float(y1.abs().max())),
            # a rank's cotangents are the world (2) times its rows' share
            "gy": _rel(d["gy"], 2 * gy1[rows], 2 * float(gy1.abs().max())),
            **{k: _rel(d[k], 2 * one[k].cpu()[rows],
                       2 * float(one[k].abs().max()))
               for k in ("g_signature", "g_parts", "g_b_conv4")},
            "switches": _switches(d, {k: one[k].cpu()[rows] for k in (
                "y", "y4", "fmap_sa", "fmap_sb")}),
            "x_bitwise": bool(torch.equal(d["x"], x1[rows])),
            "y_bitwise": bool(torch.equal(d["y"], y1[rows])),
            "gy_bitwise": bool(torch.equal(d["gy"], 2 * gy1[rows]))})

    # the layer alone, on the one process's tensors, at 120 rows and at two
    # 60-row halves, each against float64
    xd, gyd = one["x"], one["gy"]
    w64 = _wgrad(xd.double(), gyd.double(), w.double()).cpu()
    res["w_step_vs_float64"] = _rel(w_one, w64, gmax)
    res["cudnn"] = {}
    # the averaged gradient from the ranks' own tensors: their rows' weight
    # gradients (cotangents 2x the one process's), summed, halved
    ranks_w = sum(_wgrad(d["x"].to(dev), d["gy"].to(dev), w).cpu()
                  for d in ranks) / 2
    res["dp_vs_rank_tensors"] = _rel(ranks_w, w_dp, gmax)
    res["rank_local_vs_own"] = [
        _rel(_wgrad(d["x"].to(dev), d["gy"].to(dev), w).cpu(), d["w_local"],
             gmax) for d in ranks]
    for det in (True, False):
        torch.backends.cudnn.deterministic = det
        full = _wgrad(xd, gyd, w).cpu()
        halves = [_wgrad(xd[i * h:(i + 1) * h], gyd[i * h:(i + 1) * h], w)
                  .cpu() for i in range(2)]
        split = halves[0] + halves[1]
        y60 = torch.cat([F.conv2d(xd[i * h:(i + 1) * h], w, padding=1)
                         for i in range(2)]).cpu()
        res["cudnn"][f"deterministic={det}"] = {
            "w120_vs_step": _rel(full, w_one, gmax),
            "w120_bitwise_step": bool(torch.equal(full, w_one)),
            "w60x2_vs_w120": _rel(split, full, gmax),
            "w60x2_vs_dp": _rel(split, w_dp, gmax),
            "w60x2_bitwise_dp": bool(torch.equal(split, w_dp)),
            "rank_local_vs_w60": [_rel(d["w_local"], 2 * hv, gmax)
                                  for d, hv in zip(ranks, halves)],
            "w120_vs_float64": _rel(full, w64, gmax),
            "w60x2_vs_float64": _rel(split, w64, gmax),
            "y60_vs_y120": _rel(y60, y1, float(y1.abs().max())),
            "y60_bitwise_y120": bool(torch.equal(y60, y1))}
    C._p12_setup()
    res["seconds"] = time.perf_counter() - t0
    for k, v in res.items():
        print(f"{k}: {v}")
    out = os.path.join(REPO, args.out)
    os.makedirs(os.path.dirname(out), exist_ok=True)
    with open(out, "w") as f:
        json.dump(res, f, indent=1)
    print(json.dumps(res))


if __name__ == "__main__":
    main()
