"""Import reference-trained Keras weight files into UGaitNet params.

Port of ``ugaitnet_tpu/utils/keras_import.py``.  The loaders fill the JAX
package's flax-layout parameter tree, with numpy leaves, exactly as the JAX
module does; the port's weight bridge (``utils/weights.py``) carries that
tree to and from a ``UGaitNet`` state_dict, so no layout logic is written
twice:

    params = state_dict_to_flax(model.state_dict())
    model.load_state_dict(flax_to_state_dict(
        load_keras_weights("weights.h5", params)))

Migration path for users with models trained by the original repo (h5
checkpoints from model.save_weights / model.save,
(reference) mains/mj_trainUWYHGaitNet_DataGen_CasiaB.py:524-527): reads
the HDF5 weight layout directly (h5py, imported where it is used; no
TensorFlow needed) and maps layers into the parameter tree.

Supported families (layer mappings follow the reference build order):

  * gaitset, any branch count (2-mod flagship + 3-mod,
    mj_uwyhNets_ba.py:419-484 / :1100-1151): TimeDistributed convs 1..6 =
    frame-stream a_conv1..6, plain Conv2D 1..4 = set-stream b_conv1..4,
    MatMul = part_proj — groups split evenly per branch in creation order
    (of, gray, depth); classprob Dense maps directly (the flatten orders
    agree: both are (part, dim) per sample).
  * conv2d branches (UWYHNet.buildBranch/buildBranchLReLU Sequentials named
    "<mod>Branch"): conv kernels/biases copy directly (HWIO both); the
    first Dense's input rows are permuted from the reference's
    channels-first flatten (c,h,w) to ours (h,w,c).
  * conv3d branches (build_3Dbranch[LReLU] Sequentials): identical layouts,
    direct copy of the 6 convs + the 1x1x1 code conv.

`load_keras_weights` sniffs the family from the h5 layer names.
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np


def _collect_weights(h5path: str) -> Dict[str, List[np.ndarray]]:
    """layer name -> [weight arrays] from a Keras h5 weights file."""
    import h5py
    out: Dict[str, List[np.ndarray]] = {}
    with h5py.File(h5path, "r") as f:
        root = f["model_weights"] if "model_weights" in f else f
        names = [n.decode() if isinstance(n, bytes) else n
                 for n in root.attrs.get("layer_names", list(root.keys()))]
        for lname in names:
            if lname not in root:
                continue
            grp = root[lname]
            wnames = [n.decode() if isinstance(n, bytes) else n
                      for n in grp.attrs.get("weight_names", [])]
            ws = []
            for wn in wnames:
                node = grp
                for part in wn.split("/"):
                    node = node[part]
                ws.append(np.asarray(node))
            if not ws:  # fallback: walk datasets (no weight_names attr)
                named = []

                def visit(name, obj):
                    if hasattr(obj, "shape") and obj.shape is not None:
                        named.append((name, np.asarray(obj)))
                grp.visititems(lambda n, o: visit(n, o)
                               if hasattr(o, "dtype") else None)
                # h5py visits alphabetically, which puts 'bias' before
                # 'kernel'; loaders expect Keras order (kernel, bias) PER
                # LAYER, so group by the layer path prefix first and only
                # reorder kernel-before-bias within a layer — a flat
                # (rank, path) key would put every kernel of a multi-layer
                # group before every bias and break the
                # (ws[2i], ws[2i+1]) pairing in
                # load_sequential_branch_weights
                rank = {"kernel": 0, "bias": 1}

                def natural(s):
                    # Keras global layer counters go past 9 in multi-branch
                    # nets; plain string order would put conv2d_10 before
                    # conv2d_2 and transplant kernels into the wrong convs
                    import re
                    return tuple(int(t) if t.isdigit() else t
                                 for t in re.split(r"(\d+)", s))

                def key(item):
                    path, leaf = (item[0].rsplit("/", 1) + [""])[:2]
                    if not leaf:
                        path, leaf = "", item[0]
                    return (natural(path), rank.get(leaf.split(":")[0], 2),
                            natural(item[0]))
                ws = [a for _, a in sorted(named, key=key)]
            if ws:
                out[lname] = ws
    return out


def _leaf(a) -> np.ndarray:
    """A float32 copy of an h5 weight (the JAX module's jnp.asarray; a
    copy, so no leaf aliases another tree's)."""
    return np.array(a, np.float32)


def _suffix(name: str, prefix: str) -> int:
    return int(name[len(prefix):].lstrip("_") or 0)


# reference branch creation order (of first, then gray, then depth)
_MOD_ORDER = {"branch_of": 0, "branch_gray": 1, "branch_depth": 2}


def _branch_keys(p: Dict) -> List[str]:
    keys = [k for k in p if k.startswith("branch_")]
    return sorted(keys, key=lambda b: (_MOD_ORDER.get(b, 99), b))


def _copy_tree(tree: Any) -> Any:
    """Fresh nested dicts over the same (immutable) leaves, so the loaders
    can assign in place without mutating the caller's tree."""
    if isinstance(tree, dict):
        return {k: _copy_tree(v) for k, v in tree.items()}
    return tree


def _copy_head(p: Dict, weights: Dict) -> None:
    if "classprob" in p and "classprob" in weights:
        k, b = weights["classprob"][:2]
        if p["classprob"]["kernel"].shape == k.shape:
            p["classprob"]["kernel"] = _leaf(k)
            p["classprob"]["bias"] = _leaf(b)


def load_gaitset_weights(h5path: str, params: Any,
                         weights: Dict[str, List[np.ndarray]] = None) -> Any:
    """Fill an n-branch gaitset params tree from a reference h5 file.

    params: the tree from init_params (mutated copy returned). Raises if the
    layer counts don't match 6/4/1 TimeDistributed/Conv2D/MatMul per branch.
    """
    if weights is None:
        weights = _collect_weights(h5path)
    params = _copy_tree(params)
    tds = sorted([n for n in weights if n.startswith("time_distributed")],
                 key=lambda n: _suffix(n, "time_distributed"))
    convs = sorted([n for n in weights if n.startswith("conv2d")],
                   key=lambda n: _suffix(n, "conv2d"))
    mms = sorted([n for n in weights if n.startswith("mat_mul")],
                 key=lambda n: _suffix(n, "mat_mul"))

    p = params["params"] if "params" in params else params
    order = _branch_keys(p)
    n = len(order)
    if len(tds) != 6 * n or len(convs) != 4 * n or len(mms) != n:
        raise ValueError(
            f"not an {n}-mod gaitset checkpoint: {len(tds)} TimeDistributed,"
            f" {len(convs)} Conv2D, {len(mms)} MatMul layers "
            f"(expected {6*n}/{4*n}/{n})")

    def fill(branch: Dict, td6, conv4, mm):
        for i, name in enumerate(td6, 1):
            branch[f"a_conv{i}"]["kernel"] = _leaf(weights[name][0])
        for i, name in enumerate(conv4, 1):
            branch[f"b_conv{i}"]["kernel"] = _leaf(weights[name][0])
        branch["part_proj"] = _leaf(weights[mm][0])

    for bi, key in enumerate(order):
        fill(p[key], tds[6 * bi:6 * (bi + 1)], convs[4 * bi:4 * (bi + 1)],
             mms[bi])
    _copy_head(p, weights)
    return params


def load_gaitset_branch_weights(h5path: str, branch_params: Dict,
                                src_index: int,
                                weights: Dict[str, List[np.ndarray]] = None
                                ) -> Dict:
    """Extract ONE branch (by creation-order index) from a reference
    gaitset h5 with ANY branch count into a copy of `branch_params`.

    Powers per-branch warm starts whose source net has a different branch
    count than the target — e.g. the reference's 2-mod gray branch
    initialized from a single-modality OF model (mj_uwyhNets_ba.py:765)."""
    if weights is None:
        weights = _collect_weights(h5path)
    tds = sorted([n for n in weights if n.startswith("time_distributed")],
                 key=lambda n: _suffix(n, "time_distributed"))
    convs = sorted([n for n in weights if n.startswith("conv2d")],
                   key=lambda n: _suffix(n, "conv2d"))
    mms = sorted([n for n in weights if n.startswith("mat_mul")],
                 key=lambda n: _suffix(n, "mat_mul"))
    n = len(mms)
    if n == 0 or len(tds) != 6 * n or len(convs) != 4 * n:
        raise ValueError(
            f"not a gaitset checkpoint: {len(tds)}/{len(convs)}/{n} "
            "TimeDistributed/Conv2D/MatMul layers")
    if not 0 <= src_index < n:
        raise ValueError(f"source h5 has {n} branch(es); "
                         f"index {src_index} out of range")
    branch = _copy_tree(branch_params)
    for i, name in enumerate(tds[6 * src_index:6 * (src_index + 1)], 1):
        branch[f"a_conv{i}"]["kernel"] = _leaf(weights[name][0])
    for i, name in enumerate(convs[4 * src_index:4 * (src_index + 1)], 1):
        branch[f"b_conv{i}"]["kernel"] = _leaf(weights[name][0])
    branch["part_proj"] = _leaf(weights[mms[src_index]][0])
    return branch


def _conv2d_flatten_perm(rows: int, channels: int) -> np.ndarray:
    """Row permutation taking the reference's channels-first flatten order
    (c, h, w) to ours (h, w, c) for the first Dense after the convs."""
    hw = rows // channels
    h = int(round(hw ** 0.5))
    if channels * h * h != rows:
        raise ValueError(
            f"dense input rows {rows} != c*h*h for c={channels}")
    return np.arange(rows).reshape(channels, h, h).transpose(1, 2, 0
                                                             ).reshape(-1)


def load_sequential_branch_weights(h5path: str, params: Any,
                                   weights: Dict[str, List[np.ndarray]] = None
                                   ) -> Any:
    """Fill conv2d/conv3d branch subtrees from '<mod>Branch' Sequential
    groups in a reference h5 (UWYHNet.buildBranch* / build_3Dbranch*)."""
    if weights is None:
        weights = _collect_weights(h5path)
    params = _copy_tree(params)
    p = params["params"] if "params" in params else params

    # positional matching: the reference hard-codes branch slot names
    # (ofBranch/grayBranch/depthBranch) regardless of actual modality, so we
    # zip its slots in creation order against our branches in creation order
    slot_order = {"ofBranch": 0, "grayBranch": 1, "depthBranch": 2}
    groups = sorted([n for n in weights if n.endswith("Branch")],
                    key=lambda n: (slot_order.get(n, 99), n))
    keys = _branch_keys(p)
    if len(groups) != len(keys):
        raise ValueError(
            f"h5 has branch groups {groups} but the target net has "
            f"{len(keys)} branches ({keys})")

    for key, gname in zip(keys, groups):
        ws = weights[gname]
        branch = p[key]
        is3d = ws[0].ndim == 5
        nconv = len([k for k in branch if k.startswith("conv")])
        pairs = [(ws[2 * i], ws[2 * i + 1]) for i in range(len(ws) // 2)]
        if is3d:
            # 6 convs + 1x1x1 code conv
            if len(pairs) != nconv + 1:
                raise ValueError(
                    f"{gname}: {len(pairs)} weighted layers, expected "
                    f"{nconv + 1} (convs + code)")
            for i in range(nconv):
                branch[f"conv{i}"]["kernel"] = _leaf(pairs[i][0])
                branch[f"conv{i}"]["bias"] = _leaf(pairs[i][1])
            branch["code"]["kernel"] = _leaf(pairs[nconv][0])
            branch["code"]["bias"] = _leaf(pairs[nconv][1])
        else:
            # n convs + Dense(2d) + Dense(d)
            if len(pairs) != nconv + 2:
                raise ValueError(
                    f"{gname}: {len(pairs)} weighted layers, expected "
                    f"{nconv + 2} (convs + dense + code)")
            for i in range(nconv):
                branch[f"conv{i}"]["kernel"] = _leaf(pairs[i][0])
                branch[f"conv{i}"]["bias"] = _leaf(pairs[i][1])
            kd, bd = pairs[nconv]
            c_last = int(branch[f"conv{nconv - 1}"]["kernel"].shape[-1])
            perm = _conv2d_flatten_perm(kd.shape[0], c_last)
            branch["dense"]["kernel"] = _leaf(kd[perm])
            branch["dense"]["bias"] = _leaf(bd)
            kc, bc = pairs[nconv + 1]
            branch["code"]["kernel"] = _leaf(kc)
            branch["code"]["bias"] = _leaf(bc)
    _copy_head(p, weights)
    return params


def load_keras_weights(h5path: str, params: Any) -> Any:
    """Family-sniffing entry point: gaitset nets carry MatMul layers at the
    model top level; conv2d/conv3d nets carry '<mod>Branch' Sequentials."""
    weights = _collect_weights(h5path)
    if any(n.startswith("mat_mul") for n in weights):
        return load_gaitset_weights(h5path, params, weights=weights)
    if any(n.endswith("Branch") for n in weights):
        return load_sequential_branch_weights(h5path, params,
                                              weights=weights)
    raise ValueError(
        f"unrecognized reference checkpoint family; h5 layers: "
        f"{sorted(weights)}")
