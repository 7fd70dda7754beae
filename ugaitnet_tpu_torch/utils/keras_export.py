"""Export UGaitNet params into a reference-layout Keras h5 weights file.

Port of ``ugaitnet_tpu/utils/keras_export.py``.  It writes the JAX
package's flax-layout parameter tree (numpy leaves); a port model gives that
tree through the weight bridge:

    export_keras_weights(state_dict_to_flax(model.state_dict()),
                         "ours.h5", "template.h5")

The inverse of utils/keras_import.py: a model trained in this framework can
be written back into the HDF5 weight layout the original repo's mains
consume (`model.load_weights(...)`, e.g.
(reference) mains/mj_testUWYHGaitNet_open_casiab.py:536 loadnet /
nets/mj_uwyhNets_ba.py:554-579), closing the cross-check loop: train here,
evaluate inside the original TF stack.

Keras layer names carry process-global build counters (`time_distributed_17`)
and the MatMul weight names embed an internal variable counter
(`MatMul_kernel[94]:0`), so a from-scratch writer cannot know the names a
user's build will expect.  Export therefore works from a TEMPLATE: any h5
produced by `reference_model.save_weights(...)` for the same architecture
(every reference user has these — its mains write one per epoch).  We copy
the template and overwrite each weight dataset in place, which preserves
every Keras attribute (layer_names, weight_names, backend, version) exactly,
so both `load_weights(path)` (order-based) and `load_weights(path,
by_name=True)` see a file indistinguishable from a native save.

Layer matching reuses the importer's conventions (sorted name suffixes,
branch creation order of/gray/depth); the conv2d family's first Dense rows
are inverse-permuted back to the reference's channels-first flatten order.

The JAX package's tests/test_keras_export.py holds its module against the
reference oracle; tests/test_torch_keras.py holds this port to that module
bitwise and export -> import as an involution.
"""

from __future__ import annotations

import shutil
from typing import Any, Dict, List

import numpy as np

from ugaitnet_tpu_torch.utils.keras_import import (
    _branch_keys, _collect_weights, _conv2d_flatten_perm, _suffix)


def _template_layout(h5path: str) -> Dict[str, List[str]]:
    """layer name -> [h5 dataset paths within the layer group], in Keras
    weight order (the weight_names attr; fallback mirrors the importer)."""
    import h5py
    out: Dict[str, List[str]] = {}
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
            if wnames:
                out[lname] = wnames
    return out


def _overwrite(h5path: str, layer: str, wnames: List[str],
               values: List[np.ndarray]) -> None:
    import h5py
    with h5py.File(h5path, "r+") as f:
        root = f["model_weights"] if "model_weights" in f else f
        grp = root[layer]
        if len(wnames) != len(values):
            raise ValueError(
                f"{layer}: template has {len(wnames)} weights, "
                f"exporting {len(values)}")
        for wn, val in zip(wnames, values):
            node = grp
            for part in wn.split("/"):
                node = node[part]
            val = np.asarray(val, np.float32)
            if tuple(node.shape) != val.shape:
                raise ValueError(
                    f"{layer}/{wn}: template shape {tuple(node.shape)} != "
                    f"exported {val.shape} — architecture mismatch")
            node[...] = val


def export_gaitset_weights(params: Any, h5path: str,
                           template_h5: str) -> None:
    """Write an n-branch gaitset params tree over a copy of template_h5.

    Template: any save_weights h5 of the SAME reference architecture
    (UWYHSemiNet.build(gaitset=True) / UWYHSemiNet3Mods, one MatMul per
    branch).  Inverse of keras_import.load_gaitset_weights.
    """
    shutil.copyfile(template_h5, h5path)
    layout = _template_layout(h5path)
    tds = sorted([n for n in layout if n.startswith("time_distributed")],
                 key=lambda n: _suffix(n, "time_distributed"))
    convs = sorted([n for n in layout if n.startswith("conv2d")],
                   key=lambda n: _suffix(n, "conv2d"))
    mms = sorted([n for n in layout if n.startswith("mat_mul")],
                 key=lambda n: _suffix(n, "mat_mul"))

    p = params["params"] if "params" in params else params
    order = _branch_keys(p)
    n = len(order)
    if len(tds) != 6 * n or len(convs) != 4 * n or len(mms) != n:
        raise ValueError(
            f"template is not an {n}-mod gaitset checkpoint: "
            f"{len(tds)}/{len(convs)}/{len(mms)} TimeDistributed/Conv2D/"
            f"MatMul layers (expected {6*n}/{4*n}/{n})")

    for bi, key in enumerate(order):
        branch = p[key]
        for i, lname in enumerate(tds[6 * bi:6 * (bi + 1)], 1):
            _overwrite(h5path, lname, layout[lname],
                       [branch[f"a_conv{i}"]["kernel"]])
        for i, lname in enumerate(convs[4 * bi:4 * (bi + 1)], 1):
            _overwrite(h5path, lname, layout[lname],
                       [branch[f"b_conv{i}"]["kernel"]])
        _overwrite(h5path, mms[bi], layout[mms[bi]], [branch["part_proj"]])
    if "classprob" in p and "classprob" in layout:
        _overwrite(h5path, "classprob", layout["classprob"],
                   [p["classprob"]["kernel"], p["classprob"]["bias"]])


def export_sequential_branch_weights(params: Any, h5path: str,
                                     template_h5: str) -> None:
    """Write conv2d/conv3d branch subtrees over a copy of template_h5
    ('<mod>Branch' Sequential groups, UWYHNet.buildBranch* /
    build_3Dbranch*).  Inverse of load_sequential_branch_weights: the
    conv2d first-Dense rows are permuted back from our (h, w, c) flatten
    order to the reference's channels-first (c, h, w)."""
    shutil.copyfile(template_h5, h5path)
    layout = _template_layout(h5path)
    p = params["params"] if "params" in params else params

    slot_order = {"ofBranch": 0, "grayBranch": 1, "depthBranch": 2}
    groups = sorted([n for n in layout if n.endswith("Branch")],
                    key=lambda n: (slot_order.get(n, 99), n))
    keys = _branch_keys(p)
    if len(groups) != len(keys):
        raise ValueError(
            f"template has branch groups {groups} but the source net has "
            f"{len(keys)} branches ({keys})")

    template = _collect_weights(template_h5)
    for key, gname in zip(keys, groups):
        branch = p[key]
        is3d = template[gname][0].ndim == 5
        nconv = len([k for k in branch if k.startswith("conv")])
        vals: List[np.ndarray] = []
        for i in range(nconv):
            vals += [branch[f"conv{i}"]["kernel"], branch[f"conv{i}"]["bias"]]
        if is3d:
            vals += [branch["code"]["kernel"], branch["code"]["bias"]]
        else:
            kd = np.asarray(branch["dense"]["kernel"], np.float32)
            c_last = int(
                np.asarray(branch[f"conv{nconv - 1}"]["kernel"]).shape[-1])
            perm = _conv2d_flatten_perm(kd.shape[0], c_last)
            inv = np.argsort(perm)  # ours[h,w,c-order] -> ref (c,h,w) rows
            vals += [kd[inv], branch["dense"]["bias"],
                     branch["code"]["kernel"], branch["code"]["bias"]]
        _overwrite(h5path, gname, layout[gname], vals)
    if "classprob" in p and "classprob" in layout:
        _overwrite(h5path, "classprob", layout["classprob"],
                   [p["classprob"]["kernel"], p["classprob"]["bias"]])


def export_keras_weights(params: Any, h5path: str, template_h5: str) -> None:
    """Family-sniffing entry point, mirroring keras_import.load_keras_weights:
    gaitset templates carry MatMul layers; conv2d/conv3d templates carry
    '<mod>Branch' Sequential groups."""
    layout = _template_layout(template_h5)
    if any(n.startswith("mat_mul") for n in layout):
        return export_gaitset_weights(params, h5path, template_h5)
    if any(n.endswith("Branch") for n in layout):
        return export_sequential_branch_weights(params, h5path, template_h5)
    raise ValueError(
        f"unrecognized reference template family; h5 layers: "
        f"{sorted(layout)}")
