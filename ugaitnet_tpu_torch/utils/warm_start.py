"""Warm-starting networks from prior experiments (reference --initnet /
init_branches).

Two reference mechanisms re-derived here:

  * full-net init with classifier-head surgery — `build_or_load(initnet=...)`
    loads a whole prior model and rebuilds the classprob head when nclasses
    differs ((reference) nets/mj_uwyhNets_ba.py:582-632).
  * per-branch init — every net builder accepts pretrained per-branch
    weights (`init_branches`, fc_loadBranch,
    (reference) nets/mj_uwyhNets_ba.py:57-62,419-424), including the
    quirk that the 2-mod gaitset *gray* branch is built under the name
    "ofBranch" with the OF init (:765) — exposed here as an explicit
    source-modality remap rather than silently.

Sources may be a prior experiment dir of the port (config.json + ckpt/,
``core/checkpoint.py``) or a reference-trained Keras .h5/.hdf5 file
(utils/keras_import).

Port of ``ugaitnet_tpu/utils/warm_start.py``.  Every function works, as the
JAX module's does, on the flax-layout parameter tree with numpy leaves (the
JAX package's ``{"params": {"branch_<m>": ...}}``); a port checkpoint's
state_dict enters that layout through the weight bridge
(``utils/weights.py:state_dict_to_flax``), and a warm-started tree goes back
into a model with ``flax_to_state_dict``.  No input tree is mutated.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

from ugaitnet_tpu_torch.core.checkpoint import \
    merge_matching as _merge_matching

# canonical reference branch build order — all its mains construct nets
# with inputs in this sequence, so branch i of an h5 maps to this modality
# (mains/mj_trainUWYHGaitNet_DataGen_*.py input_shapes ordering)
_REF_BRANCH_ORDER = ("of", "gray", "depth", "silhouette", "rgb")


def load_source_params(path: str, epoch=-1,
                       target_params: Optional[Any] = None) -> Any:
    """Load a flax-layout parameter tree from an experiment dir or a Keras
    h5 file.

    Experiment dirs restore the checkpoint's model (no target needed);
    Keras files need `target_params` to know the destination layout.
    epoch: -1 (or None) for the newest checkpoint, an int, or 'best'.
    """
    if path.endswith((".h5", ".hdf5")):
        if target_params is None:
            raise ValueError("Keras h5 warm start needs target params")
        from ugaitnet_tpu_torch.utils.keras_import import load_keras_weights
        return load_keras_weights(path, target_params)

    from ugaitnet_tpu_torch.core import checkpoint as ckpt
    from ugaitnet_tpu_torch.utils.weights import state_dict_to_flax
    step = epoch
    if epoch == -1 or epoch is None:
        step = ckpt.latest_checkpoint_step(path)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {path}")
    # a port checkpoint holds {"step", "model", "optimizer"}: the model's
    # state_dict, carried into the flax layout by the bridge
    return state_dict_to_flax(ckpt.restore_raw(path, step)["model"])


def warm_start_full(params: Any, initnet: str, epoch=-1) -> Any:
    """Reference --initnet: initialize the whole net from a prior model,
    keeping the fresh head wherever shapes mismatch (nclasses surgery,
    mj_uwyhNets_ba.py:610-632)."""
    src = load_source_params(initnet, epoch, target_params=params)
    out = _merge_matching(params, src)
    return out


def warm_start_branches(params: Any, sources: Dict[str, Tuple[str, str]],
                        epoch=-1) -> Any:
    """Reference init_branches: per-branch warm start.

    sources: {dst_modality: (path, src_modality)} — e.g.
    {"gray": ("/exp/of_single", "of")} reproduces the :765 gray-from-OF
    quirk explicitly.
    """
    tree = params["params"] if "params" in params else params
    new_tree = dict(tree)
    loaded: Dict[str, Any] = {}
    for dst, (path, src_mod) in sources.items():
        is_h5 = path.endswith((".h5", ".hdf5"))
        if path not in loaded:
            # `loaded` caches the h5 layer-weights dict for h5 sources and
            # the restored params tree for experiment dirs
            if is_h5:
                from ugaitnet_tpu_torch.utils.keras_import import \
                    _collect_weights
                loaded[path] = _collect_weights(path)
            else:
                loaded[path] = load_source_params(path, epoch,
                                                  target_params=params)
        dkey = f"branch_{dst}"
        if dkey not in tree:
            raise KeyError(f"target net has no '{dkey}' branch")
        if is_h5:
            # extract the single branch straight from the h5 so the source
            # net may have ANY branch count (e.g. gray init from a 1-mod
            # OF model, the reference :765 quirk)
            from ugaitnet_tpu_torch.utils.keras_import import (
                load_gaitset_branch_weights)
            weights = loaded[path]
            nh5 = len([n for n in weights if n.startswith("mat_mul")])
            if nh5 == 0:
                raise ValueError(
                    f"{path}: per-branch h5 warm start supports the "
                    "gaitset family only (no MatMul layers found); use "
                    "--initnet for conv2d/conv3d h5s")
            # src_mod may be a modality name (resolved through the
            # canonical reference build order, which assumes the source
            # net's modalities are a prefix of it) or an explicit integer
            # branch index ("gray=path@1") for sources that are not
            if src_mod.isdigit():
                idx = int(src_mod)
            elif nh5 == 1:
                idx = 0
            elif src_mod in _REF_BRANCH_ORDER:
                # NOTE: assumes the source net's modalities are a prefix of
                # the canonical order — true for every reference main; for
                # anything else pass '@<branch index>' explicitly.  The h5
                # cannot confirm this (gaitset branches are positional
                # mat_mul<N> layers; even the reference's '<mod>Branch'
                # group names are assigned by slot, keras_import.py:229),
                # so a multi-branch name resolution is flagged loudly: a
                # non-prefix source (e.g. a custom gray+depth net) would
                # otherwise transplant the WRONG branch with no error.
                idx = _REF_BRANCH_ORDER.index(src_mod)
                if nh5 > 1:
                    import warnings
                    warnings.warn(
                        f"resolving source branch {src_mod!r} -> index "
                        f"{idx} of {nh5} assumes the source h5's branches "
                        f"are ordered {_REF_BRANCH_ORDER[:nh5]} (true for "
                        "all reference-trained nets); pass "
                        f"'{dst}={path}@<branch index>' to silence or "
                        "override", stacklevel=2)
            else:
                raise ValueError(
                    f"unknown source modality {src_mod!r}; use one of "
                    f"{_REF_BRANCH_ORDER} or an explicit "
                    f"'{dst}={path}@<branch index>'")
            if not 0 <= idx < nh5:
                raise ValueError(
                    f"{path} has {nh5} branch(es); source {src_mod!r} "
                    f"resolves to index {idx}. If the source net's "
                    "modalities are not a prefix of "
                    f"{_REF_BRANCH_ORDER}, pass an explicit index: "
                    f"'{dst}={path}@<branch index>'")
            src_branch = load_gaitset_branch_weights(
                path, tree[dkey], idx, weights=weights)
            new_tree[dkey] = _merge_matching(tree[dkey], src_branch)
            continue
        src = loaded[path]
        src_tree = src["params"] if "params" in src else src
        skey = f"branch_{src_mod}"
        if skey not in src_tree:
            raise KeyError(
                f"source {path} has no '{skey}' subtree "
                f"(has {sorted(src_tree)})")
        merged = _merge_matching(tree[dkey], src_tree[skey])
        new_tree[dkey] = merged
    if "params" in params:
        return dict(params, params=new_tree)
    return new_tree


def parse_initbranch_specs(specs, modalities) -> Dict[str, Tuple[str, str]]:
    """CLI parsing: each spec is 'mod=path' or 'mod=path@srcmod'."""
    out: Dict[str, Tuple[str, str]] = {}
    for s in specs or []:
        if "=" not in s:
            raise ValueError(f"--initbranch expects mod=path, got {s!r}")
        dst, path = s.split("=", 1)
        src = dst
        if "@" in path:
            head, tail = path.rsplit("@", 1)
            # only treat the suffix as a source selector when it looks
            # like one — checkpoint paths may legitimately contain '@'
            if tail.isdigit() or tail in _REF_BRANCH_ORDER:
                path, src = head, tail
        if dst not in modalities:
            raise ValueError(
                f"--initbranch modality {dst!r} not in net ({modalities})")
        out[dst] = (path, src)
    return out
