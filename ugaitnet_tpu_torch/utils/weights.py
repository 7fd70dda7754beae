"""Weight bridge between the JAX package's flax param tree and the port.

The flax tree comes in as nested dicts of numpy arrays (with or without the
top-level ``"params"`` key):

  params/branch_<m>/<layer>/kernel   (k, k, ci, co) HWIO, (kd, kh, kw, ci,
                                     co) DHWIO, or (F, N) for a Dense
  params/branch_<m>/<layer>/bias     (co,) where the layer has one
  params/branch_<m>/part_proj        (P, C3, D), GaitSet only
  params/branch_<m>/router           (C3, E), GaitSet with MoE
  params/branch_<m>/expert_proj      (E, C3, D), GaitSet with MoE
  params/{classprob, classprob_<m>, extra_dense}/{kernel (F, N), bias (N,)}

(layers: GaitSet ``a_conv1..6``, ``b_conv1..4``; 2D CNN ``conv0..3``,
``dense``, ``code``; 3D CNN ``conv0..5``, ``code``) and maps onto
``UGaitNet``'s state_dict:

  branches.branch_<m>.<layer>.weight  OIHW, OIDHW, or (N, F)
  branches.branch_<m>.<layer>.bias    unchanged
  branches.branch_<m>.part_proj       (P, C3, D), unchanged
  branches.branch_<m>.{router, expert_proj}   unchanged
  {classprob, classprob_<m>, extra_dense}.{weight (N, F), bias (N,)}

Both directions are transposes only, so a round trip is bit-exact.

``quantized_flax_to_state_dict`` / ``quantized_to_flax`` carry the JAX
package's int8 trees (``ugaitnet_tpu/ops/quantize.py``: ``kernel_q``,
``w_scale``, ``in_scale``, ``bias``) to and from the port's
``ops/quantize.py:QuantizedNet``, so both packages can run one set of int8
weights and scales.

The optimizer-state bridge carries a JAX training state across mid-run:
``optax_adam_to_state_dict`` turns optax Adam state, given as numpy
(``count``, ``mu`` and ``nu`` as flax trees, ``learning_rate``), into a
``state_dict`` for the port's ``torch.optim.Adam``, and
``state_dict_to_optax_adam`` goes back.  Parameters are matched by name;
the optimizer must have been made from ``model.parameters()``.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch


# kernel layout: flax -> torch, and back, by kernel rank
_TO_TORCH = {2: (1, 0), 4: (3, 2, 0, 1), 5: (4, 3, 0, 1, 2)}
_TO_FLAX = {2: (1, 0), 4: (2, 3, 1, 0), 5: (2, 3, 4, 1, 0)}


def _tensor(arr) -> torch.Tensor:
    return torch.from_numpy(np.array(arr, copy=True, order="C"))


def _numpy(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy().copy()     # never alias live params


# a branch's bare parameters (no kernel/bias subtree), carried unchanged
BARE = ("part_proj", "router", "expert_proj")


def _is_head_dense(name: str) -> bool:
    """The head's Dense layers: the id head, the aux heads, extra_dense."""
    return name in ("classprob", "extra_dense") or name.startswith(
        "classprob_")


def flax_path(key: str) -> str:
    """The '/'-joined flax path of a UGaitNet state_dict key:
    'branches.branch_of.a_conv1.weight' -> 'params/branch_of/a_conv1/kernel',
    'classprob.bias' -> 'params/classprob/bias'."""
    parts = key.split(".")
    if parts[0] == "branches":
        parts = parts[1:]
    if parts[-1] == "weight":
        parts[-1] = "kernel"
    return "/".join(["params"] + parts)


def flax_to_state_dict(params: Mapping) -> Dict[str, torch.Tensor]:
    """flax param tree (numpy leaves) -> UGaitNet state_dict."""
    tree = params["params"] if "params" in params else params
    sd: Dict[str, torch.Tensor] = {}
    for name, sub in tree.items():
        if name.startswith("branch_"):
            prefix = f"branches.{name}"
            for layer, leaf in sub.items():
                if layer in BARE:
                    sd[f"{prefix}.{layer}"] = _tensor(leaf)
                    continue
                k = np.asarray(leaf["kernel"])
                sd[f"{prefix}.{layer}.weight"] = _tensor(
                    k.transpose(_TO_TORCH[k.ndim]))
                if "bias" in leaf:
                    sd[f"{prefix}.{layer}.bias"] = _tensor(leaf["bias"])
        elif _is_head_dense(name):
            sd[f"{name}.weight"] = _tensor(np.asarray(sub["kernel"]).T)
            sd[f"{name}.bias"] = _tensor(sub["bias"])
        else:
            raise NotImplementedError(
                f"param subtree {name!r} is not a UGaitNet subtree this "
                "bridge knows")
    return sd


def state_dict_to_flax(state_dict: Mapping[str, torch.Tensor]) -> Dict:
    """UGaitNet state_dict -> flax param tree ``{"params": ...}`` of numpy
    arrays (the inverse of ``flax_to_state_dict``)."""
    tree: Dict[str, Dict] = {}
    for key, t in state_dict.items():
        arr = _numpy(t)
        parts = key.split(".")
        if parts[0] == "branches":
            branch = tree.setdefault(parts[1], {})
            if parts[2] in BARE:
                branch[parts[2]] = arr
            elif parts[3] == "weight":
                branch.setdefault(parts[2], {})["kernel"] = \
                    np.ascontiguousarray(arr.transpose(_TO_FLAX[arr.ndim]))
            else:
                branch.setdefault(parts[2], {})["bias"] = arr
        elif _is_head_dense(parts[0]):
            head = tree.setdefault(parts[0], {})
            if parts[1] == "weight":
                head["kernel"] = np.ascontiguousarray(arr.T)
            else:
                head["bias"] = arr
        else:
            raise NotImplementedError(
                f"state_dict key {key!r} is not a UGaitNet entry this "
                "bridge knows")
    return {"params": tree}


def _param_names(model: torch.nn.Module):
    return [name for name, _ in model.named_parameters()]


def optax_adam_to_state_dict(opt: Mapping, optimizer: torch.optim.Optimizer,
                             model: torch.nn.Module) -> Dict:
    """optax Adam state {count, mu, nu, learning_rate} (numpy; mu and nu in
    the flax layout) -> a ``state_dict`` for ``optimizer`` (a
    ``torch.optim.Adam`` over ``model.parameters()``), lr rounded to
    float32 as optax holds it."""
    mu, nu = flax_to_state_dict(opt["mu"]), flax_to_state_dict(opt["nu"])
    step = torch.tensor(float(int(np.asarray(opt["count"]))),
                        dtype=torch.float32)
    sd = optimizer.state_dict()
    state = {i: {"step": step.clone(), "exp_avg": mu[name],
                 "exp_avg_sq": nu[name]}
             for i, name in enumerate(_param_names(model))}
    lr = float(np.float32(np.asarray(opt["learning_rate"])))
    groups = [dict(g, lr=lr) for g in sd["param_groups"]]
    return {"state": state, "param_groups": groups}


def state_dict_to_optax_adam(state_dict: Mapping, model: torch.nn.Module
                             ) -> Dict:
    """A ``torch.optim.Adam`` state_dict over ``model.parameters()`` ->
    {count, mu, nu, learning_rate} as numpy, mu and nu as flax trees (the
    inverse of ``optax_adam_to_state_dict``)."""
    names = _param_names(model)
    st = state_dict["state"]
    mu = {n: st[i]["exp_avg"] for i, n in enumerate(names)}
    nu = {n: st[i]["exp_avg_sq"] for i, n in enumerate(names)}
    return {"count": np.int32(int(st[0]["step"])),
            "mu": state_dict_to_flax(mu), "nu": state_dict_to_flax(nu),
            "learning_rate": np.float32(
                state_dict["param_groups"][0]["lr"])}


def quantized_flax_to_state_dict(qparams: Mapping) -> Dict[str, torch.Tensor]:
    """The JAX package's quantized tree (``quantize_model_params``) -> a
    state_dict for the port's ``QuantizedNet`` of the same config.  Only
    the branch subtrees are carried: the int8 encode uses nothing else.

    int8 convs: ``kernel_q`` (*kernel, ci, co) -> ``weight_q``, the (co,
    K) GEMM matrix with K over (*kernel, ci), zero-padded to a multiple of
    8; ``w_scale``, ``in_scale`` and ``bias`` as they are.  Float layers as
    in ``flax_to_state_dict``."""
    tree = qparams["params"] if "params" in qparams else qparams
    sd: Dict[str, torch.Tensor] = {}
    for name, sub in tree.items():
        if not name.startswith("branch_"):
            continue
        prefix = f"branches.{name}"
        for layer, leaf in sub.items():
            key = f"{prefix}.{layer}"
            if layer == "part_proj":
                sd[key] = _tensor(leaf)
            elif "kernel_q" in leaf:
                kq = np.asarray(leaf["kernel_q"])
                k = int(np.prod(kq.shape[:-1]))
                mat = np.zeros((kq.shape[-1], -(-k // 8) * 8), np.int8)
                mat[:, :k] = kq.reshape(k, kq.shape[-1]).T
                sd[f"{key}.weight_q"] = _tensor(mat)
                for f in ("w_scale", "in_scale", "bias"):
                    if f in leaf:
                        sd[f"{key}.{f}"] = _tensor(leaf[f])
            else:
                kern = np.asarray(leaf["kernel"])
                sd[f"{key}.weight"] = _tensor(
                    kern.transpose(_TO_TORCH[kern.ndim]))
                if "bias" in leaf:
                    sd[f"{key}.bias"] = _tensor(leaf["bias"])
    return sd


def quantized_to_flax(qnet: torch.nn.Module) -> Dict:
    """The port's ``QuantizedNet`` -> the JAX package's quantized branch
    trees (numpy), the inverse of ``quantized_flax_to_state_dict``."""
    from ugaitnet_tpu_torch.ops.quantize import QuantConv
    tree: Dict[str, Dict] = {}
    for name, branch in qnet.branches.items():
        sub = tree.setdefault(name, {})
        for layer, mod in branch.named_children():
            if isinstance(mod, QuantConv):
                k = int(np.prod(mod.kernel)) * mod.cin
                kq = _numpy(mod.weight_q)[:, :k].reshape(
                    -1, *mod.kernel, mod.cin)
                leaf = {"kernel_q": np.ascontiguousarray(
                            np.moveaxis(kq, 0, -1)),
                        "w_scale": _numpy(mod.w_scale),
                        "in_scale": _numpy(mod.in_scale)}
                if mod.bias is not None:
                    leaf["bias"] = _numpy(mod.bias)
            else:
                w = _numpy(mod.weight)
                leaf = {"kernel": np.ascontiguousarray(
                    w.transpose(_TO_FLAX[w.ndim]))}
                if hasattr(mod, "bias"):
                    leaf["bias"] = _numpy(mod.bias)
            sub[layer] = leaf
        if hasattr(branch, "part_proj"):
            sub["part_proj"] = _numpy(branch.part_proj)
    return tree
