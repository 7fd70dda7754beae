"""Weight bridge between the JAX package's flax param tree and the port.

The flax tree comes in as nested dicts of numpy arrays (with or without the
top-level ``"params"`` key):

  params/branch_<m>/{a_conv1..6, b_conv1..4}/kernel   (k, k, ci, co) HWIO
  params/branch_<m>/part_proj                          (P, C3, D)
  params/classprob/{kernel (F, N), bias (N,)}

and maps onto ``UGaitNet``'s state_dict:

  branches.branch_<m>.<conv>.weight   (co, ci, k, k) OIHW
  branches.branch_<m>.part_proj       (P, C3, D), unchanged
  classprob.{weight (N, F), bias (N,)}

Both directions are transposes only, so a round trip is bit-exact.

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

from ugaitnet_tpu_torch.models.gaitset import A_CONVS, B_CONVS

_CONVS = A_CONVS + B_CONVS


def flax_to_state_dict(params: Mapping) -> Dict[str, torch.Tensor]:
    """flax param tree (numpy leaves) -> UGaitNet state_dict."""
    tree = params["params"] if "params" in params else params
    sd: Dict[str, torch.Tensor] = {}

    def put(key, arr):
        sd[key] = torch.from_numpy(np.array(arr, copy=True, order="C"))

    for name, sub in tree.items():
        if name.startswith("branch_"):
            prefix = f"branches.{name}"
            for conv in _CONVS:
                put(f"{prefix}.{conv}.weight",
                    np.asarray(sub[conv]["kernel"]).transpose(3, 2, 0, 1))
            put(f"{prefix}.part_proj", np.asarray(sub["part_proj"]))
        elif name == "classprob":
            put("classprob.weight", np.asarray(sub["kernel"]).T)
            put("classprob.bias", np.asarray(sub["bias"]))
        else:
            raise NotImplementedError(
                f"param subtree {name!r} has no counterpart in the port yet")
    return sd


def state_dict_to_flax(state_dict: Mapping[str, torch.Tensor]) -> Dict:
    """UGaitNet state_dict -> flax param tree ``{"params": ...}`` of numpy
    arrays (the inverse of ``flax_to_state_dict``)."""
    tree: Dict[str, Dict] = {}
    for key, t in state_dict.items():
        arr = t.detach().cpu().numpy().copy()   # never alias live params
        parts = key.split(".")
        if parts[0] == "branches":
            branch = tree.setdefault(parts[1], {})
            if parts[2] == "part_proj":
                branch["part_proj"] = arr
            else:
                branch[parts[2]] = {"kernel": np.ascontiguousarray(
                    arr.transpose(2, 3, 1, 0))}
        elif parts[0] == "classprob":
            head = tree.setdefault("classprob", {})
            if parts[1] == "weight":
                head["kernel"] = np.ascontiguousarray(arr.T)
            else:
                head["bias"] = arr
        else:
            raise NotImplementedError(f"state_dict key {key!r} has no flax "
                                      "counterpart")
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
