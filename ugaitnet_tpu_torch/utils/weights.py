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
