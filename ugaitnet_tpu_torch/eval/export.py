"""Serving artifacts: the raw -> signature encoder as ``torch.export``
programs.

Port of ``ugaitnet_tpu/eval/export.py``.  The JAX package writes one
StableHLO executable per batch bucket; the port writes one
``torch.export`` program per bucket, with the trained (or int8) weights
and any standardization stats inside, so a serving process needs no model
code, checkpoint plumbing or retracing: it loads one file per bucket and
calls it.  This module imports nothing of the port's models.

Layout on disk (one directory):
    meta.json            the JAX package's keys (modalities, channels,
                         compress_factors, typecode, buckets, platform,
                         ntype, normalized, has_source, norm_sources), plus
                         code_dim, code_dtype and quantized
    encode_b{N}.pt2      the program for batch bucket N

Artifacts are bound to the device type that exported them ("cuda" or
"cpu" in ``meta["platform"]``); ``ExportedEncoder`` refuses another.  TF32
is a setting of the serving process, not of the artifact: codes equal the
exporting service's only under the same ``torch.backends`` TF32 flags
(the port's parity setting is off).

On the card the GaitSet stage tail is the custom op
``ugaitnet::stage_tail`` (``ops/cuda/stage_tail.py``), and in a bf16 net
a_conv2 and a_conv6 are ``ugaitnet::conv3x3`` (``ops/cuda/conv3x3.py``;
the export traces without autograd), which the program records as it
records aten ops, so an artifact serves through the same kernels as the
service.  ``meta["custom_ops"]`` lists the port's ops a
program calls; the loader imports the module that registers each (kernel
code, which builds nothing at import) and still no model code.
"""

from __future__ import annotations

import importlib
import json
import os
from typing import Dict, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ugaitnet_tpu_torch.core.config import FRAME_H, FRAME_W, NUM_FRAMES
from ugaitnet_tpu_torch.core.device import DeviceLike, resolve_device

# the port's custom ops an exported program may call, and the module whose
# import registers each
CUSTOM_OP_MODULES = {
    "ugaitnet::stage_tail": "ugaitnet_tpu_torch.ops.cuda.stage_tail",
    "ugaitnet::conv3x3": "ugaitnet_tpu_torch.ops.cuda.conv3x3",
}


def _custom_ops(prog) -> list:
    """The port's custom ops (``ugaitnet::``) that ``prog``'s graph calls."""
    return sorted({n.target.name() for n in prog.graph.nodes
                   if n.op == "call_function"
                   and isinstance(n.target, torch._ops.OpOverload)
                   and n.target.namespace == "ugaitnet"})


def _raw_specs(modalities, channels, compress_factors, batch: int,
               with_source: bool = False
               ) -> Dict[str, Tuple[Tuple[int, ...], np.dtype]]:
    """(shape, dtype) of each entry of the service's raw feed at one bucket
    size: interleaved quantized planes (B, T*C, H, W) per modality, int16
    where the quantization factor is > 1 and uint8 otherwise, presence
    flags, labels, and the dataset source where standardization needs it
    (without it a multi-source artifact would standardize every query
    with source 0's statistics)."""
    spec = {}
    for m, c, f in zip(modalities, channels, compress_factors):
        spec[f"raw_{m}"] = ((batch, NUM_FRAMES * c, FRAME_H, FRAME_W),
                            np.dtype(np.int16 if f > 1 else np.uint8))
        spec[f"present_{m}"] = ((batch,), np.dtype(np.float32))
    spec["labels"] = ((batch,), np.dtype(np.int32))
    if with_source:
        spec["source"] = ((batch,), np.dtype(np.int32))
    return spec


class _Encoder(nn.Module):
    """The service's encode as a module: its net (float or int8) is a
    submodule, so the export lifts the weights as parameters / buffers."""

    def __init__(self, service):
        super().__init__()
        self.net = service._qnet if service.quantized else service.model
        self.service = service

    def forward(self, raw: Dict[str, torch.Tensor]) -> torch.Tensor:
        return self.service._encode(dict(raw))


def export_encoder(service, out_dir: str,
                   buckets: Sequence[int] = ()) -> Dict[int, int]:
    """Export ``service``'s raw -> codes encoder (a SignatureService, float
    or quantized), weights inside, one program per batch bucket, on the
    service's device.  Returns {bucket: file bytes}."""
    os.makedirs(out_dir, exist_ok=True)
    buckets = tuple(sorted(buckets or service.buckets))
    with_source = service.norm_stats is not None
    enc = _Encoder(service).eval()
    sizes: Dict[int, int] = {}
    code = None
    custom_ops = set()
    for b in buckets:
        spec = _raw_specs(service.modalities, service.channels,
                          service.compress_factors, b,
                          with_source=with_source)
        raw = {k: torch.zeros(shape, dtype=torch.from_numpy(
                   np.zeros((), dt)).dtype, device=service.device)
               for k, (shape, dt) in spec.items()}
        with torch.no_grad():
            prog = torch.export.export(enc, (raw,))
            if code is None:
                code = prog.module()(raw)
        custom_ops.update(_custom_ops(prog))
        prog.example_inputs = None     # zeros of the bucket's size
        path = os.path.join(out_dir, f"encode_b{b}.pt2")
        torch.export.save(prog, path)
        sizes[b] = os.path.getsize(path)
    meta = {
        "modalities": list(service.modalities),
        "channels": list(service.channels),
        "compress_factors": list(service.compress_factors),
        "typecode": service.typecode,
        "buckets": list(buckets),
        "platform": service.device.type,
        "ntype": service.ntype,
        "normalized": with_source,
        "has_source": with_source,
        "norm_sources": service.norm_sources,
        "code_dim": int(code.shape[-1]),
        "code_dtype": str(code.dtype).replace("torch.", ""),
        "quantized": bool(service.quantized),
        "custom_ops": sorted(custom_ops),
    }
    with open(os.path.join(out_dir, "meta.json"), "w") as f:
        json.dump(meta, f, indent=1)
    return sizes


class ExportedEncoder:
    """Load an ``export_encoder`` directory and serve ``encode`` from it:
    no model code, checkpoint or retracing involved."""

    def __init__(self, path: str, device: DeviceLike = None,
                 warmup: bool = False):
        """device: None means the CUDA card; the artifact must have been
        exported for this device type.  warmup=True runs every bucket once
        on zeros at load time."""
        with open(os.path.join(path, "meta.json")) as f:
            self.meta = json.load(f)
        self.device = resolve_device(device)
        if self.meta["platform"] != self.device.type:
            raise RuntimeError(
                f"artifact at {path} was exported for platform "
                f"{self.meta['platform']!r} but this encoder runs on "
                f"{self.device.type!r}; re-export on the serving platform "
                "(cli/export_model.py)")
        self.modalities = tuple(self.meta["modalities"])
        self.buckets = tuple(self.meta["buckets"])
        self.code_dim = int(self.meta["code_dim"])
        self.code_dtype = np.dtype(self.meta["code_dtype"])
        for op in self.meta.get("custom_ops", ()):
            importlib.import_module(CUSTOM_OP_MODULES[op])
        self._fns = {b: torch.export.load(
                         os.path.join(path, f"encode_b{b}.pt2")).module()
                     for b in self.buckets}
        if warmup:
            self.warmup()

    def warmup(self) -> None:
        """Run every bucket once on zero batches."""
        for b in self.buckets:
            spec = _raw_specs(self.modalities, self.meta["channels"],
                              self.meta["compress_factors"], b,
                              with_source=self.meta["has_source"])
            self.encode({k: np.zeros(shape, dt)
                         for k, (shape, dt) in spec.items()
                         if k.startswith("raw_") or k == "source"})

    def _bucket(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        return -1   # chunk through the largest bucket

    def encode(self, raw: Dict[str, np.ndarray]) -> np.ndarray:
        """raw: {"raw_<mod>": (B, T*C, H, W) quantized planes, optional
        "present_<mod>": (B,) flags, "source": (B,) where the artifact
        standardizes with several sources}.  Pads to the nearest bucket by
        repeating the last row, with presence 0 on the pad rows."""
        n = next(v.shape[0] for k, v in raw.items() if k.startswith("raw_"))
        if n == 0:
            # an empty query has an empty answer, in the artifact's dtype
            return np.zeros((0, self.code_dim), self.code_dtype)
        b = self._bucket(n)
        if b < 0:
            big = self.buckets[-1]
            return np.concatenate([
                self.encode({k: np.asarray(v)[s:s + big]
                             for k, v in raw.items()})
                for s in range(0, n, big)])
        feed = {}
        for m in self.modalities:
            v = np.asarray(raw[f"raw_{m}"])
            if n < b:
                v = np.concatenate([v, np.repeat(v[-1:], b - n, axis=0)])
            pres = np.asarray(raw.get(f"present_{m}", np.ones(n, np.float32)),
                              np.float32)
            feed[f"raw_{m}"] = v
            feed[f"present_{m}"] = np.concatenate(
                [pres, np.zeros(b - n, np.float32)])
        feed["labels"] = np.zeros(b, np.int32)
        if self.meta["has_source"]:
            if self.meta["norm_sources"] > 1 and "source" not in raw:
                raise ValueError(
                    "this artifact standardizes with "
                    f"{self.meta['norm_sources']} dataset-source stat rows; "
                    "queries must carry a 'source' entry selecting each "
                    "sample's dataset")
            src = np.asarray(raw.get("source", np.zeros(n, np.int32)))
            feed["source"] = np.concatenate(
                [src, np.zeros(b - n, src.dtype)]).astype(np.int32)
        feed = {k: torch.from_numpy(np.ascontiguousarray(v)).to(self.device)
                for k, v in feed.items()}
        with torch.no_grad():
            codes = self._fns[b](feed)
        return codes[:n].cpu().numpy()
