"""The benchmark of ugaitnet_tpu_torch on one NVIDIA card.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

runs cell ``portbench/workloads/<cell>.json`` (its configuration is
``portbench/configs/<config>.json``, its traffic kind
``portbench/drivers/<kind>.py``): set-up, a window of ``--seconds``, then
the check of the window's outputs against the plain reference
(``portbench/reference``).  The last line of standard output is one JSON
object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics of BENCHMARK.json, or with ``--trace 1`` its per-layer
metrics, read by ``portbench/metrics/<metric>.py``), ``device``, with
``--trace 1`` ``breakdown``, and last ``checks``: each number compared
with its limit, which also end standard error.  The cell's ``limits``
name the numbers it compares; the driver's other readings go to the
record on standard error, unchecked.

Measurement only, never in a checked run: ``--control tf32`` runs the
program with TF32 on (train cells); ``--control fp8`` puts the reference
computed in fp8 in the program's place in the check (the bf16 encode);
``--readings 1`` adds the readings of the reference put in the program's
place with a planted fault (train cells).
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
FORBIDDEN = ("jax", "jaxlib", "flax", "ugaitnet_tpu")


def cache_env(root: str) -> None:
    """Build and kernel caches at fixed paths inside the checkout (the
    program's nvcc builds already go to build/kernels there)."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
        os.environ[var] = os.path.join(root, "build", "portbench", sub)
    os.environ.setdefault("USE_FLAX", "0")


def load_json(*parts: str) -> dict:
    with open(os.path.join(BENCH, *parts)) as f:
        return json.load(f)


def load_file(name: str, path: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules(modules) -> list:
    """Loaded modules whose top-level name is a forbidden one, compared
    whole (``ugaitnet_tpu_torch`` is not ``ugaitnet_tpu``)."""
    return sorted({m for m in modules if m.split(".")[0] in FORBIDDEN})


def cell_metrics(name: str, key: str) -> list:
    """The BENCHMARK.json metrics of list ``key`` that cell ``name``
    reports: those whose ``workloads`` name it, or that have none."""
    path = os.path.join(ROOT, "BENCHMARK.json")
    if not os.path.exists(path):
        return []
    with open(path) as f:
        bench = json.load(f)
    return [m for m in bench[key]
            if name in m.get("workloads", [name])]


class Context:
    """What a driver gets: the cell and its configuration, the run's
    arguments, the host-clock spans, the tracer and the set-up clock."""

    def __init__(self, cell, cfg, seed, seconds, trace, device,
                 control=None, readings=False, t_start=None):
        import torch
        from portbench.harness import Spans, Tracer
        self.cell, self.cfg, self.seed, self.seconds = cell, cfg, seed, seconds
        self.trace, self.device = trace, torch.device(device)
        self.control, self.readings = control, readings
        self.tf32 = control == "tf32"
        self.t_start = T_START if t_start is None else t_start
        self.setup_s = None
        self.phases = {}
        self._phase_t = self.t_start
        self.memory_peak = 0
        self.spans = Spans(trace)
        tmp = os.environ.get("TMPDIR", "/tmp")
        t = cell.get("trace", {})
        self.tracer = Tracer(trace and self.device.type == "cuda",
                             t.get("active", 4),
                             t.get("start_share", 0.2) * seconds,
                             os.path.join(tmp, f"portbench_{os.getpid()}"
                                               ".trace.json"))

    def phase(self, name: str) -> None:
        """Mark the end of a set-up phase (seconds kept in the record)."""
        t = time.perf_counter()
        self.phases[name] = t - self._phase_t
        self._phase_t = t

    def mark_setup_done(self) -> None:
        import torch
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        self.phase("warm-up")
        self.setup_s = time.perf_counter() - self.t_start

    def read_memory_peak(self) -> None:
        import torch
        if self.device.type == "cuda":
            self.memory_peak = torch.cuda.max_memory_allocated(self.device)


def execute(cell: dict, cfg: dict, seed: int, seconds: float, trace: bool,
            device: str = "cuda", control=None,
            readings: bool = False, t_start=None) -> dict:
    """Run one cell and return its result object (without printing)."""
    from portbench.harness import read_trace, set_precision
    set_precision(control == "tf32")
    ctx = Context(cell, cfg, seed, seconds, trace, device, control, readings,
                  t_start)
    driver = load_file(f"portbench_driver_{cell['kind']}",
                       os.path.join(BENCH, "drivers", f"{cell['kind']}.py"))
    out = driver.run(ctx)
    limits = cell["limits"]
    checks = {k: {"value": v, "limit": limits[k]}
              for k, v in out["readings"].items() if k in limits}
    correct = (out["failed"] == 0
               and all(c["value"] <= c["limit"] for c in checks.values()))
    e2e = dict(out["metrics"], setup_s=ctx.setup_s)
    rec = dict(out["record"], spans=dict(ctx.spans.times),
               setup_phases=ctx.phases,
               unchecked={k: v for k, v in out["readings"].items()
                          if k not in limits})
    res = {"correct": correct, "attempted": out["attempted"],
           "failed": out["failed"], "metrics": {}, "device": {}}
    if trace:
        tr = read_trace(ctx.tracer)
        rec["trace"] = tr
        for m in cell_metrics(cell["name"], "per_layer"):
            reader = load_file(
                f"portbench_metric_{m['name']}",
                os.path.join(BENCH, "metrics", f"{m['name']}.py"))
            v = reader.read(rec)
            if v is not None:
                res["metrics"][m["name"]] = {"value": v, "unit": m["unit"]}
        if tr:
            res["device"].update(busy_s=tr["busy_s"], window_s=tr["window_s"])
            res["breakdown"] = {"device_ops": tr["device_ops"],
                                "idle_gaps": tr["idle_gaps"]}
    else:
        for m in cell_metrics(cell["name"], "end_to_end"):
            if m["name"] in e2e:
                res["metrics"][m["name"]] = {"value": e2e[m["name"]],
                                             "unit": m["unit"]}
    res["device"] = dict(device_info(ctx), **res["device"])
    res["record"] = rec
    res["extra"] = out["extra"]
    res["checks"] = checks
    return res


def device_info(ctx) -> dict:
    import torch
    if ctx.device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": ctx.cell.get("chips", 1),
            "memory_peak_bytes": int(ctx.memory_peak)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser("portbench")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, default=0, choices=(0, 1))
    ap.add_argument("--control", choices=("tf32", "fp8"), default=None)
    ap.add_argument("--readings", type=int, default=0, choices=(0, 1))
    args = ap.parse_args(argv)
    cache_env(ROOT)
    sys.path.insert(0, ROOT)

    cell = load_json("workloads", f"{args.workload}.json")
    cfg = load_json("configs", f"{cell['config']}.json")
    import torch
    chips = cell.get("chips", 1)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: cell {args.workload} needs {chips} CUDA "
              f"device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(ROOT, "ugaitnet_tpu_torch")):
        print("portbench: the program (ugaitnet_tpu_torch) is not in this "
              "checkout", file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    res = execute(cell, cfg, args.seed, args.seconds, bool(args.trace),
                  control=args.control, readings=bool(args.readings))
    bad = forbidden_modules(sys.modules)
    if bad:
        print(f"portbench: forbidden modules loaded: {bad}", file=sys.stderr)
        return 3
    record, extra = res.pop("record"), res.pop("extra")
    spans = record.pop("spans")
    record["spans"] = {k: [len(v), sum(v)] for k, v in spans.items()}
    print(f"record {json.dumps(record, default=str)}", file=sys.stderr)
    if extra:
        print(f"readings {json.dumps(extra)}", file=sys.stderr)
    for name, c in res["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
