"""Export a trained experiment as a self-contained serving artifact.

Port of ``ugaitnet_tpu/cli/export_model.py``, plus ``--device`` (default
``cuda``; the CPU only when asked for):

    python -m ugaitnet_tpu_torch.cli.export_model \\
        --experdir experiments/casiab_2mod --epoch best \\
        --out artifacts/casiab_2mod --buckets 1 8 32 128

Loads the checkpoint, bakes the weights (and a persisted
``norm_stats.npz``) into one ``torch.export`` program of the raw ->
signature encoder per batch bucket (``eval/export.py``), and writes a
directory that a serving process loads with ``ExportedEncoder(path)``:
no model code, checkpoint plumbing or retracing.  Export on the device type
you will serve on (the artifact is bound to it).

``--keras-h5 OUT --keras-template TEMPLATE`` also writes the checkpoint as
a reference-layout Keras h5 over a copy of TEMPLATE, an h5 that the
reference architecture's save_weights wrote (``utils/keras_export.py``;
needs h5py).
"""

from __future__ import annotations

import argparse
import time


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("ugaitnet-torch-export")
    p.add_argument("--experdir", type=str, required=True,
                   help="experiment dir (config.json + checkpoints)")
    p.add_argument("--epoch", type=str, default="-1",
                   help="checkpoint epoch, -1 = latest, 'best'")
    p.add_argument("--out", type=str, required=True,
                   help="output artifact directory")
    p.add_argument("--buckets", type=int, nargs="+", default=[1, 8, 32, 128],
                   help="query batch sizes to export")
    p.add_argument("--typecode", type=int, default=3)
    p.add_argument("--knn", type=int, default=3)
    p.add_argument("--ntype", type=int, default=2,
                   help="OF dequantization scale convention of the data "
                        "this artifact will serve (dataset ntype)")
    p.add_argument("--warmup", action="store_true",
                   help="load the artifact back and run every bucket once")
    p.add_argument("--keras-h5", type=str, default="",
                   help="ALSO write the checkpoint as a reference-layout "
                        "Keras h5 weights file at this path (loadable by "
                        "the original repo's mains) — requires "
                        "--keras-template")
    p.add_argument("--keras-template", type=str, default="",
                   help="an h5 produced by the reference architecture's "
                        "save_weights (e.g. any of its per-epoch "
                        "checkpoints); layer names/counters are copied "
                        "from it (utils/keras_export.py)")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to export for (default the CUDA "
                        "card; 'cpu' only when asked for)")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.keras_h5 and not args.keras_template:
        raise SystemExit("--keras-h5 needs --keras-template (an h5 saved by "
                         "the reference build — its layer names carry "
                         "process-global counters we cannot synthesize)")
    from ugaitnet_tpu_torch.cli.evaluate import load_experiment
    from ugaitnet_tpu_torch.data.pipeline import load_norm_stats
    from ugaitnet_tpu_torch.eval.export import ExportedEncoder, export_encoder
    from ugaitnet_tpu_torch.eval.serving import SignatureService

    model, _, mcfg, step = load_experiment(args.experdir, args.epoch,
                                           device=args.device)
    modalities = tuple(b.modality for b in mcfg.branches)
    if args.keras_h5:
        from ugaitnet_tpu_torch.models.deepgaitv2 import refuse
        from ugaitnet_tpu_torch.utils.keras_export import export_keras_weights
        from ugaitnet_tpu_torch.utils.weights import state_dict_to_flax
        refuse(mcfg, "Keras export")
        export_keras_weights(state_dict_to_flax(model.state_dict()),
                             args.keras_h5, args.keras_template)
        print(f"* wrote reference-layout Keras weights -> {args.keras_h5}",
              flush=True)
    # a model trained with --normstats needs its standardization baked in
    norm_stats = load_norm_stats(args.experdir, modalities)
    if norm_stats is not None:
        print("* baking persisted norm_stats.npz standardization into the "
              "artifact", flush=True)
    svc = SignatureService(model, modalities, typecode=args.typecode,
                           knn=args.knn, buckets=tuple(args.buckets),
                           ntype=args.ntype, norm_stats=norm_stats)
    sizes = export_encoder(svc, args.out, buckets=tuple(args.buckets))
    for b, n in sorted(sizes.items()):
        print(f"bucket {b:4d}: {n / 1e6:.1f} MB")
    print(f"exported epoch {step} -> {args.out}", flush=True)
    if args.warmup:
        t0 = time.perf_counter()
        ExportedEncoder(args.out, device=args.device, warmup=True)
        print(f"warmed {len(args.buckets)} buckets in "
              f"{time.perf_counter() - t0:.1f}s")
    return args.out


if __name__ == "__main__":
    main()
