"""Dataset build entry point.

Port of ``ugaitnet_tpu/cli/build_data.py``: host code only (numpy, with h5py
for --import-ref and cv2 for decoding videos, each imported where it is
used), so it needs no card and no --device:

    python -m ugaitnet_tpu_torch.cli.build_data --synthetic --outdir /data/x

Mirrors the reference's generate*Data.py CLIs
((reference) data/generateOFData.py:25-49) but emits packed GaitDataset
directories (one gather per training batch) instead of one h5 per window.

Two source modes:
  --import-ref DIR   convert an existing reference-format per-sample h5
                     directory (the output of the original scripts)
  --ofdir/--videodir + --trackdir
                     build from raw OF .npz / video files + track .pkl files
                     laid out like the reference expects
  --synthetic        emit a synthetic packed dataset (smoke/testing)
  --merge DIR [DIR ...]
                     align already-packed single-modality datasets (built
                     from the same videos, e.g. one --import-ref run per
                     modality) into one multimodal dataset
"""

from __future__ import annotations

import argparse
import os
import pickle

import numpy as np


def build_parser():
    p = argparse.ArgumentParser("ugaitnet-torch-build-data")
    p.add_argument("--outdir", type=str, required=True)
    p.add_argument("--modality", type=str, default="of",
                   choices=["of", "gray", "depth", "silhouette", "rgb"])
    p.add_argument("--dataset", type=str, default="casiab")
    p.add_argument("--mode", type=str, default="train",
                   help="train | ft | test_nm | test_bg | test_cl | elapsed")
    p.add_argument("--subject-ids", type=str, default="",
                   help="subject id list: a file with one id per line "
                        "(OU-MVLP's ID_list_train.txt / ID_list_test.txt, "
                        "reference datasetInfo.py:260-285) or a comma-"
                        "separated list; required for oumvlp train/ft")
    p.add_argument("--import-ref", type=str, default="",
                   help="reference-format per-sample h5 dir to convert")
    p.add_argument("--ofdir", type=str, default="")
    p.add_argument("--videodir", type=str, default="")
    p.add_argument("--trackdir", type=str, default="")
    p.add_argument("--nframes", type=int, default=25)
    p.add_argument("--step", type=int, default=5)
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--merge", type=str, nargs="+", default=[],
                   help="packed single-modality dataset dirs to align into "
                        "one multimodal dataset (written to --outdir)")
    return p


def _parse_subject_ids(arg: str):
    """--subject-ids: a file of one id per line (the OU-MVLP ID_list_*.txt
    format, reference datasetInfo.py:260-264) or a comma-separated list."""
    if not arg:
        return None
    if os.path.exists(arg):
        with open(arg) as f:
            return [int(line) for line in f.read().split() if line.strip()]
    return [int(s) for s in arg.split(",") if s.strip()]


def _iter_raw_videos(args):
    """Yield TrackedVideo items from raw OF/video + track files following the
    reference naming: <subject><condition>[-<cam>].{npz,avi} + .pkl."""
    from ugaitnet_tpu_torch.data.builders import TrackedVideo, load_video_frames
    from ugaitnet_tpu_torch.data.partitions import get_partition

    spec = get_partition(args.dataset, args.mode,
                         subject_ids=_parse_subject_ids(args.subject_ids))
    video_id = 0
    for sid in spec.subject_ids:
        for cond in spec.conditions:
            cams = spec.cameras or (0,)
            for cam in cams:
                if args.dataset.startswith("casia"):
                    stem = f"{sid:03d}-{cond}-{cam:03d}"
                elif spec.dataset == "oumvlp":
                    # OU-MVLP naming: 5-digit subject, bare sequence number,
                    # 3-digit camera (subject_pattern '{:05d}' + '-00-'/'-01-'
                    # + cam, reference datasetInfo.py:254-276)
                    stem = f"{sid:05d}-{cond}-{cam:03d}"
                else:
                    stem = f"p{sid:03d}-{cond}"
                track_path = os.path.join(args.trackdir, stem + ".pkl")
                if not os.path.exists(track_path):
                    continue
                with open(track_path, "rb") as f:
                    tracks, frame_ids = pickle.load(f)
                if not len(tracks):
                    continue
                if args.modality == "of":
                    src = os.path.join(args.ofdir, stem + ".npz")
                    if not os.path.exists(src):
                        continue
                    of = np.load(src)["of"]
                    frames = np.moveaxis(of, 1, -1)
                else:
                    src = os.path.join(args.videodir, stem + ".avi")
                    if not os.path.exists(src):
                        continue
                    frames = load_video_frames(
                        src, gray=(args.modality != "rgb"))
                video_id += 1
                # OF arrays stay whole and extract_windows selects frames
                # by their track frame ids (generateOFData.py:106-109);
                # decoded videos are pre-indexed by those ids, so their
                # frames are already track-aligned (frame_ids=None)
                yield TrackedVideo(
                    frames=frames[np.asarray(frame_ids[0], int)]
                    if args.modality != "of" else frames,
                    boxes=np.asarray(tracks[0], float),
                    label=sid, gait=spec.gait_of[cond], cam=cam,
                    video_id=video_id,
                    frame_ids=(np.asarray(frame_ids[0], int)
                               if args.modality == "of" else None))


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.merge:
        from ugaitnet_tpu_torch.data.builders import merge_modalities
        from ugaitnet_tpu_torch.data.schema import GaitDataset
        # the inputs are mmap'd; saving over one would truncate pages the
        # merge output still reads (SIGBUS / corrupt store)
        out = os.path.realpath(args.outdir)
        for d in args.merge:
            if os.path.realpath(d) == out:
                raise SystemExit(f"--outdir must differ from input {d}")
        parts = [GaitDataset.load(d) for d in args.merge]
        ds = merge_modalities(parts, name=os.path.basename(
            args.outdir.rstrip("/")) or "merged")
    elif args.synthetic:
        from ugaitnet_tpu_torch.data.synthetic import make_synthetic_dataset
        ds = make_synthetic_dataset()
    elif args.import_ref:
        from ugaitnet_tpu_torch.data.convert import import_reference_dir
        ds = import_reference_dir(args.import_ref, args.modality)
    else:
        from ugaitnet_tpu_torch.data.builders import build_dataset
        if not args.trackdir:
            raise SystemExit("need --import-ref, --synthetic, or raw dirs")
        # the OF builder reads .npy flow fields from --ofdir; every other
        # modality decodes .avi videos from --videodir — accepting the
        # wrong one would silently pack a 0-sample dataset
        if args.modality == "of" and not args.ofdir:
            raise SystemExit("--modality of needs --ofdir")
        if args.modality != "of" and not args.videodir:
            raise SystemExit(f"--modality {args.modality} needs --videodir")
        ds = build_dataset(
            _iter_raw_videos(args), args.modality,
            name=f"{args.dataset}_{args.mode}_{args.modality}",
            n_frames=args.nframes, step=args.step)
    ds.save(args.outdir)
    print(f"* packed {len(ds)} samples "
          f"({', '.join(ds.modality_names)}) -> {args.outdir}")


if __name__ == "__main__":
    main()
