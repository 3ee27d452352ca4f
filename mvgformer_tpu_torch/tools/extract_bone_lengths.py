"""Average ground-truth bone lengths and T-pose offsets of a dataset.

    python -m mvgformer_tpu_torch.tools.extract_bone_lengths --cfg <yaml> \
        [--subset train] [--max_frames 300] [--out assets/] \
        [--tree cmupanoptic] [--device cuda] [KEY.SUB=value ...]

The port of tools/extract_bone_lengths.py: the dataset's ground-truth 3D
poses (the frames' `joints_3d`, or for datasets that make their frames
lazily, such as the synthetic one, each frame's batch targets) are turned
into bones with the kinematic tree (`geometry.structural.HumanTree`), and
the mean bone lengths (the prior of triangulation 'st') and the mean
root-relative joint offsets (the T-pose that DECODER.t_pose_dir reads) are
saved as bone_lengths.npy and tpose.npy. The statistics are computed on
the host, as in the JAX tool; `--device` defaults to the card and raises
without one, as every tool of the port does, so `--device cpu` runs it on
a machine with none.
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence

import numpy as np


def gt_poses(ds, num_joints: int, max_frames: int) -> np.ndarray:
    """Up to max_frames ground-truth poses (F, J, 3) of `ds`."""
    poses = []
    for fr in getattr(ds, "frames", []):
        gt = fr.get("joints_3d") if isinstance(fr, dict) else None
        if gt is None or not np.asarray(gt).size:
            continue
        for p in np.asarray(gt, dtype=np.float32):
            if p.shape[0] == num_joints:
                poses.append(p)
        if len(poses) >= max_frames:
            break
    if not poses:
        # datasets with lazy frames (synthetic): pull batches
        for i in range(min(len(ds), max_frames)):
            b = ds.load_batch([i], load_images=False)
            n = int(b.targets.num_person[0])
            for p in b.targets.joints_3d[0][:n].numpy():
                poses.append(np.asarray(p, np.float32))
    if not poses:
        raise SystemExit("no ground-truth poses found")
    return np.stack(poses[:max_frames])


def main(argv: Optional[Sequence[str]] = None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cfg", required=True)
    ap.add_argument("--subset", default=None,
                    help="dataset subset (default: cfg TRAIN_SUBSET)")
    ap.add_argument("--max_frames", type=int, default=300,
                    help="poses to average over")
    ap.add_argument("--out", default="assets")
    ap.add_argument("--tree", default="cmupanoptic")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args, overrides = ap.parse_known_args(argv)

    from mvgformer_tpu_torch.config import load_config
    from mvgformer_tpu_torch.data.datasets import get_dataset
    from mvgformer_tpu_torch.device import resolve_device
    from mvgformer_tpu_torch.geometry.structural import HumanTree

    resolve_device(args.device)

    cfg = load_config(args.cfg, overrides)
    ds = get_dataset(cfg, args.subset or cfg.DATASET.TRAIN_SUBSET,
                     is_train=True)
    tree = HumanTree(args.tree)
    poses = gt_poses(ds, tree.size, args.max_frames)
    lengths = tree.bone_lengths(poses)  # (F, J-1)
    mean_len = lengths.mean(axis=0)
    std_len = lengths.std(axis=0)

    root = cfg.DATASET.ROOTIDX
    tpose = (poses - poses[:, root:root + 1]).mean(axis=0)  # (J, 3)

    os.makedirs(args.out, exist_ok=True)
    np.save(os.path.join(args.out, "bone_lengths.npy"), mean_len)
    np.save(os.path.join(args.out, "tpose.npy"), tpose)
    print(f"poses used: {len(poses)}")
    for i, (m, s) in enumerate(zip(mean_len, std_len)):
        print(f"bone {i:2d}: {m:8.2f} mm +- {s:6.2f}")
    print(f"saved {args.out}/bone_lengths.npy and {args.out}/tpose.npy")
    return mean_len, tpose


if __name__ == "__main__":
    main()
