"""Stitch saved per-frame debug images into an mp4.

    python -m mvgformer_tpu_torch.run.generate_video \
        --image_dir <dir with *.png/*.jpg> --out video.mp4 [--fps 15] \
        [--pattern "*_joints3d.png"]

The port's copy of run/generate_video.py (the original repository's
run/generate_video.py): the images in natural order (frame 2 before frame
10), resized to the first one's size, written with OpenCV's mp4v codec.
"""

from __future__ import annotations

import argparse
import glob
import os
import re
from typing import Optional, Sequence


def natural_key(path: str):
    return [int(t) if t.isdigit() else t
            for t in re.split(r"(\d+)", os.path.basename(path))]


def main(argv: Optional[Sequence[str]] = None) -> str:
    """Write the video; returns its path."""
    parser = argparse.ArgumentParser(
        description="Stitch debug images into an mp4")
    parser.add_argument("--image_dir", required=True)
    parser.add_argument("--out", default="video.mp4")
    parser.add_argument("--fps", type=int, default=15)
    parser.add_argument("--pattern", default="*.png")
    args = parser.parse_args(argv)

    import cv2

    files = sorted(glob.glob(os.path.join(args.image_dir, args.pattern)),
                   key=natural_key)
    if not files:
        raise SystemExit(f"no images match {args.pattern} in "
                         f"{args.image_dir}")
    first = cv2.imread(files[0])
    h, w = first.shape[:2]
    writer = cv2.VideoWriter(
        args.out, cv2.VideoWriter_fourcc(*"mp4v"), args.fps, (w, h))
    for f in files:
        img = cv2.imread(f)
        if img is None:
            continue
        if img.shape[:2] != (h, w):
            img = cv2.resize(img, (w, h))
        writer.write(img)
    writer.release()
    print(f"wrote {args.out} ({len(files)} frames at {args.fps} fps)")
    return args.out


if __name__ == "__main__":
    main()
