"""Host input-pipeline serving-rate benchmark, onto the card.

    python -m mvgformer_tpu_torch.tools.bench_host_pipeline [--frames 40] \
        [--threads 1 2 4 8] [--out FILE] [--device cuda]

The port of tools/bench_host_pipeline.py. A served frame pays, on the host:
5 x (JPEG decode of a 1920x1080 camera image -> affine crop-warp to 960x512
-> ImageNet normalization), then one host-to-device copy. This measures
whether the host can feed the device: it synthesizes five 1920x1080 JPEGs
(quality 90, low-frequency content plus noise, so the decode cost is
representative), and runs them through the port's own code:
data.datasets._load_image / _load_and_warp_image, the native warp of
`runtime` where it builds (else cv2), the center-crop affine of
geometry.transforms, and data.prefetch.DevicePlacer for the copy (pinned
memory, a copy stream), waited for with torch.cuda.synchronize.

It prints each stage's milliseconds (single thread), then frames/s of the
whole pipeline at each thread count, and one JSON summary line (appended
to --out where given). cv2 is needed (to write and read the JPEGs); it is
imported only where an image is made or read. `--device` defaults to the
card and raises without one.
"""

from __future__ import annotations

import argparse
import concurrent.futures as cf
import json
import os
import shutil
import tempfile
import time
from typing import Optional, Sequence

import numpy as np
import torch

V = 5
RAW_WH = (1920, 1080)
NET_WH = (960, 512)


def make_images(tmpdir):
    """Five synthetic camera JPEGs with natural-ish spectra."""
    import cv2

    rng = np.random.RandomState(0)
    paths = []
    for v in range(V):
        small = rng.randint(0, 255, (68, 120, 3), dtype=np.uint8)
        img = cv2.resize(small, RAW_WH, interpolation=cv2.INTER_CUBIC)
        noise = rng.randint(0, 30, img.shape, dtype=np.uint8)
        img = cv2.add(img, noise)
        p = os.path.join(tmpdir, f"cam{v}.jpg")
        cv2.imwrite(p, img, [cv2.IMWRITE_JPEG_QUALITY, 90])
        paths.append(p)
    sizes = [os.path.getsize(p) for p in paths]
    print(f"images: {RAW_WH[0]}x{RAW_WH[1]} jpeg, "
          f"{min(sizes)//1024}-{max(sizes)//1024} KB", flush=True)
    return paths


def center_affine() -> np.ndarray:
    """The center-crop affine of the data path (build_view_data's per-view
    2x3) for the synthetic camera: the 1920x1080 image onto the 960x512
    network canvas about the image center."""
    from mvgformer_tpu_torch.geometry.transforms import (get_affine_transform,
                                                         get_scale)

    c = np.array([RAW_WH[0] / 2.0, RAW_WH[1] / 2.0], dtype=np.float32)
    s = get_scale(RAW_WH, NET_WH)
    return get_affine_transform(c, s, np.asarray(NET_WH)).numpy().astype(
        np.float32)


def decode(paths):
    from mvgformer_tpu_torch.data.datasets import _load_image

    return np.stack([_load_image(p) for p in paths])


def warp(paths, raw, aff, native: bool) -> np.ndarray:
    """(V, 512, 960, 3) float32 normalized views: the native warp of the
    decoded images, or cv2 from the files."""
    from mvgformer_tpu_torch import runtime
    from mvgformer_tpu_torch.data.datasets import _load_and_warp_image

    if native:
        return runtime.warp_normalize_views(raw, aff, NET_WH)
    return np.stack([_load_and_warp_image(paths[v], aff[v], NET_WH)
                     for v in range(V)])


def main(argv: Optional[Sequence[str]] = None) -> dict:
    from mvgformer_tpu_torch import runtime
    from mvgformer_tpu_torch.data.prefetch import DevicePlacer
    from mvgformer_tpu_torch.device import resolve_device

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=40)
    ap.add_argument("--threads", type=int, nargs="*", default=[1, 2, 4, 8])
    ap.add_argument("--out", default=None,
                    help="append the JSON summary to this file")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    placer = DevicePlacer(device)

    def put(views):
        placed = placer.ready(placer.place(torch.from_numpy(views[None])))
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return placed

    tmpdir = tempfile.mkdtemp(prefix="hostbench_")
    try:
        paths = make_images(tmpdir)
        aff = np.stack([center_affine() for _ in range(V)])
        native = runtime.native_available()

        # --- stage timings (single thread)
        t0 = time.perf_counter()
        for _ in range(10):
            raw = decode(paths)
        t_decode = (time.perf_counter() - t0) / 10
        t0 = time.perf_counter()
        for _ in range(10):
            views = warp(paths, raw, aff, native)
        t_warp = (time.perf_counter() - t0) / 10
        t0 = time.perf_counter()
        for _ in range(10):
            put(views)
        t_put = (time.perf_counter() - t0) / 10

        print(f"stage decode 5 views: {t_decode*1e3:8.1f} ms", flush=True)
        print(f"stage warp+norm ({'native' if native else 'cv2'}): "
              f"{t_warp*1e3:8.1f} ms", flush=True)
        print(f"stage placement on {device}: {t_put*1e3:8.1f} ms",
              flush=True)

        def one_frame(_):
            return put(warp(paths, decode(paths), aff, native)).shape

        rows = {}
        for nt in args.threads:
            one_frame(0)  # warm
            t0 = time.perf_counter()
            if nt == 1:
                for i in range(args.frames):
                    one_frame(i)
            else:
                with cf.ThreadPoolExecutor(nt) as ex:
                    list(ex.map(one_frame, range(args.frames)))
            fps = args.frames / (time.perf_counter() - t0)
            rows[nt] = round(fps, 2)
            print(f"end-to-end host pipeline, {nt} thread(s): "
                  f"{fps:6.2f} frames/s", flush=True)
    finally:
        shutil.rmtree(tmpdir, ignore_errors=True)

    summary = {"bench": "host_input_pipeline",
               "raw_wh": list(RAW_WH), "net_wh": list(NET_WH),
               "views": V, "native_warp": bool(native),
               "device": (torch.cuda.get_device_name(device)
                          if device.type == "cuda" else "cpu"),
               "stage_ms": {"decode5": round(t_decode * 1e3, 1),
                            "warp5": round(t_warp * 1e3, 1),
                            "device_put": round(t_put * 1e3, 1)},
               "frames_per_s_by_threads": rows}
    print(json.dumps(summary), flush=True)
    if args.out:
        with open(args.out, "a") as f:
            f.write(json.dumps(summary) + "\n")
    return summary


if __name__ == "__main__":
    main()
