"""The port's trace capture and busy-time union (utils/profiling.py; its
spans: tests/test_torch_spans.py) and its generate_video
(run/generate_video.py, as tests/test_cli_smoke.py::
test_generate_video_cli holds JAX's), on the CPU."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from mvgformer_tpu_torch.run import generate_video
from mvgformer_tpu_torch.utils.profiling import busy_seconds, span, trace

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_busy_seconds_is_the_union_of_the_spans():
    # microsecond spans: [0, 10) and [5, 20) overlap, [20, 25) touches,
    # [30, 31) stands apart, [12, 14) lies inside
    spans = [(30.0, 31.0), (5.0, 20.0), (0.0, 10.0), (12.0, 14.0),
             (20.0, 25.0)]
    assert busy_seconds(spans) == pytest.approx(26e-6)
    assert busy_seconds([]) == 0.0


def test_trace_writes_a_chrome_trace(tmp_path):
    with trace(str(tmp_path)) as log_dir:
        with span("mvg.step"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    assert log_dir == str(tmp_path)
    with open(tmp_path / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    (step,) = [e for e in events if e.get("name") == "mvg.step"]
    mm = [e for e in events if "mm" in e.get("name", "")]
    # the span holds the op it ran, on the same thread
    assert mm and all(step["ts"] <= e["ts"] and e["tid"] == step["tid"]
                      for e in mm)


def _frames(tmp_path, sizes):
    import cv2

    for i, (h, w) in enumerate(sizes):
        cv2.imwrite(str(tmp_path / f"{i}_joints3d.png"),
                    np.full((h, w, 3), i * 40, np.uint8))


def test_generate_video(tmp_path):
    import cv2

    # frame 10 after frame 2; a frame of another size is resized
    _frames(tmp_path, [(64, 96)] * 3 + [(32, 48)] * 8)
    out = generate_video.main(["--image_dir", str(tmp_path), "--out",
                               str(tmp_path / "vid.mp4"), "--pattern",
                               "*_joints3d.png", "--fps", "5"])
    cap = cv2.VideoCapture(out)
    frames = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
    size = (int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT)),
            int(cap.get(cv2.CAP_PROP_FRAME_WIDTH)))
    cap.release()
    assert frames == 11 and size == (64, 96)
    assert generate_video.natural_key("a/10_x.png") > \
        generate_video.natural_key("a/2_x.png")
    with pytest.raises(SystemExit, match="no images match"):
        generate_video.main(["--image_dir", str(tmp_path), "--pattern",
                             "*.jpg"])


def test_generate_video_as_a_module(tmp_path):
    _frames(tmp_path, [(64, 96)] * 4)
    out = tmp_path / "vid.mp4"
    res = subprocess.run(
        [sys.executable, "-m", "mvgformer_tpu_torch.run.generate_video",
         "--image_dir", str(tmp_path), "--out", str(out),
         "--pattern", "*_joints3d.png"],
        capture_output=True, text=True, cwd=REPO, timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]
    assert out.exists() and out.stat().st_size > 0
