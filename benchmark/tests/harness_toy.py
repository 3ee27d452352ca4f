"""Tiny sizes of the benchmark's cells for the CPU tests: the cell's own
configuration file with its widths cut down, a short ring, and a run of
the cell's loop on the CPU through `run.run_cell`, which skips the
harness's look for a card."""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

CHECKOUT = Path(__file__).resolve().parents[2]
if str(CHECKOUT) not in sys.path:
    sys.path.insert(0, str(CHECKOUT))

import torch  # noqa: E402

from benchmark import run  # noqa: E402

TOY = {"NETWORK.IMAGE_SIZE": [96, 64], "DECODER.d_model": 32,
       "DECODER.nhead": 4, "DECODER.dim_feedforward": 64,
       "DECODER.dec_n_points": 4, "DECODER.num_decoder_layers": 2,
       "DECODER.num_instance": 16, "DATASET.CAMERA_NUM": 3,
       "MULTI_PERSON.MAX_PEOPLE_NUM": 4,
       "POSE_RESNET.NUM_DECONV_FILTERS": [32, 32, 32],
       "POSE_RESNET.NUM_LAYERS": 18}
TOY_DQ = {"DECODER.inference_topk_queries": 4,
          "DECODER.inference_point_topm": 2}
CONFIGS = {"mvgformer_panoptic5": "dq_serve_live_b1",
           "mvp_panoptic5": "mvp_serve_live_b1"}
TRAIN_TRAFFIC = {"loop": "train", "batch": 1, "ring_frames": 4,
                 "people": [1, 2, 3, 4], "cam_seed": 0,
                 "image_wh": [1920, 1080], "check_steps": 3,
                 "warmup_steps": 1,
                 "trace_units": 1}
# the float32 port against the float32 reference at toy widths reads
# under 1e-3 of a leaf's gradient or change (Adam's normalized change
# moves near-zero gradients' elements most: the worst leaf up to 5e-4)
TRAIN_LIMITS = {"grad_gap_p50": 1e-3, "change_gap_p50": 1e-3,
                "change_gap": 1e-2}


def spec(config: str, dtype: str = "float32") -> dict:
    """The configuration file `config` at the toy widths, in `dtype`."""
    out = run.load_json(run.HERE / "configs" / f"{config}.json")
    s = out["settings"]
    s.update(TOY)
    if s["TRANSFORMER"] == "dq_transformer":
        s.update(TOY_DQ)
    s["PARALLEL.COMPUTE_DTYPE"] = dtype
    return out


def stated_dtype(config: str) -> str:
    """The compute dtype that the configuration file states."""
    return run.load_json(run.HERE / "configs" / f"{config}.json")[
        "settings"]["PARALLEL.COMPUTE_DTYPE"]


def traffic(batch: int = 1) -> dict:
    return {"loop": "serve_closed", "batch": batch, "ring_frames": 8,
            "people": [1, 2, 3, 4], "cam_seed": 0,
            "image_wh": [1920, 1080], "warmup_units": 1, "trace_units": 1,
            "check_units": 2}


def limits(config: str) -> dict:
    """The cell's compared numbers with toy limits: the float32 program
    against the float32 reference reads rounding (under 0.01 mm and 1e-6
    of a score at these sizes), so 0.1 mm and 1e-4 sit far above it and
    far below a wrong answer; the exact numbers keep 0."""
    names = run.load_json(run.HERE / "limits" / f"{CONFIGS[config]}.json")
    return {k: 0 if v == 0 else (0.1 if k.endswith("_mm") else 1e-4)
            for k, v in names.items()}


def run_toy(config: str, seed: int = 2 ** 31 + 5, batch: int = 1,
            dtype: str = "float32", keep: bool = False, lim=None,
            seconds: float = 0.5) -> dict:
    torch.set_num_threads(2)
    cell = {"name": CONFIGS[config], "config": config,
            "traffic": "toy", "chips": 1}
    bench = run.benchmark()
    return run.run_cell(bench, cell, seed, seconds, False, torch.device("cpu"),
                        time.perf_counter(), keep=keep,
                        spec=spec(config, dtype), traffic=traffic(batch),
                        limits=lim or limits(config))


def run_toy_train(seed: int = 2 ** 31 + 77, dtype: str = "float32",
                  keep: bool = False) -> dict:
    """The training cell's loop at the toy widths on the CPU."""
    torch.set_num_threads(2)
    cell = {"name": "dq_train_b1", "config": "mvgformer_panoptic5",
            "traffic": "toy", "chips": 1}
    return run.run_cell(run.benchmark(), cell, seed, 0.5, False,
                        torch.device("cpu"), time.perf_counter(), keep=keep,
                        spec=spec("mvgformer_panoptic5", dtype),
                        traffic=dict(TRAIN_TRAFFIC), limits=TRAIN_LIMITS)


def main() -> None:
    """A toy run as a subprocess: prints its result and the forbidden
    modules loaded."""
    out = run_toy(sys.argv[1])
    print(json.dumps({"correct": out["result"]["correct"],
                      "forbidden": run.forbidden_modules(),
                      "modules": sorted({m.split(".")[0]
                                         for m in sys.modules})}))


if __name__ == "__main__":
    main()
