"""Where a training step waits for the card: the synchronizing CUDA
operations of a training step, by call site, and its steps/s. Run from
the repository root on a machine with a card:

    python tests/sync_diagnosis.py [--root DIR] [--config ablation]
        [--steps 3] [--frames 4]

--config picks the step: 'ablation' trains
configs/synthetic_ap_ablation.yaml at its full width on the first
--frames frames of its synthetic train split (the fast trainer's step);
'flagship' and 'mvp' train configs/panoptic/knn5-lr4-q1024.yaml in
bfloat16 at batch 1 on --frames synthetic frames, as chip_smoke.py's
phase 13 (the DQ model, Jacobi DLT) and phase 18c (the MvP baseline)
do. One warm-up step, then --steps steps under
torch.cuda.set_sync_debug_mode("warn"); it prints one JSON line per call
site of the port that led to a synchronization (the port's frames of its
stack and the count), then one line with the syncs per step, the steps/s
of --steps more steps without the debug mode, the peak memory and the
card. With --root the package
(and its kernel sources) of the checkout at DIR is measured, so a parent
commit unpacked beside this one can be read in the same call. The kernels
are built first, as chip_smoke.py builds them. Nothing here imports JAX.
"""

import argparse
import collections
import json
import subprocess
import sys
import time
import traceback
import warnings
from pathlib import Path

import torch

SOURCES = ("table_build.cu", "table_gather.cu")
# chip_smoke.py's MvP baseline
MVP_OVERRIDES = ("TRANSFORMER=multi_view_pose_transformer",
                 "DECODER.projattn_posembed_mode=use_rayconv")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--config", default="ablation",
                    choices=("ablation", "flagship", "mvp"))
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--frames", type=int, default=4)
    args = ap.parse_args(argv)
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    from mvgformer_tpu_torch.config import load_config
    from mvgformer_tpu_torch.core.train import (create_train_state,
                                                make_train_step)
    from mvgformer_tpu_torch.data.datasets import SyntheticDataset
    from mvgformer_tpu_torch.data.synthetic import make_batch
    from mvgformer_tpu_torch.models import build_model
    from mvgformer_tpu_torch.ops import _build

    if not torch.cuda.is_available():
        sys.exit("sync_diagnosis needs a CUDA card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    _build.build_all([_build.CSRC / s for s in SOURCES])
    if args.config == "ablation":
        cfg = load_config(
            str(root / "configs" / "synthetic_ap_ablation.yaml"),
            [f"DATASET.MAX_DATA_NUM={args.frames}"])
        ds = SyntheticDataset(cfg, "train", True)
        frames = [ds.load_batch([i]).to("cuda") for i in range(len(ds))]
    else:
        cfg = load_config(
            str(root / "configs" / "panoptic" / "knn5-lr4-q1024.yaml"),
            list(MVP_OVERRIDES if args.config == "mvp" else ())
            + ["PARALLEL.COMPUTE_DTYPE=bfloat16"])
        if args.config == "flagship":
            cfg.DECODER.triangulation_method = "jacobi"
        frames = [make_batch(cfg, batch_size=1, seed=100 + i, num_people=3,
                             cam_seed=0) for i in range(args.frames)]
    model = build_model(cfg, generator=torch.Generator().manual_seed(0),
                        device="cuda")
    state, tx = create_train_state(cfg, model, steps_per_epoch=len(frames))
    step = make_train_step(cfg, model, tx)
    gen = torch.Generator().manual_seed(0)
    state, _ = step(state, frames[0], gen)
    torch.cuda.synchronize()

    sites = collections.Counter()

    def record(message, category, filename, lineno, file=None, line=None):
        if not str(message).startswith("called a synchronizing"):
            return
        port = [f"{Path(f.filename).relative_to(root)}:{f.lineno} "
                f"{(f.line or '').strip()}"
                for f in traceback.extract_stack()[:-1]
                if str(root / "mvgformer_tpu_torch") in f.filename]
        sites[tuple(port[-3:])] += 1

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = record
        torch.cuda.set_sync_debug_mode("warn")
        try:
            for i in range(args.steps):
                state, _ = step(state, frames[(i + 1) % len(frames)], gen)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    for site, count in sites.most_common():
        print(json.dumps({"count": count, "site": list(site)}), flush=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(args.steps):
        state, _ = step(state, frames[i % len(frames)], gen)
    torch.cuda.synchronize()
    print(json.dumps({
        "root": str(root), "config": args.config,
        "syncs_per_step": sum(sites.values()) / args.steps,
        "steps_per_s": args.steps / (time.perf_counter() - t0),
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
        "frames": len(frames), "card": card}), flush=True)


if __name__ == "__main__":
    main()
