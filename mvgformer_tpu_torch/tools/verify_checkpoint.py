"""One-command check of the fidelity gate, on the card.

    python -m mvgformer_tpu_torch.tools.verify_checkpoint \
        --model_path /path/to/mvgformer_q1024_model.pth.tar \
        --data_root /path/to/panoptic/ [--cfg YAML] [--tolerance 0.5] \
        [--device cuda] [KEY.SUB=value ...]

The port of tools/verify_checkpoint.py. The gate is the original repo's
published Panoptic CMU0 result: AP25 92.3 / MPJPE 16.0 mm from its
released mvgformer_q1024_model.pth.tar. This runs the port's validate CLI
(`python -m mvgformer_tpu_torch.run.validate`, a subprocess) on
configs/panoptic/knn5-lr4-q1024.yaml with the checkpoint (a released
`.pth.tar`, converted by utils/torch_convert.py, or a checkpoint directory
of the port's train CLI) and the data root, takes the best row over the
configured confidence thresholds, and exits non-zero unless AP25 and MPJPE
are both within --tolerance percent of the published numbers. A missing
path, a failed run and a run that prints no metric row exit non-zero too.
`--device` defaults to the card and raises without one.
"""

from __future__ import annotations

import argparse
import os
import re
import subprocess
import sys
from pathlib import Path
from typing import Optional, Sequence

from mvgformer_tpu_torch.utils.logging import parse_metric_dict

REPO = Path(__file__).resolve().parents[2]
CFG = str(REPO / "configs" / "panoptic" / "knn5-lr4-q1024.yaml")

PUBLISHED_AP25 = 92.3   # percent
PUBLISHED_MPJPE = 16.0  # mm

METRIC_RE = re.compile(r"thr=[\d.]+\s+(\{.*\})")


def main(argv: Optional[Sequence[str]] = None):
    from mvgformer_tpu_torch.device import resolve_device

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model_path", required=True,
                    help="released .pth.tar or a checkpoint dir of the "
                         "port's train CLI")
    ap.add_argument("--data_root", required=True,
                    help="Panoptic dataset root (CMU0 val sequences)")
    ap.add_argument("--cfg", default=CFG)
    ap.add_argument("--tolerance", type=float, default=0.5,
                    help="max relative deviation, percent")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("extra", nargs="*",
                    help="extra KEY.SUB=value overrides for validate")
    args = ap.parse_intermixed_args(argv)
    device = resolve_device(args.device)

    for path, what in ((args.model_path, "checkpoint"),
                       (args.data_root, "data root")):
        if not os.path.exists(path):
            sys.exit(f"missing {what}: {path}")

    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    cmd = [sys.executable, "-m", "mvgformer_tpu_torch.run.validate",
           "--cfg", args.cfg, "--model_path", args.model_path,
           "--device", str(device), f"DATASET.ROOT={args.data_root}",
           *args.extra]
    print("+", " ".join(cmd), flush=True)
    res = subprocess.run(cmd, capture_output=True, text=True, cwd=REPO,
                         env=env)
    sys.stdout.write(res.stdout[-4000:])
    sys.stderr.write(res.stderr[-4000:])
    if res.returncode != 0:
        sys.exit(f"validate.py failed (rc={res.returncode})")

    rows = [parse_metric_dict(m.group(1))
            for m in METRIC_RE.finditer(res.stdout + res.stderr)]
    if not rows:
        sys.exit("no metric rows found in validate.py output")
    best = max(rows, key=lambda r: r.get("ap@25", 0.0))
    ap25 = 100.0 * best.get("ap@25", 0.0)
    mpjpe = best.get("mpjpe", float("inf"))
    dev_ap = 100.0 * abs(ap25 - PUBLISHED_AP25) / PUBLISHED_AP25
    dev_mp = 100.0 * abs(mpjpe - PUBLISHED_MPJPE) / PUBLISHED_MPJPE
    print(f"\nbest row: AP25 {ap25:.2f} (published {PUBLISHED_AP25}, "
          f"dev {dev_ap:.2f}%)  MPJPE {mpjpe:.2f} mm (published "
          f"{PUBLISHED_MPJPE}, dev {dev_mp:.2f}%)")
    if dev_ap > args.tolerance or dev_mp > args.tolerance:
        sys.exit(f"FIDELITY GATE FAILED: deviation exceeds "
                 f"{args.tolerance}%")
    print("FIDELITY GATE PASSED")


if __name__ == "__main__":
    main()
