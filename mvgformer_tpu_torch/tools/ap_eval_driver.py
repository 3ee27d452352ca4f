"""Phased driver for the AP-ablation eval matrix (ap_ablation.evaluate).

    python -m mvgformer_tpu_torch.tools.ap_eval_driver warm|final \
        [--windowed] [--device cuda] [--out DIR] [KEY.SUB=value ...]

The port of tools/ap_eval_driver.py. The two phases run the same matrix
on the latest checkpoint under --out and differ in where the rows go:

  warm  - against whatever checkpoint exists (for example the epoch-20 one
          the fast trainer writes mid-run), a preview: rows go to
          perf/torch_ap_ablation_results_warm.jsonl;
  final - against the finished checkpoint: rows go to
          perf/torch_ap_ablation_results.jsonl, the table PERF.md cites.

`--device` defaults to the card and raises without one.
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence

from mvgformer_tpu_torch.tools import ap_ablation

WARM_RESULTS = os.path.join(ap_ablation.PERF_DIR,
                            "torch_ap_ablation_results_warm.jsonl")


def main(argv: Optional[Sequence[str]] = None):
    from mvgformer_tpu_torch.device import resolve_device

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("phase", nargs="?", default="final",
                    choices=("warm", "final"))
    ap.add_argument("overrides", nargs="*")
    ap.add_argument("--windowed", action="store_true")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--out", default=ap_ablation.OUT)
    ap.add_argument("--cfg", default=ap_ablation.CFG)
    args = ap.parse_intermixed_args(argv)
    device = str(resolve_device(args.device))
    results = WARM_RESULTS if args.phase == "warm" else ap_ablation.RESULTS
    return ap_ablation.evaluate(windowed=args.windowed, results=results,
                                out_dir=args.out, cfg=args.cfg,
                                device=device, common=tuple(args.overrides))


if __name__ == "__main__":
    main()
