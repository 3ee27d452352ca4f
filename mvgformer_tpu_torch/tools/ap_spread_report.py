"""Render the AP noise band of the port's spread rows.

    python -m mvgformer_tpu_torch.tools.ap_spread_report [ROWS.jsonl] \
        [--device cuda]

The port of tools/ap_spread_report.py. It reads the rows that
`python -m mvgformer_tpu_torch.tools.ap_ablation spread` writes
(perf/torch_ap_ablation_spread.jsonl by default: the contested configs
k128 / k64 / k64_ptop4 at several late checkpoints, optionally over
re-seeded runs) and prints:

  1. the rows as a markdown table;
  2. per config the MPJPE and recall@500 spread (min-max over the
     checkpoints of one seed; over the seeds at matching epochs where a
     second seed exists);
  3. the measured noise band (the largest of those MPJPE spreads), and the
     headline rule against it at the seed-0 rows of the last epoch seed 0
     has: a config qualifies with MPJPE <= the k128 baseline's + band and
     recall >= the baseline's.

Three things differ from the JAX copy:
  * the configs are ordered by the frames/s that their own rows carry
    (`frames_per_s`, measured by the validate CLI in the run that made the
    row, on the device the row names), fastest first, not by constants; a
    config whose row has none prints "fps: not measured" and comes last;
  * the band is printed as the full spread, the allowance the rule grants
    (the JAX copy prints half of it);
  * the last epoch is taken over the seed-0 rows, so a re-seeded arm
    evaluated at an epoch seed 0 lacks cannot hide the baseline.

Pure reporting on the host; `--device` defaults to the card and raises
without one, as every tool of the port does, so `--device cpu` runs it on
a machine with none.
"""

from __future__ import annotations

import argparse
import json
import sys
from collections import defaultdict
from typing import Optional, Sequence

from mvgformer_tpu_torch.tools.ap_ablation import SPREAD_RESULTS

SEED_PREFIXES = ("seed0_", "seed1_", "seed2_")


def load(path=SPREAD_RESULTS):
    rows = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                rows.append(json.loads(line))
    return rows


def base_name(config: str) -> str:
    for pref in SEED_PREFIXES:
        if config.startswith(pref):
            return config[len(pref):]
    return config


def fps_of(row) -> Optional[float]:
    return row.get("frames_per_s")


def report(rows, out=print):
    """Print the report of `rows`; returns (band, the qualifying configs
    in the rule's order, or None when the baseline row is missing)."""
    out("| seed | epoch | config | AP150 | MPJPE (mm) | recall@500 | "
        "frames/s |")
    out("|---|---|---|---|---|---|---|")
    by_cfg = defaultdict(list)
    for r in rows:
        seed = r.get("seed_tag", "seed0")
        base = base_name(r["config"])
        fps = fps_of(r)
        out(f"| {seed} | {r.get('epoch', '?')} | {base} | "
            f"{(r.get('ap150') or 0.0):.4f} | {r['mpjpe']:.2f} | "
            f"{r['recall500']:.4f} | "
            f"{'not measured' if fps is None else f'{fps:.2f}'} |")
        by_cfg[(seed, base)].append(r)

    out("\nPer-config spread across checkpoints (within one seed):")
    band = 0.0
    recall_band = 0.0
    for (seed, cfg), rs in sorted(by_cfg.items()):
        mp = [r["mpjpe"] for r in rs]
        rc = [r["recall500"] for r in rs]
        sp = max(mp) - min(mp)
        rsp = max(rc) - min(rc)
        band = max(band, sp)
        recall_band = max(recall_band, rsp)
        out(f"  {seed}/{cfg}: mpjpe {min(mp):.1f}-{max(mp):.1f} "
            f"(spread {sp:.1f} mm), recall {min(rc):.3f}-{max(rc):.3f}"
            f" (spread {rsp:.3f}), n={len(rs)}")

    seeds = sorted({s for s, _ in by_cfg})
    if len(seeds) > 1:
        out("\nCross-seed spread at matching (epoch, config):")
        by_ec = defaultdict(list)
        for r in rows:
            by_ec[(r.get("epoch"), base_name(r["config"]))].append(
                r["mpjpe"])
        for (ep, cfg), mp in sorted(by_ec.items()):
            if len(mp) > 1:
                band = max(band, max(mp) - min(mp))
                out(f"  epoch {ep} / {cfg}: {min(mp):.1f}-{max(mp):.1f} "
                    f"(spread {max(mp) - min(mp):.1f} mm)")

    out(f"\nMEASURED noise band: {band:.1f} mm MPJPE (full spread "
        f"{band:.1f} mm; the rule admits a config up to {band:.1f} mm "
        f"above the baseline), recall spread {recall_band:.3f}.")

    seed0 = [r for r in rows if r.get("seed_tag", "seed0") == "seed0"]
    if not seed0:
        out("\nNo seed0 rows: the headline rule is not applied.")
        return band, None
    last_ep = max(r.get("epoch", -1) for r in seed0)
    final = {base_name(r["config"]): r for r in seed0
             if r.get("epoch", -1) == last_ep}
    if "jacobi_k128" not in final:
        out(f"\nNo seed0 jacobi_k128 row at epoch {last_ep}: the headline "
            f"rule is not applied.")
        return band, None
    b = final["jacobi_k128"]
    out(f"\nHeadline rule vs k128 baseline at epoch {last_ep} "
        f"(mpjpe {b['mpjpe']:.1f}, recall {b['recall500']:.3f}), "
        f"band {band:.1f} mm:")

    def order(cfg):
        fps = fps_of(final[cfg])
        return (fps is None, -(fps or 0.0), cfg)

    qualifying = []
    for cfg in sorted(final, key=order):
        r = final[cfg]
        ok = (r["mpjpe"] <= b["mpjpe"] + band
              and r["recall500"] >= b["recall500"])
        margin = b["mpjpe"] - r["mpjpe"]
        units = margin / band if band else float("inf")
        fps = fps_of(r)
        fps_text = ("fps: not measured" if fps is None else
                    f"{fps:.2f} fps on {r.get('card', 'an unnamed device')}")
        out(f"  {cfg} ({fps_text}): mpjpe margin {margin:+.1f} mm = "
            f"{units:+.1f} band units, recall {r['recall500']:.3f} -> "
            f"{'QUALIFIES' if ok else 'no'}")
        if ok:
            qualifying.append(cfg)
    return band, qualifying


def main(argv: Optional[Sequence[str]] = None):
    from mvgformer_tpu_torch.device import resolve_device

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("rows", nargs="?", default=SPREAD_RESULTS)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    resolve_device(args.device)
    rows = load(args.rows)
    if not rows:
        sys.exit(f"no rows in {args.rows}")
    return report(rows)


if __name__ == "__main__":
    main()
