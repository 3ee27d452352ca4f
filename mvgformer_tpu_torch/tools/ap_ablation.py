"""Synthetic-AP ablation harness, on the card.

    python -m mvgformer_tpu_torch.tools.ap_ablation \
        train|eval|all|train_solver|spread [--windowed] [--device cuda] \
        [--out DIR] [--results FILE] [--cfg YAML] [...]

The port of tools/ap_ablation.py. It trains the flagship proxy
(configs/synthetic_ap_ablation.yaml) on SyntheticDataset with the fast
trainer (`python -m mvgformer_tpu_torch.tools.ap_train_fast`), then tables
AP and MPJPE across the inference options that change them:

    {svd (linalg), eigh, jacobi} triangulation
  x {dense, top-K 256 / 128 / 64} query compaction
  x point-top-m (4, 2) at K 128 and 64
  x layer1_offset_clamp (4, 2) at K 128
  (+ --windowed: the windowed layer 1 at the clamp rows and at jacobi
   dense / K 128)

13 rows, each one run of the port's validate CLI (`python -m
mvgformer_tpu_torch.run.validate`, a subprocess) on the checkpoint. A row
holds the AP at 25 / 50 / 100 / 150 mm, MPJPE and recall@500 parsed from
the CLI's `thr=... {...}` line, the CLI's wall seconds, and `frames_per_s`,
the frames/s of the CLI's eval loop measured in that run on that device
(its `eval loop: ... frames/s` line), the serving kernels' launches in
that run (its `kernel launches: {...}` line), and the device it ran on
(`card`: nvidia-smi's name and power limit, or "cpu"). Rows append to
perf/torch_ap_ablation_results.jsonl (spread: perf/
torch_ap_ablation_spread.jsonl), or to --results.

Modes:
  train         the fast trainer into --out;
  eval          the 13-row matrix on the latest checkpoint
                under --out;
  all           train, then eval;
  train_solver  [SOLVER ...] [KEY.SUB=value ...]: the fast trainer with
                each solver (default eigh) into --out/train_<solver>, then
                its K 128 row with the same solver;
  spread        [CKPT_ROOT] [STEP ...] [tag=NAME]: k128 / k64 / k64_ptop4
                at each step (default 59 79 99), rows tagged with `epoch`
                and `seed_tag` (default seed0) for
                mvgformer_tpu_torch.tools.ap_spread_report.
Dotted overrides after the mode (KEY.SUB=value) go to every validate run
(eval, spread) or to the trainer (train, train_solver). `--device`
defaults to the card and raises without one.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import time
from pathlib import Path
from typing import Optional, Sequence

from mvgformer_tpu_torch.utils.logging import parse_metric_dict

REPO = Path(__file__).resolve().parents[2]
CFG = str(REPO / "configs" / "synthetic_ap_ablation.yaml")
OUT = str(REPO / "output" / "torch_ap_ablation")
PERF_DIR = str(REPO / "perf")
RESULTS = os.path.join(PERF_DIR, "torch_ap_ablation_results.jsonl")
SPREAD_RESULTS = os.path.join(PERF_DIR, "torch_ap_ablation_spread.jsonl")
MODES = ("train", "eval", "all", "train_solver", "spread")

METRIC_RE = re.compile(r"thr=[\d.]+\s+(\{.*\})")
FPS_RE = re.compile(
    r"eval loop: \d+ frames in [\d.]+ s \(([\d.]+) frames/s\)")
LAUNCHES_RE = re.compile(r"kernel launches: (\{.*\})")


def card_name(device: str) -> str:
    """nvidia-smi's name and power limit of the card, or "cpu"."""
    if not str(device).startswith("cuda"):
        return "cpu"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    return env


def run_validate(*args, cfg=CFG, out_dir=OUT, device="cuda", timeout=3600):
    """The port's validate CLI in a subprocess."""
    cmd = [sys.executable, "-m", "mvgformer_tpu_torch.run.validate",
           "--cfg", cfg, "--device", str(device), f"OUTPUT_DIR={out_dir}",
           *args]
    print("+", " ".join(cmd), flush=True)
    return subprocess.run(cmd, capture_output=True, text=True, cwd=REPO,
                          timeout=timeout, env=_env())


def run_trainer(out_dir, *overrides, cfg=CFG, device="cuda", timeout=14400):
    """The fast trainer in a subprocess."""
    cmd = [sys.executable, "-m", "mvgformer_tpu_torch.tools.ap_train_fast",
           "--out", out_dir, "--cfg", cfg, "--device", str(device),
           *overrides]
    print("+", " ".join(cmd), flush=True)
    return subprocess.run(cmd, capture_output=True, text=True, cwd=REPO,
                          timeout=timeout, env=_env())


def find_checkpoint(root_dir=None):
    for root, dirs, _ in os.walk(root_dir or OUT):
        if "checkpoints" in dirs:
            return os.path.join(root, "checkpoints")
    raise FileNotFoundError(f"no checkpoints under {root_dir or OUT}")


def train(*overrides, out_dir=None, cfg=CFG, device="cuda"):
    t0 = time.time()
    res = run_trainer(out_dir or OUT, *overrides, cfg=cfg, device=device)
    print(res.stdout[-3000:])
    print(res.stderr[-3000:])
    if res.returncode != 0:
        sys.exit("training failed")
    print(f"trained in {(time.time() - t0) / 60:.1f} min")


def parse_row(name, output):
    """The metrics and frames/s of a validate run's output, or None when
    it printed no metric line."""
    m = METRIC_RE.search(output)
    if not m:
        return None
    metrics = parse_metric_dict(m.group(1))
    fps = FPS_RE.search(output)
    launches = LAUNCHES_RE.search(output)
    return {"config": name, "ap25": metrics.get("ap@25"),
            "ap50": metrics.get("ap@50"), "ap100": metrics.get("ap@100"),
            "ap150": metrics.get("ap@150"), "mpjpe": metrics.get("mpjpe"),
            "recall500": metrics.get("recall@500"),
            "frames_per_s": float(fps.group(1)) if fps else None,
            "launches": (parse_metric_dict(launches.group(1))
                         if launches else None)}


def eval_config(name, overrides, ckpt, step=None, extra_fields=None,
                results=RESULTS, cfg=CFG, out_dir=OUT, device="cuda",
                common=()):
    """One row: the validate CLI on `ckpt` with `overrides` (after the
    `common` ones), parsed, printed and appended to `results`."""
    t0 = time.time()
    extra = ["--model_step", str(step)] if step is not None else []
    res = run_validate("--model_path", ckpt, *extra, *common, *overrides,
                       cfg=cfg, out_dir=out_dir, device=device)
    combined = res.stdout + res.stderr
    row = parse_row(name, combined) if res.returncode == 0 else None
    if row is None:
        print(f"[{name}] FAILED\n{combined[-2000:]}")
        return None
    row.update(wall_s=round(time.time() - t0, 1), device=str(device),
               card=card_name(device))
    if extra_fields:
        row.update(extra_fields)
    print(json.dumps(row), flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(results)), exist_ok=True)
    with open(results, "a") as f:
        f.write(json.dumps(row) + "\n")
    return row


def matrix(windowed=False):
    """(name, overrides) of the eval rows: the top-K sweep on the Jacobi
    solver, the solvers at K 128 (and linalg dense), point-top-m, the
    layer-1 offset clamp, and with `windowed` the windowed layer 1."""
    configs = []
    for solver, topks in (("jacobi", (None, 256, 128, 64)),
                          ("linalg", (None, 128)),
                          ("eigh", (128,))):
        for topk in topks:
            name = f"{solver}_{'dense' if topk is None else f'k{topk}'}"
            ov = [f"DECODER.triangulation_method={solver}"]
            if topk is not None:
                ov.append(f"DECODER.inference_topk_queries={topk}")
            configs.append((name, ov))
    for topk in (128, 64):
        for m in (4, 2):
            configs.append((f"jacobi_k{topk}_ptop{m}",
                            ["DECODER.triangulation_method=jacobi",
                             f"DECODER.inference_topk_queries={topk}",
                             f"DECODER.inference_point_topm={m}"]))
    for clamp in (4.0, 2.0):
        base = ["DECODER.triangulation_method=jacobi",
                "DECODER.inference_topk_queries=128",
                f"DECODER.layer1_offset_clamp={clamp}"]
        configs.append((f"jacobi_k128_clamp{int(clamp)}", list(base)))
        if windowed:
            configs.append((f"jacobi_k128_clamp{int(clamp)}_windowed",
                            base + ["DECODER.layer1_windowed_sampling"
                                    "=true"]))
    if windowed:
        for topk in (None, 128):
            name = (f"jacobi_{'dense' if topk is None else f'k{topk}'}"
                    "_windowed")
            ov = ["DECODER.triangulation_method=jacobi",
                  "DECODER.layer1_windowed_sampling=true"]
            if topk is not None:
                ov.append(f"DECODER.inference_topk_queries={topk}")
            configs.append((name, ov))
    return configs


def evaluate(windowed=False, results=RESULTS, out_dir=OUT, cfg=CFG,
             device="cuda", common=()):
    """The matrix on the latest checkpoint under out_dir; prints the table
    and returns the rows."""
    ckpt = find_checkpoint(out_dir)
    print("checkpoint:", ckpt)
    done = []
    for name, ov in matrix(windowed):
        row = eval_config(name, ov, ckpt, results=results, cfg=cfg,
                          out_dir=out_dir, device=device, common=common)
        if row:
            done.append(row)
    print("\n| config | AP25 | AP50 | AP100 | AP150 | MPJPE | recall@500 "
          "| frames/s |")
    print("|---|---|---|---|---|---|---|---|")
    for r in done:
        fps = ("not measured" if r["frames_per_s"] is None
               else f"{r['frames_per_s']:.2f}")
        print(f"| {r['config']} | {r['ap25']:.4f} | {r['ap50']:.4f} | "
              f"{r['ap100']:.4f} | {(r.get('ap150') or 0.0):.4f} | "
              f"{r['mpjpe']:.2f} | {r['recall500']:.4f} | {fps} |")
    return done


def train_solver(solvers=("eigh",), overrides=(), out_dir=OUT, cfg=CFG,
                 device="cuda", results=RESULTS):
    """The fast trainer with each solver, then its K 128 row with the same
    solver (watch notfinite_total in fast_train_metrics.jsonl: a climbing
    counter means updates are being dropped)."""
    for solver in solvers:
        sub = os.path.join(out_dir, f"train_{solver}")
        os.makedirs(sub, exist_ok=True)
        res = run_trainer(sub, f"DECODER.triangulation_method={solver}",
                          *overrides, cfg=cfg, device=device)
        print(res.stdout[-2000:])
        if res.returncode != 0:
            print(res.stderr[-3000:])
            continue
        eval_config(f"trained_{solver}_eval_{solver}_k128",
                    [f"DECODER.triangulation_method={solver}",
                     "DECODER.inference_topk_queries=128"],
                    find_checkpoint(sub), results=results, cfg=cfg,
                    out_dir=sub, device=device)


SPREAD_CONFIGS = (
    ("jacobi_k128", ["DECODER.triangulation_method=jacobi",
                     "DECODER.inference_topk_queries=128"]),
    ("jacobi_k64", ["DECODER.triangulation_method=jacobi",
                    "DECODER.inference_topk_queries=64"]),
    ("jacobi_k64_ptop4", ["DECODER.triangulation_method=jacobi",
                          "DECODER.inference_topk_queries=64",
                          "DECODER.inference_point_topm=4"]),
)


def spread(steps=(59, 79, 99), ckpt_root=None, tag="", results=SPREAD_RESULTS,
           cfg=CFG, out_dir=OUT, device="cuda", common=()):
    """The contested configs at several retained checkpoints, each row with
    its `epoch` and `seed_tag`."""
    ckpt = find_checkpoint(ckpt_root or out_dir)
    print("checkpoint dir:", ckpt, "steps:", steps, flush=True)
    tag = tag.rstrip("_") or "seed0"
    for step in steps:
        for name, ov in SPREAD_CONFIGS:
            eval_config(f"{tag}_{name}", ov, ckpt, step=step,
                        extra_fields={"epoch": int(step), "seed_tag": tag},
                        results=results, cfg=cfg, out_dir=out_dir,
                        device=device, common=common)


def parse_args(argv: Optional[Sequence[str]] = None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("mode", nargs="?", default="all", choices=MODES)
    ap.add_argument("rest", nargs="*",
                    help="train_solver: solvers and KEY.SUB=value; spread: "
                         "[CKPT_ROOT] [STEP ...] [tag=NAME]; otherwise "
                         "KEY.SUB=value overrides")
    ap.add_argument("--windowed", action="store_true")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--out", default=OUT)
    ap.add_argument("--cfg", default=CFG)
    ap.add_argument("--results", default=None,
                    help="rows file (default perf/torch_ap_ablation_"
                         "results.jsonl; spread: ..._spread.jsonl)")
    return ap.parse_intermixed_args(argv)


def main(argv: Optional[Sequence[str]] = None):
    from mvgformer_tpu_torch.device import resolve_device

    args = parse_args(argv)
    device = str(resolve_device(args.device))
    os.makedirs(args.out, exist_ok=True)
    overrides = tuple(a for a in args.rest if "=" in a
                      and not a.startswith("tag="))
    if args.mode in ("train", "all"):
        train(*overrides, out_dir=args.out, cfg=args.cfg, device=device)
    if args.mode in ("eval", "all"):
        evaluate(windowed=args.windowed, results=args.results or RESULTS,
                 out_dir=args.out, cfg=args.cfg, device=device,
                 common=() if args.mode == "all" else overrides)
    if args.mode == "spread":
        rest = [a for a in args.rest if "=" not in a]
        kw = {}
        if rest and os.path.isdir(rest[0]):
            kw["ckpt_root"] = rest.pop(0)
        bad = [a for a in rest if not a.isdigit()]
        if bad:
            sys.exit(f"spread takes [CKPT_ROOT] [STEP ...] [tag=NAME] "
                     f"[KEY.SUB=value ...], got {bad}")
        tags = [a.split("=", 1)[1] for a in args.rest if a.startswith("tag=")]
        if tags and not tags[-1]:
            sys.exit("tag= needs a name")
        if tags:
            kw["tag"] = tags[-1]
        if rest:
            kw["steps"] = tuple(int(s) for s in rest)
        spread(results=args.results or SPREAD_RESULTS, cfg=args.cfg,
               out_dir=args.out, device=device, common=overrides, **kw)
    if args.mode == "train_solver":
        solvers = tuple(a for a in args.rest if "=" not in a) or ("eigh",)
        train_solver(solvers, overrides=overrides, out_dir=args.out,
                     cfg=args.cfg, device=device,
                     results=args.results or RESULTS)


if __name__ == "__main__":
    main()
