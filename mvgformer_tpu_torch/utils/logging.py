"""Logging: a file and console logger, running metric meters, an ASCII
table and a JSONL experiment tracker.

The port's copy of `mvgformer_tpu/utils/logging.py`, which stands for the
original repo's create_logger (lib/utils/utils.py:36-71) and the
AverageMeter instrumentation of its training loop (lib/core/function.py:
56-61)."""

from __future__ import annotations

import json
import logging
import os
import re
import time
from collections import defaultdict
from typing import Dict


def create_logger(cfg, cfg_name: str, phase: str = "train",
                  write: bool = True):
    """File + console logger under OUTPUT_DIR/<dataset>/<cfg>/. With
    `write` False (a data-parallel rank other than 0) no log file: the
    console only, at warning level."""
    root = cfg.OUTPUT_DIR or "output"
    cfg_base = os.path.splitext(os.path.basename(cfg_name))[0]
    out_dir = os.path.join(root, cfg.DATASET.TEST_DATASET, cfg_base)
    os.makedirs(out_dir, exist_ok=True)

    logger = logging.getLogger("mvgformer_tpu_torch")
    logger.setLevel(logging.INFO if write else logging.WARNING)
    logger.handlers.clear()
    fmt = logging.Formatter("%(asctime)-15s %(message)s")
    sh = logging.StreamHandler()
    sh.setFormatter(fmt)
    logger.addHandler(sh)
    if write:
        stamp = time.strftime("%Y-%m-%d-%H-%M")
        fh = logging.FileHandler(
            os.path.join(out_dir, f"{cfg_base}_{stamp}_{phase}.log"))
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    return logger, out_dir


class AverageMeter:
    """Running average (the reference's ubiquitous helper)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val: float, n: int = 1):
        self.val = val
        self.sum += val * n
        self.count += n

    @property
    def avg(self) -> float:
        return self.sum / max(self.count, 1)


class MetricLogger:
    """Dict of AverageMeters with compact formatting."""

    def __init__(self):
        self.meters: Dict[str, AverageMeter] = defaultdict(AverageMeter)

    def update(self, metrics: Dict[str, float], n: int = 1):
        for k, v in metrics.items():
            self.meters[k].update(float(v), n)

    def format(self, keys=None) -> str:
        keys = keys or sorted(self.meters)
        return " ".join(f"{k}={self.meters[k].avg:.4f}" for k in keys
                        if k in self.meters)


def parse_metric_dict(text: str) -> dict:
    """The metrics dict a CLI logs (`{'ap@25': 0.1, 'mpjpe': nan, ...}`,
    Python's repr of str keys and float values, nan and inf included)
    back into a dict."""
    text = re.sub(r"\bnan\b", "NaN", text)
    text = re.sub(r"(?<![\w.])inf\b", "Infinity", text)
    return json.loads(text.replace("'", '"'))


def format_table(headers, rows) -> str:
    """Aligned ASCII table (the original repo's PrettyTable AP/NMS
    reports, run/train_3d.py:326-364, run/validate_3d.py:182-268) without
    the dependency. Values are rendered with 4 decimals when float."""

    def cell(v):
        return f"{v:.4f}" if isinstance(v, float) else str(v)

    table = [[cell(v) for v in row] for row in rows]
    widths = [max(len(h), *(len(r[i]) for r in table)) if table
              else len(h) for i, h in enumerate(headers)]
    sep = "+" + "+".join("-" * (w + 2) for w in widths) + "+"
    out = [sep, "| " + " | ".join(
        h.ljust(w) for h, w in zip(headers, widths)) + " |", sep]
    for r in table:
        out.append("| " + " | ".join(
            c.rjust(w) for c, w in zip(r, widths)) + " |")
    out.append(sep)
    return "\n".join(out)


class ExperimentTracker:
    """Lightweight experiment tracking: JSONL event stream + summary.

    Capability-parity stand-in for the original repo's wandb integration
    (run/train_3d.py:172-182 summary metrics,
    lib/core/function.py:270-318 per-iter/per-epoch dicts) without a
    network service: every `log` call appends one JSON line to
    metrics.jsonl, and max/min summary metrics (AP25 / Recall25 maximize,
    MPJPE minimize — run/train_3d.py:176-181) are folded into
    summary.json as training progresses.
    """

    MAXIMIZE = ("ap", "recall", "precision", "pcp")
    MINIMIZE = ("mpjpe", "loss", "total", "error", "wait")

    def __init__(self, out_dir: str, run_name: str = "",
                 config: Dict = None):
        import json

        self._json = json
        self.path = os.path.join(out_dir, "metrics.jsonl")
        self.summary_path = os.path.join(out_dir, "summary.json")
        self.summary: Dict[str, float] = {}
        self._t0 = time.time()
        if config is not None:
            with open(os.path.join(out_dir, "run_config.json"), "w") as f:
                json.dump({"run_name": run_name, "config": config}, f,
                          indent=1, default=str)

    def _is_better(self, key: str, new: float, old: float) -> bool:
        k = key.lower()
        if any(s in k for s in self.MINIMIZE):
            return new < old
        if any(s in k for s in self.MAXIMIZE):
            return new > old
        return False

    def log(self, metrics: Dict[str, float], step: int = None,
            epoch: int = None, prefix: str = ""):
        rec = {"t": round(time.time() - self._t0, 3)}
        if step is not None:
            rec["step"] = int(step)
        if epoch is not None:
            rec["epoch"] = int(epoch)
        for k, v in metrics.items():
            key = f"{prefix}{k}"
            try:
                v = float(v)
            except (TypeError, ValueError):
                continue
            rec[key] = v
            kl = k.lower()
            if not any(s in kl for s in self.MAXIMIZE + self.MINIMIZE):
                continue  # no best_ direction known; don't freeze one
            best_key = f"best_{key}"
            # direction from the UNPREFIXED metric name: a prefix like
            # 'loss/' must not flip a maximize metric into minimize
            if best_key not in self.summary or self._is_better(
                    k, v, self.summary[best_key]):
                self.summary[best_key] = v
        with open(self.path, "a") as f:
            f.write(self._json.dumps(rec) + "\n")
        with open(self.summary_path, "w") as f:
            self._json.dump(self.summary, f, indent=1)
