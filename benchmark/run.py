"""The benchmark of the PyTorch port `mvgformer_tpu_torch` on the card:

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

run from the root of a checkout. The cell is a `workloads` entry of
BENCHMARK.json; it names a configuration (`benchmark/configs/<config>.json`)
and a traffic mix (`benchmark/traffic/<traffic>.json`), which names its
loop (`benchmark/loops/<loop>.py`). A run sets up (the kernels, the model
with weights drawn from the seed, the frames, a warm-up), measures for
`--seconds`, with `--trace 1` traces a few more units and reads each
per-layer metric with its reader (`benchmark/metrics/<name>.py`), then
judges a sample of the window's results against the plain reference
(`benchmark/check.py`, limits in `benchmark/limits/<cell>.json`).

The last line of standard output is one JSON object: `correct`,
`attempted`, `failed`, `metrics` (the cell's end-to-end metrics, or with
`--trace 1` its per-layer ones), `device`, with `--trace 1` `breakdown`,
then `checks`, each number compared beside its limit (also the last lines
of standard error). A run without enough CUDA cards, or that finds JAX or
the JAX package loaded once the window has closed, prints no result and
exits 2 or 3.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
CHECKOUT = HERE.parent
# top-level module names that may not be loaded in a run
FORBIDDEN = ("jax", "jaxlib", "flax", "mvgformer_tpu")


def cache_dirs() -> None:
    """Every build and kernel cache at a fixed path inside the checkout
    (the port's nvcc output is `build/kernels/` there already)."""
    build = CHECKOUT / "build"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")


def load_json(path: Path) -> dict:
    return json.loads(path.read_text())


def benchmark() -> dict:
    return load_json(CHECKOUT / "BENCHMARK.json")


def cell_of(bench: dict, name: str) -> dict:
    for cell in bench["workloads"]:
        if cell["name"] == name:
            return cell
    raise SystemExit(f"no workload {name!r} in BENCHMARK.json")


def module_at(path: Path):
    """The Python file at `path` as a module (its name may hold dots)."""
    spec = importlib.util.spec_from_file_location(
        "benchmark_" + path.stem.replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def forbidden_modules():
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def loads_forbidden() -> bool:
    """Whether JAX or the JAX package is loaded in this process, named on
    standard error where it is: a run that loads one prints no result."""
    found = forbidden_modules()
    if found:
        print(f"loaded in the run: {', '.join(found)}", file=sys.stderr)
    return bool(found)


def require_cards(count: int) -> None:
    import torch

    if not torch.cuda.is_available():
        print("no CUDA card: the benchmark measures the card only",
              file=sys.stderr)
        raise SystemExit(2)
    if torch.cuda.device_count() < count:
        print(f"the cell asks for {count} cards, "
              f"{torch.cuda.device_count()} are visible", file=sys.stderr)
        raise SystemExit(2)


def card_line(device) -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    import subprocess

    if device.type != "cuda":
        return "cpu"
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "unknown"


def judge(values: dict, limits: dict):
    """Each number that `limits` names beside its limit, and whether every
    one lies within its limit."""
    checks = {k: {"value": values[k], "limit": v} for k, v in limits.items()}
    return checks, all(c["value"] <= c["limit"] for c in checks.values())


def run_cell(bench: dict, cell: dict, seed: int, seconds: float,
             trace: bool, device, t0: float, keep: bool = False,
             spec=None, traffic=None, limits=None) -> dict:
    """One run of a cell: its loop's output and the result line's object
    (`out["result"]`). `spec`, `traffic` and `limits` replace the cell's
    files where given (the tests' tiny sizes)."""
    import torch

    spec = spec or load_json(HERE / "configs" / f"{cell['config']}.json")
    traffic = traffic or load_json(HERE / "traffic"
                                   / f"{cell['traffic']}.json")
    loop = module_at(HERE / "loops" / f"{traffic['loop']}.py")
    limits = limits or load_json(HERE / "limits" / f"{cell['name']}.json")
    out = loop.run({"spec": spec, "traffic": traffic, "cell": cell,
                    "seed": seed, "seconds": seconds, "trace": trace,
                    "device": device, "t0": t0, "keep": keep})
    metrics = {}
    if trace:
        for m in bench["per_layer"]:
            if applies(m, cell["name"]):
                value = module_at(HERE / "metrics" / f"{m['name']}.py").read(
                    out["record"])
                if value is not None:
                    metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in bench["end_to_end"]:
            if applies(m, cell["name"]):
                metrics[m["name"]] = {"value": out["metrics"][m["name"]],
                                      "unit": m["unit"]}
    checks, ok = judge(out["values"], limits)
    gpu = device.type == "cuda"
    result = {"correct": bool(ok and out["failed"] == 0),
              "attempted": out["attempted"], "failed": out["failed"],
              "metrics": metrics,
              "device": {"platform": "gpu" if gpu else "cpu",
                         "kind": (torch.cuda.get_device_name(device)
                                  if gpu else "cpu"),
                         "count": cell["chips"],
                         "memory_peak_bytes": out["memory_peak_bytes"]}}
    if trace:
        result["device"].update(busy_s=out["record"]["busy_s"],
                                window_s=out["record"]["window_s"])
        result["breakdown"] = out["record"]["breakdown"]
    result["card"] = card_line(device)
    result["host"] = out["host"]
    result["checks"] = checks
    out["result"] = result
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    cache_dirs()
    bench = benchmark()
    cell = cell_of(bench, args.workload)
    require_cards(cell["chips"])
    import torch

    out = run_cell(bench, cell, args.seed, args.seconds, bool(args.trace),
                   torch.device("cuda", 0), T0)
    if loads_forbidden():
        return 3
    result = out["result"]
    for name, c in result["checks"].items():
        print(f"{name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
