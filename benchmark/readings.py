"""The readings that a cell's limits are set from, on the card:

    python3 -m benchmark.readings --workload <cell> --seeds 12 \
        --control-seeds 3 --seconds 5 [--first-seed N] [--out FILE] \
        [--set KEY=JSON ...]

For each of `--seeds` seeds, one run of the cell with a short window:
the numbers that `benchmark/check.py` compares, read off the program's
results (the lower readings). For each of the first `--control-seeds`
seeds, the control in the program's place: the plain reference in float8
e4m3 (`reference/precision.py`) on the same frames or steps, judged by
the float32 reference as the program's results are (the upper readings;
each loop's `control`), judged against the cell's limits as a run's
results are: its line says `correct`, which has to be false. One JSON line
per reading, then a summary line: each number's largest reading over the
program's seeds, its smallest over the control's, and whether any control
came out correct. `--set` changes a setting of the configuration for
every run (a witness: `--set PARALLEL.COMPUTE_DTYPE='"float32"'` runs the
program in float32). The benchmark's own runs never run the control.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from benchmark import run


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, default=12)
    parser.add_argument("--control-seeds", type=int, default=3)
    parser.add_argument("--seconds", type=float, default=5.0)
    parser.add_argument("--first-seed", type=int, default=3_000_000_000)
    parser.add_argument("--out", default=None)
    parser.add_argument("--set", action="append", default=[],
                        metavar="KEY=JSON")
    args = parser.parse_args(argv)
    run.cache_dirs()
    bench = run.benchmark()
    cell = run.cell_of(bench, args.workload)
    run.require_cards(cell["chips"])
    import torch

    device = torch.device("cuda", 0)
    spec = run.load_json(run.HERE / "configs" / f"{cell['config']}.json")
    for item in args.set:
        key, _, value = item.partition("=")
        spec["settings"][key] = json.loads(value)
    limits = run.load_json(run.HERE / "limits" / f"{cell['name']}.json")
    traffic = run.load_json(run.HERE / "traffic" / f"{cell['traffic']}.json")
    loop = run.module_at(run.HERE / "loops" / f"{traffic['loop']}.py")
    lines = []

    def emit(line):
        lines.append(line)
        print(json.dumps(line), flush=True)

    for k in range(args.seeds):
        seed = args.first_seed + 7919 * k
        out = run.run_cell(bench, cell, seed, args.seconds, False, device,
                           time.perf_counter(), keep=k < args.control_seeds,
                           spec=spec)
        emit({"kind": "program", "seed": seed, "values": out["values"],
              "correct": out["result"]["correct"],
              "metrics": out["result"]["metrics"]})
        if k < args.control_seeds:
            values = loop.control(spec, out, seed, device)
            emit({"kind": "control", "seed": seed, "values": values,
                  "correct": run.judge(values, limits)[1]})
        del out
        torch.cuda.empty_cache()
    summary = {"workload": cell["name"], "card": run.card_line(device),
               "settings": args.set, "lower": {}, "upper": {},
               "program_correct": all(line["correct"] for line in lines
                                      if line["kind"] == "program"),
               "control_correct": any(line["correct"] for line in lines
                                      if line["kind"] == "control")}
    for line in lines:
        side = "lower" if line["kind"] == "program" else "upper"
        pick = max if side == "lower" else min
        for name, value in line["values"].items():
            old = summary[side].get(name)
            summary[side][name] = value if old is None else pick(old, value)
    emit(summary)
    if args.out:
        with open(args.out, "w") as f:
            f.write("".join(json.dumps(line) + "\n" for line in lines))
    return 0


if __name__ == "__main__":
    sys.exit(main())
