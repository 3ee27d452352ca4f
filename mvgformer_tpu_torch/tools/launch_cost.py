"""The cost of one launch of the probe kernels' wrappers at the probes' own
(small) shapes, where the host's path per call decides the time:

    python mvgformer_tpu_torch/tools/launch_cost.py [--root DIR] [--label L]

imports `mvgformer_tpu_torch` from the checkout at DIR (default: this one),
so two trees can be held side by side in one run on one card. For each case
(bfloat16: P4's take-along, (2048, 128) by (30720, 128) on axis 0; P3's
scale of (2048, 128) by 2; P1's row gather of 30,720 rows from 2048) it
prints one JSON line with

    ms         the median of 20 calls each between two CUDA events (the
               kernels line's yardstick: host path and device time together);
    device_ms  the device's mean per call over 50 back-to-back calls, the
               stream held by a sleep kernel until all are enqueued;
    host_us    the host's microseconds per call of that enqueue;

and the same three for the PyTorch call of the same function. A last line
splits the host's path of the take-along wrapper: microseconds per call,
in a loop of 3000, of the whole wrapper, of its output's `torch.empty`, of
its checks, and of the bare ctypes launch (when the tree has a
`Launcher`). Needs one CUDA card; `device_ms` is also what chip_smoke.py
reports beside `ms`.
"""

import argparse
import json
import sys
import time
from pathlib import Path


def cuda_ms(fn, runs=20, warmup=3):
    """Median milliseconds of fn() over `runs` CUDA-event-timed calls."""
    import numpy as np
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def device_ms(fn, launches=50, hold_cycles=20_000_000):
    """The device's mean milliseconds per fn() over `launches` back-to-back
    calls between two events, with the stream held by a sleep kernel (~10
    ms at the H100's clock) until the host has enqueued them all, so the
    host's path is off the device's clock; and the host's microseconds per
    call of that enqueue."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(hold_cycles)
    start.record()
    t0 = time.perf_counter()
    for _ in range(launches):
        fn()
    host_us = (time.perf_counter() - t0) / launches * 1e6
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / launches, host_us


def loop_us(fn, n=3000):
    """Host microseconds per call of fn() over n calls in a loop."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    us = (time.perf_counter() - t0) / n * 1e6
    torch.cuda.synchronize()
    return us


def host_breakdown(gather_forms, torch):
    """The parts of take_along's host path, each timed alone."""
    tbl = torch.zeros(2048, 128, device="cuda", dtype=torch.bfloat16)
    idx = torch.zeros(30720, 128, device="cuda", dtype=torch.int32)
    out = torch.empty(idx.shape, dtype=tbl.dtype, device="cuda")
    row = {"wrapper_us": loop_us(lambda: gather_forms.take_along(tbl, idx,
                                                                 0)),
           "torch_empty_us": loop_us(lambda: torch.empty(
               idx.shape, dtype=tbl.dtype, device=tbl.device)),
           "checks_us": loop_us(lambda: (
               gather_forms._check_device(tbl, idx),
               gather_forms._check_cuda([("tbl", tbl)], [("idx", idx)])))}
    launcher = getattr(gather_forms, "_TAKE_ALONG", None)
    if launcher is not None:
        row["ctypes_launch_us"] = loop_us(lambda: launcher(
            tbl, tbl.data_ptr(), idx.data_ptr(), out.data_ptr(), 2048, 128,
            30720, 128, 0, 2))
    return row


def cases(gather_forms, torch, rng):
    def table(*shape):
        a = rng.random(shape, dtype="float32") - 0.5
        return torch.from_numpy(a).to("cuda", torch.bfloat16)

    small = table(2048, 128)
    idx = torch.from_numpy(rng.integers(0, 2048, 30720).astype("int32")).cuda()
    along = idx[:, None].expand(30720, 128).contiguous()
    along64 = along.long()
    return [
        ("take_along P4", lambda: gather_forms.take_along(small, along, 0),
         lambda: torch.gather(small, 0, along64)),
        ("scale P3", lambda: gather_forms.scale(small, 2.0),
         lambda: torch.mul(small, 2.0)),
        ("row_gather P1", lambda: gather_forms.row_gather(small, idx),
         lambda: torch.index_select(small, 0, idx)),
    ]


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", default=str(Path(__file__).resolve()
                                              .parents[2]))
    parser.add_argument("--label", default=None)
    args = parser.parse_args(argv)
    sys.path.insert(0, str(Path(args.root).resolve()))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        sys.exit("launch_cost needs a CUDA card")
    from mvgformer_tpu_torch.ops import gather_forms

    rng = np.random.default_rng(0)
    for name, kernel, library in cases(gather_forms, torch, rng):
        row = {"case": name, "root": args.root, "label": args.label,
               "device": torch.cuda.get_device_name(0)}
        for key, fn in (("", kernel), ("library_", library)):
            row[key + "ms"] = cuda_ms(fn)
            row[key + "device_ms"], row[key + "host_us"] = device_ms(fn)
        print(json.dumps(row), flush=True)
    print(json.dumps({"case": "take_along host path", "root": args.root,
                      "label": args.label,
                      **host_breakdown(gather_forms, torch)}), flush=True)


if __name__ == "__main__":
    main()
