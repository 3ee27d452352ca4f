"""What the ported probes share: the device, inputs made with numpy from a
seed, CUDA-event timing, the check of a kernel against its plain version,
and one printed line per result."""

from __future__ import annotations

import argparse
import json
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from mvgformer_tpu_torch.device import resolve_device

SEED = 0


def parse_args(argv: Optional[Sequence[str]], doc: str, device,
               variants: Sequence[str] = ()) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=doc.splitlines()[0])
    if variants:
        parser.add_argument("variants", nargs="*", metavar="variant",
                            help="run only these: " + ", ".join(variants))
    parser.add_argument("--runs", type=int, default=20,
                        help="timed launches per result (median)")
    parser.add_argument("--warmup", type=int, default=3)
    parser.add_argument("--toy", action="store_true",
                        help="tiny shapes, for a run on the CPU")
    args = parser.parse_args(list(argv or []))
    args.device = device
    if variants:
        unknown = sorted(set(args.variants) - set(variants))
        if unknown:
            parser.error(f"unknown variants {unknown}")
        args.variants = args.variants or list(variants)
    return args


class Probe:
    """Device, generator, timer and the results of one probe run."""

    def __init__(self, args: argparse.Namespace):
        self.device = resolve_device(args.device)
        self.runs, self.warmup = args.runs, args.warmup
        self.rng = np.random.default_rng(SEED)
        self.results: List[dict] = []
        if self.device.type == "cuda":
            print(f"# {torch.cuda.get_device_name(self.device)}", flush=True)

    # inputs ---------------------------------------------------------------

    def table(self, shape, dtype) -> torch.Tensor:
        """Uniform values in [-0.5, 0.5) on the device, in `dtype`."""
        a = self.rng.random(shape, dtype=np.float32) - np.float32(0.5)
        return torch.from_numpy(a).to(self.device, dtype)

    def ints(self, low, high, shape) -> torch.Tensor:
        return torch.from_numpy(self.rng.integers(
            low, high, shape, dtype=np.int32)).to(self.device)

    def put(self, array: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(array)).to(self.device)

    # timing and checks ----------------------------------------------------

    def ms(self, fn: Callable[[], object]) -> Optional[float]:
        """Median milliseconds of `runs` CUDA-event-timed calls of fn after
        `warmup` untimed ones; on the CPU, one untimed call and None."""
        if self.device.type != "cuda":
            fn()
            return None
        for _ in range(self.warmup):
            fn()
        times = []
        for _ in range(self.runs):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return float(np.median(times))

    @staticmethod
    def check(name: str, got: torch.Tensor, want: torch.Tensor) -> None:
        """Raise unless the kernel's output equals its plain version's bit
        for bit (NaN nowhere: the probes' inputs are finite)."""
        if got.shape != want.shape or got.dtype != want.dtype:
            raise RuntimeError(f"{name}: {tuple(got.shape)} {got.dtype} "
                               f"against {tuple(want.shape)} {want.dtype}")
        if not torch.equal(got, want):
            err = (got.float() - want.float()).abs().max().item()
            raise RuntimeError(f"{name}: the kernel differs from its plain "
                               f"version (max abs err {err})")

    def report(self, name: str, kernel: Optional[Callable] = None,
               rows: Optional[int] = None, **fields) -> dict:
        """Print and keep one result. `kernel` is the wrapper timed as ms;
        ns_per_row is ms over `rows`."""
        rec = {"variant": name,
               "kernel": None if kernel is None else kernel.__name__,
               "device": self.device.type, **fields}
        if rows:
            rec["rows"] = rows
            if rec.get("ms") is not None:
                rec["ns_per_row"] = rec["ms"] * 1e6 / rows
        self.results.append(rec)
        print(json.dumps(rec), flush=True)
        return rec
