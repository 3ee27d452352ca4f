"""How fast the host was around a measured window. The cells are bound by
the host's launches, so their rates follow the host's speed, which varies
on the card's machines from minute to minute (PERF.md sec. 2). These
readings stand beside the result (its `host` key) to tell a slow host from
a slow program:

  * `cpu_s`: the process's CPU seconds in the window, every thread: near
    the window's length where one thread launches all the time;
  * `dispatch_us_before`, `dispatch_us_after`: the host's microseconds per
    small CPU operation of torch (an in-place add on one element, the
    dispatcher's path that every launch takes too), timed just before the
    window opens and just after it closes.
"""

from __future__ import annotations

import time

OPS = 20000


def dispatch_us(ops: int = OPS) -> float:
    import torch

    x = torch.zeros(1)
    t = time.perf_counter()
    for _ in range(ops):
        x.add_(1.0)
    return (time.perf_counter() - t) / ops * 1e6


class Window:
    """Opened just before a window starts; `close()` gives its readings."""

    def __init__(self):
        self.before = dispatch_us()
        self.cpu = time.process_time()

    def close(self) -> dict:
        cpu = time.process_time() - self.cpu
        return {"cpu_s": cpu, "dispatch_us_before": self.before,
                "dispatch_us_after": dispatch_us()}
