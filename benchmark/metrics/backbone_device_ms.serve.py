"""Device ms per served frame attributed to the backbone: the CUDA time of
the profiler range that the benchmark opens around every call of the
model's backbone module (`program.mark_backbone`). Left out where the
profiler attributes no device time to the range."""

RANGE = "bench.backbone"


def read(record: dict):
    seconds = record["ranges"].get(RANGE, 0.0)
    if not seconds:
        return None
    return 1e3 * seconds / record["frames"]
