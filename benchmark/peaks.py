"""Published peaks of the card, NVIDIA's H100 SXM data sheet (dense,
without sparsity, at the full 700 W)."""

PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "float32": 67e12,
              "tf32": 495e12, "float8": 1979e12}
PEAK_BYTES_PER_S = 3.35e12
