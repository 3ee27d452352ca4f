"""Device ms per served frame of B1, the port's deformable-sampling
kernel (`ops/deform_attn.py`, `csrc/deform_sample.cu`): the summed device
time of the kernels whose name holds one of KERNELS. Left out where none
ran."""

KERNELS = ("deform_sample_fwd_kernel",)


def read(record: dict):
    seconds = sum(v[0] for name, v in record["kernels"].items()
                  if any(k in name for k in KERNELS))
    if not seconds:
        return None
    return 1e3 * seconds / record["frames"]
