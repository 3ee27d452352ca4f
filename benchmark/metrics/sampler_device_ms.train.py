"""Device ms per training step of the training sampler's kernels, B2
(`csrc/table_build.cu`) and B3's forward and backward
(`csrc/table_gather.cu`): the summed device time of the kernels whose
name holds one of KERNELS. Left out where none ran."""

KERNELS = ("table_build_kernel", "gather_reduce_fwd_kernel",
           "segment_sum_kernel", "rows_kernel")


def read(record: dict):
    seconds = sum(v[0] for name, v in record["kernels"].items()
                  if any(k in name for k in KERNELS))
    if not seconds:
        return None
    return 1e3 * seconds / record["steps"]
