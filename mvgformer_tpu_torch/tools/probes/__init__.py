"""The probes of `tools/probes/` that hold Pallas kernels, ported to the card.

One module per probe, under the probe's own name:

    probe_pallas_gather        row gather and take-along at S = 30720, and
                               one row at B3's flagship level-0 shape
    probe_pallas_gather2       scale, take-along, row gather at S = 30720
    probe_mosaic_gather_forms  the six gather forms f1-f6, each checked
    probe_onehot_parts         the windowed select's variants and B3's
                               composition at NH = 40, R = 31460
    probe_sorted_gather_parts  torch.sort over (40, 184320), sorted block
                               spans, the windowed select and the gather on
                               sorted and unsorted indices
    probe_table_kernel_forms   B2's table (forms a, b, c, e) and the slot
                               patterns d0-d4

Each module's `main(argv=None, device="cuda")` runs on the card unless asked
for the CPU, and returns its results as dicts:

    python -m mvgformer_tpu_torch.tools.probes.probe_onehot_parts [--runs N]

Importing a module runs nothing. Each kernel is held against its plain
version and a disagreement raises; each time is the median of `--runs`
CUDA-event-timed launches after `--warmup` (the CPU gives no times), with
the PyTorch call that computes the same function timed beside it as
`library_ms`.
"""
