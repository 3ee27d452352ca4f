"""The cost of one launch of the port's kernel wrappers, and the same
kernels of two checkouts side by side:

    python mvgformer_tpu_torch/tools/launch_cost.py [--root DIR] [--label L]
        [--kernels probes,deform,window_block,window_dma,table_build,
                   table_slots]

imports `mvgformer_tpu_torch` from the checkout at DIR (default: this one),
so two trees can be held side by side in one run on one card (run it once
per tree, in turns). The cases, all bfloat16:

    probes        P4's take-along, (2048, 128) by (30720, 128) on axis 0;
                  P3's scale of (2048, 128) by 2; P1's row gather of 30,720
                  rows from 2048: the probe kernels at their own small
                  shapes, where the host's path per call decides the time;
                  and scale at a flagship level-0 value (5, 128, 240, 256),
                  where bytes do; each beside the PyTorch call of the same
                  function; then a
                  line splitting the host's path of the take-along wrapper
                  (microseconds per call, in a loop of 3000, of the whole
                  wrapper, of its output's `torch.empty`, of its checks, and
                  of the bare ctypes launch when the tree has a `Launcher`);
    deform        B1 (`deform_sample`) at the two shapes of a served frame:
                  dense layer 1 (5 views x 15,360 queries, P 4) and a layer
                  after top-64 compaction (960 queries, P 4), 8 heads x 32,
                  the flagship levels, border, far and non-finite locations
                  mixed in (`sampling_inputs`);
    window_block  B4 (`window_block_matmul`) on the three level calls of
                  the flagship rig's layer-1 plan (K = 28), P 4, offsets
                  out to the halo and past it (`window_inputs`);
    window_dma    B5 (`window_block_dma`) on the same plan's three level
                  calls under impl 'pallas_dma' (K 28, Kx 32);
    table_build   B2 (`build_corner_table`) on the three level views of a
                  flagship value (5 views, 8 heads x 32), strided as the
                  corner sampler hands them over (`level_views`);
    table_slots   the table slots' maps d0-d4 (B2's kernel with a slot map)
                  on (40, h, w, 32) at the flagship level 0 (128, 240) and
                  at the probe's (16, 30), the five launches summed.

Each case prints one JSON line with

    ms         the median of 20 calls each between two CUDA events (the
               kernels line's yardstick: host path and device time together);
    device_ms  the device's mean per call over 50 back-to-back calls, the
               stream held by a sleep kernel until all are enqueued;
    host_us    the host's microseconds per call of that enqueue;
    max_abs_err  (the B1, window and table cases) the largest difference
               from the kernels' plain versions on the same inputs.

The inputs come from a fixed seed, so every tree gets the same ones.
`dlt_inputs` makes a served layer's DLT operands on a distorted camera ring
(`ops/dlt_jacobi.py`; chip_smoke.py phase 26 and the kernel's card tests). Needs
one CUDA card; `device_ms` is also what chip_smoke.py reports beside `ms`,
and chip_smoke.py --parent DIR runs the deform, window_block, window_dma and
table_build cases of DIR and of its own checkout in turns. The tool is this
checkout's; only the package it times comes from DIR.
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
    value = table(5, 128, 240, 256)
    return [
        ("take_along P4", lambda: gather_forms.take_along(small, along, 0),
         lambda: torch.gather(small, 0, along64)),
        ("scale P3", lambda: gather_forms.scale(small, 2.0),
         lambda: torch.mul(small, 2.0)),
        ("scale flagship value", lambda: gather_forms.scale(value, 2.0),
         lambda: torch.mul(value, 2.0)),
        ("row_gather P1", lambda: gather_forms.row_gather(small, idx),
         lambda: torch.index_select(small, 0, idx)),
    ]


FLAGSHIP_LEVELS = ((128, 240), (64, 120), (32, 60))
# B1's shapes in a served frame: dense layer 1, then the top-64 layers
B1_SHAPES = ((15360, 4), (960, 4))
KERNEL_SETS = ("probes", "deform", "window_block", "window_dma",
               "table_build", "table_slots")
# the table slots' sizes: the flagship level 0 and the probe's small level
SLOT_SIZES = ((128, 240), (16, 30))


def sampling_inputs(Lq, P, dtype, gen, levels=FLAGSHIP_LEVELS, views=5,
                    heads=8, head_dim=32, device="cuda"):
    """B1's value, locations and weights on `device`, with border,
    far-outside and non-finite locations mixed into the uniform ones
    (Lq >= 48)."""
    import torch

    L = len(levels)
    len_in = sum(h * w for h, w in levels)
    value = torch.randn(views, len_in, heads, head_dim, device=device,
                        generator=gen).to(dtype)
    loc = torch.rand(views, Lq, heads, L, P, 2, device=device,
                     generator=gen) * 1.2 - 0.1
    w = torch.tensor([s[1] for s in levels], device=device)
    h = torch.tensor([s[0] for s in levels], device=device)
    q = Lq // 8
    u = torch.rand(views, q, heads, L, P, device=device, generator=gen)
    # x in (-1, 0) pixels, then y in [h-1, h) pixels
    loc[:, :q, ..., 0] = (-u + 0.5) / w[:, None]
    loc[:, q:2 * q, ..., 1] = (h[:, None] - 1 + u + 0.5) / h[:, None]
    loc[:, 2 * q:2 * q + 8] = 50.0
    loc[:, 2 * q + 8:2 * q + 16, ..., 0] = float("inf")
    loc[:, 2 * q + 16:2 * q + 24, ..., 1] = -float("inf")
    loc[:, 2 * q + 24:2 * q + 32, ..., 0] = float("nan")
    aw = torch.rand(views, Lq, heads, L, P, device=device,
                    generator=gen).to(dtype)
    return value, loc, aw


# the DLT's operands: a Panoptic-like rig in the 8 x 8 x 2 m space
DLT_NET_SIZE = (960, 512)
DLT_IMAGE_SIZE = (1920, 1080)
DLT_SPACE_CENTER = (0.0, -500.0, 800.0)


def dlt_rig(B, V, seed=0):
    """(view_data, proj) on the CPU of a ring of V distorted cameras
    (`data.synthetic.make_camera_ring`), the same for each of B frames."""
    import numpy as np
    import torch

    from mvgformer_tpu_torch.data.meta import build_view_data
    from mvgformer_tpu_torch.data.synthetic import make_camera_ring
    from mvgformer_tpu_torch.geometry.cameras import (CameraParams,
                                                      projection_matrices)

    ring = make_camera_ring(V, image_size=DLT_IMAGE_SIZE,
                            center=DLT_SPACE_CENTER, seed=seed)
    cams = CameraParams(**{
        name: getattr(ring, name)[None].expand(
            (B,) + getattr(ring, name).shape).contiguous()
        for name in ("R", "T", "f", "c", "k", "p")})
    image_wh = np.tile(np.asarray(DLT_IMAGE_SIZE, np.float32), (B, V, 1))
    vd = build_view_data(cams, image_wh, DLT_NET_SIZE)
    return vd, projection_matrices(cams, inv_trans=True)


def dlt_inputs(B, N, V, seed=0, noise_px=2.0, masked=0.3, device="cuda"):
    """A decoder layer's DLT operands (`ops.dlt_jacobi.fused_dlt`'s keyword
    arguments) on `device`: world points in the middle 5 x 5 x 1.8 m of
    the capture space projected through `dlt_rig`, mapped into the network
    image, plus `noise_px` of gaussian noise (detections); random logits;
    a random mask with a `masked` share of queries off. Made on the CPU
    from `seed`."""
    import torch

    from mvgformer_tpu_torch.geometry.cameras import (CameraParams,
                                                      project_points)
    from mvgformer_tpu_torch.geometry.transforms import apply_affine

    gen = torch.Generator().manual_seed(seed)
    vd, proj = dlt_rig(B, V, seed)
    cx, cy, _ = DLT_SPACE_CENTER
    lo = torch.tensor([cx - 2500.0, cy - 2500.0, 0.0])
    hi = torch.tensor([cx + 2500.0, cy + 2500.0, 1800.0])
    world = lo + (hi - lo) * torch.rand(B, N, 3, generator=gen)
    pix = project_points(world[:, None].expand(B, V, N, 3), vd.cameras)
    net = apply_affine(pix, vd.affine)  # (B, V, N, 2)
    net = net + noise_px * torch.randn(net.shape, generator=gen)
    cams = CameraParams(**{name: getattr(vd.cameras, name).to(device)
                           for name in ("R", "T", "f", "c", "k", "p")})
    return dict(refined=net.transpose(0, 1).contiguous().to(device),
                logits=torch.randn(V, B, N, generator=gen).to(device),
                mask=(torch.rand(B, N, generator=gen) >= masked).to(device),
                inv_affine=vd.inv_affine.to(device), cameras=cams,
                proj=proj.to(device))


def window_inputs(centers_px, halo, P, dtype, gen, escape,
                  levels=FLAGSHIP_LEVELS, heads=8, head_dim=32,
                  device="cuda"):
    """value, locations and weights on `device` around a plan's static
    centers. Offsets are uniform within +-(halo - 2) px; with `escape`, one
    sample in eight reaches +-(halo + 6) px, out of the K window and in
    part out of the wider Kx window. Weights sum to 1 per (query, head)."""
    import torch

    L = len(levels)
    len_in = sum(h * w for h, w in levels)
    c = torch.from_numpy(centers_px).to(device)  # (V, Lq, L, 2)
    V, Lq = c.shape[:2]
    value = torch.randn(V, len_in, heads, head_dim, device=device,
                        generator=gen).to(dtype)
    off = (torch.rand(V, Lq, heads, L, P, 2, device=device, generator=gen)
           * 2.0 - 1.0) * (halo - 2)
    if escape:
        far = torch.rand(V, Lq, heads, L, P, 1, device=device,
                         generator=gen) < 0.125
        off = torch.where(far, off * (halo + 6) / (halo - 2), off)
    wh = torch.tensor([[w, h] for h, w in levels],
                      dtype=torch.float32, device=device)
    loc = (c[:, :, None, :, None, :] + off + 0.5) / wh[:, None, :]
    aw = torch.rand(V, Lq, heads, L, P, device=device, generator=gen)
    aw = aw / aw.sum(dim=(3, 4), keepdim=True)
    return value, loc.contiguous(), aw


def level_views(value, levels):
    """The (N, H, h, w, D) level views of a (N, Len_in, H, D) value, strided
    as the corner sampler hands them to the table build (no copy)."""
    sizes = [h * w for h, w in levels]
    return [v.unflatten(2, (h, w)) for v, (h, w) in zip(
        value.transpose(1, 2).split(sizes, dim=2), levels)]


def kernel_cases(root, torch, sets, device="cuda", cfg=None):
    """(name, fn, plain) of B1 at B1_SHAPES ('deform' in sets), of the three
    level calls of the layer-1 plan through B4 ('window_block') or B5
    ('window_dma'), of B2 on the three level views of a value
    ('table_build'), and of the table slots' five maps at SLOT_SIZES
    ('table_slots'), bfloat16, through the checkout at root. `plain`
    computes the same through the kernels' plain versions. The window and
    table cases take their levels, views, heads and plan from `cfg`
    (default: the flagship config of root, whose plan has K = 28)."""
    from mvgformer_tpu_torch.config import load_config
    from mvgformer_tpu_torch.data.synthetic import make_batch
    from mvgformer_tpu_torch.models.mvgformer import (
        build_layer1_window_plan, feature_spatial_shapes, layer1_centers_px)
    from mvgformer_tpu_torch.ops import (deform_attn, gather_forms, sampling,
                                         table_build, window_block,
                                         window_dma, window_sampling)

    gen = torch.Generator(device=device).manual_seed(0)
    cases = []
    for Lq, P in B1_SHAPES if "deform" in sets else ():
        a = sampling_inputs(Lq, P, torch.bfloat16, gen, device=device)
        cases.append((f"deform_sample Lq {Lq} P {P}",
                      lambda a=a: deform_attn.deform_sample(
                          a[0], FLAGSHIP_LEVELS, a[1], a[2]),
                      lambda a=a: sampling.deform_sample(
                          a[0], FLAGSHIP_LEVELS, a[1], a[2])))
    if cfg is None:
        cfg = load_config(str(Path(root, "configs", "panoptic",
                                   "knn5-lr4-q1024.yaml")))
    levels = feature_spatial_shapes(cfg)
    heads = cfg.DECODER.nhead
    head_dim = cfg.DECODER.d_model // heads
    plain = {window_block.window_block_matmul:
             window_block.window_block_matmul_plain,
             window_dma.window_block_dma: window_dma.window_block_dma_plain}
    for kernels, impl in (("window_block", "pallas"),
                          ("window_dma", "pallas_dma")):
        if kernels not in sets:
            continue
        batch = make_batch(cfg, batch_size=1, seed=0, num_people=3,
                           cam_seed=0, device=device)
        plan = build_layer1_window_plan(cfg, batch.view_data, device=device)
        value, loc, aw = window_inputs(
            layer1_centers_px(cfg, batch.view_data), plan.halo, 4,
            torch.bfloat16, gen, escape=True, levels=levels, heads=heads,
            head_dim=head_dim, device=device)
        calls = window_sampling.level_calls(value, levels, loc, aw, plan,
                                            impl=impl)
        cases.append((f"{calls[0].fn.__name__} K {plan.levels[0].K} P 4, "
                      f"{len(calls)} levels",
                      lambda calls=calls: [c.fn(*c.args, **c.kwargs)
                                           for c in calls],
                      lambda calls=calls: [plain[c.fn](*c.args, **c.kwargs)
                                           for c in calls]))
    if "table_build" in sets:
        value = torch.randn(cfg.DATASET.CAMERA_NUM,
                            sum(h * w for h, w in levels), heads, head_dim,
                            device=device, generator=gen).to(torch.bfloat16)
        views = level_views(value, levels)
        cases.append((f"build_corner_table {len(views)} levels",
                      lambda: [table_build.build_corner_table(v)
                               for v in views],
                      lambda: [table_build.build_corner_table_plain(v)
                               for v in views]))
    maps = list(gather_forms.SLOT_MAPS.values())
    for h, w in SLOT_SIZES if "table_slots" in sets else ():
        v = torch.randn(40, h, w, 32, device=device, generator=gen).to(
            torch.bfloat16)
        cases.append((f"table_slots d0-d4 at ({h}, {w})",
                      lambda v=v: [gather_forms.table_slots(v, m)
                                   for m in maps],
                      lambda v=v: [gather_forms.table_slots_plain(v, m)
                                   for m in maps]))
    return cases


def max_abs_err(got, want):
    """The largest |got - want| over a tensor or a list of them, in
    float32."""
    if not isinstance(got, list):
        got, want = [got], [want]
    return max(float((g.float() - w.float()).abs().max())
               for g, w in zip(got, want))


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", default=str(Path(__file__).resolve()
                                              .parents[2]))
    parser.add_argument("--label", default=None)
    parser.add_argument("--kernels", default="probes",
                        help="comma-separated: " + ", ".join(KERNEL_SETS))
    args = parser.parse_args(argv)
    sets = args.kernels.split(",")
    if not set(sets) <= set(KERNEL_SETS):
        parser.error(f"--kernels takes {KERNEL_SETS}, got {sets}")
    sys.path.insert(0, str(Path(args.root).resolve()))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        sys.exit("launch_cost needs a CUDA card")
    from mvgformer_tpu_torch.ops import gather_forms

    head = {"root": args.root, "label": args.label,
            "device": torch.cuda.get_device_name(0)}
    if "probes" in sets:
        rng = np.random.default_rng(0)
        for name, kernel, library in cases(gather_forms, torch, rng):
            row = {"case": name, **head}
            for key, fn in (("", kernel), ("library_", library)):
                row[key + "ms"] = cuda_ms(fn)
                row[key + "device_ms"], row[key + "host_us"] = device_ms(fn)
            print(json.dumps(row), flush=True)
        print(json.dumps({"case": "take_along host path", **head,
                          **host_breakdown(gather_forms, torch)}),
              flush=True)
    for name, fn, plain in kernel_cases(args.root, torch, sets):
        err = max_abs_err(fn(), plain())
        dev_ms, host_us = device_ms(fn)
        print(json.dumps({"case": name, **head, "ms": cuda_ms(fn),
                          "device_ms": dev_ms, "host_us": host_us,
                          "max_abs_err": err}), flush=True)


if __name__ == "__main__":
    main()
