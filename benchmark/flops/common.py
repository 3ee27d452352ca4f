"""The parts both model families share: the backbone and projective
attention."""

from __future__ import annotations

from typing import Dict

RESNET_BLOCKS = {18: (2, 2, 2, 2), 34: (3, 4, 6, 3), 50: (3, 4, 6, 3),
                 101: (3, 4, 23, 3), 152: (3, 8, 36, 3)}
STRIDES = (16, 8, 4)
# FLOPs of one bilinear sample per channel: 4 corners x a multiply-add,
# and the weighted sum into the output
SAMPLE_FLOPS = 10


def conv(cin: int, cout: int, k: int, h_out: int, w_out: int) -> float:
    return 2.0 * cin * cout * k * k * h_out * w_out


def backbone(s: dict) -> float:
    """PoseResNet (bottleneck blocks) on one view, with its three stride-2
    deconvolutions (kernel 4)."""
    W, H = s["NETWORK.IMAGE_SIZE"]
    h, w = H // 2, W // 2
    total = conv(3, 64, 7, h, w)
    h, w = (h + 1) // 2, (w + 1) // 2  # the max pool
    cin = 64
    for li, (planes, blocks) in enumerate(zip(
            (64, 128, 256, 512), RESNET_BLOCKS[s["POSE_RESNET.NUM_LAYERS"]])):
        for bi in range(blocks):
            stride = (1 if li == 0 else 2) if bi == 0 else 1
            ho, wo = (h + stride - 1) // stride, (w + stride - 1) // stride
            total += conv(cin, planes, 1, h, w)
            total += conv(planes, planes, 3, ho, wo)
            total += conv(planes, planes * 4, 1, ho, wo)
            if bi == 0 and (stride != 1 or cin != planes * 4):
                total += conv(cin, planes * 4, 1, ho, wo)
            cin, h, w = planes * 4, ho, wo
    for f in s["POSE_RESNET.NUM_DECONV_FILTERS"]:
        total += conv(cin, f, 4, h, w)  # each input pixel meets k x k taps
        cin, h, w = f, 2 * h, 2 * w
    return total


def level_pixels(s: dict) -> int:
    W, H = s["NETWORK.IMAGE_SIZE"]
    return sum((H // st) * (W // st) for i, st in enumerate(STRIDES)
               if i in s["DECODER.use_feat_level"])


def levels(s: dict) -> int:
    return sum(1 for i in range(len(STRIDES))
               if i in s["DECODER.use_feat_level"])


def proj_attn(s: dict, views: int, queries: int, points: int,
              extra_channels: int = 0) -> Dict[str, float]:
    """One projective attention over `views` maps for `queries` queries,
    `points` of the P points sampled per head and level."""
    C, H = s["DECODER.d_model"], s["DECODER.nhead"]
    P, L = s["DECODER.dec_n_points"], levels(s)
    nl = s["DECODER.num_feature_levels"]
    rows = views * queries
    matmul = 2.0 * views * level_pixels(s) * (C + extra_channels) * C
    matmul += 2.0 * rows * L * C * H * nl * P * 3  # offsets (2), weights
    matmul += 2.0 * rows * C * C  # output_proj
    sample = rows * L * SAMPLE_FLOPS * C  # the reference-point features
    sample += rows * H * L * nl * points * SAMPLE_FLOPS * (C // H)
    return {"matmul": matmul, "sample": sample}


def mlp(rows: int, dims) -> float:
    return sum(2.0 * rows * a * b for a, b in zip(dims[:-1], dims[1:]))
