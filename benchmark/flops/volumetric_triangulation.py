"""The volumetric Learnable Triangulation model: PoseResNet with its
heatmap head and `process_features` on every view, the five-level V2V over
the aggregated feature cube (`matmul`); the unprojection of every cube
point into every view's processed features and the base joint's 2D
soft-argmax over its heatmaps (`sample`); the base joint's DLT over the
views (`solve`)."""

from __future__ import annotations

import math

from benchmark.flops import common
from benchmark.flops.dq_transformer import GRAM_FLOPS_PER_VIEW, JACOBI_FLOPS
from benchmark.flops.voxelpose import conv3d, res3d

# the channels at each level of the V2V's encoder-decoder, the input's
# first
LEVELS = (32, 64, 128, 128, 128, 128)


def v2v_model(cin: int, cout: int, bins) -> float:
    """V2VModel on one volume of `bins` voxels: the front and back layers
    at full size; at each level a skip of its input, the encoder's block
    at an eighth of the voxels, the decoder's block there and its
    transposed convolution back up; the middle block at the bottom."""
    n = math.prod(bins)
    total = (conv3d(cin, 16, 7, n) + res3d(16, 32, n) + 2 * res3d(32, 32, n)
             + res3d(32, 32, n) + 2 * conv3d(32, 32, 1, n)
             + conv3d(32, cout, 1, n))
    for i in range(1, len(LEVELS)):
        above, here = n // 8 ** (i - 1), n // 8 ** i
        total += (res3d(LEVELS[i - 1], LEVELS[i - 1], above)  # skip_res<i>
                  + res3d(LEVELS[i - 1], LEVELS[i], here)  # encoder_res<i>
                  + res3d(LEVELS[i], LEVELS[i], here)  # decoder_res<i>
                  # decoder_upsample<i>, over its input voxels
                  + conv3d(LEVELS[i], LEVELS[i - 1], 2, here))
    return total + res3d(LEVELS[-1], LEVELS[-1], n // 8 ** (len(LEVELS) - 1))


def serve_frame(s: dict) -> dict:
    V, J = s["DATASET.CAMERA_NUM"], s["NETWORK.NUM_JOINTS"]
    W, H = s["NETWORK.IMAGE_SIZE"]
    C = s["POSE_RESNET.NUM_DECONV_FILTERS"][-1]
    F = s["NETWORK.VOLUME_FEATURES"]
    bins = s["PICT_STRUCT.CUBE_SIZE"]
    h, w = H // 4, W // 4
    # the heatmap head and process_features, 1x1 convolutions at a quarter
    # of the image
    heads = common.conv(C, J, 1, h, w) + common.conv(C, F, 1, h, w)
    matmul = V * (common.backbone(s) + heads) + v2v_model(F, J, bins)
    # every cube point sampled in every view, each of F channels; the base
    # joint's heatmap read once in every view
    sample = (math.prod(bins) * V * F + V * h * w) * common.SAMPLE_FLOPS
    solve = V * GRAM_FLOPS_PER_VIEW + JACOBI_FLOPS
    return {"matmul": matmul, "sample": sample, "solve": float(solve)}
