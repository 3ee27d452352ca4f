"""VoxelPose: PoseResNet's heatmaps on every view, then the V2V networks
over voxel volumes: the cuboid proposal network's once a frame and the
pose regression network's once a candidate (the port runs it on every one
of MAX_PEOPLE_NUM candidates)."""

from __future__ import annotations

import math

from benchmark.flops import common


def conv3d(cin: int, cout: int, k: int, voxels: int) -> float:
    """A k^3 convolution over `voxels` output voxels; a stride-2
    transposed convolution of kernel 2 over `voxels` input voxels (each
    meets k^3 taps)."""
    return 2.0 * cin * cout * k ** 3 * voxels


def res3d(cin: int, cout: int, voxels: int) -> float:
    skip = conv3d(cin, cout, 1, voxels) if cin != cout else 0.0
    return conv3d(cin, cout, 3, voxels) + conv3d(cout, cout, 3, voxels) + skip


def v2v(cin: int, cout: int, bins) -> float:
    """V2VNet on one volume of `bins` voxels: the front layers and the
    skip at full size, the encoder at an eighth and a 64th, the decoder
    back up."""
    n = math.prod(bins)
    half, quarter = n // 8, n // 64
    return (conv3d(cin, 16, 7, n) + res3d(16, 32, n)
            + res3d(32, 32, n)  # skip_res1
            + res3d(32, 64, half) + res3d(64, 64, half)  # encoder_res1, skip
            + res3d(64, 128, quarter)  # encoder_res2
            + 2 * res3d(128, 128, quarter)  # mid_res, decoder_res2
            + conv3d(128, 64, 2, quarter)  # decoder_upsample2
            + res3d(64, 64, half)  # decoder_res1
            + conv3d(64, 32, 2, half)  # decoder_upsample1
            + conv3d(32, cout, 1, n))  # output_layer


def serve_frame(s: dict) -> dict:
    V, J = s["DATASET.CAMERA_NUM"], s["NETWORK.NUM_JOINTS"]
    M = s["MULTI_PERSON.MAX_PEOPLE_NUM"]
    W, H = s["NETWORK.IMAGE_SIZE"]
    root_bins = s["MULTI_PERSON.INITIAL_CUBE_SIZE"]
    pose_bins = s["PICT_STRUCT.CUBE_SIZE"]
    # the heatmap head, a 1x1 convolution at a quarter of the image
    head = common.conv(s["POSE_RESNET.NUM_DECONV_FILTERS"][-1], J, 1,
                       H // 4, W // 4)
    matmul = (V * (common.backbone(s) + head) + v2v(J, 1, root_bins)
              + M * v2v(J, J, pose_bins))
    # every voxel centre sampled in every view, each of J channels
    voxels = math.prod(root_bins) + M * math.prod(pose_bins)
    return {"matmul": matmul, "sample": voxels * V * J * common.SAMPLE_FLOPS}
