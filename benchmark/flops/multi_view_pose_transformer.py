"""The MvP baseline: dense queries, self-attention, camera rays, cat_proj
view fusion."""

from __future__ import annotations

from benchmark.flops import common

RAY_CHANNELS = {"ablation_not_use_rayconv": 0, "use_rayconv": 3,
                "use_2d_coordconv": 2}


def serve_frame(s: dict) -> dict:
    V = s["DATASET.CAMERA_NUM"]
    C, F = s["DECODER.d_model"], s["DECODER.dim_feedforward"]
    rows = s["DECODER.num_instance"] * s["DECODER.num_keypoints"]
    P = s["DECODER.dec_n_points"]
    extra = RAY_CHANNELS[s["DECODER.projattn_posembed_mode"]]
    head = [C] * s["DECODER.pose_embed_layer"] + [3]
    out = {"matmul": V * common.backbone(s), "sample": 0.0}
    if s["DECODER.query_adaptation"]:
        out["matmul"] += common.mlp(1, [V * common.levels(s) * C, C])
    out["matmul"] += common.mlp(rows, [C, 3])  # reference_points
    for _ in range(s["DECODER.num_decoder_layers"]):
        for kind, n in common.proj_attn(s, V, rows, P, extra).items():
            out[kind] += n
        out["matmul"] += (common.mlp(rows, [C, 3 * C])  # q, k, v
                          + 2 * 2.0 * rows * rows * C  # scores, values
                          + common.mlp(rows, [C, C])  # out_proj
                          + common.mlp(rows, [V * C, C])  # cat_proj
                          + common.mlp(rows, [C, F, C])  # the FFN
                          + common.mlp(rows, head)  # pose_embed
                          + common.mlp(rows, [C, 2]))  # class_embed
    return out
