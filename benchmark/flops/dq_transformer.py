"""MVGFormer: the DQ decoder with top-K queries after layer 1 and
point-top-m."""

from __future__ import annotations

from benchmark.flops import common

# per triangulated point and view: the 2V x 4 system's Gram matrix
GRAM_FLOPS_PER_VIEW = 2 * 2 * 4 * 4
# per point: 6 cyclic sweeps x 6 rotations, each ~60 multiplies and adds
# (the angle, the 4x4 update and the accumulated rotation)
JACOBI_FLOPS = 6 * 6 * 60


def train_step(s: dict) -> dict:
    dense = dict(s, **{"DECODER.inference_topk_queries": None,
                       "DECODER.inference_point_topm": None})
    out = serve_frame(dense)
    backbone = s["DATASET.CAMERA_NUM"] * common.backbone(s)
    return {k: (backbone + 3 * (v - backbone)) if k == "matmul" else 3 * v
            for k, v in out.items()}


def serve_frame(s: dict) -> dict:
    V = s["DATASET.CAMERA_NUM"]
    C, F = s["DECODER.d_model"], s["DECODER.dim_feedforward"]
    Q, J = s["DECODER.num_instance"], s["DECODER.num_keypoints"]
    K = s["DECODER.inference_topk_queries"] or Q
    P = s["DECODER.inference_point_topm"] or s["DECODER.dec_n_points"]
    layers = s["DECODER.num_decoder_layers"]
    head = [C] * s["DECODER.pose_embed_layer"] + [3]
    out = {"matmul": V * common.backbone(s), "sample": 0.0, "solve": 0.0}
    for lid in range(layers):
        rows = (Q if lid == 0 else K) * J  # queries attended
        kept = K * J  # queries triangulated
        for kind, n in common.proj_attn(s, V, rows, P).items():
            out[kind] += n
        out["matmul"] += (common.mlp(rows, [C, C])  # feature_update_mlp
                          + common.mlp(rows, [C, F, C])  # the FFN
                          + common.mlp(rows, [C, 2])  # class_embed
                          + common.mlp(V * kept, head))  # offsets, conf.
        out["solve"] += kept * (V * GRAM_FLOPS_PER_VIEW + JACOBI_FLOPS)
    return out
