"""build_model builds and serves every value of TRANSFORMER,
init_ref_method, feature_update_method, triangulation_method,
init_self_attention, bayesian_update, share_layer_weights,
TRAIN.SAMPLE_CHUNKS, PARALLEL.REMAT_POLICY and, on the MvP model,
projattn_posembed_mode, fuse_view_feats and query_adaptation that the JAX
package accepts, one value at a time on the toy config of
tests/torch_parity.py: every layer's poses finite. The values JAX refuses
are refused in tests/test_torch_decoder_variants.py and
tests/test_torch_mvp.py."""

import pytest
import torch

from mvgformer_tpu_torch.data.synthetic import make_batch
from mvgformer_tpu_torch.models import build_model
from torch_one_thread import one_torch_thread  # noqa: F401
from torch_parity import toy_cfg

# (key, values, on the MvP model)
ACCEPTED = [
    ("TRANSFORMER", ["dq_transformer", "multi_view_pose_transformer"], False),
    ("DECODER.init_ref_method", ["sample_space", "gt_noise", "query_adapt",
                                 "query_adapt_center", "voxcel_pose_base"],
     False),
    ("DECODER.feature_update_method", [
        "MLP", "MLP0", "MLPr", "mean", "attention", "attention_embed",
        "attention_direct", "attention_embed_direct"], False),
    ("DECODER.triangulation_method", ["linalg", "eigh", "jacobi", "st"],
     False),
    ("DECODER.init_self_attention", [True], False),
    ("DECODER.bayesian_update", [True], False),
    ("DECODER.share_layer_weights", [True], False),
    ("TRAIN.SAMPLE_CHUNKS", [None, 1, 2, 7], False),
    ("PARALLEL.REMAT_POLICY", ["full", "save_sampled"], False),
    ("DECODER.projattn_posembed_mode", [
        "use_rayconv", "use_2d_coordconv", "ablation_not_use_rayconv"], True),
    ("DECODER.fuse_view_feats", [
        "mean", "cat_proj", "sum_proj", "attn_fuse_dot_prod",
        "attn_fuse_subtract"], True),
    ("DECODER.query_adaptation", [True, False], True),
]


@pytest.mark.parametrize("key,value,mvp", [
    (k, v, mvp) for k, vals, mvp in ACCEPTED for v in vals])
def test_build_model_accepts_every_option(key, value, mvp):
    cfg = toy_cfg({"DECODER.num_instance": 4,
                   "MULTI_PERSON.MAX_PEOPLE_NUM": 4})
    if mvp:
        cfg.TRANSFORMER = "multi_view_pose_transformer"
    *path, name = key.split(".")
    node = cfg
    for part in path:
        node = getattr(node, part)
    setattr(node, name, value)
    model = build_model(cfg, device="cpu")
    batch = make_batch(cfg, seed=1, num_people=2, device="cpu")
    if cfg.DECODER.init_ref_method == "voxcel_pose_base":
        batch.targets.voxelpose_pred = torch.cat(
            [batch.targets.joints_3d, torch.ones(
                batch.targets.joints_3d.shape[:-1] + (2,))], dim=-1)
    with torch.no_grad():
        outs = model(batch)
    assert len(outs) == cfg.DECODER.num_decoder_layers
    assert all(torch.isfinite(o["pred_poses"]).all() for o in outs)
