"""The FLOP counter against counts made by hand and by PyTorch's own
FLOP counter on the plain reference, at toy widths."""

from __future__ import annotations

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

import harness_toy

from benchmark import check, flops, frames, weights
from benchmark.flops import common
from benchmark.reference import model as ref_model


def test_conv_by_hand():
    # a 3x3 convolution, 2 -> 4 channels, on a 5x6 output: 2*2*4*9*30
    assert common.conv(2, 4, 3, 5, 6) == 2 * 2 * 4 * 9 * 30


def test_mlp_by_hand():
    assert common.mlp(10, [4, 8, 2]) == 2 * 10 * (4 * 8 + 8 * 2)


@pytest.mark.parametrize("config", sorted(harness_toy.CONFIGS))
def test_matmul_flops_match_torchs_counter(config):
    spec = harness_toy.spec(config)
    s = spec["settings"]
    traffic = harness_toy.traffic()
    cpu = torch.device("cpu")
    from benchmark import program

    shapes = weights.float_shapes(program.model(program.config(spec), cpu))
    net = ref_model.Net(weights.draw(shapes, 11, cpu))
    ring = frames.make_ring(spec, traffic, 11, cpu)
    counter = FlopCounterMode(display=False)
    with counter, torch.no_grad():
        check.family(spec)(spec, net, ring.frame([0], cpu))
    counted = counter.get_total_flops()
    want = flops.serve_frame_parts(s)["matmul"]
    # torch also counts the geometry's small products (projections,
    # affines, the rays' inverse intrinsics), which the model count leaves
    # out: under 1% at these widths
    assert want <= counted <= want * 1.01


def test_training_step_is_the_backbone_and_three_dense_decoders():
    s = harness_toy.spec("mvgformer_panoptic5")["settings"]
    dense = dict(s, **{"DECODER.inference_topk_queries": None,
                       "DECODER.inference_point_topm": None})
    backbone = s["DATASET.CAMERA_NUM"] * common.backbone(s)
    serve = flops.serve_frame(dense)
    assert flops.train_step(s) == pytest.approx(backbone
                                                + 3 * (serve - backbone))
