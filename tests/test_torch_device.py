"""The port's entry points run on the card unless the caller asks for the
CPU: `MVGFormer`, `make_batch` and `build_layer1_window_plan` default to
"cuda" and raise without a card, never carrying on on the CPU; with
device="cpu" every tensor they make lies on the CPU; and the weights come
from the caller's CPU generator alone, so a seed gives the same weights
whatever the global generator holds."""

import pytest
import torch

from mvgformer_tpu_torch.config import load_config
from mvgformer_tpu_torch.data.synthetic import make_batch
from mvgformer_tpu_torch.device import resolve_device
from mvgformer_tpu_torch.models.mvgformer import (MVGFormer,
                                                  build_layer1_window_plan)


def _cfg():
    cfg = load_config()
    cfg.NETWORK.IMAGE_SIZE = [96, 64]
    cfg.DECODER.d_model = 32
    cfg.DECODER.dim_feedforward = 64
    cfg.DECODER.nhead = 4
    cfg.DECODER.num_decoder_layers = 2
    cfg.DECODER.num_instance = 16
    cfg.POSE_RESNET.NUM_DECONV_FILTERS = [32, 32, 32]
    cfg.DATASET.CAMERA_NUM = 3
    cfg.MULTI_PERSON.MAX_PEOPLE_NUM = 4
    return cfg


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_resolve_device(no_card):
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        resolve_device(torch.device("cuda", 0))


def test_entry_points_default_to_the_card(no_card):
    cfg = _cfg()
    with pytest.raises(RuntimeError, match="no CUDA card"):
        MVGFormer(cfg, generator=torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="no CUDA card"):
        make_batch(cfg, seed=1)
    batch = make_batch(cfg, seed=1, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        build_layer1_window_plan(cfg, batch.view_data)


def _tensors(obj):
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, (tuple, list)):
        for x in obj:
            yield from _tensors(x)
    elif hasattr(obj, "__dataclass_fields__") or hasattr(obj, "_fields"):
        names = getattr(obj, "_fields", None) or obj.__dataclass_fields__
        for name in names:
            yield from _tensors(getattr(obj, name))


def test_cpu_when_asked():
    cfg = _cfg()
    model = MVGFormer(cfg, generator=torch.Generator().manual_seed(0),
                      device="cpu")
    assert {t.device.type for t in model.state_dict().values()} == {"cpu"}
    assert model.init_reference.device.type == "cpu"
    batch = make_batch(cfg, seed=1, device="cpu")
    found = list(_tensors(batch))
    assert len(found) > 5 and {t.device.type for t in found} == {"cpu"}
    plan = build_layer1_window_plan(cfg, batch.view_data, device="cpu")
    arrays = list(_tensors(plan.levels))
    assert arrays and {t.device.type for t in arrays} == {"cpu"}


def test_a_seed_fixes_the_weights():
    cfg = _cfg()
    torch.manual_seed(1)
    a = MVGFormer(cfg, generator=torch.Generator().manual_seed(0),
                  device="cpu").state_dict()
    torch.manual_seed(2)
    b = MVGFormer(cfg, generator=torch.Generator().manual_seed(0),
                  device="cpu").state_dict()
    assert a.keys() == b.keys()
    assert all(torch.equal(a[k], b[k]) for k in a)
