"""The port's own config tree (mvgformer_tpu_torch/config.py) against the
JAX package's (mvgformer_tpu/config.py): the same tree and values for the
defaults and every YAML under configs/, the same dotted overrides, and the
same KeyError for a key that does not exist. The port's tree holds the
JAX package's and, besides, exactly the keys of PORT_ONLY, for models the
JAX package does not build, at the defaults named there."""

import dataclasses
import glob
import os

import pytest

from mvgformer_tpu import config as jconfig
from mvgformer_tpu_torch import config as tconfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
YAMLS = sorted(os.path.relpath(p, REPO) for p in glob.glob(
    os.path.join(REPO, "configs", "**", "*.yaml"), recursive=True))
OVERRIDES = ["DECODER.nhead=4", "DECODER.use_feat_level=[0,2]",
             "TRAIN.LR=1e-3", "PARALLEL.REMAT_DECODER=false",
             "DECODER.inference_topk_queries=64", "DATASET.CAMERA_NUM=3",
             "NETWORK.IMAGE_SIZE=480,256", "OUTPUT_DIR=/tmp/x"]
# the keys of the volumetric Learnable Triangulation model
# (`models/volumetric.py`), with their types and defaults
PORT_ONLY = {"NETWORK.HEATMAP_MULTIPLIER": ("float", 100.0),
             "NETWORK.VOLUME_FEATURES": ("int", 32),
             "NETWORK.BASE_JOINT": ("int", 6)}


def _tree(cfg):
    """The config as nested dicts, with each leaf's value and type."""
    def leaf(v):
        return (type(v).__name__, v)
    flat = {}

    def walk(d, path):
        for k, v in d.items():
            if isinstance(v, dict):
                walk(v, f"{path}{k}.")
            else:
                flat[path + k] = leaf(v)
    walk(dataclasses.asdict(cfg), "")
    return flat


def _shared(cfg):
    """The port's tree without its own keys, which hold their defaults
    (no YAML under configs/ and no override below sets them)."""
    tree = _tree(cfg)
    assert {k: tree.pop(k) for k in PORT_ONLY} == PORT_ONLY
    return tree


def test_the_configs_directory_is_found():
    assert len(YAMLS) >= 5, YAMLS


@pytest.mark.parametrize("yaml_path", [None] + YAMLS)
def test_load_config_equals_jax(yaml_path):
    path = None if yaml_path is None else os.path.join(REPO, yaml_path)
    want = _tree(jconfig.load_config(path))
    got = _shared(tconfig.load_config(path))
    assert got == want


@pytest.mark.parametrize("yaml_path", [None, YAMLS[0]])
def test_dotted_overrides_equal_jax(yaml_path):
    path = None if yaml_path is None else os.path.join(REPO, yaml_path)
    want = jconfig.load_config(path, OVERRIDES)
    got = tconfig.load_config(path, OVERRIDES)
    assert _shared(got) == _tree(want)
    assert got.DECODER.use_feat_level == [0, 2]
    assert got.NETWORK.IMAGE_SIZE == [480, 256]
    assert got.PARALLEL.REMAT_DECODER is False


@pytest.mark.parametrize("override", ["DECODER.no_such_knob=1",
                                      "NO_SECTION.knob=1", "NO_KEY=1"])
def test_unknown_override_raises_keyerror(override):
    with pytest.raises(KeyError) as want:
        jconfig.load_config(None, [override])
    with pytest.raises(KeyError) as got:
        tconfig.load_config(None, [override])
    assert str(got.value) == str(want.value)


def test_unknown_yaml_key_raises_keyerror(tmp_path):
    for text in ("DECODER:\n  no_such_knob: 1\n", "NO_SECTION: 1\n"):
        path = tmp_path / "bad.yaml"
        path.write_text(text)
        with pytest.raises(KeyError) as want:
            jconfig.load_config(str(path))
        with pytest.raises(KeyError) as got:
            tconfig.load_config(str(path))
        assert str(got.value) == str(want.value)


def test_the_port_has_its_own_classes():
    assert tconfig.Config is not jconfig.Config
    assert tconfig.Config.__module__ == "mvgformer_tpu_torch.config"
