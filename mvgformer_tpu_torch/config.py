"""Configuration tree of the port.

The port's own copy of the JAX package's `mvgformer_tpu/config.py`: the same
dataclass tree, defaults, YAML overlay and dotted overrides, so both packages
read the same experiment files and key names, and the port imports nothing
of the JAX package. `tests/test_torch_config.py` holds the two against each
other on every YAML under `configs/`.

A typed dataclass mirror of the original repo's global edict config
(lib/core/config.py:32-330), preserving its key names (section and knob) so
the shipped YAML experiment configs (configs/panoptic/*.yaml,
configs/shelf_campus/*.yaml) load unmodified, and so `KEY.SUBKEY=value` CLI
overrides behave like its update_config_dynamic_input
(lib/core/config.py:377-392).

There is no mutable module-global config; `load_config` returns an
immutable-by-convention Config object that is threaded explicitly.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, List, Optional, Sequence, Tuple

import yaml


def _f(default):
    return field(default_factory=lambda: list(default))


@dataclass
class NetworkConfig:
    # reference: lib/core/config.py:75-100 (NETWORK section)
    PRETRAINED: str = ""
    PRETRAINED_BACKBONE: str = ""
    NUM_JOINTS: int = 15
    IMAGE_SIZE: List[int] = _f([960, 512])  # (W, H)
    HEATMAP_SIZE: List[int] = _f([240, 128])
    SIGMA: float = 3
    TARGET_TYPE: str = "gaussian"
    AGGRE: bool = True
    USE_GT: bool = False
    BETA: float = 100.0
    INPUT_SIZE: int = 512
    # The port's own keys, for the volumetric Learnable Triangulation model
    # (`models/volumetric.py`; its yaml's `model.heatmap_multiplier`, and
    # the widths its code fixes): the multiplier of the heatmaps' 2D
    # soft-argmax, the processed feature width, and the joint whose
    # triangulation places the cube.
    HEATMAP_MULTIPLIER: float = 100.0
    VOLUME_FEATURES: int = 32
    BASE_JOINT: int = 6


@dataclass
class PoseResNetConfig:
    # reference: lib/core/config.py POSE_RESNET section
    NUM_LAYERS: int = 50
    DECONV_WITH_BIAS: bool = False
    NUM_DECONV_LAYERS: int = 3
    NUM_DECONV_FILTERS: List[int] = _f([256, 256, 256])
    NUM_DECONV_KERNELS: List[int] = _f([4, 4, 4])
    FINAL_CONV_KERNEL: int = 1


@dataclass
class DatasetConfig:
    # reference: lib/core/config.py DATASET section
    ROOT: str = "data/panoptic/"
    TRAIN_DATASET: str = "panoptic"
    TEST_DATASET: str = "panoptic"
    TRAIN_SUBSET: str = "train"
    TEST_SUBSET: str = "validation"
    ROOTIDX: int = 2
    DATA_FORMAT: str = "jpg"
    DATA_AUGMENTATION: bool = False
    FLIP: bool = False
    COLOR_RGB: bool = True
    ROT_FACTOR: float = 45
    SCALE_FACTOR: float = 0.35
    CAMERA_NUM: int = 5
    SUBSET_SELECTION: str = "all"
    FILTER_VALID_OBSERVATIONS: bool = False
    NMS_DETAIL: bool = True
    NMS_DETAIL_ALL: bool = False
    MAX_DATA_NUM: Optional[int] = None
    # camera arrangements (CMU0 / CMU0ex / CMU1..4), panoptic.py:207-215
    TRAIN_CAM_SEQ: str = "CMU0"
    TEST_CAM_SEQ: str = "CMU0"
    PESUDO_GT: str = ""
    CAMERA_DETAIL: bool = False
    ADD_VOXEL_PRED: bool = False


@dataclass
class MultiPersonConfig:
    # reference: lib/core/config.py:225-230 (MULTI_PERSON section)
    SPACE_SIZE: List[float] = _f([8000.0, 8000.0, 2000.0])
    SPACE_CENTER: List[float] = _f([0.0, -500.0, 800.0])
    INITIAL_CUBE_SIZE: List[int] = _f([80, 80, 20])
    MAX_PEOPLE_NUM: int = 10
    THRESHOLD: float = 0.1


@dataclass
class DecoderConfig:
    # reference: lib/core/config.py:232-330 (DECODER section); defaults follow
    # the shipped configs/panoptic/knn5-lr4-q1024-g8.yaml where they differ.
    d_model: int = 256
    nhead: int = 8
    dim_feedforward: int = 1024
    dropout: float = 0.1
    activation: str = "relu"
    num_feature_levels: int = 1
    dec_n_points: int = 8
    num_decoder_layers: int = 4
    return_intermediate_dec: bool = True
    num_instance: int = 1024
    num_keypoints: int = 15
    num_views: int = 5
    with_pose_refine: bool = True
    aux_loss: bool = False
    lr_linear_proj_mult: float = 0.1
    loss_pose_normalize: bool = False
    loss_joint_type: str = "l1"
    pred_class_fuse: str = "mean"
    pred_conf_threshold: float = 0.5
    match_coord_est: str = "abs"
    match_coord_gt: str = "norm"
    detach_refpoints_cameraprj_firstlayer: bool = True
    fuse_view_feats: str = "cat_proj"
    epipolar_encoder: bool = False
    use_loss_pose_perbone: bool = False
    use_loss_pose_perjoint_aligned: bool = False
    use_loss_pose_perprojection: bool = False
    use_loss_pose_perprojection_2d: bool = True
    use_quality_focal_loss: bool = False
    loss_weight_loss_ce: float = 2.0
    loss_pose_perjoint: float = 5.0
    loss_pose_perbone: float = 5.0
    loss_pose_perjoint_aligned: float = 5.0
    loss_heatmap2d: float = 2.0
    loss_pose_perprojection_2d: float = 5.0
    pose_embed_layer: int = 3
    query_embed_type: str = "person_joint"
    optimizer: str = "adam"
    lr_decay_epoch: List[int] = _f([40])
    projattn_posembed_mode: str = "ablation_not_use_rayconv"
    use_feat_level: List[int] = _f([0, 1, 2])
    query_adaptation: bool = True
    inference_conf_thr: List[float] = _f([0.1])
    convert_joint_format_indices: Optional[List[int]] = None
    t_pose_dir: str = "./tpose.pt"
    feature_update_method: str = "MLP"
    init_self_attention: bool = False
    open_forward_ffn: bool = True
    query_filter_method: str = "threshold"
    init_ref_method: str = "sample_space"
    init_ref_method_value: Optional[float] = 0
    gt_match: bool = True
    close_pose_embedding: bool = False
    share_layer_weights: bool = False
    bayesian_update: bool = False
    triangulation_method: str = "linalg"
    decay_method: str = "none"
    gt_match_test: bool = False
    match_method: str = "KNN"
    match_method_value: float = 5
    use_ce_match: bool = False
    filter_query: bool = True
    loss_weight_init: float = 0.0
    # TPU-native inference fast path (no reference equivalent): after the
    # first decoder layer, keep only the top-K person queries by class
    # score and run the remaining layers compacted (static shapes).
    # Queries dropped here cannot re-enter, unlike the reference's
    # zeroed-but-still-attending filtered queries; None disables.
    inference_topk_queries: Optional[int] = None
    # TPU-native inference fast path: layer-1 deformable sampling via
    # rig-static tile bucketing + blocked MXU einsums instead of
    # per-sample gathers (ops/window_sampling.py). Exact while learned
    # offsets stay within `layer1_window_halo - 2` px of the projected
    # grid centers (always true at offset init); escaped samples read
    # zero and their weight mass is tracked as telemetry. The eval loop
    # builds the plan from the first batch's cameras (one rig per run).
    layer1_windowed_sampling: bool = False
    layer1_window_halo: Optional[int] = None  # default dec_n_points + 2
    layer1_window_tile: int = 8
    # 'xla' (blocked einsum) or 'pallas' (scalar-prefetch tile kernel,
    # ops/window_pallas.py); TPU-only either way
    layer1_window_impl: str = "xla"
    # SEMANTICS-CHANGING inference fast path: clamp the layer-1 learned
    # sampling offsets to +-this many pixels (each level's own pixel
    # units). With layer1_window_halo >= clamp + 2 the windowed path is
    # then EXACT w.r.t. the clamped model (escape mass ~0) and its VPU
    # cost shrinks ~(K/28)^2. AP cost of the clamp itself is measured by
    # tools/ap_ablation.py before this may back a headline number.
    # None = off (reference semantics).
    layer1_offset_clamp: Optional[float] = None
    # SEMANTICS-CHANGING inference fast path: per (query, head, level),
    # sample only the top-m of the P learned attention points by softmax
    # weight (kept weights renormalized so total attention mass stays 1).
    # Deformable-gather rows — the measured v5e wall (PERF.md "gather
    # wall") — scale by m/P across ALL decoder layers. AP cost is
    # measured by tools/ap_ablation.py before this may back a headline
    # number. None = off (all P points, reference semantics).
    inference_point_topm: Optional[int] = None
    # clip next-layer reference points into the capture-space box (+50%
    # slack): from-scratch stabilizer — early near-parallel-ray
    # triangulations otherwise run away and each layer amplifies the
    # last. Layer outputs / losses keep raw predictions. Default off
    # (reference behavior).
    clamp_refs_to_space: bool = False


@dataclass
class TrainConfig:
    # reference: lib/core/config.py TRAIN section
    LR: float = 4e-4
    LR_FACTOR: float = 0.1
    LR_STEP: List[int] = _f([20])
    OPTIMIZER: str = "adam"
    MOMENTUM: float = 0.9
    WD: float = 1e-4
    NESTEROV: bool = False
    BEGIN_EPOCH: int = 0
    END_EPOCH: int = 100
    RESUME: bool = False
    FINETUNE_MODEL: Optional[str] = None
    BATCH_SIZE: int = 1
    SHUFFLE: bool = True
    clip_max_norm: float = 0.1
    LR_SCHEDULER: str = "multistep"  # multistep | cosine
    SEED: int = 42
    # train the backbone instead of freezing it (deviation knob: the
    # reference hard-freezes because it always loads pretrained backbone
    # weights, run/train_3d.py:118-121; training from scratch on
    # synthetic data needs the backbone to learn)
    TRAIN_BACKBONE: bool = False
    # linear LR warmup epochs (0 = reference behavior, no warmup)
    WARMUP_EPOCHS: float = 0
    # drop optimizer updates containing non-finite values
    # (optax.apply_if_finite): robustness knob for from-scratch synthetic
    # training where degenerate camera geometry can spike the
    # triangulation VJP; default off (reference has no equivalent)
    SKIP_NONFINITE: bool = False
    # clip the per-point cotangent norm arriving at the triangulation's
    # 2D inputs (geometry/triangulate.py clip_cotangent): from-scratch
    # stabilizer — the DLT jacobian of an ill-conditioned system
    # amplifies the (bounded) 3D L1 cotangent by orders of magnitude,
    # and that noise swamps the well-behaved 2D-reprojection signal in
    # the summed gradient Adam sees. Forward math is bit-identical;
    # default off (the reference never trains from scratch, its
    # pretrained backbone keeps triangulations well-conditioned)
    TRI_GRAD_CLIP: Optional[float] = None
    # the JAX package's query-chunked deformable gather, which keeps its
    # training backward from holding every sample's corner rows; the
    # port's gather-reduce backward holds only the tables, indices and
    # weights, so the value is accepted and the sampler runs unchunked
    # (the same result)
    SAMPLE_CHUNKS: Optional[int] = None


@dataclass
class TestConfig:
    BATCH_SIZE: int = 8
    STATE: str = "best"
    MODEL_FILE: str = ""
    PRED_FILE: Optional[str] = None


@dataclass
class DebugConfig:
    DEBUG: bool = False
    LOG_VAL_LOSS: bool = False
    PRINT_TO_FILE: bool = False
    VISUALIZATION_JUMP_NUM: int = -1
    WANDB_KEY: str = ""
    WANDB_NAME: str = ""
    SAVE_BATCH_IMAGES_GT: bool = True
    SAVE_BATCH_IMAGES_PRED: bool = True
    SAVE_HEATMAPS_GT: bool = True
    SAVE_HEATMAPS_PRED: bool = True


@dataclass
class LossConfig:
    USE_TARGET_WEIGHT: bool = True


@dataclass
class CudnnConfig:
    # accepted for YAML compatibility; has no effect on TPU
    BENCHMARK: bool = True
    DETERMINISTIC: bool = False
    ENABLED: bool = True


@dataclass
class PictStructConfig:
    # accepted for YAML compatibility (unused by the live model path)
    GRID_SIZE: List[float] = _f([2000.0, 2000.0, 2000.0])
    CUBE_SIZE: List[int] = _f([64, 64, 64])
    FIRST_NBINS: int = 16
    PAIRWISE_FILE: str = ""
    RECUR_NBINS: int = 2
    RECUR_DEPTH: int = 10
    LIMB_LENGTH_TOLERANCE: float = 150
    DEBUG: bool = False
    TEST_PAIRWISE: bool = False
    SHOW_ORIIMG: bool = False
    SHOW_CROPIMG: bool = False
    SHOW_HEATIMG: bool = False


@dataclass
class ParallelConfig:
    """TPU-native parallelism knobs (no reference equivalent; the reference
    is single-node DDP only, SURVEY.md §2.8)."""

    # data-parallel axis size; -1 = all available devices
    DATA: int = -1
    # mesh axis names
    MESH_AXES: List[str] = _f(["data"])
    # compute dtype for backbone/attention matmuls
    COMPUTE_DTYPE: str = "bfloat16"
    # parameter dtype
    PARAM_DTYPE: str = "float32"
    # rematerialize the backbone during training to save HBM (moot while
    # the backbone is frozen: its features are stop-gradiented, so no
    # backbone activations are kept for backward anyway)
    REMAT_BACKBONE: bool = True
    # rematerialize each decoder layer in the training backward pass:
    # the flagship train step otherwise exceeds v5e HBM (19.6G vs 15.75G
    # measured; see PERF.md "training memory")
    REMAT_DECODER: bool = True
    # the JAX package's decoder remat policy: 'save_sampled' keeps each
    # layer's sampled features for the backward; the port's sampler
    # backward recomputes no gather forward, so the value is accepted and
    # every policy checkpoints the whole layer ('full')
    REMAT_POLICY: str = "full"


@dataclass
class Config:
    TRANSFORMER: str = "dq_transformer"
    BACKBONE_MODEL: str = "pose_resnet"
    MODEL: str = "multi_person_posenet"
    DATA_DIR: str = ""
    GPUS: str = "0"
    OUTPUT_DIR: str = "output"
    LOG_DIR: str = "log"
    WORKERS: int = 4
    PRINT_FREQ: int = 100

    NETWORK: NetworkConfig = field(default_factory=NetworkConfig)
    POSE_RESNET: PoseResNetConfig = field(default_factory=PoseResNetConfig)
    DATASET: DatasetConfig = field(default_factory=DatasetConfig)
    MULTI_PERSON: MultiPersonConfig = field(default_factory=MultiPersonConfig)
    DECODER: DecoderConfig = field(default_factory=DecoderConfig)
    TRAIN: TrainConfig = field(default_factory=TrainConfig)
    TEST: TestConfig = field(default_factory=TestConfig)
    DEBUG: DebugConfig = field(default_factory=DebugConfig)
    LOSS: LossConfig = field(default_factory=LossConfig)
    CUDNN: CudnnConfig = field(default_factory=CudnnConfig)
    PICT_STRUCT: PictStructConfig = field(default_factory=PictStructConfig)
    PARALLEL: ParallelConfig = field(default_factory=ParallelConfig)


# ---------------------------------------------------------------------------
# YAML overlay + dotted overrides
# ---------------------------------------------------------------------------


def _coerce(value: Any, target: Any) -> Any:
    """Coerce a YAML/CLI value onto the type of the existing default."""
    if target is None or value is None:
        return value
    if isinstance(target, bool):
        if isinstance(value, str):
            return value.lower() in ("1", "true", "yes", "on")
        return bool(value)
    if isinstance(target, int) and not isinstance(target, bool):
        return int(value)
    if isinstance(target, float):
        return float(value)
    if isinstance(target, list):
        return list(value) if isinstance(value, (list, tuple)) else [value]
    return value


def _apply_section(obj: Any, updates: dict, path: str) -> None:
    for key, val in updates.items():
        if not hasattr(obj, key):
            raise KeyError(f"{path}.{key} does not exist in config")
        cur = getattr(obj, key)
        if dataclasses.is_dataclass(cur) and isinstance(val, dict):
            _apply_section(cur, val, f"{path}.{key}")
        else:
            setattr(obj, key, _coerce(val, cur))


def load_config(yaml_path: Optional[str] = None,
                overrides: Optional[Sequence[str]] = None) -> Config:
    """Build a Config: defaults -> YAML overlay -> dotted CLI overrides.

    Mirrors update_config / update_config_dynamic_input
    (the original repo's lib/core/config.py:360-392): unknown YAML keys raise,
    unknown CLI override keys raise too (stricter than the reference, which
    only warned).
    """
    cfg = Config()
    if yaml_path is not None:
        with open(yaml_path) as f:
            data = yaml.safe_load(f) or {}
        for key, val in data.items():
            if not hasattr(cfg, key):
                raise KeyError(f"{key} does not exist in config")
            cur = getattr(cfg, key)
            if dataclasses.is_dataclass(cur):
                if not isinstance(val, dict):
                    raise ValueError(f"section {key} must be a mapping")
                _apply_section(cur, val, key)
            else:
                setattr(cfg, key, _coerce(val, cur))
    for ov in overrides or []:
        apply_override(cfg, ov)
    return cfg


def _parse_value(text: str) -> Any:
    """Parse a CLI override value with type inference, including lists.

    Mirrors lib/utils/string_parser.py:20-34 semantics via YAML parsing.
    """
    text = text.strip()
    if text.startswith("[") or "," in text:
        inner = text.strip("[]")
        return [_parse_value(v) for v in inner.split(",") if v.strip()]
    try:
        return yaml.safe_load(text)
    except yaml.YAMLError:
        return text


def apply_override(cfg: Config, item: str) -> None:
    """Apply one `A.B=value` or `A.B.C=value` override in place."""
    if "=" not in item:
        raise ValueError(f"override must look like KEY.SUBKEY=value: {item}")
    key, _, raw = item.partition("=")
    parts = key.strip().split(".")
    obj: Any = cfg
    for part in parts[:-1]:
        if not hasattr(obj, part):
            raise KeyError(f"{key}: section {part} does not exist in config")
        obj = getattr(obj, part)
    leaf = parts[-1]
    if not hasattr(obj, leaf):
        raise KeyError(f"{key} does not exist in config")
    cur = getattr(obj, leaf)
    setattr(obj, leaf, _coerce(_parse_value(raw), cur))


def config_to_dict(cfg: Any) -> dict:
    """Plain-dict view (for logging / checkpoint metadata)."""
    return dataclasses.asdict(cfg)
