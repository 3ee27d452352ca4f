"""Dataset loaders: CMU Panoptic, Shelf, Campus, Human3.6M and synthetic
scenes, and the registry.

The port's own copy of `mvgformer_tpu/data/datasets.py`: the same on-disk
formats (Panoptic hdPose3d_stage1_coco19 jsons and per-view hdImgs,
Shelf/Campus actorsGT.mat and calibration jsons, H36M annot pickles), the
same sequence lists, camera arrangements and frame intervals, and the same
numpy parsers. `load_batch` returns a Batch of CPU tensors; placing it on
the card is the Prefetcher's job. Images are crop-warped to the network
size and ImageNet-normalized on the host by the native warp (`runtime`),
or cv2 without a compiler; cv2 is imported only where an image file is
read. Projections run through the port's `geometry.cameras.project_points`
on the CPU in float32.
"""

from __future__ import annotations

import dataclasses
import glob
import json
import logging
import os
import os.path as osp
import pickle
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

import torch

from mvgformer_tpu_torch.config import Config
from mvgformer_tpu_torch.core.evaluate import evaluate_ap_mpjpe, evaluate_pcp
from mvgformer_tpu_torch.data.meta import (Batch, Targets,
                                           build_view_data, pad_targets)
from mvgformer_tpu_torch.geometry.cameras import (CameraParams,
                                                  camera_to_world,
                                                  project_points)

logger = logging.getLogger(__name__)

# ---------------------------------------------------------------------------
# Panoptic definitions (the original repo's lib/dataset/panoptic.py:54-215)
# ---------------------------------------------------------------------------

PANOPTIC_TRAIN_SEQS = [
    "160422_ultimatum1", "160224_haggling1", "160226_haggling1",
    "161202_haggling1", "160906_ian1", "160906_ian2", "160906_ian3",
    "160906_band1", "160906_band2",
]
PANOPTIC_VAL_SEQS = [
    "160906_pizza1", "160422_haggling1", "160906_ian5", "160906_band4",
]

# DATASET.SUBSET_SELECTION ablation lists (panoptic.py:54-172): each key
# names a sequence subset; train and val pick from their own table.
_SEQ2_PROGRESSION = [
    "160906_pizza1", "160906_ian2", "160226_haggling1", "161202_haggling1",
    "160422_ultimatum1", "160906_ian1", "160906_ian2", "160906_ian3",
]
PANOPTIC_TRAIN_LISTS = {
    "all": PANOPTIC_TRAIN_SEQS,
    "seq1": ["160906_pizza1"],
    "seq2": ["160906_pizza1"],
    "dbg": ["160906_pizza1"],
    # seq2-N: first N entries of the progression (skipping the held-out
    # haggling seq exactly as the reference's hand-written lists do)
    "seq2-2": _SEQ2_PROGRESSION[:2],
    "seq2-3": ["160906_pizza1", "160906_ian2", "160226_haggling1"],
    "seq2-4": _SEQ2_PROGRESSION[:4],
    "seq2-5": _SEQ2_PROGRESSION[:5],
    "seq2-6": _SEQ2_PROGRESSION[:6],
    "seq2-7": _SEQ2_PROGRESSION[:7],
    "seq2-8": _SEQ2_PROGRESSION[:8],
    "ian-1": ["160906_ian1"],
    "ian-2": ["160906_ian1", "160906_ian2"],
    "ian-3": ["160906_ian1", "160906_ian2", "160906_ian3"],
    "dbg-val": PANOPTIC_VAL_SEQS,
}
PANOPTIC_VAL_LISTS = {
    "all": PANOPTIC_VAL_SEQS,
    "seq1": ["160422_haggling1"],
    "seq2": ["160906_ian5"],
    "dbg": ["160906_pizza1"],
    **{f"seq2-{n}": ["160906_ian5"] for n in range(2, 9)},
    "ian-1": ["160906_ian5"],
    "ian-2": ["160906_ian5"],
    "ian-3": ["160906_ian5"],
    "hag": ["160422_haggling1"],
    "band": ["160906_band4"],
    "all-val": PANOPTIC_TRAIN_SEQS,
    "dbg-val": PANOPTIC_VAL_SEQS,
}

CAM_LIST = {
    "CMU0_ori": [(0, 12), (0, 6), (0, 23), (0, 13), (0, 3)],
    "CMU0": [(0, 3), (0, 6), (0, 12), (0, 13), (0, 23)],
    "CMU1": [(0, 1), (0, 2), (0, 3), (0, 4), (0, 6), (0, 7), (0, 10)],
    "CMU2": [(0, 12), (0, 16), (0, 18), (0, 19), (0, 22), (0, 23), (0, 30)],
    "CMU3": [(0, 10), (0, 12), (0, 16), (0, 18)],
    "CMU4": [(0, 6), (0, 7), (0, 10), (0, 12), (0, 16), (0, 18), (0, 19),
             (0, 22), (0, 23), (0, 30)],
    "CMU0ex": [(0, 3), (0, 6), (0, 12), (0, 13), (0, 23), (0, 10), (0, 16)],
}

# CMU coordinate axis swap (panoptic.py:354-357, 460-462)
PANOPTIC_M = np.array([[1.0, 0.0, 0.0],
                       [0.0, 0.0, -1.0],
                       [0.0, 1.0, 0.0]])

# Panoptic 15-joint -> Shelf/Campus 14-joint conversion
# (configs/shelf_campus/*.yaml convert_joint_format_indices)
PANOPTIC_TO_SHELF14 = [14, 13, 12, 6, 7, 8, 11, 10, 9, 3, 4, 5, 0, 1]


def parse_panoptic_camera(cam: dict) -> Dict[str, np.ndarray]:
    """One calibration entry -> reference camera convention
    (panoptic.py:395-407, 460-472): R' = R @ M, T = -R'.T @ t * 10 (cm->mm),
    k/p split from the OpenCV distCoef vector."""
    K = np.array(cam["K"], dtype=np.float64)
    dist = np.array(cam["distCoef"], dtype=np.float64).reshape(-1)
    R = np.array(cam["R"], dtype=np.float64) @ PANOPTIC_M
    t = np.array(cam["t"], dtype=np.float64).reshape(3, 1)
    return {
        "R": R.astype(np.float32),
        "T": (-R.T @ t * 10.0).astype(np.float32),
        "f": np.array([K[0, 0], K[1, 1]], dtype=np.float32),
        "c": np.array([K[0, 2], K[1, 2]], dtype=np.float32),
        "k": dist[[0, 1, 4]].astype(np.float32),
        "p": dist[[2, 3]].astype(np.float32),
    }


def parse_plain_camera(cam: dict) -> Dict[str, np.ndarray]:
    """Shelf/Campus calibration entry (already in the reference convention:
    R world->cam, T camera position; campus.py:228-248)."""
    return {
        "R": np.array(cam["R"], dtype=np.float32),
        "T": np.array(cam["T"], dtype=np.float32).reshape(3, 1),
        "f": np.array([cam["fx"], cam["fy"]], dtype=np.float32),
        "c": np.array([cam["cx"], cam["cy"]], dtype=np.float32),
        "k": np.array(cam["k"], dtype=np.float32).reshape(-1)[:3],
        "p": np.array(cam["p"], dtype=np.float32).reshape(-1)[:2],
    }


CAMERA_FIELDS = ("R", "T", "f", "c", "k", "p")


def stack_cameras(cams: Sequence[Dict[str, np.ndarray]]) -> CameraParams:
    """List of per-view camera dicts -> (V, ...) CameraParams of float32
    CPU tensors."""
    return CameraParams(**{
        f: torch.from_numpy(np.stack([c[f] for c in cams]).astype(
            np.float32)) for f in CAMERA_FIELDS})


def _project(points: np.ndarray, cams: CameraParams) -> np.ndarray:
    """(V, N, 3) float32 world points -> (V, N, 2) pixels in each view."""
    with torch.no_grad():
        return project_points(
            torch.from_numpy(np.ascontiguousarray(points, np.float32)),
            cams).numpy()


def _load_image(path: str, color_rgb: bool = True) -> np.ndarray:
    import cv2

    img = cv2.imread(path, cv2.IMREAD_COLOR | cv2.IMREAD_IGNORE_ORIENTATION)
    if img is None:
        raise FileNotFoundError(path)
    if color_rgb:
        img = cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
    return img


def _load_and_warp_image(path: str, affine_2x3: np.ndarray,
                         net_size: Tuple[int, int],
                         color_rgb: bool = True) -> np.ndarray:
    """Load, center-crop-warp to net size, ImageNet-normalize (HWC f32).

    Mirrors JointsDataset.__getitem__'s cv2 pipeline
    (lib/dataset/JointsDataset.py:97-116) + the ToTensor/Normalize transform
    (run/train_3d.py:196-203)."""
    from mvgformer_tpu_torch import runtime

    return runtime.warp_normalize_cv2(_load_image(path, color_rgb),
                                      affine_2x3, net_size)


class MultiViewDataset:
    """Shared plumbing: frames -> Batches of CPU tensors.

    A "frame" is one synchronized multi-view sample; the reference stores
    V consecutive db entries per frame (panoptic.py:482-488)."""

    def __init__(self, cfg: Config, image_set: str, is_train: bool):
        self.cfg = cfg
        self.image_set = image_set
        self.is_train = is_train
        self.net_size = tuple(cfg.NETWORK.IMAGE_SIZE)
        self.num_joints = cfg.NETWORK.NUM_JOINTS
        self.max_people = cfg.MULTI_PERSON.MAX_PEOPLE_NUM
        # gt joint count: Panoptic gt is 15-joint; Shelf/Campus gt is the
        # 14-joint format the predictions are converted to
        # (convert_joint_format_indices, dq_transformer.py:582-594)
        self.gt_num_joints = self.num_joints
        self.root_id = cfg.DATASET.ROOTIDX
        self.num_views = cfg.DATASET.CAMERA_NUM
        self.frames: List[dict] = []  # each: {'images': [paths], 'cameras':
        #   CameraParams(V,...), 'image_wh': (V,2), 'joints_3d': (G,J,3),
        #   'joints_3d_vis': (G,J), 'joints_2d_vis': (V,G,J)}

    def __len__(self):
        return len(self.frames)

    def observability_arrays(self, n: int):
        """(gt_joints, per-frame (G, J) 3D-vis or None, per-frame
        (V, G, J) 2D-visibility) for the first n frames, or None when the
        dataset carries no per-view visibility — feeds
        evaluate_by_observability (TEST.CAMERA_DETAIL, reference
        lib/dataset/panoptic.py:577-703)."""
        frames = self.frames[:n]
        if not frames or any(
                fr.get("joints_2d_vis") is None for fr in frames):
            return None
        gts = [fr["joints_3d"] for fr in frames]
        vis3d = [fr.get("joints_3d_vis") for fr in frames]
        if any(v is None for v in vis3d):
            vis3d = None
        vis = [np.asarray(fr["joints_2d_vis"]) for fr in frames]
        return gts, vis3d, vis

    def load_batch(self, indices: Sequence[int],
                   load_images: bool = True) -> Batch:
        """Assemble a Batch of CPU tensors from frame indices."""
        frames = [self.frames[i] for i in indices]
        B = len(frames)
        V = self.num_views
        W, H = self.net_size
        cams = CameraParams(**{
            f: torch.stack([getattr(fr["cameras"], f) for fr in frames])
            for f in CAMERA_FIELDS})
        image_wh = np.stack([fr["image_wh"] for fr in frames])

        J = self.gt_num_joints
        vis2d = np.zeros((B, V, self.max_people, J), dtype=np.float32)
        for b, fr in enumerate(frames):
            g = min(len(fr["joints_3d"]), self.max_people)
            if g and fr.get("joints_2d_vis") is not None:
                vis2d[b, :, :g] = np.asarray(fr["joints_2d_vis"])[:, :g]
            else:
                vis2d[b, :, :g] = 1.0

        view_data = build_view_data(cams, image_wh, self.net_size,
                                    joints_vis_2d=vis2d,
                                    max_people=self.max_people,
                                    num_joints=J)
        targets = pad_targets([fr["joints_3d"] for fr in frames],
                              self.max_people, J)
        # overwrite per-joint 3D visibility when provided
        vis3 = np.zeros((B, self.max_people, J), dtype=np.float32)
        for b, fr in enumerate(frames):
            g = min(len(fr["joints_3d"]), self.max_people)
            if g:
                v = fr.get("joints_3d_vis")
                vis3[b, :g] = (np.asarray(v)[:g] if v is not None else 1.0)
        vp = None
        if any(fr.get("joints_3d_voxelpose_pred") is not None
               for fr in frames):
            vp = np.zeros((B, self.max_people, J, 5), dtype=np.float32)
            for b, fr in enumerate(frames):
                p = fr.get("joints_3d_voxelpose_pred")
                if p is not None:
                    p = np.asarray(p, dtype=np.float32)
                    m = min(len(p), self.max_people)
                    vp[b, :m] = p[:m, :J]
        targets = Targets(joints_3d=targets.joints_3d,
                          joints_3d_vis=torch.from_numpy(vis3),
                          roots_3d=targets.roots_3d,
                          num_person=targets.num_person,
                          voxelpose_pred=(None if vp is None
                                          else torch.from_numpy(vp)))

        if load_images:
            from mvgformer_tpu_torch import runtime as native_runtime

            aff = view_data.affine.numpy()
            use_native = native_runtime.native_available()
            sample_views = []
            for b, fr in enumerate(frames):
                if use_native:
                    raw = np.stack([_load_image(fr["images"][v],
                                                self.cfg.DATASET.COLOR_RGB)
                                    for v in range(V)])
                    sample_views.append(
                        native_runtime.warp_normalize_views(
                            raw, aff[b], self.net_size))
                else:
                    sample_views.append(np.stack(
                        [_load_and_warp_image(
                            fr["images"][v], aff[b, v], self.net_size,
                            self.cfg.DATASET.COLOR_RGB)
                         for v in range(V)]))
            views = np.stack(sample_views)
        else:
            views = np.zeros((B, V, H, W, 3), dtype=np.float32)
        return Batch(views=torch.from_numpy(views), view_data=view_data,
                     targets=targets)

    def batches(self, batch_size: int, shuffle: bool = False,
                seed: int = 0, load_images: bool = True,
                drop_last: bool = True):
        """Yield (frame indices, Batch); pads the final short batch by
        repeating its last frame so shapes stay static (the caller stores
        predictions by frame index, which drops the repeats)."""
        order = np.arange(len(self))
        if shuffle:
            np.random.RandomState(seed).shuffle(order)
        n = len(order)
        for s in range(0, n, batch_size):
            idx = order[s:s + batch_size]
            if len(idx) < batch_size:
                if drop_last and shuffle:
                    return
                idx = np.concatenate(
                    [idx, np.full(batch_size - len(idx), idx[-1])])
            yield [int(i) for i in idx], self.load_batch(
                [int(i) for i in idx], load_images=load_images)


class PanopticDataset(MultiViewDataset):
    """CMU Panoptic (lib/dataset/panoptic.py). Frame assembly: every
    `_interval`-th hdPose3d json (3 train / 12 val), people with visible
    root only, cm->mm, axis-swapped; per-view 2D visibility from projecting
    into each camera; db cached as a pickle keyed like the JAX package's,
    under this package's own prefix (a pickle holds its CameraParams)."""

    IMAGE_WH = (1920, 1080)

    def __init__(self, cfg: Config, image_set: str, is_train: bool,
                 max_frames: Optional[int] = None):
        super().__init__(cfg, image_set, is_train)
        arrangement = (cfg.DATASET.TEST_CAM_SEQ
                       if image_set == "validation"
                       else cfg.DATASET.TRAIN_CAM_SEQ)
        self.cam_list = CAM_LIST[arrangement][:self.num_views]
        self.num_views = len(self.cam_list)
        self.dataset_root = osp.join(cfg.DATA_DIR, cfg.DATASET.ROOT)
        # sequence-subset ablations (panoptic.py:231-234): SUBSET_SELECTION
        # picks from the TRAIN_LISTS/VAL_LISTS tables; None/'all' = default
        subset = cfg.DATASET.SUBSET_SELECTION or "all"
        lists = (PANOPTIC_TRAIN_LISTS if image_set == "train"
                 else PANOPTIC_VAL_LISTS)
        if subset not in lists:
            raise KeyError(
                f"SUBSET_SELECTION {subset!r} unknown for {image_set}; "
                f"options: {sorted(lists)}")
        self.sequences = lists[subset]
        # observed-by->=3-views db filter (panoptic.py:422-443)
        self.filter_valid_observations = \
            cfg.DATASET.FILTER_VALID_OBSERVATIONS
        self._interval = 3 if image_set == "train" else 12
        self.max_frames = max_frames or cfg.DATASET.MAX_DATA_NUM

        # max_frames / subset / observation-filter are part of the key: a
        # truncated or filtered db must never be silently reused by a full
        # run (or vice versa)
        cap = self.max_frames if self.max_frames else "all"
        sub = "" if subset == "all" else f"_{subset}"
        filt = "_obsfilt" if self.filter_valid_observations else ""
        cache = osp.join(
            self.dataset_root,
            f"mvgtorch_{image_set}_{arrangement}_{self.num_views}"
            f"_{cap}{sub}{filt}.pkl")
        if osp.isfile(cache):
            with open(cache, "rb") as f:
                self.frames = pickle.load(f)
            logger.info("loaded %d frames from %s", len(self.frames), cache)
        else:
            self.frames = self._build_frames()
            try:
                with open(cache, "wb") as f:
                    pickle.dump(self.frames, f)
            except OSError:
                pass

        if cfg.DATASET.ADD_VOXEL_PRED:
            self._attach_voxelpose_preds(cfg.DATASET.ADD_VOXEL_PRED)

    def _attach_voxelpose_preds(self, pred_db_name) -> None:
        """Attach per-frame VoxelPose predictions to the db
        (panoptic.py:284-301): an auxiliary db pickle keyed like the main
        one carries 'joints_3d_voxelpose_pred' arrays (M, J, 5) used by the
        'voxcel_pose_base' reference-init method and db augmentation.
        Missing entries forward-fill the previous frame's prediction."""
        path = pred_db_name if osp.isfile(str(pred_db_name)) else osp.join(
            self.dataset_root, str(pred_db_name))
        if not osp.isfile(path):
            logger.warning("voxelpose pred db not found: %s", path)
            return
        with open(path, "rb") as f:
            ex_info = pickle.load(f)
        ex_entries = (ex_info.get("db", ex_info)
                      if isinstance(ex_info, dict) else ex_info)

        def norm_key(key: str) -> str:
            # reference db keys carry a per-view camera prefix
            # ("{seq}_{panel:02d}_{node:02d}_{frame}", panoptic.py:443);
            # this framework's frame keys don't ("{seq}__{frame}").
            # Normalize both to (seq, frame-number) so reference-produced
            # pred dbs match. Panoptic seq names are "<date>_<name>"
            # (two '_'-separated parts).
            parts = str(key).split("_")
            if len(parts) >= 3:
                return f"{parts[0]}_{parts[1]}_{parts[-1]}"
            return key

        by_key = {}
        last = None
        for item in ex_entries:
            pred = item.get("joints_3d_voxelpose_pred") \
                if isinstance(item, dict) else None
            if isinstance(pred, np.ndarray):
                last = pred
            if isinstance(item, dict) and "key" in item:
                by_key[norm_key(item["key"])] = last
        last = None
        for frame in self.frames:
            pred = by_key.get(norm_key(frame["key"]), None)
            if isinstance(pred, np.ndarray):
                last = pred
            frame["joints_3d_voxelpose_pred"] = last
        # backfill frames before the first available prediction with it —
        # a leading None would crash voxcel_pose_base init mid-epoch and
        # flip the Batch structure between batches
        first = next((f["joints_3d_voxelpose_pred"] for f in self.frames
                      if f["joints_3d_voxelpose_pred"] is not None), None)
        if first is not None:
            for frame in self.frames:
                if frame["joints_3d_voxelpose_pred"] is None:
                    frame["joints_3d_voxelpose_pred"] = first
                else:
                    break

    def _load_cameras(self, seq: str) -> List[Dict[str, np.ndarray]]:
        cam_file = osp.join(self.dataset_root, seq,
                            f"calibration_{seq}.json")
        with open(cam_file) as f:
            calib = json.load(f)
        by_id = {(c["panel"], c["node"]): c for c in calib["cameras"]}
        return [parse_panoptic_camera(by_id[cid]) for cid in self.cam_list]

    def _build_frames(self) -> List[dict]:
        t0 = time.time()
        frames: List[dict] = []
        W, H = self.IMAGE_WH
        for seq in self.sequences:
            cam_dicts = self._load_cameras(seq)
            cams = stack_cameras(cam_dicts)
            anno_dir = osp.join(self.dataset_root, seq,
                                "hdPose3d_stage1_coco19")
            files = sorted(glob.iglob(f"{anno_dir}/*.json"))
            count = 0
            for i, file in enumerate(files):
                if i % self._interval:
                    continue
                with open(file) as f:
                    bodies = json.load(f)["bodies"]
                if not bodies:
                    continue
                poses, vis3d = [], []
                for body in bodies:
                    p = np.array(body["joints19"],
                                 dtype=np.float32).reshape(-1, 4)
                    p = p[:self.num_joints]
                    jv = p[:, 3] > 0.1
                    if not jv[self.root_id]:
                        continue
                    xyz = (p[:, :3] @ PANOPTIC_M.astype(np.float32)) * 10.0
                    poses.append(xyz)
                    vis3d.append(jv.astype(np.float32))
                if not poses:
                    continue
                poses = np.stack(poses)  # (G, J, 3)
                vis3d = np.stack(vis3d)
                # per-view visibility: projected inside the full image
                V, G = len(cam_dicts), len(poses)
                flat = np.broadcast_to(poses.reshape(1, -1, 3),
                                       (V, G * self.num_joints, 3))
                pix = _project(flat, cams).reshape(V, G, self.num_joints, 2)
                inb = ((pix[..., 0] >= 0) & (pix[..., 0] <= W - 1)
                       & (pix[..., 1] >= 0) & (pix[..., 1] <= H - 1))
                vis2d = (inb & (vis3d[None] > 0)).astype(np.float32)

                # FILTER_VALID_OBSERVATIONS (panoptic.py:422-443): keep a
                # frame only if every joint of every person is observable
                # by at least 3 cameras
                if self.filter_valid_observations:
                    obs_per_joint = vis2d.sum(axis=0)  # (G, J)
                    if not np.all(obs_per_joint > 2):
                        continue

                postfix = osp.basename(file).replace("body3DScene", "")
                images = []
                for (panel, node) in self.cam_list:
                    prefix = f"{panel:02d}_{node:02d}"
                    images.append(osp.join(
                        self.dataset_root, seq, "hdImgs", prefix,
                        (prefix + postfix).replace("json", "jpg")))
                frames.append({
                    "key": f"{seq}_{postfix.split('.')[0]}",
                    "images": images,
                    "cameras": cams,
                    "image_wh": np.tile(
                        np.array(self.IMAGE_WH, np.float32),
                        (len(cam_dicts), 1)),
                    "joints_3d": poses,
                    "joints_3d_vis": vis3d,
                    "joints_2d_vis": vis2d,
                })
                count += 1
                if self.max_frames and count >= self.max_frames:
                    break
        logger.info("built %d frames in %.1fs", len(frames),
                    time.time() - t0)
        return frames

    def evaluate(self, preds: Sequence[np.ndarray],
                 method: str = "score_sort") -> Dict[str, float]:
        gts = [f["joints_3d"] for f in self.frames[:len(preds)]]
        vis = [f["joints_3d_vis"] for f in self.frames[:len(preds)]]
        return evaluate_ap_mpjpe(list(preds), gts, vis, method=method)


class _ShelfCampusBase(MultiViewDataset):
    """Shared Shelf/Campus logic (lib/dataset/shelf.py, campus.py):
    actorsGT.mat ground truth, plain-json calibration, fixed eval frame
    ranges, zero-shot eval with the 14-joint converted prediction format."""

    IMAGE_WH: Tuple[int, int] = (1032, 776)
    FRAME_RANGE = range(0, 1)
    TRAIN_FRAME_RANGE: List[int] = []
    CALIB_FILE = ""
    GT_UNIT_TO_MM = 1000.0

    def __init__(self, cfg: Config, image_set: str, is_train: bool,
                 image_pattern: str = ""):
        super().__init__(cfg, image_set, is_train)
        self.dataset_root = osp.join(cfg.DATA_DIR, cfg.DATASET.ROOT)
        self.image_pattern = image_pattern
        # eval gt is the 14-joint converted format; finetuning trains
        # against 15-joint voxelpose pseudo-GT directly (shelf.py:151-187)
        self.gt_num_joints = self.num_joints if is_train else 14
        self.actor_3d = self._load_actors()
        self.num_actors = len(self.actor_3d) if self.actor_3d is not None \
            else 0
        cams = self._load_cameras()
        self.cameras = stack_cameras(cams)
        self.num_views = len(cams)
        self.frames = (self._build_train_frames() if is_train
                       else self._build_frames())

    def _load_cameras(self):
        with open(osp.join(self.dataset_root, self.CALIB_FILE)) as f:
            calib = json.load(f)
        return [parse_plain_camera(calib[k])
                for k in sorted(calib.keys(), key=lambda s: int(s))[
                    :self.num_views]]

    def _load_actors(self):
        path = osp.join(self.dataset_root, "actorsGT.mat")
        if not osp.isfile(path):
            return None
        import scipy.io as scio

        data = scio.loadmat(path)
        return np.array(np.array(data["actor3D"].tolist()).tolist(),
                        dtype=object).squeeze()

    def _gt_for_frame(self, fi: int) -> List[np.ndarray]:
        out = []
        if self.actor_3d is None:
            return out
        for person in range(self.num_actors):
            gt = self.actor_3d[person][fi]
            if len(gt[0]) == 0:
                out.append(np.zeros((0,)))
            else:
                out.append(np.asarray(gt, dtype=np.float32)
                           * self.GT_UNIT_TO_MM)
        return out

    def _build_train_frames(self) -> List[dict]:
        """Finetuning frames from voxelpose pseudo-GT (shelf.py:151-187,
        campus.py same pattern): a pickle {image basename: [poses (J,3)
        mm]} built by running voxelpose on the train frame ranges; the
        model finetunes against these 15-joint panoptic-format poses while
        eval stays 14-joint via convert_joint_format_indices."""
        if not self.cfg.DATASET.PESUDO_GT:
            raise ValueError(
                "finetuning on shelf/campus needs DATASET.PESUDO_GT "
                "(a voxelpose pseudo-gt pickle; shelf.py:110-112)")
        path = osp.join(self.dataset_root, "pesudo_gt",
                        self.cfg.DATASET.PESUDO_GT)
        with open(path, "rb") as f:
            pgt = pickle.load(f)

        frames = []
        W, H = self.IMAGE_WH
        J = self.gt_num_joints
        for fi in self.TRAIN_FRAME_RANGE:
            key = osp.basename(self.image_pattern.format(cam=0, frame=fi))
            poses = [np.asarray(p, np.float32) for p in pgt.get(key, [])
                     if np.asarray(p).size]
            poses = [p for p in poses if p.shape[0] >= J]
            images = [osp.join(self.dataset_root,
                               self.image_pattern.format(cam=v, frame=fi))
                      for v in range(self.num_views)]
            if poses:
                gt = np.stack([p[:J, :3] for p in poses])  # (G, J, 3)
                V, G = self.num_views, len(gt)
                flat = np.broadcast_to(gt.reshape(1, -1, 3), (V, G * J, 3))
                pix = _project(flat, self.cameras).reshape(V, G, J, 2)
                vis2d = ((pix[..., 0] >= 0) & (pix[..., 0] <= W - 1)
                         & (pix[..., 1] >= 0)
                         & (pix[..., 1] <= H - 1)).astype(np.float32)
            else:
                gt = np.zeros((0, J, 3), np.float32)
                vis2d = np.zeros((self.num_views, 0, J), np.float32)
            frames.append({
                "key": str(fi),
                "frame_index": fi,
                "images": images,
                "cameras": self.cameras,
                "image_wh": np.tile(np.array(self.IMAGE_WH, np.float32),
                                    (self.num_views, 1)),
                "joints_3d": gt,
                "joints_3d_vis": np.ones((len(gt), J), np.float32),
                "joints_2d_vis": vis2d,
            })
        return frames

    def _build_frames(self) -> List[dict]:
        frames = []
        W, H = self.IMAGE_WH
        for fi in self.FRAME_RANGE:
            gts = self._gt_for_frame(fi)
            present = [g for g in gts if g.size]
            images = [osp.join(self.dataset_root,
                               self.image_pattern.format(cam=v, frame=fi))
                      for v in range(self.num_views)]
            frames.append({
                "key": str(fi),
                "frame_index": fi,
                "images": images,
                "cameras": self.cameras,
                "image_wh": np.tile(np.array(self.IMAGE_WH, np.float32),
                                    (self.num_views, 1)),
                "joints_3d": (np.stack(present) if present
                              else np.zeros((0, 14, 3), np.float32)),
                "joints_3d_vis": None,
                "joints_2d_vis": None,
            })
        return frames

    def evaluate(self, preds: Sequence[np.ndarray], recall_threshold=500):
        gt_per_frame = [self._gt_for_frame(f["frame_index"])
                        for f in self.frames[:len(preds)]]
        return evaluate_pcp(list(preds), gt_per_frame, self.num_actors,
                            recall_threshold=recall_threshold)


class ShelfDataset(_ShelfCampusBase):
    """Shelf: 5 cameras, eval frames 300-600 (shelf.py:104-108)."""

    IMAGE_WH = (1032, 776)
    FRAME_RANGE = range(300, 601)
    # shelf.py:105-106
    TRAIN_FRAME_RANGE = list(range(0, 300)) + list(range(601, 3200))
    CALIB_FILE = "calibration_shelf.json"

    def __init__(self, cfg: Config, image_set: str = "validation",
                 is_train: bool = False):
        super().__init__(cfg, image_set, is_train,
                         image_pattern="Camera{cam}/img_{frame:06d}.png")


class CampusDataset(_ShelfCampusBase):
    """Campus: 3 cameras, 360x288 images, eval frames 350-470 + 650-750
    (campus.py:104-112)."""

    IMAGE_WH = (360, 288)
    FRAME_RANGE = list(range(350, 471)) + list(range(650, 751))
    # campus.py:88-89 (augmented training set: hard ranges repeated)
    TRAIN_FRAME_RANGE = (list(range(0, 350)) + list(range(471, 650))
                         + list(range(751, 1900))
                         + list(range(471, 520)) * 2
                         + list(range(751, 1200)) * 2)
    CALIB_FILE = "calibration_campus.json"

    def __init__(self, cfg: Config, image_set: str = "validation",
                 is_train: bool = False):
        super().__init__(cfg, image_set, is_train,
                         image_pattern="Camera{cam}/campus4-c{cam}-"
                                       "{frame:05d}.png")


DATASETS = {
    "panoptic": PanopticDataset,
    "shelf": ShelfDataset,
    "campus": CampusDataset,
}


def get_dataset(cfg: Config, image_set: str, is_train: bool):
    name = (cfg.DATASET.TRAIN_DATASET if is_train
            else cfg.DATASET.TEST_DATASET)
    return DATASETS[name](cfg, image_set, is_train)


H36M_TO_PANOPTIC = [8, 9, 0, 11, 12, 13, 4, 5, 6, 14, 15, 16, 1, 2, 3]


class H36MDataset(MultiViewDataset):
    """Human3.6M single-person multi-view variant (lib/dataset/h36m.py):
    annot/h36m_{set}.pkl entries grouped into full 4-view frames, camera-
    frame joints converted to world, joints remapped to the Panoptic
    15-joint order (H36M_TO_PANOPTIC, h36m.py:69), sparse frame sampling
    (::5 train / ::64 eval, h36m.py:95-98)."""

    IMAGE_WH = (1000, 1002)

    def __init__(self, cfg: Config, image_set: str, is_train: bool):
        super().__init__(cfg, image_set, is_train)
        self.dataset_root = osp.join(cfg.DATA_DIR, cfg.DATASET.ROOT)
        self.num_views = 4
        self.frames = self._build_frames(image_set, is_train)

    def _build_frames(self, image_set, is_train):
        anno = osp.join(self.dataset_root, "annot",
                        f"h36m_{image_set}.pkl")
        if not osp.isfile(anno):
            logger.warning("H36M annotations not found at %s", anno)
            return []
        with open(anno, "rb") as f:
            db = pickle.load(f)

        # group by (subject, action, subaction, image_id) across 4 cameras
        groups = {}
        for i, rec in enumerate(db):
            s, a, sa = rec["subject"], rec["action"], rec["subaction"]
            if s == 9 and ((a == 5 and sa == 2) or (a == 10 and sa == 2)
                           or (a == 13 and sa == 1)):
                continue  # damaged actions (h36m.py:192-197)
            key = (s, a, sa, rec["image_id"])
            groups.setdefault(key, [-1] * 4)[rec["camera_id"]] = i
        grouping = [v for v in groups.values() if all(i >= 0 for i in v)]
        grouping = grouping[::5] if is_train else grouping[::64]

        frames = []
        for views in grouping:
            cams, images, poses_w = [], [], None
            for idx in views:
                rec = db[idx]
                cam = rec["camera"]
                R = np.asarray(cam["R"], np.float32)
                T = np.asarray(cam["T"], np.float32).reshape(3, 1)
                cams.append({
                    "R": R, "T": T,
                    "f": np.asarray([cam["fx"], cam["fy"]],
                                    np.float32).reshape(-1)[:2],
                    "c": np.asarray([cam["cx"], cam["cy"]],
                                    np.float32).reshape(-1)[:2],
                    "k": np.asarray(cam["k"], np.float32).reshape(-1)[:3],
                    "p": np.asarray(cam["p"], np.float32).reshape(-1)[:2],
                })
                images.append(osp.join(self.dataset_root, "images",
                                       rec["image"]))
                if poses_w is None:
                    # camera-frame joints -> world, Panoptic joint order
                    cp = CameraParams(**{
                        f: torch.from_numpy(np.asarray(cams[-1][f]))
                        for f in CAMERA_FIELDS})
                    j3d = np.asarray(rec["joints_3d"], np.float32)
                    with torch.no_grad():
                        world = camera_to_world(
                            torch.from_numpy(j3d[None]), cp).numpy()[0]
                    poses_w = world[H36M_TO_PANOPTIC][None]  # (1, 15, 3)
            frames.append({
                "key": str(views),
                "images": images,
                "cameras": stack_cameras(cams),
                "image_wh": np.tile(np.asarray(self.IMAGE_WH, np.float32),
                                    (4, 1)),
                "joints_3d": poses_w,
                "joints_3d_vis": np.ones((1, self.num_joints), np.float32),
                "joints_2d_vis": None,
            })
        return frames

    def evaluate(self, preds):
        gts = [f["joints_3d"] for f in self.frames[:len(preds)]]
        return evaluate_ap_mpjpe(list(preds), gts)


DATASETS["h36m"] = H36MDataset


class SyntheticDataset(MultiViewDataset):
    """Synthetic multi-view scenes (no files on disk): rendered gaussian-blob
    views with exact gt, a camera ring matching the configured arrangement
    size. Enables end-to-end train/validate runs and CI smoke tests without
    the real datasets."""

    def __init__(self, cfg: Config, image_set: str, is_train: bool,
                 num_frames: Optional[int] = None):
        super().__init__(cfg, image_set, is_train)
        self._cfg = cfg
        self._seed0 = 0 if is_train else 10_000
        self._cache = {}
        if num_frames is None:
            num_frames = cfg.DATASET.MAX_DATA_NUM or 16
        self.frames = [{"key": str(i)} for i in range(num_frames)]

    def _num_people(self, i: int) -> int:
        # vary scene density deterministically (1..min(4, MAX)) so trained
        # scoring must actually separate people from empty queries
        return 1 + int(i) % min(4, self._cfg.MULTI_PERSON.MAX_PEOPLE_NUM)

    def _frame(self, i: int, load_images: bool):
        key = (int(i), bool(load_images))
        if key not in self._cache:
            from mvgformer_tpu_torch.data.synthetic import make_batch

            # cam_seed=0: ONE fixed rig across all frames and both splits
            # (a real capture studio; also the rig-static windowed-plan
            # premise). Scenes (people/poses) still vary per frame.
            self._cache[key] = make_batch(
                self._cfg, batch_size=1, seed=self._seed0 + int(i),
                num_people=self._num_people(i), render=load_images,
                cam_seed=0, device="cpu")
        return self._cache[key]

    def load_batch(self, indices, load_images: bool = True):
        return concat_batches([self._frame(i, load_images)
                               for i in indices])

    def evaluate(self, preds):
        gts, vis = [], []
        for i in range(len(preds)):
            b = self.load_batch([i], load_images=False)
            n = int(b.targets.num_person[0])
            gts.append(b.targets.joints_3d[0, :n].numpy())
            vis.append(b.targets.joints_3d_vis[0, :n].numpy())
        return evaluate_ap_mpjpe(list(preds), gts, vis)

    def observability_arrays(self, n: int):
        gts, vis3d, vis = [], [], []
        for i in range(n):
            b = self.load_batch([i], load_images=False)
            g = int(b.targets.num_person[0])
            gts.append(b.targets.joints_3d[0, :g].numpy())
            vis3d.append(b.targets.joints_3d_vis[0, :g].numpy())
            vis.append(b.view_data.joints_vis_2d[0, :, :g].numpy())
        return gts, vis3d, vis


DATASETS["synthetic"] = SyntheticDataset


def concat_batches(batches: Sequence[Batch]) -> Batch:
    """Concatenate Batches along the batch axis, field by field."""
    first = batches[0]
    if len(batches) == 1:
        return first

    def cat(obj, parts):
        if obj is None:
            return None
        if isinstance(obj, torch.Tensor):
            return torch.cat(parts, dim=0)
        return dataclasses.replace(obj, **{
            f.name: cat(getattr(obj, f.name),
                        [getattr(p, f.name) for p in parts])
            for f in dataclasses.fields(obj)})

    return cat(first, list(batches))
