"""Debug visualization: 3D skeletons, 2D overlays, attention points.

The port's copy of `mvgformer_tpu/utils/visualization.py` (the original
repository's visualization hooks, lib/utils/vis.py): host-side helpers on
numpy arrays and matplotlib, with the same function and file names. Enabled
the same way: DEBUG.VISUALIZATION_JUMP_NUM >= 0 in the validate CLI, which
passes the DQ model's debug taps (`MVGFormer.forward(...,
return_intermediates=True)`), or call these directly. matplotlib is
imported where a plot is drawn; without it those functions raise
ImportError.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np

from mvgformer_tpu_torch.data.meta import IMAGE_MEAN, IMAGE_STD
from mvgformer_tpu_torch.data.synthetic import LIMBS15


def _ax3d():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig = plt.figure(figsize=(8, 8))
    return fig, fig.add_subplot(111, projection="3d")


def _draw_skeleton_3d(ax, pose, color, alpha=1.0, limbs=LIMBS15):
    pose = np.asarray(pose)
    ax.scatter(pose[:, 0], pose[:, 1], pose[:, 2], c=color, s=8,
               alpha=alpha)
    for a, b in limbs:
        if a < len(pose) and b < len(pose):
            ax.plot(*np.stack([pose[a], pose[b]], axis=1), c=color,
                    alpha=alpha, linewidth=1)


def save_3d_poses(path: str, pred_poses, gt_poses=None,
                  pred_color="b", gt_color="g", pred_alpha=0.7,
                  axis_range_mm: Optional[np.ndarray] = None):
    """3D scatter of predicted skeletons vs gt (save_ref_points_with_gt,
    vis.py:202-283). pred_poses/gt_poses: (N, J, 3) arrays (mm)."""
    import matplotlib.pyplot as plt

    fig, ax = _ax3d()
    for pose in np.asarray(pred_poses):
        _draw_skeleton_3d(ax, pose, pred_color, pred_alpha)
    if gt_poses is not None:
        for pose in np.asarray(gt_poses):
            _draw_skeleton_3d(ax, pose, gt_color, 1.0)
    if axis_range_mm is not None:
        r = np.asarray(axis_range_mm)
        ax.set_xlim(r[0]); ax.set_ylim(r[1]); ax.set_zlim(r[2])
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fig.savefig(path, dpi=100, bbox_inches="tight")
    plt.close(fig)


def denormalize_image(img: np.ndarray) -> np.ndarray:
    """(H, W, 3) normalized float -> uint8 RGB."""
    out = np.asarray(img) * IMAGE_STD + IMAGE_MEAN
    return np.clip(out * 255.0, 0, 255).astype(np.uint8)


def save_2d_overlay(path: str, image, joints_2d, joints_vis=None,
                    refined_2d=None, limbs=LIMBS15, draw_lines=True):
    """One view image with projected (and optionally refined) 2D joints
    (visualize_proj_attention / save_batch_image_with_joints_multi).

    image: (H, W, 3) normalized; joints_2d: (N, J, 2) net-image px."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(10, 6))
    ax.imshow(denormalize_image(image))
    joints_2d = np.asarray(joints_2d)
    for n, pose in enumerate(joints_2d):
        vis = (np.asarray(joints_vis)[n] if joints_vis is not None
               else np.ones(len(pose)))
        ax.scatter(pose[vis > 0, 0], pose[vis > 0, 1], s=10, c="lime")
        if draw_lines:
            for a, b in limbs:
                if a < len(pose) and b < len(pose) \
                        and vis[a] > 0 and vis[b] > 0:
                    ax.plot([pose[a, 0], pose[b, 0]],
                            [pose[a, 1], pose[b, 1]], c="lime",
                            linewidth=1)
    if refined_2d is not None:
        for pose in np.asarray(refined_2d):
            ax.scatter(pose[:, 0], pose[:, 1], s=10, c="red", marker="x")
    ax.set_axis_off()
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fig.savefig(path, dpi=100, bbox_inches="tight")
    plt.close(fig)


def save_view_grid(path: str, views, poses_2d_per_view=None):
    """All views of one frame in a grid with optional 2D joints.
    views: (V, H, W, 3) normalized."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    views = np.asarray(views)
    V = len(views)
    cols = min(V, 3)
    rows = (V + cols - 1) // cols
    fig, axes = plt.subplots(rows, cols, figsize=(5 * cols, 3.2 * rows))
    axes = np.atleast_1d(axes).reshape(-1)
    for v in range(V):
        axes[v].imshow(denormalize_image(views[v]))
        if poses_2d_per_view is not None:
            for pose in np.asarray(poses_2d_per_view[v]):
                axes[v].scatter(pose[:, 0], pose[:, 1], s=6, c="lime")
        axes[v].set_axis_off()
    for v in range(V, len(axes)):
        axes[v].set_axis_off()
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fig.savefig(path, dpi=90, bbox_inches="tight")
    plt.close(fig)


def save_attention_points(path: str, image, locations, weights,
                          ref_points_2d=None, level: int = 0,
                          max_queries: int = 64):
    """Deformable-attention sampling points over one view, colored by
    attention weight (visualize_proj_attention, vis.py:82-202).

    image:     (H, W, 3) normalized net image.
    locations: (Lq, H, L, P, 2) normalized [0, 1] sampling locations for
               this view (ProjAttn sows these as 'sampling_locations';
               index the (V*B) fold first).
    weights:   (Lq, H, L, P) softmaxed attention weights.
    ref_points_2d: optional (Lq, 2) projected reference points (px).
    """
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    img = denormalize_image(image)
    h, w = img.shape[:2]
    fig, ax = plt.subplots(figsize=(10, 6))
    ax.imshow(img)
    loc = np.asarray(locations)[:, :, level]      # (Lq, H, P, 2)
    wgt = np.asarray(weights)[:, :, level]        # (Lq, H, P)
    # cap the query count like the original repository (it draws active
    # queries only; dense callers pass the top-scoring slice)
    loc, wgt = loc[:max_queries], wgt[:max_queries]
    xy = loc.reshape(-1, 2) * np.array([w, h])
    cv = wgt.reshape(-1)
    inb = ((xy[:, 0] >= 0) & (xy[:, 0] < w)
           & (xy[:, 1] >= 0) & (xy[:, 1] < h))
    sc = ax.scatter(xy[inb, 0], xy[inb, 1], c=cv[inb], cmap="plasma",
                    s=6, alpha=0.8)
    fig.colorbar(sc, ax=ax, fraction=0.03, label="attention weight")
    if ref_points_2d is not None:
        rp = np.asarray(ref_points_2d)[:max_queries]
        ax.scatter(rp[:, 0], rp[:, 1], s=22, c="cyan", marker="+")
    ax.set_axis_off()
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fig.savefig(path, dpi=100, bbox_inches="tight")
    plt.close(fig)


def save_debug_3d_images(cfg, batch, preds, prefix: str,
                         show_id: bool = False):
    """Per-sample 3D subplot grid: gt skeletons (red, dashed where either
    endpoint is invisible) + predicted skeletons (cycled colors), saved to
    <dir(prefix)>/3d_joints/<base(prefix)>_3d.png. Rebuild of
    save_debug_3d_images (the original repository's
    lib/utils/vis.py:683-756) over the port's Batch (preds: (B, N, J, >=4)
    with col 3 the kept-score, or (B, N, J, 3) = all kept, matching the
    original repository's shape-3 branch)."""
    import math

    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    dirname = os.path.join(os.path.dirname(prefix), "3d_joints")
    os.makedirs(dirname, exist_ok=True)
    file_name = os.path.join(
        dirname, os.path.basename(prefix) + "_3d.png")

    tgt = batch.targets
    batch_size = int(np.asarray(tgt.num_person).shape[0])
    xplot = min(4, batch_size)
    yplot = int(math.ceil(float(batch_size) / xplot))
    fig = plt.figure(figsize=(4.0 * xplot, 4.0 * yplot))
    plt.subplots_adjust(left=0.05, right=0.95, bottom=0.05, top=0.95,
                        wspace=0.05, hspace=0.15)
    colors = ["b", "g", "c", "y", "m", "orange",
              "pink", "royalblue", "lightgreen", "gold"]
    for i in range(batch_size):
        ax = fig.add_subplot(yplot, xplot, i + 1, projection="3d")
        num_person = int(np.asarray(tgt.num_person)[i])
        joints_3d = np.asarray(tgt.joints_3d)[i]
        joints_vis = np.asarray(tgt.joints_3d_vis)[i]
        for n in range(num_person):
            joint, vis = joints_3d[n], joints_vis[n]
            for a, b in LIMBS15:
                seg = np.stack([joint[a], joint[b]], axis=1)
                solid = vis[a] > 0 and vis[b] > 0
                ax.plot(*seg, c="r", ls="-" if solid else "--", lw=1.5,
                        marker="o", markerfacecolor="w", markersize=2,
                        markeredgewidth=1)
            if show_id:
                for j, p in enumerate(joint):
                    ax.text(p[0], p[1], p[2], str(j), color="red")
        if preds is not None:
            pred = np.asarray(preds[i])
            for n in range(len(pred)):
                joint = pred[n]
                if joint.shape[-1] == 3 or joint[0, 3] >= 0:
                    for a, b in LIMBS15:
                        seg = np.stack([joint[a, :3], joint[b, :3]],
                                       axis=1)
                        ax.plot(*seg, c=colors[n % 10], lw=1.5,
                                marker="o", markerfacecolor="w",
                                markersize=2, markeredgewidth=1)
    fig.savefig(file_name)
    plt.close(fig)
    return file_name


def save_debug_3d_cubes(cfg, batch, roots, prefix: str):
    """Scatter of gt roots (red) vs predicted roots (blue) bounded to the
    MULTI_PERSON capture space, saved to <dir>/root_cubes/<base>_root.png.
    Rebuild of save_debug_3d_cubes (vis.py:757-811); unlike the original
    it does not gate on DEBUG.DEBUG — callers gate. roots: (B, N, >=4),
    col 3 >= 0 marks a kept detection."""
    import math

    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    dirname = os.path.join(os.path.dirname(prefix), "root_cubes")
    os.makedirs(dirname, exist_ok=True)
    file_name = os.path.join(
        dirname, os.path.basename(prefix) + "_root.png")

    tgt = batch.targets
    roots = np.asarray(roots)
    batch_size = roots.shape[0]
    xplot = min(4, batch_size)
    yplot = int(math.ceil(float(batch_size) / xplot))
    fig = plt.figure(figsize=(4.0 * xplot, 4.0 * yplot))
    plt.subplots_adjust(left=0.05, right=0.95, bottom=0.05, top=0.95,
                        wspace=0.05, hspace=0.15)
    space_size = cfg.MULTI_PERSON.SPACE_SIZE
    space_center = cfg.MULTI_PERSON.SPACE_CENTER
    for i in range(batch_size):
        ax = fig.add_subplot(yplot, xplot, i + 1, projection="3d")
        n = int(np.asarray(tgt.num_person)[i])
        gt = np.asarray(tgt.roots_3d)[i][:n]
        ax.scatter(gt[:, 0], gt[:, 1], gt[:, 2], c="r")
        kept = roots[i][roots[i][:, 3] >= 0]
        ax.scatter(kept[:, 0], kept[:, 1], kept[:, 2], c="b")
        ax.set_xlim(space_center[0] - space_size[0] / 2,
                    space_center[0] + space_size[0] / 2)
        ax.set_ylim(space_center[1] - space_size[1] / 2,
                    space_center[1] + space_size[1] / 2)
        ax.set_zlim(space_center[2] - space_size[2] / 2,
                    space_center[2] + space_size[2] / 2)
    fig.savefig(file_name)
    plt.close(fig)
    return file_name


def save_debug_epipolar_dump(batch, prefix: str, batch_index: int = 0,
                             extras: Optional[dict] = None):
    """Offline-analysis pickle of one frame's per-view images + gt 2D
    joints/visibility, <dir>/epipolar/<base>_epipolar.pkl. Rebuild of
    save_debug_epipolar (vis.py:812-837); the original repository pickles
    the raw per-view tensors for notebook analysis rather than plotting.
    The gt 2D joints are the camera projections of targets.joints_3d
    mapped through the per-view full->net affine (the original repository
    stores the dataset's precomputed equivalents); `extras` lands in the
    pickle verbatim (the original repository's epipolar_line_* branch
    reads keys from the wrong dict and is dead — covered by passing the
    debug taps here instead)."""
    import pickle

    import torch

    from mvgformer_tpu_torch.data.meta import map_tensors
    from mvgformer_tpu_torch.geometry.cameras import project_points

    dirname = os.path.join(os.path.dirname(prefix), "epipolar")
    os.makedirs(dirname, exist_ok=True)
    file_name = os.path.join(
        dirname, os.path.basename(prefix) + "_epipolar.pkl")

    b = batch_index
    tgt = batch.targets
    n = int(np.asarray(tgt.num_person)[b])
    joints_3d = np.asarray(tgt.joints_3d)[b][:n]         # (n, J, 3)
    views = np.asarray(batch.views[b])                   # (V, H, W, 3)
    V = views.shape[0]
    outputs: dict = {}
    cams_b = map_tensors(batch.view_data.cameras,
                         lambda x: torch.as_tensor(x)[b].float().cpu())
    affine = np.asarray(batch.view_data.affine)[b]       # (V, 2, 3)
    vis2d = np.asarray(batch.view_data.joints_vis_2d)[b]  # (V, M, J)
    for v in range(V):
        cam_v = map_tensors(cams_b, lambda x: x[v])
        full_px = project_points(torch.from_numpy(np.ascontiguousarray(
            joints_3d.reshape(-1, 3), dtype=np.float32)),
            cam_v).numpy().reshape(n, -1, 2)
        net_px = full_px @ affine[v][:, :2].T + affine[v][:, 2]
        outputs[f"view{v}_img"] = views[v]
        outputs[f"view{v}_joints_2d"] = net_px
        outputs[f"view{v}_joints_vis"] = vis2d[v][:n]
    if extras:
        outputs.update({k: np.asarray(val) for k, val in extras.items()})
    with open(file_name, "wb") as handle:
        pickle.dump(outputs, handle, protocol=pickle.HIGHEST_PROTOCOL)
    return file_name


def visualize_frame(out_dir: str, frame_id: int, batch, pred,
                    layer_outputs=None, batch_index: int = 0,
                    intermediates=None):
    """One-call debug dump for a frame: 3D pred-vs-gt + per-view overlays
    (the model-forward hook pattern, dq_transformer.py:613-651)."""
    b = batch_index
    views = np.asarray(batch.views[b])
    gt = None
    if batch.targets is not None:
        n = int(np.asarray(batch.targets.num_person)[b])
        gt = np.asarray(batch.targets.joints_3d)[b][:n]
    kept = pred[pred[:, 0, 3] >= 0] if pred.ndim == 3 else pred
    save_3d_poses(os.path.join(out_dir, f"{frame_id}_joints3d.png"),
                  kept[:, :, :3], gt)
    if layer_outputs is not None:
        for lid, lo in enumerate(layer_outputs):
            p2d = np.asarray(lo["pred_poses_2d"])[b]  # (V, Q*J, 2)
            V = p2d.shape[0]
            J = kept.shape[1] if kept.size else 15
            # per-layer refined-2D overlays, active poses only (zeros are
            # the masked-out queries' scatter slots)
            per_view = []
            for v in range(V):
                poses = p2d[v].reshape(-1, J, 2)
                active = np.abs(poses).sum(axis=(1, 2)) > 0
                per_view.append(poses[active])
            save_view_grid(
                os.path.join(out_dir, f"{frame_id}_layer{lid}_views.png"),
                views, per_view)
    if intermediates is not None:
        # the taps' tree: decoder/layer_{l}/proj_attn/sampling_locations
        # holding ((V*B, Lq, H, L, P, 2),); view-major fold (v*B + b)
        dec = intermediates.get("decoder", {})
        V = views.shape[0]
        B_total = None
        for lid, (lname, sub) in enumerate(sorted(dec.items())):
            pa = sub.get("proj_attn", {})
            if "sampling_locations" not in pa:
                continue
            loc = np.asarray(pa["sampling_locations"][0])
            wgt = np.asarray(pa["sampling_weights"][0])
            B_total = loc.shape[0] // V
            for v in range(V):
                n = v * B_total + b
                save_attention_points(
                    os.path.join(
                        out_dir,
                        f"{frame_id}_{lname}_view{v}_attn.png"),
                    views[v], loc[n], wgt[n])
