"""The traffic generator: one fixed camera rig and a ring of frames drawn
from the seed.

A traffic file fixes the rig (`cam_seed`, the full image size), the ring's
length, the multiset of people counts per frame and the batch. The seed
draws the order of those counts, the people's poses and the image noise,
so every seed serves the same work in another order. Each view shows a
Gaussian blob (sigma 3 px) at every joint it sees, the channels scaled by
(2, 1, -1), over noise of standard deviation 0.1; the views are made on
the card and kept as float32 at the network's input size in pinned host
memory, from which a live rig would place them.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from benchmark.reference import geometry as G

BLOB_SIGMA = 3.0
CHANNEL_SCALE = (2.0, 1.0, -1.0)
NOISE_STD = 0.1


def camera_ring(views: int, image_wh, centre, seed: int,
                radius: float = 4500.0, height: float = 1200.0,
                focal: float = 1630.0) -> Dict[str, np.ndarray]:
    """A ring of `views` distorted cameras around the capture space,
    looking at its centre: R (V, 3, 3), T (V, 3, 1), f, c, p (V, 2), k
    (V, 3), float32."""
    rng = np.random.RandomState(seed)
    centre = np.asarray(centre, np.float64)
    Rs, Ts = [], []
    for i in range(views):
        ang = 2.0 * np.pi * i / views + rng.uniform(-0.1, 0.1)
        pos = centre + np.array([radius * np.cos(ang), radius * np.sin(ang),
                                 height + rng.uniform(-200, 200)])
        fwd = (centre - pos) / np.linalg.norm(centre - pos)
        right = np.cross(fwd, [0.0, 0.0, 1.0])
        right /= np.linalg.norm(right)
        Rs.append(np.stack([right, np.cross(fwd, right), fwd]))
        Ts.append(pos.reshape(3, 1))
    f = focal * rng.uniform(0.95, 1.05, size=(views, 1)) * np.ones((1, 2))
    c = (np.asarray(image_wh, np.float64) / 2.0
         + rng.uniform(-20, 20, size=(views, 2)))
    k = np.stack([rng.uniform(-0.3, -0.1, views),
                  rng.uniform(0.05, 0.2, views),
                  rng.uniform(-0.01, 0.01, views)], axis=-1)
    p = rng.uniform(-2e-3, 2e-3, size=(views, 2))
    return {name: np.asarray(a, np.float32) for name, a in
            (("R", Rs), ("T", Ts), ("f", f), ("c", c), ("k", k), ("p", p))}


def people(count: int, t_pose: np.ndarray, centre, rng,
           spread: float = 2000.0) -> np.ndarray:
    """(count, J, 3) mm: the T-pose jittered (40 mm), turned about the
    vertical and placed in the capture space."""
    out = []
    for _ in range(count):
        root = np.asarray(centre) + np.array(
            [rng.uniform(-spread, spread), rng.uniform(-spread, spread),
             rng.uniform(-50.0, 50.0) + 100.0])
        ang = rng.uniform(0, 2 * np.pi)
        rot = np.array([[np.cos(ang), -np.sin(ang), 0.0],
                        [np.sin(ang), np.cos(ang), 0.0], [0.0, 0.0, 1.0]])
        jitter = rng.normal(0.0, 40.0, size=t_pose.shape)
        out.append((t_pose + jitter) @ rot.T + root)
    return np.asarray(out, np.float32).reshape(count, -1, 3)


@dataclasses.dataclass
class Ring:
    """The frames of one run: views (R, V, H, W, 3) float32 in pinned host
    memory, the people of each frame (R, M, J, 3; the slots past a frame's
    count are zeros) with their count (R,), and the rig's tensors (V, ...)
    on the device."""

    views: torch.Tensor
    joints: np.ndarray
    counts: np.ndarray
    rig: Dict[str, torch.Tensor]

    def __len__(self) -> int:
        return self.views.shape[0]

    def rig_batch(self, batch: int) -> Dict[str, torch.Tensor]:
        """The rig's tensors expanded to (batch, V, ...)."""
        return {k: v[None].expand((batch,) + tuple(v.shape)).contiguous()
                for k, v in self.rig.items()}

    def frame(self, indices, device) -> dict:
        """The reference's frame dict of ring entries `indices`."""
        idx = list(indices)
        out = self.rig_batch(len(idx))
        out["views"] = self.views[idx].to(device)
        return out


def make_rig(spec: dict, traffic: dict, device) -> Dict[str, torch.Tensor]:
    s = spec["settings"]
    cams = camera_ring(s["DATASET.CAMERA_NUM"], traffic["image_wh"],
                       s["MULTI_PERSON.SPACE_CENTER"], traffic["cam_seed"])
    affine, inverse, centre, scale = G.crop_affines(traffic["image_wh"],
                                                    s["NETWORK.IMAGE_SIZE"])
    V = s["DATASET.CAMERA_NUM"]
    rig = dict(cams)
    rig["centers"] = np.tile(centre, (V, 1))
    rig["scales"] = np.tile(scale, (V, 1))
    rig["affine"] = np.tile(affine, (V, 1, 1))
    rig["inv_affine"] = np.tile(inverse, (V, 1, 1))
    return {k: torch.from_numpy(np.ascontiguousarray(v, np.float32)).to(device)
            for k, v in rig.items()}


def make_ring(spec: dict, traffic: dict, seed: int, device) -> Ring:
    """The ring of `traffic["ring_frames"]` frames of `seed`."""
    s = spec["settings"]
    W, H = s["NETWORK.IMAGE_SIZE"]
    M = s["MULTI_PERSON.MAX_PEOPLE_NUM"]
    t_pose = np.asarray(spec["t_pose"], np.float64)
    J = t_pose.shape[0]
    R = traffic["ring_frames"]
    rng = np.random.default_rng(seed)
    base = list(traffic["people"])
    counts = np.asarray((base * (R // len(base) + 1))[:R])
    counts = counts[rng.permutation(R)]
    joints = np.zeros((R, M, J, 3), np.float32)
    for i, n in enumerate(counts):
        joints[i, :n] = people(int(n), t_pose, s["MULTI_PERSON.SPACE_CENTER"],
                               rng)
    rig = make_rig(spec, traffic, device)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    views = torch.empty((R, rig["R"].shape[0], H, W, 3),
                        dtype=torch.float32,
                        pin_memory=torch.device(device).type == "cuda")
    xs = torch.arange(W, dtype=torch.float32, device=device)
    ys = torch.arange(H, dtype=torch.float32, device=device)
    chan = torch.tensor(CHANNEL_SCALE, device=device)
    for i, n in enumerate(counts):
        pts = torch.from_numpy(joints[i, :n].reshape(-1, 3)).to(device)
        views[i].copy_(blobs(pts, rig, xs, ys)[..., None] * chan
                       + NOISE_STD * torch.randn(
                           (rig["R"].shape[0], H, W, 3), generator=gen,
                           device=device))
    return Ring(views=views, joints=joints, counts=counts, rig=rig)


def blobs(points: torch.Tensor, rig: dict, xs: torch.Tensor,
          ys: torch.Tensor) -> torch.Tensor:
    """(V, H, W): the sum of a Gaussian blob at each world point (N, 3)
    that a view sees (in front of the camera and inside the full image),
    at its network-image pixel."""
    V = rig["R"].shape[0]
    pix = G.project_points(points[None].expand(V, -1, 3),
                           *(rig[k] for k in "RTfckp"))
    depth = torch.einsum("vij,vnj->vni", rig["R"],
                         points[None] - rig["T"].transpose(-1, -2))[..., 2]
    wh = rig["centers"][:, None] * 2.0
    seen = ((depth > 0) & (pix >= 0).all(-1) & (pix < wh).all(-1)).float()
    net = G.apply_affine(pix, rig["affine"])
    gx = torch.exp(-(xs - net[..., 0:1]) ** 2 / (2 * BLOB_SIGMA ** 2))
    gy = torch.exp(-(ys - net[..., 1:2]) ** 2 / (2 * BLOB_SIGMA ** 2))
    return torch.einsum("vnh,vnw->vhw", gy * seen[..., None], gx)
