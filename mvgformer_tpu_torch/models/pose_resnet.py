"""PoseResNet backbone: ResNet bottleneck trunk + 3 stride-2 deconvolutions.

Port of `mvgformer_tpu/models/pose_resnet.py`, with the original torch
parameter names (`conv1`, `layer1.0.conv1`, `layer1.0.downsample.0`,
`deconv_layers.{0,3,6}`, ...). The forward returns the three *pre-BN*
deconv outputs selected by `use_feat_level`. BatchNorm always uses its
running statistics (eps 1e-5): the backbone is frozen. The volumetric
models' backbone (`heatmap_joints`) adds the published heatmap head,
`final_layer`: the last deconvolution's BN and ReLU, then a 1x1 convolution
to one map per joint; Learnable Triangulation's also takes the head's input,
the features after that BN and ReLU (`with_features`).

Public tensors are NHWC, like the JAX package. Inside, the image batch is a
channels_last NCHW tensor, the layout cuDNN convolves fastest.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from mvgformer_tpu_torch.models.mlp import init_linear_

RESNET_BLOCKS = {18: (2, 2, 2, 2), 34: (3, 4, 6, 3), 50: (3, 4, 6, 3),
                 101: (3, 4, 23, 3), 152: (3, 8, 36, 3)}
BN_EPS = 1e-5


def _conv(cin: int, cout: int, k: int, stride: int, pad: int,
          generator: Optional[torch.Generator]) -> nn.Conv2d:
    conv = nn.Conv2d(cin, cout, k, stride=stride, padding=pad, bias=False)
    init_linear_(conv.weight, "lecun", generator)
    return conv


def _bn(x: torch.Tensor, bn: nn.BatchNorm2d) -> torch.Tensor:
    """Eval-mode BatchNorm folded into one scale and shift, computed in
    float32 and applied in the dtype of x."""
    scale = bn.weight * torch.rsqrt(bn.running_var + BN_EPS)
    shift = bn.bias - bn.running_mean * scale
    return (x * scale.to(x.dtype)[:, None, None]
            + shift.to(x.dtype)[:, None, None])


def _conv_fwd(x: torch.Tensor, conv: nn.Module) -> torch.Tensor:
    w = conv.weight.to(x.dtype)
    if isinstance(conv, nn.ConvTranspose2d):
        return F.conv_transpose2d(x, w, stride=conv.stride,
                                  padding=conv.padding)
    return F.conv2d(x, w, stride=conv.stride, padding=conv.padding)


class Bottleneck(nn.Module):
    """ResNet bottleneck block, expansion 4."""

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 downsample: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.conv1 = _conv(inplanes, planes, 1, 1, 0, generator)
        self.bn1 = nn.BatchNorm2d(planes)
        self.conv2 = _conv(planes, planes, 3, stride, 1, generator)
        self.bn2 = nn.BatchNorm2d(planes)
        self.conv3 = _conv(planes, planes * 4, 1, 1, 0, generator)
        self.bn3 = nn.BatchNorm2d(planes * 4)
        self.downsample = (nn.Sequential(
            _conv(inplanes, planes * 4, 1, stride, 0, generator),
            nn.BatchNorm2d(planes * 4)) if downsample else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(_bn(_conv_fwd(x, self.conv1), self.bn1))
        out = F.relu(_bn(_conv_fwd(out, self.conv2), self.bn2))
        out = _bn(_conv_fwd(out, self.conv3), self.bn3)
        residual = x
        if self.downsample is not None:
            residual = _bn(_conv_fwd(x, self.downsample[0]),
                           self.downsample[1])
        return F.relu(out + residual)


class PoseResNet(nn.Module):
    """ResNet trunk + 3 deconv stages; returns pre-BN deconv features.

    Input:  (N, H, W, 3) images (NHWC).
    Output: list of (N, h_i, w_i, C) NHWC maps at strides 16, 8, 4, i.e. in
    increasing resolution; the caller reverses it.
    """

    def __init__(self, num_layers: int = 50,
                 deconv_filters: Sequence[int] = (256, 256, 256),
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None,
                 heatmap_joints: Optional[int] = None):
        super().__init__()
        self.dtype = dtype
        self.conv1 = _conv(3, 64, 7, 2, 3, generator)
        self.bn1 = nn.BatchNorm2d(64)
        inplanes = 64
        for li, (planes, n_blocks) in enumerate(
                zip((64, 128, 256, 512), RESNET_BLOCKS[num_layers])):
            stride = 1 if li == 0 else 2
            blocks = []
            for bi in range(n_blocks):
                first = bi == 0
                blocks.append(Bottleneck(
                    inplanes, planes, stride if first else 1,
                    downsample=first and (stride != 1
                                          or inplanes != planes * 4),
                    generator=generator))
                inplanes = planes * 4
            setattr(self, f"layer{li + 1}", nn.Sequential(*blocks))
        deconv = []
        for f in deconv_filters:
            # torch ConvTranspose2d(k=4, s=2, p=1): weight (in, out, kh, kw)
            dc = nn.ConvTranspose2d(inplanes, f, 4, stride=2, padding=1,
                                    bias=False)
            # flax initializes the transposed kernel with fan_in = out*kh*kw
            init_linear_(dc.weight, "lecun", generator)
            deconv += [dc, nn.BatchNorm2d(f), nn.ReLU(inplace=True)]
            inplanes = f
        self.deconv_layers = nn.Sequential(*deconv)
        self.final_layer = None
        if heatmap_joints is not None:
            # built for the volumetric models alone, so the other models'
            # state dicts (and the weights drawn for them by name) stay as
            # they are
            self.final_layer = nn.Conv2d(inplanes, heatmap_joints, 1)
            with torch.no_grad():
                nn.init.normal_(self.final_layer.weight, 0.0, 0.001,
                                generator=generator)
                self.final_layer.bias.zero_()

    def forward(self, x: torch.Tensor,
                use_feat_level: Sequence[int] = (0, 1, 2),
                with_features: bool = False):
        """The pre-BN levels of `use_feat_level`, or where the heatmap
        head was built (the volumetric models' backbone) its heatmaps
        (N, J, h, w), and with `with_features` the features it reads
        (N, C, h, w) beside them. Both are channels_last NCHW."""
        x = x.to(self.dtype).permute(0, 3, 1, 2)  # channels_last NCHW view
        x = F.relu(_bn(_conv_fwd(x, self.conv1), self.bn1))
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        for li in range(1, 5):
            for block in getattr(self, f"layer{li}"):
                x = block(x)
        feats = []
        for di in range(len(self.deconv_layers) // 3):
            x = _conv_fwd(x, self.deconv_layers[3 * di])
            feats.append(x)  # pre-BN, as in the reference forward
            x = F.relu(_bn(x, self.deconv_layers[3 * di + 1]))
        head = self.final_layer
        if head is not None:
            hm = F.conv2d(x, head.weight.to(x.dtype), head.bias.to(x.dtype))
            return (hm, x) if with_features else hm
        return [f.permute(0, 2, 3, 1).contiguous()
                for i, f in enumerate(feats) if i in tuple(use_feat_level)]
