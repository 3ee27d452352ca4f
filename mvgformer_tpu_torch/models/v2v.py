"""The 3D encoder-decoders of the volumetric models (after Moon et al.'s
V2V-PoseNet), with their published parameter names.

`V2VNet` ports `lib/models/v2v_net.py` of microsoft/voxelpose-pytorch,
VoxelPose's two networks: a 7^3 front convolution to 16 channels and a
residual block to 32, an encoder of two 2x max pools with residual blocks
32 -> 64 -> 128 and a middle block, a decoder of two stride-2 transposed
convolutions (kernel 2) with residual skips at 64 and 32 channels, and a
1x1x1 output convolution.

`V2VModel` ports `mvn/models/v2v.py` of karfly/learnable-triangulation-pose,
the volumetric Learnable Triangulation model's network: the same blocks,
two more residual blocks in front, five pooling levels (32 -> 64 -> 128,
then 128 three times, down to 1/32 of the side), and behind the decoder a
residual block and two 1^3 convolution blocks before the output.

Both encoder-decoders are `EncoderDecorder` at their level widths. Every
convolution has a bias; BatchNorm runs on its running statistics in eval
mode. Volumes are NCDHW float32.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

# the published weight init of every 3D convolution: N(0, 0.001), bias 0
INIT_STD = 0.001


class Basic3DBlock(nn.Module):
    def __init__(self, in_planes: int, out_planes: int, kernel_size: int):
        super().__init__()
        self.block = nn.Sequential(
            nn.Conv3d(in_planes, out_planes, kernel_size,
                      padding=(kernel_size - 1) // 2),
            nn.BatchNorm3d(out_planes), nn.ReLU(inplace=True))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.block(x)


class Res3DBlock(nn.Module):
    """Two 3^3 convolutions with BN, added to the input (through a 1^3
    convolution and BN where the width changes), then ReLU."""

    def __init__(self, in_planes: int, out_planes: int):
        super().__init__()
        self.res_branch = nn.Sequential(
            nn.Conv3d(in_planes, out_planes, 3, padding=1),
            nn.BatchNorm3d(out_planes), nn.ReLU(inplace=True),
            nn.Conv3d(out_planes, out_planes, 3, padding=1),
            nn.BatchNorm3d(out_planes))
        self.skip_con = (nn.Sequential() if in_planes == out_planes else
                         nn.Sequential(nn.Conv3d(in_planes, out_planes, 1),
                                       nn.BatchNorm3d(out_planes)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.res_branch(x) + self.skip_con(x), inplace=True)


class Upsample3DBlock(nn.Module):
    def __init__(self, in_planes: int, out_planes: int):
        super().__init__()
        self.block = nn.Sequential(
            nn.ConvTranspose3d(in_planes, out_planes, 2, stride=2),
            nn.BatchNorm3d(out_planes), nn.ReLU(inplace=True))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.block(x)


class EncoderDecorder(nn.Module):
    """The published class name, misspelt as there. `widths` are the
    channels at each level, the input's first: level i pools by 2 and
    widens widths[i - 1] -> widths[i] (`encoder_res<i>`), keeps a skip of
    its input (`skip_res<i>`), and on the way back comes up through
    `decoder_res<i>` and `decoder_upsample<i>`. The modules are made in
    the published order, so the state dict's is the published one."""

    def __init__(self, widths: Sequence[int] = (32, 64, 128)):
        super().__init__()
        self.levels = len(widths) - 1
        for i in range(1, self.levels + 1):
            setattr(self, f"encoder_res{i}",
                    Res3DBlock(widths[i - 1], widths[i]))
        self.mid_res = Res3DBlock(widths[-1], widths[-1])
        for i in range(self.levels, 0, -1):
            setattr(self, f"decoder_res{i}", Res3DBlock(widths[i], widths[i]))
            setattr(self, f"decoder_upsample{i}",
                    Upsample3DBlock(widths[i], widths[i - 1]))
        for i in range(1, self.levels + 1):
            setattr(self, f"skip_res{i}",
                    Res3DBlock(widths[i - 1], widths[i - 1]))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        skips = []
        for i in range(1, self.levels + 1):
            skips.append(getattr(self, f"skip_res{i}")(x))
            x = getattr(self, f"encoder_res{i}")(F.max_pool3d(x, 2, stride=2))
        x = self.mid_res(x)
        for i in range(self.levels, 0, -1):
            x = getattr(self, f"decoder_res{i}")(x)
            x = getattr(self, f"decoder_upsample{i}")(x) + skips[i - 1]
        return x


def init_published_(net: nn.Module,
                    generator: Optional[torch.Generator]) -> None:
    """The published init of every 3D convolution: N(0, INIT_STD), bias
    0."""
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, (nn.Conv3d, nn.ConvTranspose3d)):
                nn.init.normal_(m.weight, 0.0, INIT_STD, generator=generator)
                m.bias.zero_()


class V2VNet(nn.Module):
    """(N, in, D, H, W) -> (N, out, D, H, W); D, H and W divisible by 4."""

    def __init__(self, input_channels: int, output_channels: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.front_layers = nn.Sequential(
            Basic3DBlock(input_channels, 16, 7), Res3DBlock(16, 32))
        self.encoder_decoder = EncoderDecorder()
        self.output_layer = nn.Conv3d(32, output_channels, 1)
        init_published_(self, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.encoder_decoder(self.front_layers(x))
        return self.output_layer(x)


class V2VModel(nn.Module):
    """(N, in, D, H, W) -> (N, out, D, H, W); D, H and W divisible by
    32."""

    def __init__(self, input_channels: int, output_channels: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.front_layers = nn.Sequential(
            Basic3DBlock(input_channels, 16, 7), Res3DBlock(16, 32),
            Res3DBlock(32, 32), Res3DBlock(32, 32))
        self.encoder_decoder = EncoderDecorder((32, 64, 128, 128, 128, 128))
        self.back_layers = nn.Sequential(
            Res3DBlock(32, 32), Basic3DBlock(32, 32, 1),
            Basic3DBlock(32, 32, 1))
        self.output_layer = nn.Conv3d(32, output_channels, 1)
        init_published_(self, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.encoder_decoder(self.front_layers(x))
        return self.output_layer(self.back_layers(x))
