"""V2VNet: the 3D encoder-decoder of VoxelPose's two networks.

Port of `lib/models/v2v_net.py` of microsoft/voxelpose-pytorch (after
Moon et al.'s V2V-PoseNet), with its parameter names: a 7^3 front
convolution to 16 channels and a residual block to 32, an encoder of two
2x max pools with residual blocks 32 -> 64 -> 128 and a middle block, a
decoder of two stride-2 transposed convolutions (kernel 2) with residual
skips at 64 and 32 channels, and a 1x1x1 output convolution. Every
convolution has a bias; BatchNorm runs on its running statistics in eval
mode. Volumes are NCDHW float32.
"""

from __future__ import annotations

from typing import Optional

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
    """The published class name, misspelt as there."""

    def __init__(self):
        super().__init__()
        self.encoder_res1 = Res3DBlock(32, 64)
        self.encoder_res2 = Res3DBlock(64, 128)
        self.mid_res = Res3DBlock(128, 128)
        self.decoder_res2 = Res3DBlock(128, 128)
        self.decoder_upsample2 = Upsample3DBlock(128, 64)
        self.decoder_res1 = Res3DBlock(64, 64)
        self.decoder_upsample1 = Upsample3DBlock(64, 32)
        self.skip_res1 = Res3DBlock(32, 32)
        self.skip_res2 = Res3DBlock(64, 64)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        skip_x1 = self.skip_res1(x)
        x = self.encoder_res1(F.max_pool3d(x, 2, stride=2))
        skip_x2 = self.skip_res2(x)
        x = self.encoder_res2(F.max_pool3d(x, 2, stride=2))
        x = self.decoder_res2(self.mid_res(x))
        x = self.decoder_upsample2(x) + skip_x2
        return self.decoder_upsample1(self.decoder_res1(x)) + skip_x1


class V2VNet(nn.Module):
    """(N, in, D, H, W) -> (N, out, D, H, W); D, H and W divisible by 4."""

    def __init__(self, input_channels: int, output_channels: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.front_layers = nn.Sequential(
            Basic3DBlock(input_channels, 16, 7), Res3DBlock(16, 32))
        self.encoder_decoder = EncoderDecorder()
        self.output_layer = nn.Conv3d(32, output_channels, 1)
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, (nn.Conv3d, nn.ConvTranspose3d)):
                    nn.init.normal_(m.weight, 0.0, INIT_STD,
                                    generator=generator)
                    m.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.encoder_decoder(self.front_layers(x))
        return self.output_layer(x)
