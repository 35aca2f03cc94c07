"""Pri3D ResNet and ResUNet image backbones (vision3d/models/pri3d/).

Counterpart of the JAX package's zoo/pri3d.py: BasicBlock, Bottleneck, the
ResNet encoder with its per-stage taps, the up-projection and the two ResUNet
decoders. NCHW, as the port's image layers are. The reference's BatchNorm2d
is the JAX package's GroupNorm twin (vision3d's optimal groups, eps 1e-5);
upsampling is bilinear with align_corners=True. Submodules carry the JAX
package's names (``conv1``, ``bn1``, ``layer1_0``, ``up1``, ...).
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch.nn.functional as F
from torch import nn

from ..nn.layers2d3d import optimal_groups
from ..ops.vision import resize_align_corners
from ..utils.precision import pin_float32


def _norm(channels: int) -> nn.GroupNorm:
    return nn.GroupNorm(optimal_groups(channels), channels, eps=1e-5)


class BasicBlock(nn.Module):
    def __init__(self, inplanes: int, planes: int, stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(inplanes, planes, 3, stride, 1, bias=False)
        self.bn1 = _norm(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, 1, 1, bias=False)
        self.bn2 = _norm(planes)
        if stride != 1 or inplanes != planes:
            self.downsample_conv = nn.Conv2d(inplanes, planes, 1, stride, bias=False)
            self.downsample_bn = _norm(planes)
        else:
            self.downsample_conv = None

    def forward(self, x):
        out = self.bn2(self.conv2(F.relu(self.bn1(self.conv1(x)))))
        residual = x if self.downsample_conv is None else \
            self.downsample_bn(self.downsample_conv(x))
        return F.relu(out + residual)


class Bottleneck(nn.Module):
    """The bottleneck block (expansion 4)."""

    def __init__(self, inplanes: int, planes: int, stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(inplanes, planes, 1, bias=False)
        self.bn1 = _norm(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, stride, 1, bias=False)
        self.bn2 = _norm(planes)
        self.conv3 = nn.Conv2d(planes, planes * 4, 1, bias=False)
        self.bn3 = _norm(planes * 4)
        if stride != 1 or inplanes != planes * 4:
            self.downsample_conv = nn.Conv2d(inplanes, planes * 4, 1, stride, bias=False)
            self.downsample_bn = _norm(planes * 4)
        else:
            self.downsample_conv = None

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        residual = x if self.downsample_conv is None else \
            self.downsample_bn(self.downsample_conv(x))
        return F.relu(out + residual)


class ResNetEncoder(nn.Module):
    """The ResNet stem and four stages; returns each stage's output (the taps
    the ResUNet decoders read)."""

    def __init__(self, layers: Sequence[int], bottleneck: bool = False, in_channels: int = 3):
        super().__init__()
        pin_float32()
        block = Bottleneck if bottleneck else BasicBlock
        expansion = 4 if bottleneck else 1
        self.layers = tuple(layers)
        self.conv1 = nn.Conv2d(in_channels, 64, 7, 2, 3, bias=False)
        self.bn1 = _norm(64)
        inplanes = 64
        for stage, (planes, nblocks) in enumerate(zip((64, 128, 256, 512), self.layers)):
            for i in range(nblocks):
                stride = 2 if (stage > 0 and i == 0) else 1
                self.add_module(f"layer{stage + 1}_{i}", block(inplanes, planes, stride))
                inplanes = planes * expansion

    def forward(self, x) -> Tuple:
        x = F.max_pool2d(F.relu(self.bn1(self.conv1(x))), 3, 2, 1)
        taps = []
        for stage, nblocks in enumerate(self.layers):
            for i in range(nblocks):
                x = getattr(self, f"layer{stage + 1}_{i}")(x)
            taps.append(x)
        return tuple(taps)


def create_resnet10():
    return ResNetEncoder((1, 1, 1, 1))


def create_resnet18():
    return ResNetEncoder((2, 2, 2, 2))


def create_resnet34():
    return ResNetEncoder((3, 4, 6, 3))


def create_resnet50():
    return ResNetEncoder((3, 4, 6, 3), bottleneck=True)


def create_resnet101():
    return ResNetEncoder((3, 4, 23, 3), bottleneck=True)


class UpProjection(nn.Module):
    """Bilinear (align corners) resize, then two conv branches summed."""

    def __init__(self, in_features: int, out_features: int):
        super().__init__()
        pin_float32()
        self.conv1 = nn.Conv2d(in_features, out_features, 5, 1, 2, bias=False)
        self.bn1 = _norm(out_features)
        self.conv1_2 = nn.Conv2d(out_features, out_features, 3, 1, 1, bias=False)
        self.bn1_2 = _norm(out_features)
        self.conv2 = nn.Conv2d(in_features, out_features, 5, 1, 2, bias=False)
        self.bn2 = _norm(out_features)

    def forward(self, x, size: Tuple[int, int]):
        x = resize_align_corners(x, size)
        b1 = self.bn1_2(self.conv1_2(F.relu(self.bn1(self.conv1(x)))))
        return F.relu(b1 + self.bn2(self.conv2(x)))


class ResUNetDecoder(nn.Module):
    """Four up-projections with skip additions and a 1 x 1 head."""

    def __init__(self, block_channel: Sequence[int], output_channel: int = 1):
        super().__init__()
        nf = block_channel[-1]
        for i in range(1, 5):
            self.add_module(f"up{i}", UpProjection(nf // 2 ** (i - 1), nf // 2 ** i))
        self.conv0 = nn.Conv2d(nf // 16, output_channel, 1)

    def forward(self, taps):
        x1, x2, x3, x4 = taps
        d = self.up1(x4, x3.shape[-2:]) + x3
        d = self.up2(d, x2.shape[-2:]) + x2
        d = self.up3(d, x1.shape[-2:]) + x1
        d = self.up4(d, (x1.shape[-2] * 2, x1.shape[-1] * 2))
        return self.conv0(d)


class ResUNetDecoderMultiRes(nn.Module):
    """The decoder with heads at 1/2 and 1/4 of the input: returns (out4,
    out3)."""

    def __init__(self, block_channel: Sequence[int], output_channel: int = 1):
        super().__init__()
        nf = block_channel[-1]
        for i in range(1, 5):
            self.add_module(f"up{i}", UpProjection(nf // 2 ** (i - 1), nf // 2 ** i))
        self.conv1 = nn.Conv2d(nf // 8, output_channel, 1)
        self.conv2 = nn.Conv2d(nf // 16, output_channel, 1)

    def forward(self, taps):
        x1, x2, x3, x4 = taps
        d = self.up1(x4, x3.shape[-2:]) + x3
        d = self.up2(d, x2.shape[-2:]) + x2
        d3 = self.up3(d, x1.shape[-2:])
        out3 = self.conv1(d3)
        d4 = self.up4(d3 + x1, (x1.shape[-2] * 2, x1.shape[-1] * 2))
        return self.conv2(d4), out3


class ResUNet(nn.Module):
    """Res{10,18,50}UNet behind ``depth``."""

    def __init__(self, output_channel: int, depth: int = 18, multires: bool = False,
                 in_channels: int = 3):
        super().__init__()
        if depth == 50:
            layers, bottleneck, channels = (3, 4, 6, 3), True, (256, 512, 1024, 2048)
        elif depth == 10:
            layers, bottleneck, channels = (1, 1, 1, 1), False, (64, 128, 256, 512)
        else:
            layers, bottleneck, channels = (2, 2, 2, 2), False, (64, 128, 256, 512)
        self.encoder = ResNetEncoder(layers, bottleneck, in_channels)
        decoder = ResUNetDecoderMultiRes if multires else ResUNetDecoder
        self.decoder = decoder(channels, output_channel)

    def forward(self, x):
        return self.decoder(self.encoder(x))
