"""Image backbone: a ResNet-basic-block UNet (the 2D-3D experiment's
ImageBackbone) with the optional DINO injection at the 1/8 level.

Counterpart of the JAX package's nn/image_backbone.py, in NCHW with cuDNN's
convolutions (float32: ``utils/precision.py`` keeps TF32 off), the
reference's module names, and align-corners bilinear upsampling. Returns
[fine 1/1, 1/2, 1/4, 1/8 coarse] feature maps.
"""
from __future__ import annotations

from torch import nn

from ..ops.vision import resize_align_corners
from .layers2d3d import ConvBlock, leaky2d3d


class BasicBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, stride: int = 1):
        super().__init__()
        self.conv1 = ConvBlock(in_channels, out_channels, 3, stride)
        self.conv2 = ConvBlock(out_channels, out_channels, 3, 1, use_act=False)
        self.identity = (None if stride == 1 and in_channels == out_channels
                         else ConvBlock(in_channels, out_channels, 3, stride, use_act=False))

    def forward(self, x):
        residual = self.conv2(self.conv1(x))
        identity = x if self.identity is None else self.identity(x)
        return leaky2d3d(identity + residual)


def _plain(cin, cout, k):
    return ConvBlock(cin, cout, k, use_norm=False, use_act=False)


class ImageBackbone(nn.Module):
    """image [B, C_in, H, W] -> [fine [B, out, H, W], 1/2 [B, base, .],
    1/4 [B, 2 base, .], 1/8 [B, 4 base, .]]."""

    def __init__(self, out_channels: int = 128, base_channels: int = 128, in_channels: int = 1):
        super().__init__()
        c = base_channels
        self.encoder1 = ConvBlock(in_channels, c, 7, 2)
        self.encoder2 = nn.Sequential(BasicBlock(c, c), BasicBlock(c, c))
        self.encoder3 = nn.Sequential(BasicBlock(c, 2 * c, 2), BasicBlock(2 * c, 2 * c))
        self.encoder4 = nn.Sequential(BasicBlock(2 * c, 4 * c, 2), BasicBlock(4 * c, 4 * c))
        self.decoder4_1 = _plain(4 * c, 4 * c, 1)
        self.decoder3_1 = _plain(2 * c, 4 * c, 1)
        self.decoder3_2 = nn.Sequential(ConvBlock(4 * c, 4 * c, 3), _plain(4 * c, 2 * c, 3))
        self.decoder2_1 = _plain(c, 2 * c, 1)
        self.decoder2_2 = nn.Sequential(ConvBlock(2 * c, 2 * c, 3), _plain(2 * c, c, 3))
        self.decoder1_1 = _plain(c, c, 1)
        self.decoder1_2 = nn.Sequential(ConvBlock(c, c, 3), _plain(c, c, 3))
        self.out_proj = _plain(c, out_channels, 1)

    def forward(self, image, dino_feat=None):
        """``dino_feat`` [B, 4 base, h, w] (projected DINO tokens) or None: added
        to the 1/8 encoder map after an align-corners resize to its size."""
        s1 = self.encoder1(image)                                   # 1/2
        s2 = self.encoder2(s1)
        s3 = self.encoder3(s2)                                      # 1/4
        s4 = self.encoder4(s3)                                      # 1/8
        if dino_feat is not None:
            s4 = s4 + resize_align_corners(dino_feat, s4.shape[-2:])
        latent4 = self.decoder4_1(s4)
        latent3 = self.decoder3_2(self.decoder3_1(s3)
                                  + resize_align_corners(latent4, s3.shape[-2:]))
        latent2 = self.decoder2_2(self.decoder2_1(s2)
                                  + resize_align_corners(latent3, s2.shape[-2:]))
        latent1 = resize_align_corners(self.decoder1_1(s1) + latent2, image.shape[-2:])
        fine = self.out_proj(self.decoder1_2(latent1))
        return [fine, latent2, latent3, latent4]
