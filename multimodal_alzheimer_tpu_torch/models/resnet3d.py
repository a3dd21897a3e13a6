"""MedicalNet/Med3D-style 3D ResNet backbones (depths 10/18/34/50), PyTorch.

Port of ``multimodal_alzheimer_tpu/models/resnet3d.py``, the Med3D
segmentation-style backbone:

  stem: Conv3d(k=7, stride=2, pad=3, no bias) -> BN -> ReLU ->
        MaxPool3d(k=3, stride=2, pad=1)
  layer1: 64 planes,  stride 1, dilation 1
  layer2: 128 planes, stride 2, dilation 1
  layer3: 256 planes, stride 1, dilation 2   (dilated; stride 2 if not)
  layer4: 512 planes, stride 1, dilation 4   (dilated; stride 2 if not)

Module names follow the flax tree (``conv1``, ``bn1``,
``layer{L}_block{B}/{conv1,bn1,...,downsample_conv,downsample_bn}``), so
``models/convert.py`` maps weights by name. Layout is NCDHW; padding is
torch-symmetric ``dilation*(k-1)//2``, as in the JAX package.

``fused_bn`` picks every backbone BatchNorm (20 in ResNet-18) through
``models.layers.batch_norm``: False (flax), ``"full"``/True (the Hopper
kernels), ``"hybrid"`` or ``"torch_stats"``. Train mode follows
``module.train()``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from multimodal_alzheimer_tpu_torch.models.layers import batch_norm

BLOCK_CONFIGS = {
    10: ("basic", (1, 1, 1, 1)),
    18: ("basic", (2, 2, 2, 2)),
    34: ("basic", (3, 4, 6, 3)),
    50: ("bottleneck", (3, 4, 6, 3)),
}

FEATURE_WIDTH = {10: 512, 18: 512, 34: 512, 50: 2048}


def _conv(cin: int, cout: int, kernel: int, stride: int = 1,
          dilation: int = 1, device=None) -> nn.Conv3d:
    return nn.Conv3d(cin, cout, kernel, stride=stride,
                     padding=dilation * (kernel - 1) // 2, dilation=dilation,
                     bias=False, device=device)


class BasicBlock3D(nn.Module):
    expansion = 1

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 dilation: int = 1, device=None, fused_bn=False):
        super().__init__()
        self.conv1 = _conv(inplanes, planes, 3, stride, dilation, device)
        self.bn1 = batch_norm(planes, fused_bn, device)
        self.conv2 = _conv(planes, planes, 3, 1, dilation, device)
        self.bn2 = batch_norm(planes, fused_bn, device)
        self.downsample_conv = self.downsample_bn = None
        if stride != 1 or inplanes != planes:
            self.downsample_conv = _conv(inplanes, planes, 1, stride,
                                         device=device)
            self.downsample_bn = batch_norm(planes, fused_bn, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        residual = x
        if self.downsample_conv is not None:
            residual = self.downsample_bn(self.downsample_conv(x))
        return F.relu(out + residual)


class Bottleneck3D(nn.Module):
    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 dilation: int = 1, device=None, fused_bn=False):
        super().__init__()
        out_ch = planes * self.expansion
        self.conv1 = _conv(inplanes, planes, 1, device=device)
        self.bn1 = batch_norm(planes, fused_bn, device)
        self.conv2 = _conv(planes, planes, 3, stride, dilation, device)
        self.bn2 = batch_norm(planes, fused_bn, device)
        self.conv3 = _conv(planes, out_ch, 1, device=device)
        self.bn3 = batch_norm(out_ch, fused_bn, device)
        self.downsample_conv = self.downsample_bn = None
        if stride != 1 or inplanes != out_ch:
            self.downsample_conv = _conv(inplanes, out_ch, 1, stride,
                                         device=device)
            self.downsample_bn = batch_norm(out_ch, fused_bn, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        residual = x
        if self.downsample_conv is not None:
            residual = self.downsample_bn(self.downsample_conv(x))
        return F.relu(out + residual)


class MedicalNetResNet3D(nn.Module):
    """Backbone only: (B, 1, D, H, W) -> (B, C_out, d, h, w).

    ``dilated=True`` keeps layers 3-4 at stride 1 with dilation 2/4 (Med3D);
    ``dilated=False`` uses stride-2 layers instead, with the same parameter
    shapes.
    """

    def __init__(self, depth: int = 18, dilated: bool = True, device=None,
                 fused_bn=False):
        super().__init__()
        block_kind, layout = BLOCK_CONFIGS[depth]
        block = BasicBlock3D if block_kind == "basic" else Bottleneck3D
        self.conv1 = _conv(1, 64, 7, stride=2, device=device)
        self.bn1 = batch_norm(64, fused_bn, device)
        if dilated:  # (planes, stride, dilation) per Med3D resnet.py
            specs = [(64, 1, 1), (128, 2, 1), (256, 1, 2), (512, 1, 4)]
        else:
            specs = [(64, 1, 1), (128, 2, 1), (256, 2, 1), (512, 2, 1)]
        self.block_names = []
        inplanes = 64
        for li, (planes, stride, dilation) in enumerate(specs, start=1):
            for bi in range(layout[li - 1]):
                name = f"layer{li}_block{bi}"
                self.add_module(name, block(inplanes, planes,
                                            stride if bi == 0 else 1,
                                            dilation, device, fused_bn))
                self.block_names.append(name)
                inplanes = planes * block.expansion

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.max_pool3d(x, 3, 2, 1)
        for name in self.block_names:
            x = getattr(self, name)(x)
        return x
