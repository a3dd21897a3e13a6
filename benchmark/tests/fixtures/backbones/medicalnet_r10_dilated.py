"""Med3D's ResNet-10 3D with layers 3-4 dilated (arXiv:1904.00625,
Tencent/MedicalNet ``models/resnet.py`` ``resnet10``): a 7^3 stride-2 stem,
a 3 / 2 / 1 max pool, and basic blocks (1, 1, 1, 1) at 64, 128, 256 and 512
planes, layer 2 at stride 2, layers 3-4 at stride 1 with dilation 2 and 4,
a 1^3 convolutional shortcut where the stride or the width changes. Every
convolution is followed by a BatchNorm.

A test fixture: a second backbone, which enters the benchmark as this one
file (``test_portbench_discovery``). As every backbone file: ``KEYS``,
``BLOCK`` and ``LAYERS`` (planes, blocks, stride, dilation), ``forward``
and ``convs``.
"""

from __future__ import annotations

import torch.nn.functional as F

from benchmark.lib.yardstick import conv_out
from benchmark.reference.nets import F32, Numerics, batch_norm

KEYS = {"resnet_depth": 10, "dilated": True}
BLOCK = "basic"
LAYERS = [(64, 1, 1, 1), (128, 1, 2, 1), (256, 1, 1, 2), (512, 1, 1, 4)]


def forward(P, pre, x, train: bool, nm: Numerics = F32):
    """(B, 1, D, H, W) -> feature map; ``pre`` prefixes the parameters'
    names."""
    x = nm.conv(x, P[f"{pre}conv1.weight"], stride=2, padding=3)
    x = F.relu(batch_norm(P, f"{pre}bn1", x, train))
    x = F.max_pool3d(x, 3, 2, 1)
    inplanes = 64
    for li, (planes, blocks, stride, dil) in enumerate(LAYERS, start=1):
        for bi in range(blocks):
            blk = f"{pre}layer{li}_block{bi}."
            st = stride if bi == 0 else 1
            out = nm.conv(x, P[blk + "conv1.weight"], stride=st,
                          padding=dil, dilation=dil)
            out = F.relu(batch_norm(P, blk + "bn1", out, train))
            out = nm.conv(out, P[blk + "conv2.weight"], padding=dil,
                          dilation=dil)
            out = batch_norm(P, blk + "bn2", out, train)
            if st != 1 or inplanes != planes:
                res = nm.conv(x, P[blk + "downsample_conv.weight"],
                              stride=st)
                res = batch_norm(P, blk + "downsample_bn", res, train)
            else:
                res = x
            x = F.relu(out + res)
            inplanes = planes
    return x


def convs(grid) -> list:
    """Every convolution of one forward on a ``grid`` volume: (name, C_in,
    F, k, stride, dilation, input (D, H, W), output (D, H, W)), the stem
    first. 12 convolutions, 3 of them 1^3 downsamples."""
    out_convs = []
    stem_out = conv_out(grid, 7, 2)
    out_convs.append(("stem", 1, 64, 7, 2, 1, tuple(grid), stem_out))
    size = conv_out(stem_out, 3, 2)  # the stem's max pool, 3 / 2 / 1
    inplanes = 64
    for li, (planes, blocks, stride, dilation) in enumerate(LAYERS, start=1):
        for bi in range(blocks):
            st = stride if bi == 0 else 1
            out = conv_out(size, 3, st, dilation)
            out_convs.append((f"layer{li}_block{bi}.conv1", inplanes, planes,
                              3, st, dilation, size, out))
            out_convs.append((f"layer{li}_block{bi}.conv2", planes, planes,
                              3, 1, dilation, out, out))
            if st != 1 or inplanes != planes:
                out_convs.append((f"layer{li}_block{bi}.downsample",
                                  inplanes, planes, 1, st, 1, size,
                                  conv_out(size, 1, st)))
            size, inplanes = out, planes
    return out_convs
