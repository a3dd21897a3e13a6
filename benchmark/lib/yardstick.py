"""The benchmark's yardstick: one H100's published peaks, the least time a
kernel's work could take on it, and the analytic operation counts of the
configurations' convolutions.

These are frozen copies, written here in plain Python, of the arithmetic of
the port's ``tools/kernel_times.py`` (bytes and operations of K1-K9) and of
the root ``bench.py`` (convolution FLOPs per volume of a train step); the
benchmark imports neither. Later changes to the program cannot move them.
A backbone's convolutions come from its file under ``reference/backbones/``
(``convs(grid)``), which the configuration names.

Peaks (NVIDIA's data sheet, H100 SXM, dense, at the 700 W limit): 989
TFLOP/s bf16, 1,979 TOP/s int8, 67 TFLOP/s float32 outside the tensor cores,
3.35 TB/s of HBM.
"""

from __future__ import annotations

import math

from benchmark.reference import nets

BF16_FLOP_PER_S = 989e12
INT8_OP_PER_S = 1979e12
F32_FLOP_PER_S = 67e12
HBM_BYTES_PER_S = 3.35e12

# --------------------------------------------------------------------------
# Least time of a memory- or operation-bound kernel (kernel_times.py)
# --------------------------------------------------------------------------


def bound_s(nbytes: float, flops: float, flop_rate: float = F32_FLOP_PER_S
            ) -> float:
    """The larger of the bytes over 3.35 TB/s and the operations over
    ``flop_rate`` (float32 outside the tensor cores by default), seconds."""
    return max(nbytes / HBM_BYTES_PER_S, flops / flop_rate)


def bn_bound_s(shape, item: int) -> dict:
    """K4 bn_stats, K5 bn_apply, K6 bn_grad_sum, K7 bn_dx on an NCDHW
    activation of ``shape`` with ``item``-byte elements: each full tensor
    read or written once, the float32 (C,) vectors, and the float32
    operations per element."""
    elems = float(math.prod(shape))
    c = shape[1]
    #        (full tensors moved, (C,) vectors moved, flops per element)
    counts = {"bn_stats": (1, 2, 3), "bn_apply": (2, 4, 4),
              "bn_grad_sum": (2, 4, 5), "bn_dx": (3, 5, 6)}
    return {k: bound_s(item * t * elems + 4 * v * c, f * elems)
            for k, (t, v, f) in counts.items()}


def norm_bound_s(batch: int, voxels: int, levels: int = 2) -> dict:
    """Per-scan normalisation of a (batch, voxels) float32 batch. K1
    minmax_select: volume and mask read once, (B, 1 + 2Q) words written, one
    operation a voxel. K2 minmax_apply and K3 zscore: volume and mask read,
    the output written, four operations a voxel."""
    n = float(batch * voxels)
    return {"minmax_select": bound_s(8 * n + 4 * batch * (1 + 2 * levels), n),
            "minmax_apply": bound_s(12 * n, 4 * n),
            "zscore": bound_s(12 * n, 4 * n)}


# --------------------------------------------------------------------------
# Convolution geometry of the configurations' backbones and SmallPETCNN
# --------------------------------------------------------------------------


def conv_out(size, k: int, stride: int = 1, dilation: int = 1,
             pad: int | None = None) -> tuple:
    """Output (D, H, W) of a cubic conv with symmetric padding
    ``dilation * (k - 1) // 2`` unless ``pad`` is given."""
    p = dilation * (k - 1) // 2 if pad is None else pad
    return tuple((n + 2 * p - dilation * (k - 1) - 1) // stride + 1
                 for n in size)


def backbone_convs(config: dict, bench_dir, grid=None) -> list:
    """The convolution records (name, C_in, F, k, stride, dilation, input
    (D, H, W), output (D, H, W)), the stem first, of one forward of the
    configuration's backbone (the file ``reference/backbones/<backbone>.py``
    under ``bench_dir``) on a ``grid`` volume, the configuration's by
    default."""
    net = nets.backbone(config, bench_dir)
    return net.convs(tuple(config["grid"] if grid is None else grid))


def pet_convs(grid, conv_out_widths=(8, 16, 32, 64),
              filter_size=(5, 5, 3, 3)) -> list:
    """SmallPETCNN's convolutions ('same' padding, stride 1, each followed
    by a 2^3 max pool): (name, C_in, F, k, input, output)."""
    convs, size, cin = [], tuple(grid), 1
    for i, (f, k) in enumerate(zip(conv_out_widths, filter_size)):
        convs.append((f"block_{i}", cin, f, k, size, size))
        size, cin = tuple(n // 2 for n in size), f
    return convs


def _flops(cin: int, f: int, k: int, out) -> float:
    """2 * taps * C_in * F * output voxels."""
    return 2.0 * k ** 3 * cin * f * math.prod(out)


def forward_flops(convs) -> float:
    """Σ 2 * taps * C_in * F * output voxels over a backbone's ``convs``."""
    return sum(_flops(c[1], c[2], c[3], c[7]) for c in convs)


def train_flops(convs) -> float:
    """Forward, input gradient and weight gradient of every convolution of
    a backbone's ``convs``, except the stem's input gradient (the scan is
    no differentiated variable): 444.9e9 for the dilated ResNet-18 at
    91x109x91 (``bench.py``'s count)."""
    total = 0.0
    for name, cin, f, k, _, _, _, out in convs:
        total += (2 if name == "stem" else 3) * _flops(cin, f, k, out)
    return total


def pet_forward_flops(grid, *widths) -> float:
    """``widths``: SmallPETCNN's (conv_out, filter_size), its defaults
    when left out."""
    return sum(_flops(c[1], c[2], c[3], c[5])
               for c in pet_convs(grid, *widths))


def pet_train_flops(grid, *widths) -> float:
    """As ``train_flops``: no input gradient of the first conv."""
    return sum((2 if i == 0 else 3) * _flops(c[1], c[2], c[3], c[5])
               for i, c in enumerate(pet_convs(grid, *widths)))


def conv_flops_per_sample(config: dict, bench_dir,
                          trained_towers: bool = True) -> float:
    """Analytic convolution FLOPs of one sample of a train step of
    ``config``: each MRI tower (its backbone file under ``bench_dir``;
    ValueError where there is none for the configuration) and SmallPETCNN
    tower that runs, trained (forward and both gradients) or frozen (its
    forward once)."""
    convs = backbone_convs(config, bench_dir)
    grid = tuple(config["grid"])
    towers = config["towers"]
    pet = config.get("pet", {})
    widths = (tuple(pet["conv_out"]), tuple(pet["filter_size"])) if pet \
        else ()
    if not trained_towers:
        shared = config.get("frozen_towers_shared", True)
        n_mri = 1 if shared else towers["mri"]
        n_pet = 1 if shared else towers.get("pet", 0)
        return (n_mri * forward_flops(convs)
                + (n_pet * pet_forward_flops(grid, *widths) if n_pet else 0))
    return (towers["mri"] * train_flops(convs)
            + towers.get("pet", 0) * pet_train_flops(grid, *widths))


# --------------------------------------------------------------------------
# K9: the int8 convolutions of one forward of a backbone of basic blocks
# --------------------------------------------------------------------------

# Epilogue mode of each convolution of the int8 graph: (residual bytes a
# value, output bytes a value). The stem and each block's first conv write
# int8 after ReLU; a block's second conv adds its shortcut (the int8
# carrier, or the downsample's float32 output) and writes int8, the last
# block's float32; the downsamples write float32.
def _int8_mode(name: str, has_downsample: bool, last: bool) -> tuple:
    if name == "stem" or name.endswith("conv1"):
        return 0, 1
    if name.endswith("downsample"):
        return 0, 4
    return (4 if has_downsample else 1), (4 if last else 1)


def k9_forward_bound_s(convs, batch: int) -> float:
    """Least time of K9's launches, one a convolution of ``convs`` (a
    backbone of basic blocks), in one int8 forward of ``batch`` scans: per
    launch the larger of 2 M F K operations at 1,979 TOP/s and the int8
    input and weights read once, scale and bias, the residual read once and
    the output written once, at 3.35 TB/s."""
    blocks_with_down = {c[0].rsplit(".", 1)[0] for c in convs
                        if c[0].endswith("downsample")}
    last = [c[0] for c in convs if c[0].endswith("conv2")][-1]
    total = 0.0
    for name, cin, f, k, _, _, size, out in convs:
        block = name.rsplit(".", 1)[0]
        res_b, out_b = _int8_mode(name, block in blocks_with_down,
                                  name == last)
        m = batch * math.prod(out)
        kk = cin * k ** 3
        ops = 2.0 * m * f * kk
        nbytes = (batch * math.prod(size) * cin + f * kk + 8 * f
                  + (res_b + out_b) * m * f)
        total += max(ops / INT8_OP_PER_S, nbytes / HBM_BYTES_PER_S)
    return total
