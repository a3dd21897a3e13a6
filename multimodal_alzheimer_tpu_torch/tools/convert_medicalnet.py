"""Convert MedicalNet pretrained weights to the port's backbone.

Port of the JAX package's ``tools/convert_medicalnet.py``. The reference
fine-tunes ``resnet_{10,18,50}_23dataset.pth`` (reference:
mri_models/anat_cnn.py:18-31). This tool maps that torch ``state_dict``
onto ``models.resnet3d.MedicalNetResNet3D``'s names and writes a port
checkpoint (``train.checkpoint.save_checkpoint``) that
``train.checkpoint.graft_params`` loads under a model's ``backbone``:

  conv1, bn1                      -> conv1, bn1
  layer{L}.{B}.conv{i}, .bn{i}    -> layer{L}_block{B}.conv{i}, .bn{i}
  layer{L}.{B}.downsample.{0,1}   -> layer{L}_block{B}.downsample_{conv,bn}

Torch to torch, so no transposes. BatchNorm ``running_var`` is carried
across as stored, as JAX's converter carries it; ``num_batches_tracked``
is dropped here and set to 0 where the target model has one
(``tools.convert_reference.merge_state_dicts``). A ``module.`` prefix
(a ``DataParallel`` save) is stripped.

Usage:
    python -m multimodal_alzheimer_tpu_torch.tools.convert_medicalnet \\
        resnet_18_23dataset.pth out_dir --depth 18
"""

from __future__ import annotations

import argparse
import re
from typing import Dict

import numpy as np
import torch

from multimodal_alzheimer_tpu_torch.models.resnet3d import BLOCK_CONFIGS

_BN_LEAVES = ("weight", "bias", "running_mean", "running_var")


def _tensor(value) -> torch.Tensor:
    """A float32 CPU copy of a torch tensor or numpy array."""
    if isinstance(value, torch.Tensor):
        value = value.detach().cpu().numpy()
    return torch.from_numpy(np.array(value, np.float32))


def _conv(out: Dict, prefix: str, sd: Dict, key: str) -> None:
    out[f"{prefix}.weight"] = _tensor(sd[f"{key}.weight"])


def _bn(out: Dict, prefix: str, sd: Dict, key: str) -> None:
    for leaf in _BN_LEAVES:
        out[f"{prefix}.{leaf}"] = _tensor(sd[f"{key}.{leaf}"])


def convert_state_dict(sd: Dict, depth: int) -> Dict[str, torch.Tensor]:
    """MedicalNet ``state_dict`` -> ``MedicalNetResNet3D`` ``state_dict``
    (backbone only; the head is trained fresh)."""
    sd = {re.sub(r"^module\.", "", k): v for k, v in sd.items()}
    block_kind, layout = BLOCK_CONFIGS[depth]
    n_convs = 2 if block_kind == "basic" else 3

    out: Dict[str, torch.Tensor] = {}
    _conv(out, "conv1", sd, "conv1")
    _bn(out, "bn1", sd, "bn1")
    for li in range(1, 5):
        for bi in range(layout[li - 1]):
            src = f"layer{li}.{bi}"
            dst = f"layer{li}_block{bi}"
            for ci in range(1, n_convs + 1):
                _conv(out, f"{dst}.conv{ci}", sd, f"{src}.conv{ci}")
                _bn(out, f"{dst}.bn{ci}", sd, f"{src}.bn{ci}")
            if f"{src}.downsample.0.weight" in sd:
                _conv(out, f"{dst}.downsample_conv", sd,
                      f"{src}.downsample.0")
                _bn(out, f"{dst}.downsample_bn", sd, f"{src}.downsample.1")
    return out


def main(argv=None, device="cuda"):
    """Convert, merge strictly into a ``MedicalNetResNet3D`` built on
    ``device`` (the card unless the caller asks for the CPU), and save."""
    parser = argparse.ArgumentParser()
    parser.add_argument("pth")
    parser.add_argument("out_dir")
    parser.add_argument("--depth", type=int, required=True,
                        choices=sorted(BLOCK_CONFIGS))
    args = parser.parse_args(argv)

    from multimodal_alzheimer_tpu_torch.models.resnet3d import (
        MedicalNetResNet3D,
    )
    from multimodal_alzheimer_tpu_torch.tools.convert_reference import (
        merge_state_dicts,
    )
    from multimodal_alzheimer_tpu_torch.train.checkpoint import (
        save_checkpoint,
    )
    from multimodal_alzheimer_tpu_torch.utils.device import resolve_device

    # weights_only=False: a Lightning save carries a hyper_parameters dict
    sd = torch.load(args.pth, map_location="cpu", weights_only=False)
    if "state_dict" in sd:
        sd = sd["state_dict"]
    sd = {k: v for k, v in sd.items() if isinstance(v, torch.Tensor)}
    backbone = MedicalNetResNet3D(args.depth,
                                  device=resolve_device(device))
    backbone.load_state_dict(merge_state_dicts(
        backbone.state_dict(), convert_state_dict(sd, args.depth)))
    save_checkpoint(args.out_dir, backbone.state_dict(),
                    {"resnet_depth": args.depth,
                     "source": "MedicalNet 23dataset"})
    print(f"wrote {args.out_dir}")


if __name__ == "__main__":
    main()
