"""The system under test, built through the port's public entry points.

This is the only module of the benchmark that imports
``multimodal_alzheimer_tpu_torch``. It builds each configuration's model,
optimizer, loss, preprocess, train step and loader, or its int8 serve
behind ``Predictor`` and ``BatchingServer``, from the configuration's file
and the weights the benchmark drew; it takes nothing else from the program.
"""

from __future__ import annotations

import time

import torch

from multimodal_alzheimer_tpu_torch.data.pipeline import DataLoader
from multimodal_alzheimer_tpu_torch.data.preprocess import (
    make_device_preprocess,
)
from multimodal_alzheimer_tpu_torch.inference import quantize
from multimodal_alzheimer_tpu_torch.inference.predictor import Predictor
from multimodal_alzheimer_tpu_torch.inference.server import BatchingServer
from multimodal_alzheimer_tpu_torch.losses.classification import (
    make_criterion,
)
from multimodal_alzheimer_tpu_torch.models.fusion_models.all_modalities_fusion import (
    AllModalitiesFusion,
)
from multimodal_alzheimer_tpu_torch.models.fusion_models.anat_pet_fusion import (
    AnatPETFusion,
)
from multimodal_alzheimer_tpu_torch.models.fusion_models.pet_tabular_fusion import (
    PETTabularFusion,
)
from multimodal_alzheimer_tpu_torch.models.fusion_models.tabular_mri_fusion import (
    TabularMRIFusion,
)
from multimodal_alzheimer_tpu_torch.models.mri_models.anat_cnn import AnatCNN
from multimodal_alzheimer_tpu_torch.models.pet_models.pet_cnn import (
    SmallPETCNN,
)
from multimodal_alzheimer_tpu_torch.models.tabular_models.tabular_mlp import (
    TabularMLP,
    compute_feature_stats,
)
from multimodal_alzheimer_tpu_torch.ops import _native
from multimodal_alzheimer_tpu_torch.train.driver import fusion_optimizer
from multimodal_alzheimer_tpu_torch.train.optim import single_lr_optimizer
from multimodal_alzheimer_tpu_torch.train.state import (
    TrainState,
    make_train_step,
)

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def load_library(device) -> float:
    """Load the program's kernel library on a card (its first load in a
    checkout builds it); the seconds it took, 0 on the CPU."""
    if device.type != "cuda":
        return 0.0
    t = time.perf_counter()
    _native.library()
    return time.perf_counter() - t


def _mri_norm(spec: dict) -> dict:
    return {"per_scan_norm": {"zscore": "normalize",
                              "min_max": "min_max"}[spec["mode"]]}


def preprocess_for(config: dict, stage: str):
    """The program's device preprocess of ``config`` for ``stage`` ('train'
    or 'serve')."""
    spec = config["preprocess"][stage]
    pet = spec.get("pet")
    return make_device_preprocess(
        {"mean": pet["mean"], "std": pet["std"]} if pet else None,
        _mri_norm(spec["mri"]), spec["mri"].get("quantile", 0.99))


def _anat(config: dict, dtype, device, gen) -> AnatCNN:
    return AnatCNN(n_classes=config["n_classes"],
                   resnet_depth=config["resnet_depth"],
                   dilated=config["dilated"],
                   linear_out=tuple(config["linear_out"]),
                   batchnorm_begin=config["batchnorm_begin"],
                   trailing_relu=config["trailing_relu"],
                   fused_bn=config["fused_bn"],
                   maxpool_impl=config["maxpool_impl"], dtype=dtype,
                   device=device, generator=gen)


def build_model(config: dict, regime: dict, device, dtype, pool: dict):
    """The configuration's model on ``device``, constructed with the
    program's own initialisation (replaced by the benchmark's weights)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    if config["model"] == "anat_cnn":
        return _anat(config, dtype, device, gen)
    n = config["n_classes"]
    frozen = regime.get("lr_pretrained") is None
    mean, std = compute_feature_stats(pool["tabular"])
    tab = config["tabular"]
    tab_hp = {"n_classes": n, "hidden": tuple(tab["hidden"]),
              "dropout_p": tab["dropout_p"], "feature_mean": mean,
              "feature_std": std}
    pet_cfg = config["pet"]

    def pet():
        return SmallPETCNN(n, conv_out=tuple(pet_cfg["conv_out"]),
                           filter_size=tuple(pet_cfg["filter_size"]),
                           batchnorm=pet_cfg["batchnorm"],
                           linear_out=pet_cfg["linear_out"], dtype=dtype,
                           device=device, generator=gen)

    def tab():
        return TabularMLP.from_hparams(tab_hp, dtype=dtype, device=device,
                                       generator=gen)

    kw = dict(freeze_towers=frozen, dtype=dtype, device=device,
              generator=gen)
    return AllModalitiesFusion(
        n, AnatPETFusion(n, pet(), _anat(config, dtype, device, gen), **kw),
        TabularMRIFusion(n, _anat(config, dtype, device, gen), tab(), **kw),
        PETTabularFusion(n, pet(), tab(),
                         simple_dim_red=config["pet_tower_simple_dim_red"],
                         **kw),
        freeze_towers=frozen,
        share_towers=frozen and config["frozen_towers_shared"], dtype=dtype,
        device=device, generator=gen)


def build_optimizer(config: dict, regime: dict, model):
    opt = config["optimizer"]
    if config["model"] == "anat_cnn":
        return single_lr_optimizer(model, opt["lr"], opt.get("l2_reg", 0.0))
    return fusion_optimizer({"lr": opt["lr"], "l2_reg": opt["l2_reg"],
                             "lr_pretrained": regime.get("lr_pretrained")},
                            tuple(opt["head"]), model)


def build_train(config: dict, regime: dict, device, dtype, pool: dict,
                weights_fn):
    """(model, optimizer, step, state): the program's train step over the
    model loaded with ``weights_fn(state_dict template)``."""
    model = build_model(config, regime, device, dtype, pool)
    model.load_state_dict(weights_fn(model.state_dict()), strict=True)
    optimizer = build_optimizer(config, regime, model)
    criterion = make_criterion(
        {"loss_class_weights": config["loss_class_weights"]})
    step = make_train_step(model, criterion, optimizer,
                           preprocess_for(config, "train"))
    return model, optimizer, step, TrainState(model, optimizer)


def loader(dataset, batch: int, threads: int, device) -> DataLoader:
    """The port's loader over ``dataset``, in order (the pool was shuffled
    when it was drawn)."""
    return DataLoader(dataset, batch, shuffle=False, drop_last=True,
                      num_workers=threads, device=device)


def build_int8_serve(config: dict, device, weights_fn, calib_batches,
                     batch: int, ladder, max_wait_s=None):
    """(predictor, server): the int8 core of the configuration's model
    (``quantize.quantize_anat_cnn``, calibrated on ``calib_batches`` of raw
    tensors on the device) behind ``Predictor`` and ``BatchingServer``."""
    model = build_model(config, {}, device, DTYPES[config["dtype"]], {})
    model.load_state_dict(weights_fn(model.state_dict()), strict=True)
    model.eval()
    serve_fn, _ = quantize.quantize_anat_cnn(
        model, calib_batches, preprocess_for(config, "serve"))
    predictor = Predictor(serve_fn=serve_fn, batch_size=batch,
                          ladder=tuple(ladder), device=device)
    kw = {} if max_wait_s is None else {"max_wait_s": max_wait_s}
    return predictor, BatchingServer(predictor, **kw)

