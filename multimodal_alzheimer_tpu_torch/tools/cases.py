"""The full-width cases that ``chip_smoke.py`` drives and
``tools/profile_paths.py`` and ``tools/profile_serve.py`` profile, defined
once: the raw-scan batch, the stage-3 model and the fusion baselines with
their preprocessing, and the serving model with its four serve cores
(float32, bfloat16, BN-folded bfloat16, int8), all on the 91x109x91 grid
with random weights from seed ``SEED``."""

from __future__ import annotations

import numpy as np
import torch

from multimodal_alzheimer_tpu_torch.data.preprocess import (
    make_device_preprocess,
)
from multimodal_alzheimer_tpu_torch.data.synthetic import make_labeled_volumes
from multimodal_alzheimer_tpu_torch.inference import quantize
from multimodal_alzheimer_tpu_torch.inference.predictor import model_serve_fn
from multimodal_alzheimer_tpu_torch.models.fusion_models import (
    train_anat_pet_featuremapfusion,
    train_early_fusion,
)
from multimodal_alzheimer_tpu_torch.models.fusion_models.all_modalities_fusion import (
    AllModalitiesFusion,
)
from multimodal_alzheimer_tpu_torch.models.fusion_models.anat_pet_fusion import (
    AnatPETFusion,
)
from multimodal_alzheimer_tpu_torch.models.fusion_models.early_fusion import (
    PETMRIEarlyFusion,
)
from multimodal_alzheimer_tpu_torch.models.fusion_models.featuremap_fusion import (
    PETMRIFeatureMapFusion,
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
from multimodal_alzheimer_tpu_torch.train.checkpoint import (
    sync_tower_duplicates,
)
from multimodal_alzheimer_tpu_torch.utils.seeding import make_generator

GRID = (91, 109, 91)
SEED = 0
QUANTILE = 0.99
MINMAX = {"per_scan_norm": "min_max"}
# The PET z-score constants of the PET entry points and the baselines.
PET_NORM = {"mean": 0.5145, "std": 0.5383}
# The full-width fusion steps (MRI+tabular and stage 3): 2 classes, the
# fusion optimizer's rates (lr_pretrained None freezes the towers) and the
# TabularMLP (256, 1024) tower.
FUSION_HPARAMS = {"n_classes": 2, "lr": 1e-3, "l2_reg": 1e-2,
                  "loss_class_weights": [0.5, 0.5]}
TAB_HPARAMS = {"n_classes": 2, "hidden": (256, 1024), "dropout_p": 0.0}
# Stage 3's regimes: lr_pretrained None freezes every sub-model (shared
# towers); a rate trains every tower.
STAGE3_REGIMES = {"frozen": None, "trained": 1e-5}
# The serving cores of the flagship AnatCNN (ResNet-18 dilated, 3 classes,
# raw scans min-max normalised by K1 and K2): the float32 model, the same
# weights in bfloat16 compute, the BN-folded bfloat16 graph and the int8
# graph (K9), calibrated on CALIBRATION batches of raw scans.
SERVE_CORES = ("float", "bf16", "folded", "int8")
CALIBRATION = {"batches": 2, "batch": 8, "seed": SEED + 30}
SAMENORM = {"all_scan_norm": train_early_fusion.MRI_ALL_SCAN_STATS[2]}
# name -> (model class, hparams, MRI normalisation, K1/K2 per step)
BASELINES = {
    "early differentnorm": (PETMRIEarlyFusion,
                            train_early_fusion.BEST_HPARAMS, MINMAX, 1),
    "early samenorm": (PETMRIEarlyFusion, train_early_fusion.BEST_HPARAMS,
                       SAMENORM, 0),
    "featuremap maxout": (PETMRIFeatureMapFusion,
                          train_anat_pet_featuremapfusion.BEST_MAXOUT_HPARAMS,
                          SAMENORM, 0),
    "featuremap concatenate": (
        PETMRIFeatureMapFusion,
        dict(train_anat_pet_featuremapfusion.BEST_MAXOUT_HPARAMS,
             fusion_mode="concatenate"), SAMENORM, 0),
}


def raw_batch(modalities, grid, seed: int, device, n: int = 8) -> tuple:
    """(a batch of n raw samples of both classes on the device, feature
    statistics of its tabular rows or None)"""
    data = make_labeled_volumes(n, tuple(grid), n_classes=2, seed=seed,
                                modalities=modalities)
    data["label"] = (np.arange(n) % 2).astype(np.int32)
    stats = (compute_feature_stats(data["tabular"])
             if "tabular" in data else None)
    return {k: torch.from_numpy(v).to(device) for k, v in data.items()}, stats


def stage3_batch(device, grid=GRID) -> tuple:
    """(the stage-3 cases' batch of 8 raw PET, MRI and tabular samples,
    its tabular feature statistics)"""
    return raw_batch(("mri", "pet1451", "tabular"), grid, SEED + 17, device)


def stage3_preprocess():
    """PET z-scored, MRI min-max normalised in the step (K1 and K2)."""
    return make_device_preprocess(PET_NORM, MINMAX, QUANTILE)


def stage3_model(dtype, lr_pretrained, tab_hparams: dict,
                 share_towers=None, device=None) -> AllModalitiesFusion:
    """The full-width AllModalitiesFusion from seed ``SEED``: ResNet-18 MRI
    towers (dilated, ``fused_bn="full"``), ``SmallPETCNN`` at its defaults
    and ``TabularMLP`` towers of ``tab_hparams``, 2 classes. ``lr_pretrained``
    None freezes every stage-2 model and stage 3, so the towers are shared
    (unless ``share_towers`` says otherwise); else every tower trains. Each
    duplicate tower is synced to its canonical copy, as the frozen grafting
    regime loads one stage-1 checkpoint into both."""
    gen = make_generator(SEED)
    frozen = lr_pretrained is None

    def mri():
        return AnatCNN.from_hparams(
            {"n_classes": 2, "resnet_depth": 18, "linear_out": ()},
            fused_bn="full", freeze_backbone=False, dtype=dtype,
            generator=gen)

    def pet():
        return SmallPETCNN(2, dtype=dtype, generator=gen)

    def tab():
        return TabularMLP.from_hparams(tab_hparams, dtype=dtype,
                                       generator=gen)

    kw = dict(freeze_towers=frozen, dtype=dtype, generator=gen)
    model = AllModalitiesFusion(
        2, AnatPETFusion(2, pet(), mri(), **kw),
        TabularMRIFusion(2, mri(), tab(), **kw),
        PETTabularFusion(2, pet(), tab(), simple_dim_red=True, **kw),
        freeze_towers=frozen,
        share_towers=frozen if share_towers is None else share_towers,
        dtype=dtype, generator=gen)
    model.load_state_dict(sync_tower_duplicates(model.state_dict()))
    return model.to(device)


def baseline_batch(device, grid=GRID) -> dict:
    """The baseline cases' raw PET and MRI samples, as many as the largest
    ``batch_size`` of ``BASELINES``; a case takes its first
    ``batch_size``."""
    n = max(hp["batch_size"] for _, hp, _, _ in BASELINES.values())
    return raw_batch(("mri", "pet1451"), grid, SEED + 18, device, n=n)[0]


def baseline_case(name: str, dtype, device) -> tuple:
    """(model, hparams, preprocess) of the ``BASELINES`` case ``name``:
    the model from seed ``SEED``, the hparams with balanced class weights,
    PET z-scored with the hparams' constants and MRI normalised as the case
    says, in the step."""
    model_cls, hp, mri_norm, _ = BASELINES[name]
    hp = dict(hp, loss_class_weights=[0.5, 0.5])
    model = model_cls.from_hparams(
        hp, dtype=dtype, generator=make_generator(SEED)).to(device)
    preprocess = make_device_preprocess(
        {"mean": hp["norm_mean"], "std": hp["norm_std"]}, mri_norm,
        hp.get("norm_percentile", QUANTILE))
    return model, hp, preprocess


def serve_requests(n: int, seed: int, grid=GRID) -> list:
    """Raw serving requests: ``mri`` (N(900, 400)) and ``mri_mask``, no
    memoised bounds."""
    rng = np.random.default_rng(seed)
    shape = (n,) + tuple(grid)
    mri = rng.standard_normal(shape, dtype=np.float32) * 400 + 900
    mask = (rng.random(shape, dtype=np.float32) > 0.35).astype(np.float32)
    return [{"mri": mri[i], "mri_mask": mask[i]} for i in range(n)]


def serve_model(dtype=torch.float32, device=None) -> AnatCNN:
    """The flagship serving AnatCNN in eval mode from seed ``SEED``, its
    classifier bias 1.0 (keeps the trailing ReLU off its floor)."""
    model = AnatCNN(n_classes=3, resnet_depth=18, dilated=True, dtype=dtype,
                    generator=make_generator(SEED))
    with torch.no_grad():
        model.head.cls.bias.fill_(1.0)
    return model.to(device).eval()


def serve_preprocess():
    """Per-scan min-max of the raw MRI in the serve (K1 and K2)."""
    return make_device_preprocess(normalize_mri=MINMAX, quantile=QUANTILE)


def calibration_batches(device, grid=GRID) -> list:
    """``CALIBRATION`` raw batches on the device."""
    reqs = serve_requests(CALIBRATION["batches"] * CALIBRATION["batch"],
                          CALIBRATION["seed"], grid)
    b = CALIBRATION["batch"]
    return [{k: torch.from_numpy(np.stack([r[k] for r in reqs[i:i + b]]))
             .to(device) for k in reqs[0]}
            for i in range(0, len(reqs), b)]


def serve_core(name: str, model: AnatCNN, preprocess, device, grid=GRID):
    """The ``SERVE_CORES`` core ``name`` over the float32 ``model``:
    ``batch -> {'logits', 'probs', 'embeddings'}`` on raw batches."""
    if name == "float":
        return model_serve_fn(model, preprocess)
    if name == "bf16":
        twin = serve_model(torch.bfloat16)
        twin.load_state_dict(model.state_dict())
        return model_serve_fn(twin.to(device).eval(), preprocess)
    if name == "folded":
        return quantize.fold_anat_cnn(model, preprocess)[0]
    if name == "int8":
        return quantize.quantize_anat_cnn(
            model, calibration_batches(device, grid), preprocess)[0]
    raise ValueError(f"serve core {name!r} is not one of {SERVE_CORES}")
