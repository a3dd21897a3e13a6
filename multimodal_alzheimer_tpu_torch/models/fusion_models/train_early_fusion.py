"""Train PET+MRI early fusion (reference train_early_fusion.py).

Port of ``multimodal_alzheimer_tpu/models/fusion_models/
train_early_fusion.py``. The MRI volumes take the all-scan z-score by
default (``mri_norm_style`` 'all_scan_norm'), so PET and MRI share a
normalisation style (reference :139-144: 2-class 426.9336/1018.7830,
3-class 414.8254/920.8566, the constants ``ops/normalization.
compute_split_stats`` estimates); any other style takes the per-scan
min-max at ``norm_percentile`` (bounds memoised per sample, so the step
runs K2 alone). The ``__main__`` runs the reference's fixed best-hparams
single run rather than HPO (:225-256).

    python -m multimodal_alzheimer_tpu_torch.models.fusion_models.train_early_fusion
"""

from __future__ import annotations

from multimodal_alzheimer_tpu_torch.models.fusion_models.early_fusion import (
    PETMRIEarlyFusion,
)
from multimodal_alzheimer_tpu_torch.train.driver import (
    attach_class_weights,
    build_datasets,
    run_training,
)
from multimodal_alzheimer_tpu_torch.utils.seeding import make_generator

LOG_DIRECTORY = "lightning_logs"
EXPERIMENT_NAME = "early_fusion"
EXPERIMENT_VERSION = None
SEED = 5

MRI_ALL_SCAN_STATS = {2: {"mean": 426.9336, "std": 1018.7830},
                      3: {"mean": 414.8254, "std": 920.8566}}

BEST_HPARAMS = {
    # fixed best single-run config in the reference __main__ (:225-256)
    "early_stopping_patience": 30,
    "max_epochs": 300,
    "norm_mean": 0.5145,
    "norm_std": 0.5383,
    "lr": 5e-4,
    "batch_size": 64,
    "conv_out": (8, 16, 32, 64),
    "filter_size": (5, 5, 3, 3),
    "batchnorm": False,
    "n_classes": 2,
    "linear_out": 64,
    "fl_gamma": None,
    "reduce_factor_lr_schedule": 0.5,
    "best_k_checkpoints": 5,
    "mri_norm_style": "all_scan_norm",
}


def train(hparams: dict, experiment_name: str = EXPERIMENT_NAME,
          experiment_version=None, log_confusion_images: bool = True,
          device="cuda", **run_kwargs):
    """Train ``PETMRIEarlyFusion`` on the split's paired PET and T1w
    volumes; return the last validation loss. The weights start from seed
    ``SEED``. ``run_kwargs`` go to ``run_training`` (``num_workers``,
    ...)."""
    normalize_pet = {"mean": hparams["norm_mean"],
                     "std": hparams["norm_std"]}
    if hparams.get("mri_norm_style", "all_scan_norm") == "all_scan_norm":
        normalize_mri = {
            "all_scan_norm": MRI_ALL_SCAN_STATS[hparams["n_classes"]]}
    else:
        normalize_mri = {"per_scan_norm": "min_max"}
    trainset, valset = build_datasets(
        hparams, ["pet1451", "t1w"], normalize_pet=normalize_pet,
        normalize_mri=normalize_mri,
        quantile=hparams.get("norm_percentile", 0.99))
    attach_class_weights(hparams, trainset)
    model = PETMRIEarlyFusion.from_hparams(hparams,
                                           generator=make_generator(SEED))
    _, _, last_val_loss = run_training(
        model, hparams, trainset, valset,
        experiment_name=experiment_name,
        experiment_version=experiment_version,
        log_dir=LOG_DIRECTORY, seed=SEED,
        log_confusion_images=log_confusion_images, device=device,
        **run_kwargs)
    return last_val_loss


if __name__ == "__main__":
    train(dict(BEST_HPARAMS))
