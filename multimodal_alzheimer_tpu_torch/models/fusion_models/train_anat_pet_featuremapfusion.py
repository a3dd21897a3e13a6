"""Train PET+MRI feature-map fusion (reference
train_anat_pet_featuremapfusion.py: fusion-tower search space :64-117;
``__main__`` runs the best maxout config :280-309).

Port of ``multimodal_alzheimer_tpu/models/fusion_models/
train_anat_pet_featuremapfusion.py``. Both normalisations are fixed
constants: the PET z-score and the MRI all-scan z-score of
``train_early_fusion.MRI_ALL_SCAN_STATS``.

``sample_hparams`` takes any object with optuna's ``suggest_float`` and
``suggest_categorical``; optuna is imported only by ``hpo.create_study``.
``optuna_optimization`` is the HPO entry point, sequential or
``parallel=K`` full-model trials per bucket through the K-trial trainer.

    python -m multimodal_alzheimer_tpu_torch.models.fusion_models.train_anat_pet_featuremapfusion
"""

from __future__ import annotations

import functools

from multimodal_alzheimer_tpu_torch.models.fusion_models.featuremap_fusion import (
    PETMRIFeatureMapFusion,
)
from multimodal_alzheimer_tpu_torch.models.fusion_models.train_early_fusion import (
    MRI_ALL_SCAN_STATS,
)
from multimodal_alzheimer_tpu_torch.train import hpo
from multimodal_alzheimer_tpu_torch.train.driver import (
    attach_class_weights,
    build_datasets,
    run_training,
)
from multimodal_alzheimer_tpu_torch.utils.seeding import make_generator

LOG_DIRECTORY = "lightning_logs"
EXPERIMENT_NAME = "featuremap_fusion"
EXPERIMENT_VERSION = None
SEED = 5

BEST_MAXOUT_HPARAMS = {
    "early_stopping_patience": 30,
    "max_epochs": 300,
    "norm_mean": 0.5145,
    "norm_std": 0.5383,
    "lr": 5e-4,
    "batch_size": 32,
    "conv_out": (8, 16, 32),
    "filter_size": (5, 5, 3),
    "batchnorm": True,
    "n_classes": 2,
    "fusion_mode": "maxout",
    "n_layers_fusion": 1,
    "n_out_fusion": 64,
    "filter_size_fusion": 3,
    "batchnorm_fusion": True,
    "fl_gamma": None,
    "reduce_factor_lr_schedule": 0.5,
    "best_k_checkpoints": 3,
}


def sample_hparams(trial, n_classes: int = 2) -> dict:
    hparams = {
        "early_stopping_patience": 5,
        "max_epochs": 20,
        "norm_mean": 0.5145,
        "norm_std": 0.5383,
        "n_classes": n_classes,
        "reduce_factor_lr_schedule": None,
        "best_k_checkpoints": 3,
        "n_layers_fusion": 1,
    }
    conv_out_options = {str(o): o for o in
                        [(8, 16, 32), (16, 32, 64), (8, 16, 32, 64)]}
    fs_options = {str(o): o for o in [(5, 5, 3, 3), (3, 3, 3, 3)]}
    hparams["lr"] = trial.suggest_float("lr", 5e-6, 1e-3, log=True)
    conv_idx = trial.suggest_categorical("conv_out",
                                         list(conv_out_options))
    hparams["conv_out"] = conv_out_options[conv_idx]
    fs_idx = trial.suggest_categorical("filter_size", list(fs_options))
    hparams["filter_size"] = fs_options[fs_idx][:len(hparams["conv_out"])]
    hparams["fusion_mode"] = trial.suggest_categorical(
        "fusion_mode", ("concatenate", "maxout"))
    hparams["n_out_fusion"] = trial.suggest_categorical("n_out_fusion",
                                                        (32, 64, 128))
    hparams["filter_size_fusion"] = trial.suggest_categorical(
        "filter_size_fusion", (3, 5))
    hparams["batchnorm"] = trial.suggest_categorical("batchnorm",
                                                     (True, False))
    hparams["batchnorm_fusion"] = trial.suggest_categorical(
        "batchnorm_fusion", (True, False))
    hparams["batch_size"] = trial.suggest_categorical("batch_size",
                                                      (8, 16, 32, 64))
    hparams["fl_gamma"] = trial.suggest_categorical("fl_gamma",
                                                    (None, 1, 2, 5))
    return hparams


def train(hparams: dict, experiment_name: str = EXPERIMENT_NAME,
          experiment_version=None, log_confusion_images: bool = True,
          device="cuda", **run_kwargs):
    """Train ``PETMRIFeatureMapFusion`` on the split's paired PET and T1w
    volumes; return the last validation loss. The weights start from seed
    ``SEED``. ``run_kwargs`` go to ``run_training`` (``num_workers``,
    ...)."""
    normalize_pet = {"mean": hparams["norm_mean"],
                     "std": hparams["norm_std"]}
    normalize_mri = {
        "all_scan_norm": MRI_ALL_SCAN_STATS[hparams["n_classes"]]}
    trainset, valset = build_datasets(
        hparams, ["pet1451", "t1w"], normalize_pet=normalize_pet,
        normalize_mri=normalize_mri)
    attach_class_weights(hparams, trainset)
    model = PETMRIFeatureMapFusion.from_hparams(
        hparams, generator=make_generator(SEED))
    _, _, last_val_loss = run_training(
        model, hparams, trainset, valset,
        experiment_name=experiment_name,
        experiment_version=experiment_version,
        log_dir=LOG_DIRECTORY, seed=SEED,
        log_confusion_images=log_confusion_images, device=device,
        **run_kwargs)
    return last_val_loss


@hpo.oom_guard
def _objective(trial, device="cuda", log_confusion_images: bool = True):
    return train(sample_hparams(trial), EXPERIMENT_NAME, EXPERIMENT_VERSION,
                 log_confusion_images=log_confusion_images, device=device)


def optuna_optimization(n_trials: int = 300, timeout: float = 86400,
                        parallel: int = 0, device="cuda",
                        log_confusion_images: bool = True):
    """HPO entry point. ``parallel=K`` trains full-model trials K at a time
    (``train/vmap_hpo.py``): every fusion-tower knob of this space is an
    architecture choice, so the bucket signature carries them all and only lr
    and fl_gamma vary per trial; both normalizations are fixed constants,
    applied once over the split.
    """
    study = hpo.create_study(direction="minimize")
    if parallel and parallel > 1:
        from multimodal_alzheimer_tpu_torch.train import vmap_hpo
        from multimodal_alzheimer_tpu_torch.train.fusion_hpo import (
            preprocessed_arrays,
        )

        base = {"n_classes": 2}
        trainset, valset = build_datasets(
            base, ["pet1451", "t1w"],
            normalize_pet={"mean": 0.5145, "std": 0.5383},
            normalize_mri={"all_scan_norm": MRI_ALL_SCAN_STATS[2]})
        attach_class_weights(base, trainset)
        train_data = preprocessed_arrays(trainset, device)
        val_data = preprocessed_arrays(valset, device)

        def signature(hparams):
            return (tuple(hparams["conv_out"]),
                    tuple(hparams["filter_size"]),
                    hparams["fusion_mode"],
                    int(hparams["n_out_fusion"]),
                    int(hparams["filter_size_fusion"]),
                    bool(hparams["batchnorm"]),
                    bool(hparams["batchnorm_fusion"]),
                    int(hparams["batch_size"]),
                    int(hparams["max_epochs"]),
                    int(hparams["early_stopping_patience"]))

        def batch_objective(sig, rows):
            model = PETMRIFeatureMapFusion.from_hparams(
                dict(base, **rows[0]))
            hp = vmap_hpo.stack_trial_hparams(rows)
            values, _ = vmap_hpo.run_parallel_trials(
                model, hp, train_data, val_data,
                batch_size=int(rows[0]["batch_size"]),
                max_epochs=int(rows[0]["max_epochs"]),
                patience=int(rows[0]["early_stopping_patience"]),
                class_weights=base["loss_class_weights"], seed=SEED,
                apply_fn=vmap_hpo.plain_apply, device=device)
            return [float(v) for v in values[:len(rows)]]

        vmap_hpo.optimize_batched(study, sample_hparams, batch_objective,
                                  n_trials=n_trials, parallel=parallel,
                                  signature_fn=signature, timeout=timeout)
        return study
    study.optimize(functools.partial(
        _objective, device=device,
        log_confusion_images=log_confusion_images),
        n_trials=n_trials, timeout=timeout)
    return study


if __name__ == "__main__":
    train(dict(BEST_MAXOUT_HPARAMS))
