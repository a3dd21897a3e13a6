"""Train the stage-3 all-modalities fusion (reference
train_all_modalities_fusion.py: five checkpoint paths per class count
:129-152, the full three-modality dataset :158-173).

Port of ``multimodal_alzheimer_tpu/models/fusion_models/
train_all_modalities_fusion.py``. Required hparams: the stage-2 paths
'path_anat_pet', 'path_anat_tab', 'path_pet_tab' and the stage-1 paths
'path_pet', 'path_mri', 'path_tabular', checkpoint directories of the
port. The stage-2 checkpoints carry the trained fusion heads; the stage-1
checkpoints are grafted beneath each stage-2 submodule after them (the
reference rebuilds the same nesting through load_from_checkpoint chains,
all_modalities_fusion.py:17-26). The datasets take the stage-1
checkpoints' normalisations (MRI bounds memoised per sample, so the step
runs K2 alone). With every stage-2 sub-model frozen the model shares its
towers, and the ``Trainer`` syncs the duplicates in every checkpoint.

``sample_hparams`` takes any object with optuna's ``suggest_float`` and
``suggest_categorical``; optuna is imported only by ``hpo.create_study``.
``optuna_optimization`` is the HPO entry point: sequential, or with
``parallel=K`` frozen proposals trained K heads at a time over one shared
tower forward per step (``train/fusion_hpo.py``) and unfrozen ones
sequentially.
"""

from __future__ import annotations

import functools

from multimodal_alzheimer_tpu_torch.models.fusion_models.all_modalities_fusion import (
    AllModalitiesFusion,
)
from multimodal_alzheimer_tpu_torch.train import hpo
from multimodal_alzheimer_tpu_torch.train.checkpoint import (
    graft_params,
    load_checkpoint,
)
from multimodal_alzheimer_tpu_torch.train.driver import (
    attach_class_weights,
    build_datasets,
    fusion_optimizer,
    run_training,
    stage1_normalizations,
)
from multimodal_alzheimer_tpu_torch.utils.seeding import make_generator

LOG_DIRECTORY = "lightning_logs"
EXPERIMENT_NAME = "all_modalities_fusion"
EXPERIMENT_VERSION = None
SEED = 5

HEAD_NAMES = ("stage3out", "cls3")


def sample_hparams(trial, n_classes: int = 3, **paths) -> dict:
    hparams = {
        "early_stopping_patience": 5,
        "max_epochs": 20,
        "n_classes": n_classes,
        "reduce_factor_lr_schedule": None,
        "best_k_checkpoints": 3,
        "ensemble_size": 4,
    }
    hparams.update(paths)
    hparams["lr"] = trial.suggest_float("lr", 1e-5, 1e-2, log=True)
    freeze = trial.suggest_categorical("freeze", (True, False))
    hparams["lr_pretrained"] = (None if freeze else trial.suggest_float(
        "lr_pretrained", 1e-7, 1e-5, log=True))
    hparams["batch_size"] = trial.suggest_categorical("batch_size",
                                                      (8, 16, 32, 64))
    hparams["l2_reg"] = trial.suggest_categorical(
        "l2_reg", (0, 1e-1, 1e-2, 1e-3))
    hparams["fl_gamma"] = trial.suggest_categorical("fl_gamma",
                                                    (None, 1, 2, 5))
    return hparams


def train(hparams: dict, experiment_name: str = "",
          experiment_version=None, log_confusion_images: bool = True,
          device="cuda", **run_kwargs):
    """Train ``AllModalitiesFusion`` from the stage-2 and stage-1
    checkpoints; return the last validation loss. The head starts from seed
    ``SEED``. ``run_kwargs`` go to ``run_training`` (``num_workers``,
    ...)."""
    stage1, stage1_hp, stage2, stage2_hp = {}, {}, {}, {}
    for name, key in (("pet", "path_pet"), ("mri", "path_mri"),
                      ("tab", "path_tabular")):
        stage1[name], stage1_hp[name], _ = load_checkpoint(hparams[key])
    for name in ("anat_pet", "anat_tab", "pet_tab"):
        stage2[name], stage2_hp[name], _ = load_checkpoint(
            hparams[f"path_{name}"])

    normalize_pet, normalize_mri, quantile = stage1_normalizations(
        stage1_hp["pet"], stage1_hp["mri"])
    trainset, valset = build_datasets(
        hparams, ["pet1451", "t1w", "tabular"],
        normalize_pet=normalize_pet, normalize_mri=normalize_mri,
        quantile=quantile)
    attach_class_weights(hparams, trainset)

    model = AllModalitiesFusion.from_hparams(
        hparams, stage2_hp["anat_pet"], stage2_hp["anat_tab"],
        stage2_hp["pet_tab"], stage1_hp["pet"], stage1_hp["mri"],
        stage1_hp["tab"], generator=make_generator(SEED))
    optimizer = fusion_optimizer(hparams, HEAD_NAMES, model)

    def graft(state_dict):
        # stage-2 heads first, then stage-1 weights beneath them (the
        # stage-2 checkpoints already contain trained stage-1 towers, but
        # re-grafting stage 1 reproduces the reference's loading order)
        state_dict = graft_params(state_dict, {
            f"model_{name}": stage2[name]
            for name in ("anat_pet", "anat_tab", "pet_tab")})
        return graft_params(state_dict, {
            "model_anat_pet/pet_model": stage1["pet"],
            "model_anat_pet/mri_model": stage1["mri"],
            "model_anat_tab/mri_model": stage1["mri"],
            "model_anat_tab/tab_model": stage1["tab"],
            "model_pet_tab/pet_model": stage1["pet"],
            "model_pet_tab/tab_model": stage1["tab"],
        })

    _, _, last_val_loss = run_training(
        model, hparams, trainset, valset,
        experiment_name=experiment_name,
        experiment_version=experiment_version,
        optimizer=optimizer, log_dir=LOG_DIRECTORY, seed=SEED,
        variables_transform=graft,
        log_confusion_images=log_confusion_images, device=device,
        **run_kwargs)
    return last_val_loss


def _objective(trial, device="cuda", log_confusion_images: bool = True):
    from multimodal_alzheimer_tpu_torch.utils.path_config import (
        load_path_config,
    )

    paths = load_path_config()
    hparams = sample_hparams(trial, 
        path_pet=str(paths["pet_cnn_3_class"]),
        path_mri=str(paths["mri_cnn_3_class"]),
        path_tabular=str(paths["tabular_mlp_3_class"]),
        path_anat_pet=str(paths["pet_mri_3_class"]),
        path_anat_tab=str(paths["mri_tab_3_class"]),
        path_pet_tab=str(paths["pet_tab_3_class"]))
    return _sequential(hparams, device, log_confusion_images)


def _sequential(hparams: dict, device, log_confusion_images: bool):
    return hpo.oom_guard(train)(hparams, EXPERIMENT_NAME,
                                EXPERIMENT_VERSION,
                                log_confusion_images=log_confusion_images,
                                device=device)


def optuna_optimization(n_trials: int = 300, timeout: float = 86400,
                        parallel: int = 0, device="cuda",
                        log_confusion_images: bool = True):
    """HPO entry point over the checkpoints ``path_config.yaml`` names.
    ``parallel=K`` trains frozen proposals K stage-3 heads at a time over one
    pass through the three frozen stage-2 models per step
    (``fusion_hpo.optimize_stage3_all_modalities``, stage-1 towers shared);
    unfrozen proposals keep the sequential path inside the same study.
    """
    study = hpo.create_study(direction="minimize")
    if parallel and parallel > 1:
        from multimodal_alzheimer_tpu_torch.train import fusion_hpo
        from multimodal_alzheimer_tpu_torch.utils.path_config import (
            load_path_config,
        )

        paths = load_path_config()
        return fusion_hpo.optimize_stage3_all_modalities(
            study, sample_hparams,
            functools.partial(_sequential, device=device,
                              log_confusion_images=log_confusion_images),
            n_trials=n_trials, parallel=parallel,
            path_pet=str(paths["pet_cnn_3_class"]),
            path_mri=str(paths["mri_cnn_3_class"]),
            path_tabular=str(paths["tabular_mlp_3_class"]),
            path_anat_pet=str(paths["pet_mri_3_class"]),
            path_anat_tab=str(paths["mri_tab_3_class"]),
            path_pet_tab=str(paths["pet_tab_3_class"]), timeout=timeout,
            device=device)
    study.optimize(functools.partial(
        _objective, device=device,
        log_confusion_images=log_confusion_images),
        n_trials=n_trials, timeout=timeout)
    return study


if __name__ == "__main__":
    optuna_optimization()
