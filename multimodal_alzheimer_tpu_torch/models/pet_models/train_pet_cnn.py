"""Train the small PET 3D CNN (reference train_pet_cnn.py entry point).

Port of ``multimodal_alzheimer_tpu/models/pet_models/train_pet_cnn.py``: the
reference's fixed and sampled hyperparameters (reference:
pet_models/train_pet_cnn.py:32-118): PET z-score constants 0.5145/0.5383, lr
log-uniform [5e-6, 1e-3], the conv_out ladders, the four filter-size
patterns, batch >= 64 raising patience and epochs, fl_gamma in
{None, 1, 2, 5}, seed 5; and ``train``, one training run from the split
under ``MMALZ_DATA_DIR`` (or ``./data``).

``sample_hparams`` takes any object with optuna's ``suggest_float`` and
``suggest_categorical``; optuna is imported only by ``hpo.create_study``.
``optuna_optimization`` is the HPO entry point, sequential or
``parallel=K`` trials per bucket through the K-trial trainer.

    train(sample_hparams(trial), "pet", device="cpu")  # on a CPU
"""

from __future__ import annotations

import functools

from multimodal_alzheimer_tpu_torch.models.pet_models.pet_cnn import (
    SmallPETCNN,
)
from multimodal_alzheimer_tpu_torch.train import hpo
from multimodal_alzheimer_tpu_torch.train.driver import (
    attach_class_weights,
    build_datasets,
    run_training,
)
from multimodal_alzheimer_tpu_torch.utils.seeding import make_generator

LOG_DIRECTORY = "lightning_logs"
EXPERIMENT_NAME = "optuna_two_class"
EXPERIMENT_VERSION = None
SEED = 5


def sample_hparams(trial, n_classes: int = 3) -> dict:
    """Reference search space (train_pet_cnn.py:36-109)."""
    conv_out_options = []
    for x in (8, 16, 32):
        for n in (3, 4):
            conv_out_options.append(tuple(2 ** i * x for i in range(n)))
    conv_out_index = {str(o): o for o in conv_out_options}
    filter_size_options = [(5, 5, 3, 3), (7, 5, 3, 3), (5, 5, 5, 3),
                           (3, 3, 3, 3)]
    filter_size_index = {str(o): o for o in filter_size_options}

    hparams = {
        "early_stopping_patience": 5,
        "max_epochs": 20,
        "norm_mean": 0.5145,
        "norm_std": 0.5383,
        "reduce_factor_lr_schedule": None,
        "n_classes": n_classes,
        "best_k_checkpoints": 3,
    }
    hparams["lr"] = trial.suggest_float("learning_rate", 5e-6, 1e-3,
                                        log=True)
    conv_idx = trial.suggest_categorical("conv_out", list(conv_out_index))
    hparams["conv_out"] = conv_out_index[conv_idx]
    fs_idx = trial.suggest_categorical("filter_size",
                                       list(filter_size_index))
    filter_size = filter_size_index[fs_idx]
    hparams["filter_size"] = filter_size[:len(hparams["conv_out"])]
    hparams["batchnorm"] = trial.suggest_categorical("batchnorm",
                                                     (True, False))
    hparams["linear_out"] = trial.suggest_categorical(
        "linear_out", (False, 32, 64, 128))
    hparams["batch_size"] = trial.suggest_categorical(
        "batch_size", (8, 16, 32, 64))
    if hparams["batch_size"] >= 64:
        hparams["early_stopping_patience"] = 10
        hparams["max_epochs"] = 50
    if trial.suggest_categorical("dropout_conv", (True, False)):
        hparams["dropout_conv_p"] = trial.suggest_float(
            "dropout_conv_p", 0.05, 0.2)
    if trial.suggest_categorical("dropout_dense", (True, False)):
        hparams["dropout_dense_p"] = trial.suggest_float(
            "dropout_dense_p", 0.2, 0.5)
    hparams["fl_gamma"] = trial.suggest_categorical("fl_gamma",
                                                    (None, 1, 2, 5))
    return hparams


def pet_normalization(hparams: dict) -> dict:
    """The constant PET z-score of the hparams."""
    return {"mean": hparams["norm_mean"], "std": hparams["norm_std"]}


def train(hparams: dict, experiment_name: str = "",
          experiment_version=None, log_confusion_images: bool = True,
          device="cuda", **run_kwargs):
    """Train ``SmallPETCNN`` on the split's PET volumes with the constant
    z-score in the step; return the last validation loss. The weights start
    from seed ``SEED``. ``run_kwargs`` go to ``run_training``
    (``num_workers``, ``variables_transform``, ...)."""
    trainset, valset = build_datasets(
        hparams, ["pet1451"], normalize_pet=pet_normalization(hparams))
    attach_class_weights(hparams, trainset)
    model = SmallPETCNN.from_hparams(hparams,
                                     generator=make_generator(SEED))
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
    hparams = sample_hparams(trial)
    return train(hparams, EXPERIMENT_NAME, EXPERIMENT_VERSION,
                 log_confusion_images=log_confusion_images, device=device)


def _dropout_apply(model, batch, hp, train):
    if train:
        return model(batch, dropout_conv_rate=hp["dropout_conv_p"],
                     dropout_dense_rate=hp["dropout_dense_p"])
    return model(batch)


def optuna_optimization(n_trials: int = 300, timeout: float = 86400,
                        parallel: int = 0, device="cuda",
                        log_confusion_images: bool = True):
    """HPO entry point. ``parallel=K`` switches to the K-trial searcher
    (``train/vmap_hpo.py``): the batched TPE asks K configs per round; configs
    sharing the bucket signature (conv ladder, filter sizes, batchnorm,
    linear_out, batch size and the batch>=64 epoch-budget bump) train together,
    with lr, focal gamma and BOTH dropout rates per trial (an absent dropout
    knob is rate 0.0, bit-exact no dropout, so dropout presence never splits a
    bucket). Refit the winner with ``train()`` for a checkpoint.
    """
    study = hpo.create_study(direction="minimize")
    if parallel and parallel > 1:
        from multimodal_alzheimer_tpu_torch.train import vmap_hpo
        from multimodal_alzheimer_tpu_torch.train.fusion_hpo import (
            preprocessed_arrays,
        )

        base = {"n_classes": 3}
        trainset, valset = build_datasets(
            base, ["pet1451"],
            normalize_pet={"mean": 0.5145, "std": 0.5383})
        attach_class_weights(base, trainset)
        # The PET normalization is elementwise and trial-invariant: once
        # over the whole split, not per step per trial.
        train_data = preprocessed_arrays(trainset, device)
        val_data = preprocessed_arrays(valset, device)

        def signature(hparams):
            return (tuple(hparams["conv_out"]),
                    tuple(hparams["filter_size"]),
                    bool(hparams["batchnorm"]),
                    int(hparams.get("linear_out") or 0),
                    int(hparams["batch_size"]),
                    int(hparams["max_epochs"]),
                    int(hparams["early_stopping_patience"]))

        def batch_objective(sig, rows):
            model = SmallPETCNN.from_hparams(
                dict(base, **rows[0]),
                dropout_conv_p=None, dropout_dense_p=None)
            hp = vmap_hpo.stack_trial_hparams(
                rows, extra_keys=("dropout_conv_p", "dropout_dense_p"))
            values, _ = vmap_hpo.run_parallel_trials(
                model, hp, train_data, val_data,
                batch_size=int(rows[0]["batch_size"]),
                max_epochs=int(rows[0]["max_epochs"]),
                patience=int(rows[0]["early_stopping_patience"]),
                class_weights=base["loss_class_weights"], seed=SEED,
                apply_fn=_dropout_apply, device=device)
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
    optuna_optimization()
