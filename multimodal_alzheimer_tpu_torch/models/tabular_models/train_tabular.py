"""Train the tabular MLP (the JAX package's TabPFN replacement).

Port of ``multimodal_alzheimer_tpu/models/tabular_models/train_tabular.py``.
The reference has no tabular training script: TabPFN is pretrained and fit
at construction (reference tabular_models/dl_approach.py:47-54). The fusion
stages need a tabular checkpoint, so ``train`` fits ``TabularMLP`` on the
train split's 9-feature rows with weighted cross-entropy and saves top-k
checkpoints as the other stage-1 entry points do. The train split's
feature statistics go into the hparams, and so into every checkpoint, for
the fusion stages to reuse.

``sample_hparams`` takes any object with optuna's ``suggest_float`` and
``suggest_categorical``; optuna is imported only by ``hpo.create_study``.
``optuna_optimization`` is the HPO entry point, sequential or
``parallel=K`` trials per bucket through the K-trial trainer.

    train(sample_hparams(trial), "tabular", device="cpu")  # on a CPU
"""

from __future__ import annotations

import functools

import numpy as np

from multimodal_alzheimer_tpu_torch.data.tabular import tabular_matrix
from multimodal_alzheimer_tpu_torch.models.tabular_models.tabular_mlp import (
    TabularMLP,
    compute_feature_stats,
)
from multimodal_alzheimer_tpu_torch.train import hpo
from multimodal_alzheimer_tpu_torch.train.driver import (
    attach_class_weights,
    build_datasets,
    run_training,
)
from multimodal_alzheimer_tpu_torch.utils.seeding import make_generator

LOG_DIRECTORY = "lightning_logs"
EXPERIMENT_NAME = "tabular_mlp"
EXPERIMENT_VERSION = None
SEED = 5


def sample_hparams(trial, n_classes: int = 3) -> dict:
    hparams = {
        "early_stopping_patience": 10,
        "max_epochs": 50,
        "n_classes": n_classes,
        "reduce_factor_lr_schedule": None,
        "best_k_checkpoints": 3,
    }
    hparams["lr"] = trial.suggest_float("lr", 1e-5, 1e-2, log=True)
    hparams["batch_size"] = trial.suggest_categorical("batch_size",
                                                      (16, 32, 64, 128))
    hparams["hidden"] = trial.suggest_categorical(
        "hidden", ("(256, 1024)", "(128, 1024)", "(512, 1024)"))
    hparams["hidden"] = tuple(
        int(x) for x in hparams["hidden"].strip("()").split(","))
    hparams["dropout_p"] = trial.suggest_float("dropout_p", 0.0, 0.5)
    hparams["l2_reg"] = trial.suggest_categorical(
        "l2_reg", (0, 1e-1, 1e-2, 1e-3))
    hparams["fl_gamma"] = trial.suggest_categorical("fl_gamma",
                                                    (None, 1, 2, 5))
    return hparams


def train(hparams: dict, experiment_name: str = "",
          experiment_version=None, log_confusion_images: bool = True,
          device="cuda", **run_kwargs):
    """Train ``TabularMLP`` on the split's tabular rows, standardised with
    the train split's statistics; return the last validation loss. The
    weights start from seed ``SEED``. ``run_kwargs`` go to ``run_training``
    (``num_workers``, ``variables_transform``, ...)."""
    trainset, valset = build_datasets(hparams, ["tabular"])
    attach_class_weights(hparams, trainset)
    mean, std = compute_feature_stats(tabular_matrix(trainset.rows))
    hparams["feature_mean"] = mean
    hparams["feature_std"] = std
    model = TabularMLP.from_hparams(hparams, generator=make_generator(SEED))
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


def _full_arrays(dataset) -> dict:
    """The whole split's feature rows and labels as host arrays, for the
    K-trial search."""
    labels = np.array([dataset.label_mapping[r["label"]]
                       for r in dataset.rows], np.int32)
    return {"tabular": tabular_matrix(dataset.rows), "label": labels}


def optuna_optimization(n_trials: int = 100, timeout: float = 86400,
                        parallel: int = 0, device="cuda",
                        log_confusion_images: bool = True):
    """HPO entry point (reference train_pet_cnn.py:208-216 template).

    ``parallel=K`` switches to the K-trial searcher (``train/vmap_hpo.py``):
    TPE asks K configs per round, and configs of one (batch size, hidden)
    bucket train together, each with its own lr, l2, dropout rate and loss. The
    objective stays the last val loss at early stopping that the sequential
    path returns; refit the winner with ``train()`` for a checkpoint (the
    parallel path saves none).
    """
    study = hpo.create_study(direction="minimize")
    if parallel and parallel > 1:
        from multimodal_alzheimer_tpu_torch.train import vmap_hpo

        base = {"n_classes": 3}
        trainset, valset = build_datasets(base, ["tabular"])
        attach_class_weights(base, trainset)
        mean, std = compute_feature_stats(tabular_matrix(trainset.rows))
        train_data = _full_arrays(trainset)
        val_data = _full_arrays(valset)

        def signature(hparams):
            return (int(hparams["batch_size"]), tuple(hparams["hidden"]))

        def batch_objective(signature, rows):
            batch_size, hidden = signature
            model = TabularMLP(n_classes=3, hidden=hidden,
                               feature_mean=tuple(mean),
                               feature_std=tuple(std))
            hp = vmap_hpo.stack_trial_hparams(rows)
            values, _ = vmap_hpo.run_parallel_trials(
                model, hp, train_data, val_data,
                batch_size=batch_size,
                max_epochs=int(rows[0]["max_epochs"]),
                patience=int(rows[0]["early_stopping_patience"]),
                class_weights=base["loss_class_weights"], seed=SEED,
                device=device)
            return values[:len(rows)]

        vmap_hpo.optimize_batched(
            study, sample_hparams, batch_objective, n_trials=n_trials,
            parallel=parallel, signature_fn=signature, timeout=timeout)
        return study
    study.optimize(functools.partial(
        _objective, device=device,
        log_confusion_images=log_confusion_images),
        n_trials=n_trials, timeout=timeout)
    return study


if __name__ == "__main__":
    optuna_optimization()
