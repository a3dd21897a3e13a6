"""Train the MRI Med3D-ResNet classifier (reference train_anat_cnn.py).

Port of ``multimodal_alzheimer_tpu/models/mri_models/train_anat_cnn.py``:
the search space (reference: mri_models/train_anat_cnn.py:54-140): lr log
[1e-5, 1e-2], freeze or lr_pretrained log [1e-7, 1e-5], per-scan quantile
min-max with q in {0.95, 0.98, 0.99, 1}, resnet depth in {10, 18, 50}, l2
in {0, 1e-1, 1e-2, 1e-3}, the linear-block shape generator, fl_gamma in
{None, 1, 2, 5}, seed 15; ``train_anat``, one training run from the
split under ``MMALZ_DATA_DIR`` (or ``./data``); ``train_anat_fast``, the
strided fast mode with its K-seed screen; and the HPO entry point
``optuna_optimization``, sequential or ``parallel=K`` trials per bucket
through the K-trial trainer (``train/vmap_hpo.py``), which normalizes the
raw split on the card once per percentile bucket
(``percentile_normalizer``).

Optimizer groups follow anat_cnn.py:111-126: the 'head' submodule at lr,
the backbone frozen or at lr_pretrained.

``sample_hparams`` takes any object with optuna's ``suggest_float`` and
``suggest_categorical``; optuna is imported only by ``hpo.create_study``,
which falls back to the TPE shim without it.
"""

from __future__ import annotations

import functools
import time

import torch

from multimodal_alzheimer_tpu_torch.models.mri_models.anat_cnn import AnatCNN
from multimodal_alzheimer_tpu_torch.train import hpo
from multimodal_alzheimer_tpu_torch.train.driver import (
    attach_class_weights,
    build_datasets,
    run_training,
)
from multimodal_alzheimer_tpu_torch.train.optim import (
    FROZEN,
    build_optimizer,
)
from multimodal_alzheimer_tpu_torch.utils.device import resolve_device
from multimodal_alzheimer_tpu_torch.utils.seeding import make_generator

LOG_DIRECTORY = "lightning_logs"
EXPERIMENT_NAME = "optuna_mri"
EXPERIMENT_VERSION = None
SEED = 15


def generate_linear_block_options(first_layer_options, n_layers_options):
    """Dense-block shapes (train_anat_cnn.py:67-90)."""
    dense_out_options = []
    for x in first_layer_options:
        for n in n_layers_options:
            dense_out_options.append(tuple(x for _ in range(n)))
            dense_out_options.append(tuple(int(x / 2 ** i)
                                           for i in range(n)))
    return dense_out_options


def sample_hparams(trial, n_classes: int = 2) -> dict:
    hparams = {
        "early_stopping_patience": 5,
        "max_epochs": 20,
        "n_classes": n_classes,
        "reduce_factor_lr_schedule": None,
        "best_k_checkpoints": 3,
    }
    dense_options = {str(o): o for o in
                     generate_linear_block_options([256, 128, 64], [0, 3])}

    hparams["lr"] = trial.suggest_float("lr", 1e-5, 1e-2, log=True)
    freeze = trial.suggest_categorical("freeze", (True, False))
    hparams["lr_pretrained"] = (None if freeze else trial.suggest_float(
        "lr_pretrained", 1e-7, 1e-5, log=True))
    hparams["conv_out"] = []
    hparams["filter_size"] = []
    hparams["batchnorm_begin"] = trial.suggest_categorical(
        "batchnorm_begin", (True, False))
    hparams["batchnorm_dense"] = trial.suggest_categorical(
        "batchnorm_dense", (True, False))
    hparams["batch_size"] = trial.suggest_categorical("batch_size",
                                                      (8, 16, 32, 64))
    if hparams["batch_size"] >= 64:
        hparams["early_stopping_patience"] = 10
        hparams["max_epochs"] = 50
    hparams["l2_reg"] = trial.suggest_categorical(
        "l2_reg", (0, 1e-1, 1e-2, 1e-3))
    hparams["norm_percentile"] = trial.suggest_categorical(
        "norm_percentile", (0.95, 0.98, 0.99, 1))
    hparams["fl_gamma"] = trial.suggest_categorical("fl_gamma",
                                                    (None, 1, 2, 5))
    hparams["resnet_depth"] = trial.suggest_categorical("resnet_depth",
                                                        (10, 18, 50))
    dense_idx = trial.suggest_categorical("linear_out",
                                          list(dense_options))
    hparams["linear_out"] = dense_options[dense_idx]
    return hparams


def percentile_normalizer(dataset, raw_train: dict, raw_val: dict,
                          device="cuda"):
    """Per-bucket renormalization of collated raw splits at a searched q.

    Returns ``normalized(q) -> (train_data, val_data)``, tensors on
    ``device``, for the K-trial search. Two properties matter:

    * The memoised ``mri_qminmax`` bounds in the collated arrays were
      computed at the dataset's build-time quantile, and the device
      preprocess prefers them over a fresh selection; they are dropped
      here so the searched ``norm_percentile`` is honoured. Each split is
      normalized in one preprocess call per bucket: one K1 (quantile
      select) and one K2 (min-max apply) launch per split on the card,
      whatever the number of trials and steps.
    * One percentile is resident at a time (four normalized copies of a
      split need not fit the card); consecutive same-q buckets reuse it.
    """
    device = resolve_device(device)
    raw_train = dict(raw_train)
    raw_val = dict(raw_val)
    raw_train.pop("mri_qminmax", None)
    raw_val.pop("mri_qminmax", None)
    cache: dict = {}

    def normalized(q):
        if q not in cache:
            cache.clear()
            dataset.quantile = q  # read when the preprocess is built
            pre = dataset.get_device_preprocess()
            with torch.no_grad():
                cache[q] = tuple(
                    pre({k: torch.as_tensor(v).to(device)
                         for k, v in raw.items()})
                    for raw in (raw_train, raw_val))
        return cache[q]

    return normalized


def backbone_head_optimizer(hparams: dict, model):
    """Adam over ``model``: head at lr; backbone frozen or at
    lr_pretrained (anat_cnn.py:111-126)."""
    lr_pretrained = hparams.get("lr_pretrained")

    def label(path):
        if path and path[0] == "head":
            return "head"
        return "pretrained" if lr_pretrained else FROZEN

    return build_optimizer(
        {"head": hparams["lr"],
         "pretrained": lr_pretrained if lr_pretrained else None},
        label, model, l2_reg=hparams.get("l2_reg", 0.0))


def train_anat(hparams: dict, experiment_name: str = "",
               experiment_version=None, log_confusion_images: bool = True,
               device="cuda", **run_kwargs):
    """Train ``AnatCNN`` on the split's T1w scans with per-scan quantile
    min-max at ``hparams['norm_percentile']`` (bounds memoised per sample,
    so the step runs the apply kernel alone); return the last validation
    loss. The weights start from seed ``SEED``. ``run_kwargs`` go to
    ``run_training`` (``num_workers``, ``variables_transform``, ...)."""
    trainset, valset = build_datasets(
        hparams, ["t1w"],
        normalize_mri={"per_scan_norm": "min_max"},
        quantile=hparams["norm_percentile"])
    attach_class_weights(hparams, trainset)
    model = AnatCNN.from_hparams(hparams, generator=make_generator(SEED))
    optimizer = backbone_head_optimizer(hparams, model)

    _, _, last_val_loss = run_training(
        model, hparams, trainset, valset,
        experiment_name=experiment_name,
        experiment_version=experiment_version,
        optimizer=optimizer, log_dir=LOG_DIRECTORY, seed=SEED,
        log_confusion_images=log_confusion_images, device=device,
        **run_kwargs)
    return last_val_loss


def head_backbone_lr(hp_row: dict, keys: tuple) -> float:
    """``lr_select`` of the K-trial trainer with ``backbone_head_optimizer``'s
    groups: 'head' at lr, everything else at lr_pretrained (0.0 when
    frozen)."""
    return hp_row["lr"] if keys and keys[0] == "head" else hp_row[
        "lr_pretrained"]


def train_anat_fast(hparams: dict, experiment_name: str = "",
                    experiment_version=None, screen_k: int = 8,
                    screen_epochs: int = 3, screen_batch=None,
                    log_confusion_images: bool = True, device="cuda",
                    **model_kwargs):
    """Fast-mode (strided, ``dilated=False``) MRI training with a K-seed
    screen.

    The strided backbone trains faster than the Med3D-dilated one, but
    from-scratch quick fits are seed-bimodal (BASELINE.md fast-mode study).
    So ``screen_k`` init seeds of this exact config train for
    ``screen_epochs`` epochs in the K-trial trainer
    (``train/seed_screen.py``), then the regular checkpointed fit continues
    from the winning seed's best-epoch snapshot, not a re-init.

    Defaults follow the JAX package: ``trailing_relu=False`` (the parity
    quirk's clamped logits collapse quick fits to class 0 with a
    deceptively fine val loss, which would corrupt the seed selection) and
    bf16 compute. The screen model is built with ``freeze_backbone=False``
    and trains under ``head_backbone_lr``, so frozen and unfrozen regimes
    share one construction (a frozen backbone trains at lr 0.0); the
    continuation rebuilds with the default derivation, the same state dict.
    ``screen_batch`` (default: the config's batch size) sizes each seed's
    batch.

    Returns ``(last_val_loss, screen)``: ``screen`` carries the per-seed
    val history and the screen/fit wall clocks.
    """
    from multimodal_alzheimer_tpu_torch.train.fusion_hpo import (
        preprocessed_arrays,
    )
    from multimodal_alzheimer_tpu_torch.train.seed_screen import (
        screen_seeds,
    )

    trainset, valset = build_datasets(
        hparams, ["t1w"],
        normalize_mri={"per_scan_norm": "min_max"},
        quantile=hparams["norm_percentile"])
    attach_class_weights(hparams, trainset)
    model_kwargs.setdefault("trailing_relu", False)
    model_kwargs.setdefault("dtype", torch.bfloat16)
    model = AnatCNN.from_hparams(hparams, dilated=False,
                                 freeze_backbone=False, **model_kwargs)

    # The whole split on the card, normalized once (memoised bounds: one
    # K2 launch per split), shared by all K seeds.
    train_data = preprocessed_arrays(trainset, device)
    val_data = preprocessed_arrays(valset, device)

    t0 = time.perf_counter()
    screen = screen_seeds(
        model, train_data, val_data, lr=hparams["lr"],
        batch_size=int(screen_batch or hparams["batch_size"]),
        epochs=screen_epochs,
        class_weights=hparams["loss_class_weights"],
        seeds=tuple(range(screen_k)),
        l2_reg=hparams.get("l2_reg", 0.0) or 0.0,
        fl_gamma=hparams.get("fl_gamma"), base_seed=SEED,
        extra_hparams={"lr_pretrained": hparams.get("lr_pretrained")},
        lr_select=head_backbone_lr, device=device)
    screen["screen_wall_s"] = round(time.perf_counter() - t0, 1)
    winner_variables = screen.pop("winner_variables")
    del train_data, val_data

    fit_model = AnatCNN.from_hparams(hparams, dilated=False,
                                     **model_kwargs)
    optimizer = backbone_head_optimizer(hparams, fit_model)
    t0 = time.perf_counter()
    _, _, last_val_loss = run_training(
        fit_model, hparams, trainset, valset,
        experiment_name=experiment_name,
        experiment_version=experiment_version,
        optimizer=optimizer, log_dir=LOG_DIRECTORY, seed=SEED,
        variables_transform=lambda _: winner_variables,
        log_confusion_images=log_confusion_images, device=device)
    screen["fit_wall_s"] = round(time.perf_counter() - t0, 1)
    return last_val_loss, screen


@hpo.oom_guard
def _objective(trial, device="cuda", log_confusion_images: bool = True):
    hparams = sample_hparams(trial)
    return train_anat(hparams, EXPERIMENT_NAME, EXPERIMENT_VERSION,
                      log_confusion_images=log_confusion_images,
                      device=device)


def optuna_optimization(n_trials: int = 300, timeout: float = 86400,
                        parallel: int = 0, device="cuda",
                        log_confusion_images: bool = True):
    """HPO entry point. ``parallel=K`` switches to the K-trial searcher
    (``train/vmap_hpo.py``). Bucket signature: resnet depth, dense-block shape,
    batchnorm flags, batch size (+ its epoch-budget bump) and
    ``norm_percentile``, the one preprocessing knob, handled by normalizing the
    raw split on the card once per bucket (the quantile min-max is
    deterministic and trial-invariant given q). Per-trial knobs: lr, l2, focal
    gamma, and ``lr_pretrained`` through ``head_backbone_lr``: a frozen
    proposal trains its backbone at lr 0.0, which keeps it exactly as the
    sequential path's frozen group does (the model builds with
    ``freeze_backbone=False`` so frozen and unfrozen trials share a bucket).
    The sequential path renders confusion images unless
    ``log_confusion_images`` is False.
    """
    study = hpo.create_study(direction="minimize")
    if parallel and parallel > 1:
        from multimodal_alzheimer_tpu_torch.train import vmap_hpo
        from multimodal_alzheimer_tpu_torch.train.fusion_hpo import (
            full_arrays,
        )

        base = {"n_classes": 2}
        trainset, valset = build_datasets(
            base, ["t1w"], normalize_mri={"per_scan_norm": "min_max"},
            quantile=0.99)
        attach_class_weights(base, trainset)
        # Raw volumes + masks stay on the host; each bucket normalizes
        # its own device copy.
        normalized = percentile_normalizer(
            trainset, full_arrays(trainset), full_arrays(valset), device)

        def signature(hparams):
            return (int(hparams["resnet_depth"]),
                    tuple(hparams["linear_out"]),
                    bool(hparams["batchnorm_begin"]),
                    bool(hparams["batchnorm_dense"]),
                    int(hparams["batch_size"]),
                    int(hparams["max_epochs"]),
                    int(hparams["early_stopping_patience"]),
                    float(hparams["norm_percentile"]))

        def batch_objective(sig, rows):
            model = AnatCNN.from_hparams(dict(base, **rows[0]),
                                         freeze_backbone=False)
            hp = vmap_hpo.stack_trial_hparams(
                rows, extra_keys=("lr_pretrained",))
            train_data, val_data = normalized(
                float(rows[0]["norm_percentile"]))
            values, _ = vmap_hpo.run_parallel_trials(
                model, hp, train_data, val_data,
                batch_size=int(rows[0]["batch_size"]),
                max_epochs=int(rows[0]["max_epochs"]),
                patience=int(rows[0]["early_stopping_patience"]),
                class_weights=base["loss_class_weights"], seed=SEED,
                apply_fn=vmap_hpo.plain_apply, lr_select=head_backbone_lr,
                device=device)
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
