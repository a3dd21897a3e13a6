"""HPO for the frozen fusion stages: K head trials over shared towers.

Port of ``multimodal_alzheimer_tpu/train/fusion_hpo.py``. The reference's
stage-2/3 searches are its most expensive HPO workloads: every optuna trial
re-trains a fusion model whose forward runs the full stage-1 towers, 300
sequential Lightning fits per study (reference:
train_anat_pet_fusion.py:175-183). In the default frozen regime (``freeze``
sampled True => ``lr_pretrained=None``, anat_pet_fusion.py:34-40) the
towers never update: their forward depends only on the batch, never on a
trial's head. So K trials share ONE tower forward per step and only their
small Linear heads run per trial.

Built on ``vmap_hpo.run_parallel_trials(shared_fn=...)``:

* ``make_shared_towers_fn`` runs the frozen stage-1 models, loaded from
  their checkpoints, under ``torch.no_grad()``, with the dataset's device
  preprocess (K2 with memoised min-max bounds, K1 and K2 without) once per
  step for all K trials. The towers' BatchNorm statistics live in the
  shared carry and move once per train step, input-only like the
  sequential path; validation batches read them without advancing them
  (``fusion_hpo.py:80-101``).
* Each trial's module is the fusion model without its towers
  (``make_hook_fns``): the tower submodules are left out of the copy, the
  ``towers=`` (stage 2) or ``fusion_inputs=`` (stage 3) argument supplies
  their outputs, and init and Adam see only the head, so L2 decays only
  head parameters, ``driver.fusion_optimizer``'s frozen semantics.
* Unfrozen proposals (``freeze`` False) cannot share towers; the study
  driver sends those buckets to the sequential objective unchanged.

Against K sequential frozen fits this differs where ``vmap_hpo`` does
(one shuffle per epoch for the bucket, the ragged tail dropped). Tower
dropout would be a third difference; the reference's fusion regimes run
their towers dropout-free (all_modalities_fusion.py:50), and a tower with
dropout draws its masks from one generator in the shared carry, the same
masks for every trial.
"""

from __future__ import annotations

import copy
from typing import Callable, Optional

import numpy as np
import torch

from multimodal_alzheimer_tpu_torch.models.layers import (
    reset_parameters,
    set_dropout_generator,
)
from multimodal_alzheimer_tpu_torch.train import vmap_hpo
from multimodal_alzheimer_tpu_torch.utils.device import resolve_device
from multimodal_alzheimer_tpu_torch.utils.seeding import make_generator


def full_arrays(dataset) -> dict:
    """Collate an entire dataset split into one batch of stacked host
    arrays (the whole-split layout ``run_parallel_trials`` takes)."""
    from multimodal_alzheimer_tpu_torch.data.pipeline import DataLoader

    loader = DataLoader(dataset, len(dataset), num_workers=1, device="cpu")
    return {k: np.asarray(v) for k, v in next(iter(loader)).items()}


def preprocessed_arrays(dataset, device="cuda") -> dict:
    """``full_arrays(dataset)`` moved to ``device`` and normalized once by
    the dataset's device preprocess: the split layout of a search whose
    normalization is fixed (trial-invariant), so no step normalizes
    again."""
    device = resolve_device(device)
    preprocess = dataset.get_device_preprocess()
    with torch.no_grad():
        return preprocess({k: torch.as_tensor(v).to(device)
                           for k, v in full_arrays(dataset).items()})


def _statistics(module) -> dict:
    """Copies of ``module``'s ``state_dict`` entries that are not
    parameters: its BatchNorm running statistics."""
    params = {name for name, _ in module.named_parameters()}
    return {name: value.detach().clone()
            for name, value in module.state_dict().items()
            if name not in params}


def _bind(module, statistics: dict) -> None:
    """Make the carry's tensors ``module``'s buffers, so a train-mode
    forward updates the carry in place."""
    for name, tensor in statistics.items():
        path, _, leaf = name.rpartition(".")
        owner = module.get_submodule(path)
        if owner._buffers[leaf] is not tensor:
            owner._buffers[leaf] = tensor


def _loaded(model, state_dict, device):
    model.load_state_dict(state_dict)
    return model.to(device)


def _runner(models: dict, preprocess, device, forward: Callable):
    """``(shared_fn, carry0)`` over frozen ``models``: the carry is
    ``(dropout generator state, {name: running statistics})``;
    ``forward(run, batch) -> out`` calls ``run(name, **kwargs)`` per
    model."""
    generator = make_generator(0, device)
    for model in models.values():
        set_dropout_generator(model, generator)
    carry0 = (generator.get_state(),
              {name: _statistics(model) for name, model in models.items()})

    def shared_fn(carry, batch, train):
        rng_state, stats = carry
        with torch.no_grad():
            if preprocess is not None:
                batch = preprocess(batch)
            if train:
                generator.set_state(rng_state)

            def run(name, **kwargs):
                model = models[name]
                _bind(model, stats[name])
                model.train(train)
                return model(batch, **kwargs)

            out = forward(run, batch)
            if train:
                rng_state = generator.get_state()
        return out, (rng_state, stats)

    return shared_fn, carry0


def make_shared_towers_fn(tower_models: dict, tower_variables: dict,
                          preprocess: Optional[Callable] = None,
                          device="cuda"):
    """The trial-invariant ``shared_fn`` running the frozen towers.

    ``tower_models``: name -> port model (e.g. {'pet': SmallPETCNN, 'mri':
    AnatCNN}); ``tower_variables``: name -> that model's stage-1
    ``state_dict``, loaded into it, and the models are moved to ``device``.
    Returns ``(shared_fn, shared_carry0)``; the outputs are the towers'
    output dicts keyed by name, the ``towers=`` argument of
    ``AnatPETFusion``, ``TabularMRIFusion`` and ``PETTabularFusion``.
    """
    device = resolve_device(device)
    models = {name: _loaded(tower_models[name], tower_variables[name],
                            device) for name in sorted(tower_models)}

    def forward(run, batch):
        return {name: run(name) for name in models}

    return _runner(models, preprocess, device, forward)


def _hooked(model) -> list:
    """The submodules a hook argument replaces: the child models (each
    stage-1 or stage-2 model has a ``fusion_tap``)."""
    return [m for m in model.children() if hasattr(m, "fusion_tap")]


def make_hook_fns(kwarg: str):
    """``(apply_fn, init_fn)`` feeding the shared output through a model
    argument (``towers=`` for stage-2 heads, ``fusion_inputs=`` for the
    stage-3 head), so only head layers run; ``init_fn`` copies the model
    without its child models and re-initialises the head from the trial's
    generator."""

    def apply_fn(model, batch, hp, train, shared):
        del hp, train
        return model(batch, **{kwarg: shared})

    def init_fn(model, generator, example, shared_example):
        del example, shared_example
        head = copy.deepcopy(model, {id(m): None for m in _hooked(model)})
        head = head.cpu()
        reset_parameters(head, generator)
        return head

    return apply_fn, init_fn


towers_apply_fn, towers_init_fn = make_hook_fns("towers")


def make_stage3_shared_fn(sub_models: dict, sub_variables: dict,
                          preprocess: Optional[Callable] = None,
                          device="cuda"):
    """The trial-invariant ``shared_fn`` of the stage-3 search: the three
    frozen stage-2 sub-models run once per step and their fusion taps go to
    the K stage-3 heads.

    It follows ``AllModalitiesFusion.share_towers``: anat_pet computes the
    PET and MRI towers, its MRI output feeds anat_tab, whose tabular output
    feeds pet_tab, so each stage-1 tower runs once per step. Each
    sub-model's BatchNorm statistics live in the shared carry.

    ``sub_models``/``sub_variables``: keys 'anat_pet'/'anat_tab'/'pet_tab'
    -> the stage-2 models and their ``state_dict`` with the stage-1 weights
    grafted beneath (``train_all_modalities_fusion``'s loading order).
    """
    device = resolve_device(device)
    names = ("anat_pet", "anat_tab", "pet_tab")
    models = {name: _loaded(sub_models[name], sub_variables[name], device)
              for name in names}

    def forward(run, batch):
        ap = run("anat_pet", towers={}, return_towers=True)
        at = run("anat_tab", towers={"mri": ap["towers"]["mri"]},
                 return_towers=True)
        pt = run("pet_tab", towers={"pet": ap["towers"]["pet"],
                                    "tab": at["towers"]["tab"]},
                 return_towers=True)
        return {"anat_pet": ap["embeddings"]["fusion"],
                "anat_tab": at["embeddings"]["fusion"],
                "pet_tab": pt["embeddings"]["fusion"]}

    return _runner(models, preprocess, device, forward)


def run_shared_trials(head_model, shared_fn, shared_carry0, hp: dict,
                      train_data: dict, val_data: dict, *,
                      hook_kwarg: str = "towers", batch_size: int,
                      max_epochs: int, patience: int, class_weights,
                      seed: int = 5, mesh=None, **kwargs):
    """K trials of a head over a prebuilt trial-invariant ``shared_fn``."""
    apply_fn, init_fn = make_hook_fns(hook_kwarg)
    return vmap_hpo.run_parallel_trials(
        head_model, hp, train_data, val_data, batch_size=batch_size,
        max_epochs=max_epochs, patience=patience,
        class_weights=class_weights, seed=seed, mesh=mesh,
        apply_fn=apply_fn, init_fn=init_fn,
        shared_fn=shared_fn, shared_carry0=shared_carry0, **kwargs)


def run_frozen_fusion_trials(head_model, tower_models: dict,
                             tower_variables: dict, hp: dict,
                             train_data: dict, val_data: dict, *,
                             preprocess=None, device="cuda", **kwargs):
    """K frozen stage-2 trials, one shared tower forward per step."""
    shared_fn, carry0 = make_shared_towers_fn(tower_models, tower_variables,
                                              preprocess, device)
    return run_shared_trials(head_model, shared_fn, carry0, hp, train_data,
                             val_data, hook_kwarg="towers", device=device,
                             **kwargs)


def _optimize_fusion_study(study, sample: Callable,
                           sequential_objective: Callable, *,
                           base: dict, modalities, norm_kwargs: dict,
                           make_shared: Callable, hook_kwarg: str,
                           head_builder: Callable,
                           signature_extra: Callable = lambda hp: (),
                           n_trials: int, parallel: int,
                           timeout: Optional[float] = None, device="cuda"):
    """The study driver shared by the fusion stages.

    Frozen proposals (``lr_pretrained`` None, the regime of the winning
    reference configs) run through the shared-tower trainer; unfrozen ones
    go to ``sequential_objective(hparams) -> loss`` one at a time (their
    towers train, so nothing is trial-invariant). ``head_builder(hparams)``
    builds the head for a bucket (static knobs such as ``simple_dim_red``
    belong in ``signature_extra``); ``make_shared(preprocess) ->
    (shared_fn, carry0)`` builds the trial-invariant computation fed
    through ``hook_kwarg`` on ``device``.
    """
    from multimodal_alzheimer_tpu_torch.train.driver import (
        attach_class_weights,
        build_datasets,
    )

    trainset, valset = build_datasets(base, modalities, **norm_kwargs)
    attach_class_weights(base, trainset)
    train_data = full_arrays(trainset)
    val_data = full_arrays(valset)
    shared_fn, shared_carry0 = make_shared(trainset.get_device_preprocess())

    def signature(hparams):
        return (hparams.get("lr_pretrained") is None,
                int(hparams["batch_size"])) + tuple(
                    signature_extra(hparams))

    def batch_objective(sig, rows):
        frozen, batch_size = sig[0], sig[1]
        if not frozen:  # towers train: no shared forward exists
            return [sequential_objective(dict(base, **row)) for row in rows]
        head = head_builder({**base, **rows[0], "lr_pretrained": None})
        hp = vmap_hpo.stack_trial_hparams(rows)
        values, _ = run_shared_trials(
            head, shared_fn, shared_carry0, hp, train_data, val_data,
            hook_kwarg=hook_kwarg, batch_size=batch_size,
            max_epochs=int(rows[0]["max_epochs"]),
            patience=int(rows[0]["early_stopping_patience"]),
            class_weights=base["loss_class_weights"], seed=5,
            device=device)
        return [float(v) for v in values[:len(rows)]]

    vmap_hpo.optimize_batched(study, sample, batch_objective,
                              n_trials=n_trials, parallel=parallel,
                              signature_fn=signature, timeout=timeout)
    return study


def optimize_stage2_anat_pet(study, sample_hparams: Callable,
                             sequential_objective: Callable, *,
                             n_trials: int, parallel: int,
                             path_pet: str, path_mri: str,
                             n_classes: int = 3,
                             timeout: Optional[float] = None,
                             device="cuda"):
    """Batched-TPE study over the stage-2 PET+MRI fusion search space."""
    from multimodal_alzheimer_tpu_torch.models.fusion_models.anat_pet_fusion \
        import AnatPETFusion
    from multimodal_alzheimer_tpu_torch.models.mri_models.anat_cnn import (
        AnatCNN,
    )
    from multimodal_alzheimer_tpu_torch.models.pet_models.pet_cnn import (
        SmallPETCNN,
    )
    from multimodal_alzheimer_tpu_torch.train.checkpoint import (
        load_checkpoint,
    )
    from multimodal_alzheimer_tpu_torch.train.driver import (
        stage1_normalizations,
    )

    pet_vars, pet_hp, _ = load_checkpoint(path_pet)
    mri_vars, mri_hp, _ = load_checkpoint(path_mri)
    normalize_pet, normalize_mri, quantile = stage1_normalizations(pet_hp,
                                                                   mri_hp)
    base = {"n_classes": n_classes, "path_pet": path_pet,
            "path_mri": path_mri}
    return _optimize_fusion_study(
        study,
        lambda trial: sample_hparams(trial, n_classes=n_classes,
                                     path_pet=path_pet, path_mri=path_mri),
        sequential_objective, base=base, modalities=["pet1451", "t1w"],
        norm_kwargs=dict(normalize_pet=normalize_pet,
                         normalize_mri=normalize_mri, quantile=quantile),
        make_shared=lambda preprocess: make_shared_towers_fn(
            {"pet": SmallPETCNN.from_hparams(pet_hp),
             "mri": AnatCNN.from_hparams(mri_hp, freeze_backbone=False)},
            {"pet": pet_vars, "mri": mri_vars}, preprocess, device),
        hook_kwarg="towers",
        head_builder=lambda hp: AnatPETFusion.from_hparams(hp, pet_hp,
                                                           mri_hp),
        n_trials=n_trials, parallel=parallel, timeout=timeout,
        device=device)


def optimize_stage2_mri_tab(study, sample_hparams: Callable,
                            sequential_objective: Callable, *,
                            n_trials: int, parallel: int,
                            path_mri: str, path_tabular: str,
                            n_classes: int = 3,
                            timeout: Optional[float] = None,
                            device="cuda"):
    """Batched-TPE study over the stage-2 MRI+tabular fusion space."""
    from multimodal_alzheimer_tpu_torch.models.fusion_models.tabular_mri_fusion \
        import TabularMRIFusion
    from multimodal_alzheimer_tpu_torch.models.mri_models.anat_cnn import (
        AnatCNN,
    )
    from multimodal_alzheimer_tpu_torch.models.tabular_models.tabular_mlp \
        import TabularMLP
    from multimodal_alzheimer_tpu_torch.train.checkpoint import (
        load_checkpoint,
    )
    from multimodal_alzheimer_tpu_torch.train.driver import (
        stage1_normalizations,
    )

    mri_vars, mri_hp, _ = load_checkpoint(path_mri)
    tab_vars, tab_hp, _ = load_checkpoint(path_tabular)
    _, normalize_mri, quantile = stage1_normalizations(None, mri_hp)
    base = {"n_classes": n_classes, "path_mri": path_mri,
            "path_tabular": path_tabular}
    return _optimize_fusion_study(
        study,
        lambda trial: sample_hparams(trial, n_classes=n_classes,
                                     path_mri=path_mri,
                                     path_tabular=path_tabular),
        sequential_objective, base=base, modalities=["tabular", "t1w"],
        norm_kwargs=dict(normalize_mri=normalize_mri, quantile=quantile),
        make_shared=lambda preprocess: make_shared_towers_fn(
            {"mri": AnatCNN.from_hparams(mri_hp, freeze_backbone=False),
             "tab": TabularMLP.from_hparams(tab_hp)},
            {"mri": mri_vars, "tab": tab_vars}, preprocess, device),
        hook_kwarg="towers",
        head_builder=lambda hp: TabularMRIFusion.from_hparams(hp, mri_hp,
                                                              tab_hp),
        n_trials=n_trials, parallel=parallel, timeout=timeout,
        device=device)


def optimize_stage2_pet_tab(study, sample_hparams: Callable,
                            sequential_objective: Callable, *,
                            n_trials: int, parallel: int,
                            path_pet: str, path_tabular: str,
                            n_classes: int = 2,
                            timeout: Optional[float] = None,
                            device="cuda"):
    """Batched-TPE study over the stage-2 PET+tabular fusion space.

    ``simple_dim_red`` is a static head-architecture knob, so it joins the
    bucket signature."""
    from multimodal_alzheimer_tpu_torch.models.fusion_models.pet_tabular_fusion \
        import PETTabularFusion
    from multimodal_alzheimer_tpu_torch.models.pet_models.pet_cnn import (
        SmallPETCNN,
    )
    from multimodal_alzheimer_tpu_torch.models.tabular_models.tabular_mlp \
        import TabularMLP
    from multimodal_alzheimer_tpu_torch.train.checkpoint import (
        load_checkpoint,
    )
    from multimodal_alzheimer_tpu_torch.train.driver import (
        stage1_normalizations,
    )

    pet_vars, pet_hp, _ = load_checkpoint(path_pet)
    tab_vars, tab_hp, _ = load_checkpoint(path_tabular)
    normalize_pet, _, _ = stage1_normalizations(pet_hp, None)
    base = {"n_classes": n_classes, "path_pet": path_pet,
            "path_tabular": path_tabular}
    return _optimize_fusion_study(
        study,
        lambda trial: sample_hparams(trial, n_classes=n_classes,
                                     path_pet=path_pet,
                                     path_tabular=path_tabular),
        sequential_objective, base=base, modalities=["pet1451", "tabular"],
        norm_kwargs=dict(normalize_pet=normalize_pet),
        make_shared=lambda preprocess: make_shared_towers_fn(
            {"pet": SmallPETCNN.from_hparams(pet_hp),
             "tab": TabularMLP.from_hparams(tab_hp)},
            {"pet": pet_vars, "tab": tab_vars}, preprocess, device),
        hook_kwarg="towers",
        head_builder=lambda hp: PETTabularFusion.from_hparams(hp, pet_hp,
                                                              tab_hp),
        signature_extra=lambda hp: (bool(hp.get("simple_dim_red")),),
        n_trials=n_trials, parallel=parallel, timeout=timeout,
        device=device)


def optimize_stage3_all_modalities(study, sample_hparams: Callable,
                                   sequential_objective: Callable, *,
                                   n_trials: int, parallel: int,
                                   path_pet: str, path_mri: str,
                                   path_tabular: str, path_anat_pet: str,
                                   path_anat_tab: str, path_pet_tab: str,
                                   n_classes: int = 3,
                                   timeout: Optional[float] = None,
                                   device="cuda"):
    """Batched-TPE study over the stage-3 all-modalities fusion space.

    Frozen proposals run through ``make_stage3_shared_fn``: ONE pass
    through the three frozen stage-2 sub-models (stage-1 towers shared
    across them, the ``share_towers`` forward) feeds K stage-3 heads through
    ``fusion_inputs``. Each trial's state is its stage3out/cls3 layers.
    """
    from multimodal_alzheimer_tpu_torch.models.fusion_models.all_modalities_fusion \
        import AllModalitiesFusion
    from multimodal_alzheimer_tpu_torch.models.fusion_models.anat_pet_fusion \
        import AnatPETFusion
    from multimodal_alzheimer_tpu_torch.models.fusion_models.pet_tabular_fusion \
        import PETTabularFusion
    from multimodal_alzheimer_tpu_torch.models.fusion_models.tabular_mri_fusion \
        import TabularMRIFusion
    from multimodal_alzheimer_tpu_torch.train.checkpoint import (
        graft_params,
        load_checkpoint,
    )
    from multimodal_alzheimer_tpu_torch.train.driver import (
        stage1_normalizations,
    )

    pet_vars, pet_hp, _ = load_checkpoint(path_pet)
    mri_vars, mri_hp, _ = load_checkpoint(path_mri)
    tab_vars, tab_hp, _ = load_checkpoint(path_tabular)
    ap_vars, ap_hp, _ = load_checkpoint(path_anat_pet)
    at_vars, at_hp, _ = load_checkpoint(path_anat_tab)
    pt_vars, pt_hp, _ = load_checkpoint(path_pet_tab)

    normalize_pet, normalize_mri, quantile = stage1_normalizations(pet_hp,
                                                                   mri_hp)
    paths = {"path_pet": path_pet, "path_mri": path_mri,
             "path_tabular": path_tabular, "path_anat_pet": path_anat_pet,
             "path_anat_tab": path_anat_tab, "path_pet_tab": path_pet_tab}
    base = dict({"n_classes": n_classes}, **paths)

    # The stage-2 sub-models and their two-level grafted weights
    # (train_all_modalities_fusion's loading order: stage-2 weights, then
    # stage 1 re-grafted beneath).
    sub_models = {
        "anat_pet": AnatPETFusion.from_hparams(ap_hp, pet_hp, mri_hp),
        "anat_tab": TabularMRIFusion.from_hparams(at_hp, mri_hp, tab_hp),
        "pet_tab": PETTabularFusion.from_hparams(pt_hp, pet_hp, tab_hp),
    }
    sub_variables = {
        "anat_pet": graft_params(ap_vars, {"pet_model": pet_vars,
                                           "mri_model": mri_vars}),
        "anat_tab": graft_params(at_vars, {"mri_model": mri_vars,
                                           "tab_model": tab_vars}),
        "pet_tab": graft_params(pt_vars, {"pet_model": pet_vars,
                                          "tab_model": tab_vars}),
    }

    def head_builder(hp):
        return AllModalitiesFusion.from_hparams(hp, ap_hp, at_hp, pt_hp,
                                                pet_hp, mri_hp, tab_hp)

    return _optimize_fusion_study(
        study,
        lambda trial: sample_hparams(trial, n_classes=n_classes, **paths),
        sequential_objective, base=base,
        modalities=["pet1451", "t1w", "tabular"],
        norm_kwargs=dict(normalize_pet=normalize_pet,
                         normalize_mri=normalize_mri, quantile=quantile),
        make_shared=lambda preprocess: make_stage3_shared_fn(
            sub_models, sub_variables, preprocess, device),
        hook_kwarg="fusion_inputs", head_builder=head_builder,
        n_trials=n_trials, parallel=parallel, timeout=timeout,
        device=device)
