"""Dataset-level quality study of every optimized serve path.

Port of the JAX package's ``tools/quality_eval.py``, function for
function. It trains the flagship AnatCNN (bf16 compute) on the labeled
separable synthetic task (``data/synthetic.make_labeled_volumes``: a
spatial class signal that survives per-scan normalization), then runs
every serving graph over one held-out eval set and reports F1/MCC/
balanced-accuracy deltas, confusion-matrix deltas, and prediction
agreement against the float eval graph (``inference/quality.py``):

  * ``float``          — the eval graph (baseline)
  * ``folded``         — BN-folded bf16 (exact algebra; should be ~0)
  * ``int8``           — PTQ, calibrated on REAL training batches
  * ``int8_badcalib``  — PTQ calibrated on N(0,1) JUNK: what skipping
    ``--calib`` in ``tools/export_artifact.py`` costs (the reason the
    exporter refuses int8 without a calibration set)
  * ``fast``           — ``dilated=False`` strided backbone with the
    dilated-trained weights (the quality cost of serving a dilated
    checkpoint in fast mode)

``--fusion`` adds the 3-stage deployment: PET+MRI+tabular towers trained
on the same labels, heads trained frozen-tower, then float vs BN-folded
(``fold_all_modalities_fusion``) vs int8-MRI vs int8-MRI+PET serving
graphs compared the same way.

Every metric and delta carries a bootstrap CI (``--bootstrap`` draws,
1.96 sigma — the reference's own test protocol, base_model.py:219-239);
delta CIs are PAIRED (shared resample indices across cores). The MRI
preprocess is the min-max kernels' path; the int8 cores run the int8
convolution kernel on the card.

    python -m multimodal_alzheimer_tpu_torch.tools.quality_eval  # 91^3
    python -m multimodal_alzheimer_tpu_torch.tools.quality_eval --fusion
CPU smoke (``main(argv, device="cpu")``): --volume-shape 12 14 12
--depth 10 --train-n 48 --eval-n 32 --epochs 2 --batch 8
Human tables to stderr; ONE JSON line to stdout.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

# The keys of each core's result in the JSON line (JAX's).
RESULT_KEYS = ("f1", "mcc", "balanced_acc", "delta_f1", "delta_mcc",
               "agreement", "max_prob_abs_err", "n", "f1_ci", "mcc_ci",
               "balanced_acc_ci", "delta_f1_ci", "delta_mcc_ci")


class _DeviceLoader:
    """Device-resident epoch iterator: ONE host-to-device copy per
    dataset, every batch an on-device gather. Tensors already on the
    device are reused as they are, so tower fits over sub-dicts share one
    resident copy."""

    def __init__(self, data, batch_size, shuffle, seed=0, device="cuda"):
        device = torch.device(device)
        self.dev = {k: torch.as_tensor(v, device=device)
                    for k, v in data.items()}
        self.n = len(data["label"])
        self.bs = batch_size
        self.shuffle = shuffle
        self.rng = np.random.default_rng(seed)
        self.device = device

    def __iter__(self):
        idx = (self.rng.permutation(self.n) if self.shuffle
               else np.arange(self.n))
        idx = torch.from_numpy(idx.astype(np.int64)).to(self.device)
        for i in range(0, self.n - self.n % self.bs, self.bs):
            sl = idx[i:i + self.bs]
            yield {k: v.index_select(0, sl) for k, v in self.dev.items()}

    def __len__(self):
        return self.n // self.bs


def _loader(data, batch_size, shuffle, seed=0, device="cuda"):
    return _DeviceLoader(data, batch_size, shuffle, seed=seed, device=device)


def _train_model(model, hparams, train_data, eval_data, preprocess,
                 seed=0, device="cuda", optimizer=None):
    """Fit ``model`` in place with the port's ``Trainer``; returns its
    trained ``state_dict``."""
    from multimodal_alzheimer_tpu_torch.losses.classification import (
        make_criterion,
    )
    from multimodal_alzheimer_tpu_torch.train.loop import Trainer
    from multimodal_alzheimer_tpu_torch.train.optim import (
        single_lr_optimizer,
    )

    model.to(device)
    trainer = Trainer(model, hparams,
                      optimizer or single_lr_optimizer(model, hparams["lr"]),
                      make_criterion(hparams), preprocess=preprocess,
                      logger=None, seed=seed, log_confusion_images=False,
                      device=device)
    train_loader = _loader(train_data, hparams["batch_size"], True,
                           device=device)
    val_loader = _loader(eval_data, hparams["batch_size"], False,
                         device=device)
    state = trainer.init_state()
    state, last_val = trainer.fit(state, train_loader, val_loader)
    # The trainer's own eval F1 anchors the serve-path comparison: if
    # compare_serve_cores disagrees with this number, the harness (not
    # the model) is broken.
    metrics = trainer._run_eval_epoch(val_loader, prefix="val")
    print(f"trained: last val loss {last_val:.4f}, "
          f"trainer eval F1 {metrics['val_f1_epoch']:.4f}",
          file=sys.stderr)
    return state.state_dict()


def _float_serve(model, pre):
    def serve(batch):
        model.eval()
        out = model(pre(batch))
        logits = out["logits"].to(torch.float32)
        return {"logits": logits, "probs": torch.softmax(logits, -1)}

    return serve


def _on_device(data, keys, device):
    """Half-width volumes (the dataset's cache_dtype=float16 convention:
    the preprocess upcasts before normalization), resident on the device
    once: train, eval and calibration all reference one copy."""
    for k in keys:
        dtype = torch.float16 if k != "tabular" else torch.float32
        data[k] = torch.from_numpy(data[k]).to(device, dtype)


def _report(results, key, comp, title):
    from multimodal_alzheimer_tpu_torch.inference.quality import (
        format_comparison,
    )

    print(f"== {title} (n={comp['float']['n']}) ==", file=sys.stderr)
    print(format_comparison(comp), file=sys.stderr)
    results[key] = {
        name: {k: (round(v, 4) if isinstance(v, float) else v)
               for k, v in r.items() if k in RESULT_KEYS}
        for name, r in comp.items()}


def _flagship_phase(args, results, device="cuda"):
    from multimodal_alzheimer_tpu_torch.data.synthetic import (
        make_labeled_volumes,
    )
    from multimodal_alzheimer_tpu_torch.inference.quality import (
        compare_serve_cores,
    )
    from multimodal_alzheimer_tpu_torch.inference.quantize import (
        fold_anat_cnn,
        quantize_anat_cnn,
    )
    from multimodal_alzheimer_tpu_torch.models.mri_models.anat_cnn import (
        AnatCNN,
    )
    from multimodal_alzheimer_tpu_torch.ops.normalization import (
        batched_normalize_mri,
    )

    shape = tuple(args.volume_shape)
    # jitter = contrast: some samples carry ~zero signal, so margins
    # stay moderate and the comparison is sensitive (see synthetic.py)
    train = make_labeled_volumes(args.train_n, shape, seed=args.seed,
                                 contrast=args.contrast,
                                 contrast_jitter=args.contrast)
    evald = make_labeled_volumes(args.eval_n, shape, seed=args.seed + 1,
                                 contrast=args.contrast,
                                 contrast_jitter=args.contrast)
    for d in (train, evald):
        _on_device(d, ("mri", "mri_mask"), device)

    def pre(batch):
        out = dict(batch)
        out["mri"] = batched_normalize_mri(
            out["mri"].to(torch.float32),
            out.pop("mri_mask").to(torch.float32),
            {"per_scan_norm": "min_max"}, 0.99)
        return out

    hparams = {"n_classes": 3, "resnet_depth": args.depth,
               "linear_out": (), "batchnorm_begin": False,
               "lr": args.lr, "batch_size": args.batch,
               "max_epochs": args.epochs,
               "early_stopping_patience": args.epochs,
               "reduce_factor_lr_schedule": None,
               "loss_class_weights": None}
    # trailing_relu (the reference parity quirk) clamps negative logits
    # to 0: in a short synthetic fit the clamped classes' gradients die
    # and every argmax ties to class 0. The serve transformations under
    # test are quirk-agnostic, so the study trains quirk-OFF to get a
    # well-conditioned classifier.
    torch.manual_seed(args.seed)
    model = AnatCNN.from_hparams(hparams, dtype=torch.bfloat16,
                                 trailing_relu=False)
    trained = _train_model(model, hparams, train, evald, pre,
                           seed=args.seed, device=device)

    calib = [{k: v[:args.batch] for k, v in train.items()
              if k != "label"}]
    rngj = np.random.default_rng(99)
    junk = [{"mri": torch.from_numpy(np.abs(rngj.normal(
                 0, 1, (args.batch,) + shape)).astype(np.float32)).to(device),
             "mri_mask": torch.ones((args.batch,) + shape, device=device)}]

    cores = {"float": _float_serve(model, pre),
             "folded": fold_anat_cnn(model, preprocess=pre)[0],
             "int8": quantize_anat_cnn(model, calib, preprocess=pre)[0],
             "int8_badcalib": quantize_anat_cnn(model, junk,
                                                preprocess=pre)[0]}
    if not args.no_fast:
        fast_model = AnatCNN.from_hparams(hparams, dtype=torch.bfloat16,
                                          dilated=False,
                                          trailing_relu=False).to(device)
        fast_model.load_state_dict(trained)
        cores["fast"] = _float_serve(fast_model, pre)

    comp = compare_serve_cores(cores, evald, 3, batch_size=args.batch,
                               bootstrap=args.bootstrap, device=device)
    _report(results, "flagship", comp, "flagship serve-path quality "
            "(labeled synthetic eval set)")


def _fusion_phase(args, results, device="cuda"):
    from multimodal_alzheimer_tpu_torch.data.synthetic import (
        make_labeled_volumes,
    )
    from multimodal_alzheimer_tpu_torch.inference.quality import (
        compare_serve_cores,
    )
    from multimodal_alzheimer_tpu_torch.inference.quantize import (
        fold_all_modalities_fusion,
        quantize_all_modalities_fusion,
    )
    from multimodal_alzheimer_tpu_torch.models.fusion_models.all_modalities_fusion import (  # noqa: E501
        AllModalitiesFusion,
    )
    from multimodal_alzheimer_tpu_torch.models.mri_models.anat_cnn import (
        AnatCNN,
    )
    from multimodal_alzheimer_tpu_torch.models.pet_models.pet_cnn import (
        SmallPETCNN,
    )
    from multimodal_alzheimer_tpu_torch.models.tabular_models.tabular_mlp import (  # noqa: E501
        TabularMLP,
    )
    from multimodal_alzheimer_tpu_torch.ops.normalization import (
        batched_normalize_mri,
        normalize_pet,
    )
    from multimodal_alzheimer_tpu_torch.train.checkpoint import (
        graft_params,
        sync_tower_duplicates,
    )
    from multimodal_alzheimer_tpu_torch.train.driver import fusion_optimizer

    shape = tuple(args.volume_shape)
    mods = ("mri", "pet1451", "tabular")
    train = make_labeled_volumes(args.train_n, shape, seed=args.seed + 10,
                                 contrast=args.contrast,
                                 contrast_jitter=args.contrast,
                                 modalities=mods)
    evald = make_labeled_volumes(args.eval_n, shape, seed=args.seed + 11,
                                 contrast=args.contrast,
                                 contrast_jitter=args.contrast,
                                 modalities=mods)
    pet_mean = float(train["pet1451"].mean())
    pet_std = float(train["pet1451"].std())
    # three tower fits + the fusion fit + the serve evals all gather from
    # one device copy
    for d in (train, evald):
        _on_device(d, ("mri", "mri_mask", "pet1451", "tabular"), device)

    def pre(batch):
        # tower fits see single-modality sub-batches; the fusion sees all
        out = dict(batch)
        if "mri" in out:
            out["mri"] = batched_normalize_mri(
                out["mri"].to(torch.float32),
                out.pop("mri_mask").to(torch.float32),
                {"per_scan_norm": "min_max"}, 0.99)
        if "pet1451" in out:
            out["pet1451"] = normalize_pet(
                out["pet1451"].to(torch.float32), pet_mean, pet_std)
        return out

    if min(shape) >= 32:
        pet_hp = {"n_classes": 3, "conv_out": (8, 16, 32, 64),
                  "filter_size": (5, 5, 3, 3), "linear_out": 64}
    else:  # smoke-scale volumes can't feed the 4-pool production tower
        pet_hp = {"n_classes": 3, "conv_out": (8, 16),
                  "filter_size": (5, 3), "linear_out": 32}
    mri_hp = {"n_classes": 3, "resnet_depth": args.depth, "linear_out": ()}
    tab_hp = {"n_classes": 3, "hidden": (256, 1024)}
    hp = {"n_classes": 3, "lr": args.lr, "lr_pretrained": None,
          "batch_size": args.batch, "max_epochs": args.epochs,
          "early_stopping_patience": args.epochs,
          "reduce_factor_lr_schedule": None, "loss_class_weights": None}
    torch.manual_seed(args.seed)
    fusion = AllModalitiesFusion.from_hparams(
        hp, {"n_classes": 3}, {"n_classes": 3}, {"n_classes": 3},
        pet_hp, mri_hp, tab_hp, dtype=torch.bfloat16)

    # Stage-1 towers pretrained on the same labels (quick fits), then the
    # fusion heads train frozen-tower — the reference's default regime.
    def tower_state(model_cls, hparams, keys, **overrides):
        sub = {k: train[k] for k in keys + ("label",)}
        sub_eval = {k: evald[k] for k in keys + ("label",)}
        hparams = dict(hparams, lr=args.lr, batch_size=args.batch,
                       max_epochs=args.epochs,
                       early_stopping_patience=args.epochs,
                       reduce_factor_lr_schedule=None,
                       loss_class_weights=None)
        model = model_cls.from_hparams(hparams, dtype=torch.bfloat16,
                                       **overrides)
        return _train_model(model, hparams, sub, sub_eval, pre,
                            seed=args.seed, device=device)

    pet_state = tower_state(SmallPETCNN, pet_hp, ("pet1451",))
    # quirk-OFF for the fit (see the flagship note); the fusion's own
    # internal tower keeps the default head — it consumes the embedding
    # taps, which sit before the trailing ReLU, so the grafted weights
    # feed it identically either way
    mri_state = tower_state(AnatCNN, dict(mri_hp, batchnorm_begin=False),
                            ("mri", "mri_mask"), trailing_relu=False)
    tab_state = tower_state(TabularMLP, tab_hp, ("tabular",))

    # stage-1 towers under every stage-2 sub-model (the loading layout of
    # train_all_modalities_fusion.py; stage-2 heads stay at init — stage 3
    # trains on their projections of the trained tower embeddings, enough
    # signal for a serve-path comparison)
    fusion.to(device)
    fusion.load_state_dict(sync_tower_duplicates(graft_params(
        fusion.state_dict(), {
            "model_anat_pet/pet_model": pet_state,
            "model_anat_pet/mri_model": mri_state,
            "model_anat_tab/mri_model": mri_state,
            "model_anat_tab/tab_model": tab_state,
            "model_pet_tab/pet_model": pet_state,
            "model_pet_tab/tab_model": tab_state,
        })))
    _train_model(fusion, hp, train, evald, pre, seed=args.seed,
                 device=device,
                 optimizer=fusion_optimizer(hp, ("stage3out", "cls3"),
                                            fusion))

    calib = [{k: v[:args.batch] for k, v in train.items()
              if k != "label"}]
    cores = {
        "float": _float_serve(fusion, pre),
        # BN-folding through three towers + external-tower hooks is
        # strictly more algebra than the single-model fold, so it gets
        # its own quality row
        "folded": fold_all_modalities_fusion(fusion, preprocess=pre)[0],
        "int8_mri": quantize_all_modalities_fusion(
            fusion, calib, preprocess=pre)[0],
        "int8_mri_pet": quantize_all_modalities_fusion(
            fusion, calib, preprocess=pre, quantize_pet=True)[0],
    }
    comp = compare_serve_cores(cores, evald, 3, batch_size=args.batch,
                               bootstrap=args.bootstrap, device=device)
    _report(results, "fusion", comp, "3-stage fusion serve-path quality")


def main(argv=None, device="cuda"):
    """Run the study on ``device`` (the card unless the caller asks for the
    CPU); prints and returns the JSON record."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--volume-shape", type=int, nargs=3,
                        default=(91, 109, 91), metavar=("D", "H", "W"))
    parser.add_argument("--depth", type=int, default=18)
    parser.add_argument("--train-n", type=int, default=384)
    parser.add_argument("--eval-n", type=int, default=1024)
    parser.add_argument("--batch", type=int, default=16)
    parser.add_argument("--epochs", type=int, default=12)
    parser.add_argument("--lr", type=float, default=3e-4)
    parser.add_argument("--contrast", type=float, default=0.3)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--bootstrap", type=int, default=1000,
                        help="bootstrap draws for CIs (reference protocol: 1000)")
    parser.add_argument("--no-fast", action="store_true")
    parser.add_argument("--fusion", action="store_true",
                        help="also run the 3-stage fusion phase")
    parser.add_argument("--skip-flagship", action="store_true")
    args = parser.parse_args(argv)

    from multimodal_alzheimer_tpu_torch.utils.device import resolve_device

    device = resolve_device(device)
    results: dict = {"volume_shape": list(args.volume_shape),
                     "depth": args.depth, "train_n": args.train_n,
                     "eval_n": args.eval_n, "epochs": args.epochs}
    if not args.skip_flagship:
        _flagship_phase(args, results, device)
    if args.fusion:
        _fusion_phase(args, results, device)
    record = {"metric": "serve_quality", **results}
    print(json.dumps(record))
    return record


if __name__ == "__main__":
    main()
