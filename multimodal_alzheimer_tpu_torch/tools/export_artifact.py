"""Checkpoint -> serving-artifact exporter (the deployment CLI).

Port of the JAX package's ``tools/export_artifact.py``, function for
function. One command takes a port checkpoint directory
(``train/checkpoint.py`` layout: ``state.pt`` + embedded hparams) and
writes a ``torch.export`` artifact (``inference/export.py``, weights baked
in) that ``inference.export.load_exported`` serves without the model's
Python code. The artifact is specialised to the example batch's shapes and
to the device it was made on; its kernels are the port's custom ops
(``mmalz_port::*``), which ``load_exported`` registers before it loads.

Every model family exports (the loaders of the ``inference/test_*.py``
scripts; fusion checkpoints resolve their stage-1/2 sub-checkpoints through
the embedded paths). Modes:
  * ``float``  — the model's eval graph.
  * ``folded`` — BN-folded graph (exact algebra; bf16 convolutions) —
    families with a Med3D MRI backbone.
  * ``int8``   — PTQ serve (``inference/quantize.py``): per-out-channel
    int8 weights, int8 activation dataflow through the int8 convolution
    kernel, float32 head. REQUIRES ``--calib file.npz`` holding
    representative RAW inputs (>= ``--batch`` rows); ``--synthetic-calib``
    overrides for tests/demos. Families with an MRI backbone quantize it;
    ``pet_cnn``/``pet_resnet`` quantize their own tower; ``--int8-pet``
    also quantizes the PET tower inside PET-consuming fusions.

Preprocessing is fused into the artifact from the checkpoint's own
hparams (quantile min-max at its ``norm_percentile`` for MRI, through the
min-max kernels — reference dataloader.py:261-270 — split-stats z-score for
PET, the all-scan MRI stats for the early/featuremap families), so
artifacts consume RAW batches: {'mri', 'mri_mask'} / {'pet1451'} /
{'tabular'} as the family requires, shaped ``--batch x --volume-shape``.
``--no-preprocess`` exports the bare model graph instead.

Examples:
  python -m multimodal_alzheimer_tpu_torch.tools.export_artifact \\
      runs/mri_ckpt --model anat_cnn --mode int8 --calib calib.npz \\
      --out mri_int8.pt2
  python -m multimodal_alzheimer_tpu_torch.tools.export_artifact \\
      runs/stage3_ckpt --model all_mod_fusion --mode folded --batch 64 \\
      --out fusion.pt2

``main(argv, device="cuda")`` runs on the card unless the caller asks for
the CPU.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

# Reference PET split stats (train_pet_cnn.py:77-78); used only when the
# checkpoint hparams carry no norm_mean/norm_std.
PET_MEAN, PET_STD = 0.5145, 0.5383


def _pet_stats(hparams, override):
    if override is not None:
        return override
    if "norm_mean" in hparams:
        return float(hparams["norm_mean"]), float(hparams["norm_std"])
    return PET_MEAN, PET_STD


# --------------------------------------------------------------------------
# Model registry: name -> loader(checkpoint, pet_stats_override) returning
#   (model, state_dict, norm_spec, inputs)
# norm_spec: {'pet': (mean, std)|None, 'mri': cfg-dict|None, 'quantile': q}
# inputs: subset of {'mri', 'pet', 'tabular'} the serving batch carries.
# --------------------------------------------------------------------------

def _load_anat_cnn(checkpoint, pet_override):
    from multimodal_alzheimer_tpu_torch.models.mri_models.anat_cnn import (
        AnatCNN,
    )
    from multimodal_alzheimer_tpu_torch.train.checkpoint import (
        load_checkpoint,
    )

    state_dict, hparams, _ = load_checkpoint(checkpoint)
    norm = {"pet": None, "mri": {"per_scan_norm": "min_max"},
            "quantile": float(hparams.get("norm_percentile", 0.99))}
    return AnatCNN.from_hparams(hparams), state_dict, norm, {"mri"}


def _load_pet_cnn(checkpoint, pet_override):
    from multimodal_alzheimer_tpu_torch.models.pet_models.pet_cnn import (
        SmallPETCNN,
    )
    from multimodal_alzheimer_tpu_torch.train.checkpoint import (
        load_checkpoint,
    )

    state_dict, hparams, _ = load_checkpoint(checkpoint)
    norm = {"pet": _pet_stats(hparams, pet_override), "mri": None,
            "quantile": 0.99}
    return SmallPETCNN.from_hparams(hparams), state_dict, norm, {"pet"}


def _load_pet_resnet(checkpoint, pet_override):
    from multimodal_alzheimer_tpu_torch.models.pet_models.pet_resnet_cnn import (  # noqa: E501
        PETResNetCNN,
    )
    from multimodal_alzheimer_tpu_torch.train.checkpoint import (
        load_checkpoint,
    )

    state_dict, hparams, _ = load_checkpoint(checkpoint)
    norm = {"pet": _pet_stats(hparams, pet_override), "mri": None,
            "quantile": 0.99}
    return PETResNetCNN.from_hparams(hparams), state_dict, norm, {"pet"}


def _load_tabular(checkpoint, pet_override):
    from multimodal_alzheimer_tpu_torch.models.tabular_models.tabular_mlp import (  # noqa: E501
        TabularMLP,
    )
    from multimodal_alzheimer_tpu_torch.train.checkpoint import (
        load_checkpoint,
    )

    state_dict, hparams, _ = load_checkpoint(checkpoint)
    norm = {"pet": None, "mri": None, "quantile": 0.99}
    return TabularMLP.from_hparams(hparams), state_dict, norm, {"tabular"}


def _stage1_norm(pet_hp, mri_hp, pet_override):
    from multimodal_alzheimer_tpu_torch.train.driver import (
        stage1_normalizations,
    )

    pet_n, mri_n, q = stage1_normalizations(pet_hp, mri_hp)
    pet = None
    if pet_n is not None:
        pet = (pet_override if pet_override is not None
               else (pet_n["mean"], pet_n["std"]))
    return {"pet": pet, "mri": mri_n, "quantile": q}


def _load_anat_pet_fusion(checkpoint, pet_override):
    from multimodal_alzheimer_tpu_torch.inference.test_anat_pet_fusion import (  # noqa: E501
        load_fusion,
    )

    model, state_dict, _, pet_hp, mri_hp = load_fusion(checkpoint)
    return (model, state_dict, _stage1_norm(pet_hp, mri_hp, pet_override),
            {"pet", "mri"})


def _load_mri_tab_fusion(checkpoint, pet_override):
    from multimodal_alzheimer_tpu_torch.inference.test_mri_tab_fusion import (  # noqa: E501
        load_fusion,
    )

    model, state_dict, _, mri_hp = load_fusion(checkpoint)
    return (model, state_dict, _stage1_norm(None, mri_hp, pet_override),
            {"mri", "tabular"})


def _load_pet_tab_fusion(checkpoint, pet_override):
    from multimodal_alzheimer_tpu_torch.inference.test_pet_tab_fusion import (  # noqa: E501
        load_fusion,
    )

    model, state_dict, _, pet_hp = load_fusion(checkpoint)
    return (model, state_dict, _stage1_norm(pet_hp, None, pet_override),
            {"pet", "tabular"})


def _load_all_mod_fusion(checkpoint, pet_override):
    from multimodal_alzheimer_tpu_torch.inference.test_all_mod_fusion import (  # noqa: E501
        load_fusion,
    )

    model, state_dict, _, pet_hp, mri_hp = load_fusion(checkpoint)
    return (model, state_dict, _stage1_norm(pet_hp, mri_hp, pet_override),
            {"pet", "mri", "tabular"})


def _all_scan_norm(checkpoint, pet_override):
    from multimodal_alzheimer_tpu_torch.models.fusion_models.train_early_fusion import (  # noqa: E501
        MRI_ALL_SCAN_STATS,
    )
    from multimodal_alzheimer_tpu_torch.train.checkpoint import (
        load_checkpoint,
    )

    state_dict, hparams, _ = load_checkpoint(checkpoint)
    norm = {"pet": _pet_stats(hparams, pet_override),
            "mri": {"all_scan_norm": MRI_ALL_SCAN_STATS[hparams["n_classes"]]},
            "quantile": 0.99}
    return state_dict, hparams, norm


def _load_early_fusion(checkpoint, pet_override):
    from multimodal_alzheimer_tpu_torch.models.fusion_models.early_fusion import (  # noqa: E501
        PETMRIEarlyFusion,
    )

    state_dict, hparams, norm = _all_scan_norm(checkpoint, pet_override)
    return (PETMRIEarlyFusion.from_hparams(hparams), state_dict, norm,
            {"pet", "mri"})


def _load_featuremap_fusion(checkpoint, pet_override):
    from multimodal_alzheimer_tpu_torch.models.fusion_models.featuremap_fusion import (  # noqa: E501
        PETMRIFeatureMapFusion,
    )

    state_dict, hparams, norm = _all_scan_norm(checkpoint, pet_override)
    return (PETMRIFeatureMapFusion.from_hparams(hparams), state_dict, norm,
            {"pet", "mri"})


REGISTRY = {
    "anat_cnn": _load_anat_cnn,
    "pet_cnn": _load_pet_cnn,
    "pet_resnet": _load_pet_resnet,
    "tabular": _load_tabular,
    "anat_pet_fusion": _load_anat_pet_fusion,
    "mri_tab_fusion": _load_mri_tab_fusion,
    "pet_tab_fusion": _load_pet_tab_fusion,
    "all_mod_fusion": _load_all_mod_fusion,
    "early_fusion": _load_early_fusion,
    "featuremap_fusion": _load_featuremap_fusion,
}

# Which (family, mode) pairs have an optimized graph. Everything serves
# in float; folded/int8 need a Med3D MRI backbone (or, for the PET
# towers, their own quantizer).
FOLDED = {"anat_cnn", "anat_pet_fusion", "mri_tab_fusion",
          "all_mod_fusion"}
INT8 = FOLDED | {"pet_cnn", "pet_resnet"}


def _build_preprocess(norm):
    """Fused on-device normalization matching the eval harness: the MRI
    min-max through the min-max kernels on the card."""
    from multimodal_alzheimer_tpu_torch.ops.normalization import (
        batched_normalize_mri,
        normalize_pet,
    )

    def pre(batch):
        out = dict(batch)
        if norm["mri"] is not None and "mri" in out:
            out["mri"] = batched_normalize_mri(
                out["mri"], out.pop("mri_mask", None), norm["mri"],
                norm["quantile"], qminmax=out.pop("mri_qminmax", None))
        if norm["pet"] is not None and "pet1451" in out:
            mean, std = norm["pet"]
            out["pet1451"] = normalize_pet(out["pet1451"], mean, std)
        return out

    return pre


def _example_batch(inputs, norm, batch, shape, rng):
    """The synthetic example batch, drawn with numpy in the JAX tool's
    order, so that ``--synthetic-calib`` calibrates on the same data."""
    ex = {}
    if "mri" in inputs:
        ex["mri"] = rng.normal(900, 400, (batch,) + shape).astype(np.float32)
        if norm["mri"] is not None and "per_scan_norm" in norm["mri"]:
            ex["mri_mask"] = (rng.random((batch,) + shape) > 0.35).astype(
                np.float32)
    if "pet" in inputs:
        ex["pet1451"] = rng.normal(0.5, 0.5, (batch,) + shape).astype(
            np.float32)
    if "tabular" in inputs:
        ex["tabular"] = rng.normal(size=(batch, 9)).astype(np.float32)
    return ex


def _build_serve(mode, model_name, model, preprocess, calib_batches,
                 int8_pet):
    from multimodal_alzheimer_tpu_torch.inference import quantize as Q

    if mode == "float":
        def serve(batch):
            pre = preprocess(batch) if preprocess else batch
            logits = model(pre)["logits"].to(torch.float32)
            return {"logits": logits, "probs": torch.softmax(logits, -1)}
        return serve

    if mode == "folded":
        if model_name not in FOLDED:
            raise SystemExit(
                f"--mode folded: {model_name} has no BN'd Med3D backbone "
                f"to fold — use float (or int8 where supported)")
        if model_name == "anat_cnn":
            serve, _ = Q.fold_anat_cnn(model, preprocess=preprocess)
        elif model_name == "all_mod_fusion":
            serve, _ = Q.fold_all_modalities_fusion(model,
                                                    preprocess=preprocess)
        else:
            serve, _ = Q.fold_mri_fusion(model, preprocess=preprocess)
        return serve

    if mode == "int8":
        if model_name not in INT8:
            raise SystemExit(f"--mode int8: no quantized path for "
                             f"{model_name} — use float")
        if model_name in ("pet_cnn",):
            serve, _ = Q.quantize_pet_cnn(model, calib_batches,
                                          preprocess=preprocess)
        elif model_name in ("pet_resnet", "anat_cnn"):
            serve, _ = Q.quantize_anat_cnn(model, calib_batches,
                                           preprocess=preprocess)
        elif model_name == "all_mod_fusion":
            serve, _ = Q.quantize_all_modalities_fusion(
                model, calib_batches, preprocess=preprocess,
                quantize_pet=int8_pet)
        else:
            serve, _ = Q.quantize_mri_fusion(
                model, calib_batches, preprocess=preprocess,
                quantize_pet=int8_pet and model_name == "anat_pet_fusion")
        return serve

    raise SystemExit(f"unknown --mode {mode!r}")


def main(argv=None, device="cuda"):
    parser = argparse.ArgumentParser(
        description="Export a trained checkpoint to a torch.export "
                    "serving artifact")
    parser.add_argument("checkpoint", help="checkpoint directory "
                        "(train/checkpoint.py layout)")
    parser.add_argument("--model", required=True, choices=sorted(REGISTRY))
    parser.add_argument("--out", required=True, help="artifact output path")
    parser.add_argument("--mode", default="float",
                        choices=["float", "folded", "int8"])
    parser.add_argument("--batch", type=int, default=128,
                        help="compiled serving batch size")
    parser.add_argument("--volume-shape", type=int, nargs=3,
                        default=(91, 109, 91), metavar=("D", "H", "W"))
    parser.add_argument("--calib", default=None,
                        help="npz of raw input batches for int8 "
                             "calibration (keys as the serving batch; "
                             ">= --batch rows of representative held-out "
                             "data). REQUIRED for --mode int8 unless "
                             "--synthetic-calib is passed")
    parser.add_argument("--synthetic-calib", action="store_true",
                        help="int8 only: knowingly calibrate on the "
                             "synthetic example batch (tests/demos; "
                             "activation scales will not match "
                             "production data)")
    parser.add_argument("--pet-stats", type=float, nargs=2, default=None,
                        metavar=("MEAN", "STD"),
                        help="override the checkpoint's PET split stats")
    parser.add_argument("--int8-pet", action="store_true",
                        help="int8 fusions: also quantize the PET tower")
    parser.add_argument("--no-preprocess", action="store_true",
                        help="export the bare model graph (inputs already "
                             "normalized)")
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)

    from multimodal_alzheimer_tpu_torch.inference.export import (
        export_serve_fn,
        load_exported,
    )
    from multimodal_alzheimer_tpu_torch.utils.device import resolve_device

    device = resolve_device(device)
    pet_override = tuple(args.pet_stats) if args.pet_stats else None
    model, state_dict, norm, inputs = REGISTRY[args.model](args.checkpoint,
                                                           pet_override)
    model.load_state_dict(state_dict)
    model = model.to(device).eval()
    preprocess = None if args.no_preprocess else _build_preprocess(norm)

    rng = np.random.default_rng(args.seed)
    example = _example_batch(inputs, norm, args.batch,
                             tuple(args.volume_shape), rng)
    if args.calib:
        with np.load(args.calib) as z:
            calib = [{k: z[k] for k in z.files}]
        # Validate every batched array's leading dim (a 0-d entry has no
        # rows; mismatched leading dims would silently mis-slice below).
        dims = {k: v.shape[0] for k, v in calib[0].items() if v.ndim}
        if not dims:
            raise SystemExit("--calib npz holds no batched arrays")
        if len(set(dims.values())) > 1:
            raise SystemExit(
                f"--calib arrays disagree on the leading (batch) dim: "
                f"{dims}")
        rows = next(iter(dims.values()))
        if rows < args.batch:
            # A short npz would silently compile the artifact at the
            # smaller batch while the summary still claimed --batch.
            raise SystemExit(
                f"--calib holds {rows} rows < --batch {args.batch}; "
                f"the artifact's serving signature is fixed at export")
        example = {k: (v[:args.batch] if v.ndim else v)
                   for k, v in calib[0].items()}
    else:
        # Scoped to supported families: unsupported ones get the clearer
        # "no quantized path" error from _build_serve below.
        if (args.mode == "int8" and args.model in INT8
                and not args.synthetic_calib):
            # absmax activation scales calibrated on non-representative
            # inputs are exactly how PTQ quietly degrades in production.
            raise SystemExit(
                "--mode int8 needs --calib file.npz with representative "
                "RAW inputs (>= --batch rows, keys as the serving "
                "batch: a few hundred held-out training samples is "
                "plenty — absmax scales saturate quickly). To knowingly "
                "calibrate on the synthetic example batch (tests/demos "
                "only; activation scales will NOT match production "
                "data), pass --synthetic-calib.")
        calib = [example]
    example = {k: torch.as_tensor(v).to(device) for k, v in example.items()}
    calib = [{k: torch.as_tensor(v).to(device) for k, v in c.items()}
             for c in calib]

    serve = _build_serve(args.mode, args.model, model, preprocess, calib,
                         args.int8_pet)
    blob = export_serve_fn(serve, example)
    with open(args.out, "wb") as f:
        f.write(blob)

    # Reload smoke check: the artifact must reproduce the live graph.
    art = load_exported(blob)(example)
    with torch.no_grad():
        live = serve(example)
    drift = float((art["logits"].float() - live["logits"].float()).abs()
                  .max())
    print(f"wrote {args.out}: {len(blob) / 1e6:.1f} MB, mode={args.mode}, "
          f"batch={args.batch}, reload max|dlogit|={drift:.2e}",
          file=sys.stderr)
    if not np.isfinite(drift) or drift > 1e-3:
        raise SystemExit("artifact reload drift above tolerance")
    return args.out


if __name__ == "__main__":
    main()
