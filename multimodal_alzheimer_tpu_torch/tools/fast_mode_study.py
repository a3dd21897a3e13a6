"""Fast-mode quality verdict: dilated (Med3D parity) vs strided backbone.

Port of the JAX package's root ``tools/fast_mode_study.py``, with its
flags, defaults, human lines and JSON line. The ``dilated=False`` fast mode
shrinks the layer-3/4 feature maps 64x (stride 2 where the Med3D spec keeps
stride 1 and dilation 2/4, ``models/resnet3d.py``). This study runs a
matched convergence comparison of the two arches — identical data,
budget, lr and K seeds per arch, the K seeds trained together by
``train/vmap_hpo.run_parallel_trials`` — on the labeled separable synthetic
task (``data/synthetic.make_labeled_volumes``, a spatial class signal that
survives per-scan min-max), then scores every seed's model on one held-out
eval set (``inference/quality.evaluate_serve``).

Scoring: each seed is scored at its best-val-loss epoch state
(``run_parallel_trials(track_best=True)``), what a deployment would
checkpoint, not the early-stopped final state, which sits ``patience``
non-improving epochs past the best one and can collapse there at quick-fit
lrs; the final state's F1 is reported as ``eval_f1_final`` beside it.
``screen_pick_f1[E]`` is the best-epoch eval F1 of the seed that an
E-epoch seed screen (``train/seed_screen.py``) would pick.

Outputs per arch: per-seed best val loss, eval F1/MCC, stopped epochs, wall
time of the K-seed fit. The seeds' draws are the port's own (torch
generators where JAX folds keys), so the port's numbers are its own
study, not JAX's.

    python -m multimodal_alzheimer_tpu_torch.tools.fast_mode_study   # card
CPU smoke (``main(argv, device="cpu")``): --volume-shape 12 14 12
--depth 10 --seeds 2 --train-n 32 --eval-n 16 --epochs 2 --batch 8
Human lines to stderr; ONE JSON line to stdout.
"""

from __future__ import annotations

import argparse
import copy
import json
import sys
import time

import numpy as np
import torch


def _parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    parser.add_argument("--volume-shape", type=int, nargs=3,
                        default=(91, 109, 91), metavar=("D", "H", "W"))
    parser.add_argument("--depth", type=int, default=18)
    parser.add_argument("--seeds", type=int, default=4)
    parser.add_argument("--train-n", type=int, default=192)
    parser.add_argument("--eval-n", type=int, default=96)
    parser.add_argument("--batch", type=int, default=8,
                        help="per-trial batch (K trials run vmapped: "
                             "size K*batch like one big batch)")
    parser.add_argument("--epochs", type=int, default=10)
    parser.add_argument("--patience", type=int, default=3,
                        help="early-stopping patience (< epochs so ES "
                             "can stop a collapsed run early; scoring "
                             "uses the best-epoch snapshot either way)")
    # 3e-4: lr 1e-3 is late-training-unstable for depth-18 quick fits at
    # 91^3 (collapsed final states with good best-epoch losses).
    parser.add_argument("--lr", type=float, default=3e-4)
    parser.add_argument("--contrast", type=float, default=0.5)
    parser.add_argument("--seed", type=int, default=0)
    return parser


def main(argv=None, device="cuda"):
    args = _parser().parse_args(argv)

    from multimodal_alzheimer_tpu_torch.data.synthetic import (
        make_labeled_volumes,
    )
    from multimodal_alzheimer_tpu_torch.inference.quality import (
        evaluate_serve,
    )
    from multimodal_alzheimer_tpu_torch.models.mri_models.anat_cnn import (
        AnatCNN,
    )
    from multimodal_alzheimer_tpu_torch.ops.normalization import (
        batched_normalize_mri,
    )
    from multimodal_alzheimer_tpu_torch.train import vmap_hpo
    from multimodal_alzheimer_tpu_torch.utils.device import resolve_device

    device = resolve_device(device)
    shape = tuple(args.volume_shape)

    def normed(n, seed):
        data = make_labeled_volumes(n, shape, seed=seed,
                                    contrast=args.contrast,
                                    contrast_jitter=args.contrast)
        mri = batched_normalize_mri(
            torch.from_numpy(data["mri"]).to(device),
            torch.from_numpy(data["mri_mask"]).to(device),
            {"per_scan_norm": "min_max"}, 0.99)
        return {"mri": mri, "label": torch.from_numpy(data["label"])}

    # normalization is trial- and arch-invariant: pay it once up front
    train_data = normed(args.train_n, args.seed)
    val_data = normed(args.eval_n, args.seed + 1)
    eval_data = {"mri": val_data["mri"],
                 "label": val_data["label"].numpy()}

    hp_model = {"n_classes": 3, "resnet_depth": args.depth,
                "linear_out": (), "batchnorm_begin": False, "lr": args.lr}
    rows = [{"lr": args.lr, "l2_reg": 0.0, "dropout_p": 0.0,
             "fl_gamma": None, "trial_seed": 100 + i}
            for i in range(args.seeds)]
    hp = vmap_hpo.stack_trial_hparams(rows, pad_to=args.seeds)

    results = {}
    for arch, dilated in (("dilated", True), ("fast", False)):
        # trailing_relu OFF: the parity quirk's clamped-logit dead
        # gradients wreck short synthetic fits (see tools/quality_eval.py)
        model = AnatCNN.from_hparams(hp_model, dtype=torch.bfloat16,
                                     dilated=dilated, trailing_relu=False)
        t0 = time.perf_counter()
        last, info = vmap_hpo.run_parallel_trials(
            model, hp, train_data, val_data, batch_size=args.batch,
            max_epochs=args.epochs, patience=args.patience,
            class_weights=[1 / 3, 1 / 3, 1 / 3], seed=args.seed,
            apply_fn=vmap_hpo.plain_apply, return_state=True,
            track_best=True, device=device)
        wall = time.perf_counter() - t0

        def score_states(params, stats):
            f1s, mccs = [], []
            for i in range(args.seeds):
                trial = copy.deepcopy(model).to(device).eval()
                trial.load_state_dict({**{k: v[i] for k, v in params.items()},
                                       **{k: v[i] for k, v in stats.items()}})

                def serve(batch, _m=trial):
                    logits = _m(batch)["logits"].to(torch.float32)
                    return {"logits": logits,
                            "probs": torch.softmax(logits, -1)}

                r = evaluate_serve(serve, eval_data, 3,
                                   batch_size=min(32, args.eval_n),
                                   device=device)
                f1s.append(r["f1"])
                mccs.append(r["mcc"])
            return f1s, mccs

        # deployment scoring: the best-val-loss epoch snapshot
        f1s, mccs = score_states(*info["best_carry"])
        # final ES-stopped carry, to quantify the late-collapse gap
        fparams, fstats, _ = info["carry"]
        f1s_final, _ = score_states(fparams, fstats)

        # Seed-screen oracle check (train/seed_screen.py): would picking
        # the argmin-val seed after only E epochs have selected a good
        # final model? screen_pick_f1[E] = best-epoch eval F1 of the
        # seed an E-epoch screen would choose.
        hist = np.asarray(info["val_history"])  # (epochs, K)
        screen_pick = {
            str(e): round(f1s[int(hist[:e].min(axis=0).argmin())], 4)
            for e in (1, 2, 3) if e <= hist.shape[0]}

        best_val = np.asarray(info["val_history"]).min(axis=0)
        results[arch] = {
            "best_val_loss": [round(float(v), 4) for v in best_val],
            "best_val_mean": round(float(best_val.mean()), 4),
            "eval_f1": [round(float(f), 4) for f in f1s],
            "eval_f1_mean": round(float(np.mean(f1s)), 4),
            "eval_f1_std": round(float(np.std(f1s)), 4),
            "eval_mcc_mean": round(float(np.mean(mccs)), 4),
            "eval_f1_final": [round(float(f), 4) for f in f1s_final],
            "eval_f1_final_mean": round(float(np.mean(f1s_final)), 4),
            "stopped_epoch": info["stopped_epoch"].tolist(),
            "screen_pick_f1": screen_pick,
            "fit_wall_s": round(wall, 1),
        }
        print(f"{arch}: best val loss {best_val.mean():.4f} "
              f"(per seed {np.round(best_val, 3).tolist()}), eval F1 "
              f"{np.mean(f1s):.4f}±{np.std(f1s):.4f} best-epoch "
              f"(final-state {np.mean(f1s_final):.4f}), K={args.seeds} "
              f"fit {wall:.1f}s", file=sys.stderr)

    d, f = results["dilated"], results["fast"]
    print(f"verdict: fast - dilated eval F1 delta "
          f"{f['eval_f1_mean'] - d['eval_f1_mean']:+.4f} "
          f"(K={args.seeds} seeds, same budget/lr/data); fit wall "
          f"{f['fit_wall_s']:.1f}s vs {d['fit_wall_s']:.1f}s",
          file=sys.stderr)
    print(json.dumps({"metric": "fast_mode_convergence",
                      "volume_shape": list(shape), "depth": args.depth,
                      "seeds": args.seeds, "epochs": args.epochs,
                      "patience": args.patience, "lr": args.lr,
                      "scoring": "best_epoch_snapshot",
                      "train_n": args.train_n, **results}))


if __name__ == "__main__":
    main()
