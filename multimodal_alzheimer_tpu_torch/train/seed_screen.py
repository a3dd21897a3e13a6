"""K-seed screening for unstable quick fits (the fast mode's remedy).

Port of ``multimodal_alzheimer_tpu/train/seed_screen.py``. The strided fast
mode (``AnatCNN(dilated=False)``) is the repo's fastest trainer, but its
from-scratch quick fits are seed-bimodal (round-4 study: half the seeds
collapse). The K-trial trainer makes the remedy cheap: run K seeds of the
SAME config for a few epochs, score each seed's best-val epoch, and
continue training only the winner, from its best-epoch snapshot rather
than a re-init, so the screen epochs are not wasted and the selection
transfers exactly.

The screen takes any model the K-trial trainer drives;
``models/mri_models/train_anat_cnn.train_anat_fast`` wires it into the
fast-mode MRI path.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np

from multimodal_alzheimer_tpu_torch.train import vmap_hpo


def screen_seeds(model, train_data: dict, val_data: dict, *,
                 lr: float, batch_size: int, epochs: int,
                 class_weights, seeds: Sequence[int] = tuple(range(8)),
                 l2_reg: float = 0.0, fl_gamma=None, base_seed: int = 5,
                 apply_fn: Optional[Callable] = None,
                 extra_hparams: Optional[dict] = None,
                 lr_select: Optional[Callable] = None,
                 mesh=None, device="cuda") -> dict:
    """Fit K init seeds of one config; return the winner.

    ``train_data``/``val_data``: stacked arrays with 'label' (the
    ``vmap_hpo`` data convention). Every seed sees identical data, lr and
    budget; only the init and dropout streams differ (``trial_seed``).

    ``lr_select`` (+ ``extra_hparams`` for the values it reads, e.g.
    ``{'lr_pretrained': 1e-6}``) goes to ``run_parallel_trials`` so the
    screen trains under the SAME optimizer regime as the continuation, e.g.
    the MRI head-at-lr / backbone-at-lr_pretrained split.

    Returns ``{'winner_seed', 'winner_index', 'winner_variables',
    'best_val' (K,), 'val_history' (epochs, K), 'seeds'}``, where
    ``winner_variables`` is the winning seed's ``state_dict`` (parameters
    and BatchNorm statistics, on the CPU) at its best-val epoch: hand it to
    ``run_training``'s ``variables_transform`` to continue the fit. Raises
    if no seed reaches a finite val loss (an all-diverged screen must not
    hand back an init snapshot as a "winner").
    """
    extra = dict(extra_hparams or {})
    rows = [{"lr": lr, "l2_reg": l2_reg, "dropout_p": 0.0,
             "fl_gamma": fl_gamma, "trial_seed": int(s), **extra}
            for s in seeds]
    hp = vmap_hpo.stack_trial_hparams(rows,
                                      extra_keys=tuple(sorted(extra)))
    _, info = vmap_hpo.run_parallel_trials(
        model, hp, train_data, val_data, batch_size=batch_size,
        max_epochs=epochs, patience=epochs,
        class_weights=class_weights, seed=base_seed,
        apply_fn=apply_fn or vmap_hpo.plain_apply, lr_select=lr_select,
        track_best=True, mesh=mesh, device=device)

    best_val = np.asarray(info["best_val"], np.float64)
    winner = int(np.argmin(best_val))
    if not np.isfinite(best_val[winner]):
        raise RuntimeError(
            f"seed screen: no seed reached a finite val loss in "
            f"{epochs} epochs (best_val={best_val.tolist()}) — the "
            f"config diverges; lower lr or lengthen the screen")
    params, stats = info["best_carry"]
    variables = {name: value[winner].cpu()
                 for name, value in {**params, **stats}.items()}
    return {
        "winner_seed": int(seeds[winner]),
        "winner_index": winner,
        "winner_variables": variables,
        "best_val": best_val,
        "val_history": np.asarray(info["val_history"]),
        "seeds": [int(s) for s in seeds],
    }
