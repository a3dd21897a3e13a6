"""Stage-3 fusion over two gloo ranks (after tests/test_parallel_fusion.py).

The three-tower ``AllModalitiesFusion`` with its (B, 9) tabular input, in
the reference-default regime (frozen towers, one shared forward) for 2 SGD
steps and fully unfrozen (gradients through every tower, duplicate
forwards) for 1, at batch 8 of 16^3 volumes split over two spawned ranks
(``tests/torch_dp_ranks.py``): loss, parameters and BatchNorm statistics
equal the one-process step at JAX's DP tolerances (loss rtol 1e-5; the
rest rtol 2e-4, atol 1e-5). The one-process port is held to JAX's stage 3
in tests/test_torch_stage3.py.
"""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

from multimodal_alzheimer_tpu_torch.models.fusion_models.all_modalities_fusion import (  # noqa: E501
    AllModalitiesFusion,
)
from multimodal_alzheimer_tpu_torch.parallel.launch import run_ranks
from multimodal_alzheimer_tpu_torch.train.checkpoint import (
    sync_tower_duplicates,
)
from multimodal_alzheimer_tpu_torch.utils.seeding import make_generator
from torch_dp_ranks import cases_on_ranks, run_case
from torch_threads import torch_threads  # noqa: F401 (autouse)

PET_HP = {"n_classes": 3, "conv_out": (4,), "filter_size": (3,),
          "linear_out": 8}
MRI_HP = {"n_classes": 3, "resnet_depth": 10}
TAB_HP = {"n_classes": 3, "hidden": (16, 32)}
HP2 = {"n_classes": 3}
UNFROZEN2 = {"n_classes": 3, "lr_pretrained": 1e-5}
REGIMES = {
    "frozen_shared": ({"n_classes": 3, "lr": 1e-3, "lr_pretrained": None},
                      HP2, 2),
    "unfrozen": ({"n_classes": 3, "lr": 1e-3, "lr_pretrained": 1e-5},
                 UNFROZEN2, 1),
}


def _batch(n=8, s=16, seed=0):
    rng = np.random.default_rng(seed)
    return {
        "pet1451": rng.normal(size=(n, s, s, s)).astype(np.float32),
        "mri": rng.normal(size=(n, s, s, s)).astype(np.float32),
        "tabular": rng.normal(size=(n, 9)).astype(np.float32),
        "label": rng.integers(0, 3, n).astype(np.int32),
    }


def _case(regime):
    hp3, hp2, steps = REGIMES[regime]
    hp = (hp3, hp2, hp2, hp2, PET_HP, MRI_HP, TAB_HP)
    model = AllModalitiesFusion.from_hparams(*hp,
                                             generator=make_generator(0))
    assert model.share_towers == (regime == "frozen_shared")
    return {"kind": "stage3", "hp": hp,
            "state": sync_tower_duplicates(model.state_dict()),
            "batch": _batch(), "steps": steps, "lr": 1e-2,
            "criterion": {"loss_class_weights": [0.5, 0.3, 0.2]}}


@pytest.fixture(scope="module")
def dp():
    cases = {regime: _case(regime) for regime in REGIMES}
    with ThreadPoolExecutor(1) as pool:  # the one-process runs meanwhile
        one = pool.submit(lambda: {name: run_case(case)
                                   for name, case in cases.items()})
        ranks = run_ranks(cases_on_ranks, 2, "gloo", cases, device="cpu",
                          timeout=300)
        return one.result(), ranks


@pytest.mark.parametrize("regime", sorted(REGIMES))
def test_stage3_dp_matches_single_device(dp, regime):
    one, ranks = dp
    want = one[regime]
    for rank in ranks:
        got = rank[regime]
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5)
        assert set(got["state"]) == set(want["state"])
        for key, value in want["state"].items():
            np.testing.assert_allclose(got["state"][key].numpy(),
                                       value.numpy(), rtol=2e-4, atol=1e-5,
                                       err_msg=key)
