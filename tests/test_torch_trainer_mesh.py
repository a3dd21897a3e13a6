"""``Trainer``, ``DataLoader`` and ``run_training`` over two gloo ranks
(after tests/test_trainer_mesh.py).

One spawn (``tests/torch_dp_ranks.py``) runs, on each rank:

* ``Trainer.fit`` of ``SmallPETCNN`` over 45 separable volumes at batch 16
  (a ragged tail of 13, which every rank runs whole), 8 epochs: the ranks
  agree on every val loss and parameter, the val F1 passes 0.5, and only
  rank 0 holds checkpoint managers; ``Trainer.test``'s metrics and
  bootstrap, computed on rank 0, reach both ranks;
* a sharded, shuffled ``DataLoader`` over 21 samples at batch 8 with
  ``pad_last`` (every batch a shard, the tail zero-padded, ``sample_mask``
  marking the real rows) and without it (the 5-row tail whole on every
  rank): the ranks' rows put together are the one-process loader's batches;
* ``run_training(mesh=)`` of a ResNet-10 ``AnatCNN`` on a synthetic split:
  rank 0 alone makes the logger and writes the checkpoints, once.
"""

import os

import numpy as np
import pytest
import torch

from multimodal_alzheimer_tpu_torch.data.pipeline import DataLoader
from multimodal_alzheimer_tpu_torch.data.synthetic import (
    write_synthetic_split,
)
from multimodal_alzheimer_tpu_torch.parallel.launch import run_ranks
from torch_dp_ranks import SeparableVolumes, trainer_mesh_on_ranks
from torch_threads import torch_threads  # noqa: F401 (autouse)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    root = tmp_path_factory.mktemp("mesh")
    data_dir = str(root / "data")
    write_synthetic_split(data_dir, n_subjects=(10, 4, 4), seed=1,
                          volume_shape=(12, 14, 12))
    out = run_ranks(trainer_mesh_on_ranks, 2, "gloo", str(root / "ckpt"),
                    data_dir, str(root / "logs"), device="cpu", timeout=300)
    return root, out


def test_trainer_fit_with_mesh(ranks):
    root, out = ranks
    first, second = out[0]["fit"], out[1]["fit"]
    assert np.isfinite(first["last_val_loss"])
    assert len(first["history"]) >= 1
    assert first["history"] == second["history"]
    for name, value in first["params"].items():
        torch.testing.assert_close(second["params"][name], value, rtol=0,
                                   atol=0)
    assert first["val_f1"] > 0.5 and second["val_f1"] == first["val_f1"]
    assert os.listdir(root / "ckpt")
    # the test's F1, MCC and bootstrap from rank 0, broadcast
    assert first["test"] == second["test"]
    assert np.isfinite(first["test"]["test_mcc_epoch_boot"])
    assert os.listdir(root / "ckpt_test") == ["confusion_matrix.json"]


@pytest.mark.parametrize("pad_last", [True, False])
def test_sharded_loader_pads_and_masks(ranks, pad_last):
    _, out = ranks
    key = "padded" if pad_last else "ragged"
    one = list(DataLoader(SeparableVolumes(21, 2, shape=(2, 2, 2)), 8,
                          shuffle=True, seed=3, num_workers=2, device="cpu",
                          pad_last=pad_last))
    assert len(out[0][key]) == len(out[1][key]) == len(one) == 3
    for i, want in enumerate(one):
        parts = [out[r][key][i] for r in range(2)]
        if pad_last or i < 2:
            assert [p["offset"] for p in parts] == [0, 4]
            assert all(p["global_rows"] == 8 for p in parts)
            got = {k: torch.cat([p["arrays"][k] for p in parts])
                   for k in want}
        else:  # the 5-row tail runs whole on every rank
            assert all(p["global_rows"] is None for p in parts)
            got = parts[0]["arrays"]
            for k, v in parts[1]["arrays"].items():
                torch.testing.assert_close(v, got[k], rtol=0, atol=0)
        assert set(got) == set(want)
        for k, v in want.items():
            torch.testing.assert_close(got[k], v, rtol=0, atol=0)
    if pad_last:
        mask = torch.cat([p["arrays"]["sample_mask"] for p in
                          (out[0][key][2], out[1][key][2])])
        np.testing.assert_array_equal(mask.numpy(), [1] * 5 + [0] * 3)


def test_run_training_with_mesh_checkpoints_once(ranks):
    root, out = ranks
    first, second = out[0]["run_training"], out[1]["run_training"]
    assert np.isfinite(first["last_val_loss"])
    assert first["history"] == second["history"]
    assert (first["has_logger"], first["managers"]) == (True, 2)
    assert (second["has_logger"], second["managers"]) == (False, 0)
    versions = os.listdir(root / "logs" / "dp")
    assert len(versions) == 1
    assert os.listdir(root / "logs" / "dp" / versions[0] / "checkpoints")
