"""The port's PET entry points against the JAX package's (CPU), on a split
the port writes to disk.

``train_pet_cnn.train`` from the same converted weights as the JAX
``train``: the validation-loss history within rtol 1e-4, as
tests/test_torch_driver.py holds ``run_training``. ``train_pet_resnet_cnn
.train`` runs an epoch and its checkpoint loads back; ``test_pet_cnn.main``
evaluates the checkpoint the path registry names, with the checkpoint's PET
z-score, rendering no image.
"""

import json
import os
import sys
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_alzheimer_tpu.models.pet_models import (
    train_pet_cnn as jax_train_pet_cnn,
)
from multimodal_alzheimer_tpu.models.pet_models.pet_cnn import (
    SmallPETCNN as JaxSmallPETCNN,
)
from multimodal_alzheimer_tpu.train import driver as jax_driver
from multimodal_alzheimer_tpu_torch.data.synthetic import (
    write_synthetic_split,
)
from multimodal_alzheimer_tpu_torch.inference import test_pet_cnn
from multimodal_alzheimer_tpu_torch.models.convert import state_dict_from_flax
from multimodal_alzheimer_tpu_torch.models.pet_models import (
    train_pet_cnn,
    train_pet_resnet_cnn,
)
from multimodal_alzheimer_tpu_torch.models.pet_models.pet_cnn import (
    SmallPETCNN,
)
from multimodal_alzheimer_tpu_torch.models.pet_models.pet_resnet_cnn import (
    PETResNetCNN,
)
from multimodal_alzheimer_tpu_torch.train.checkpoint import (
    load_checkpoint,
    save_checkpoint,
)
from torch_port_helpers import Trial, random_flax_variables
from torch_threads import torch_threads  # noqa: F401 (autouse)

GRID = (16, 18, 16)
PLOTTING = ("matplotlib", "seaborn", "PIL", "pandas")


class _FixedTrial:
    """A no-dropout SmallPETCNN trial: ladder (8, 16, 32), 3^3 filters."""

    ANSWERS = {"learning_rate": 1e-4, "conv_out": "(8, 16, 32)",
               "filter_size": "(3, 3, 3, 3)", "batchnorm": True,
               "linear_out": 32, "batch_size": 8, "dropout_conv": False,
               "dropout_dense": False, "fl_gamma": None}

    def suggest_float(self, name, low, high, log=False):
        return self.ANSWERS[name]

    def suggest_categorical(self, name, choices):
        assert self.ANSWERS[name] in choices
        return self.ANSWERS[name]


@pytest.fixture(scope="module")
def split(tmp_path_factory):
    root = tmp_path_factory.mktemp("pet_split")
    return write_synthetic_split(str(root / "data"), n_subjects=(8, 6, 8),
                                 seed=6, volume_shape=GRID)


def _history(run_dir):
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        return [json.loads(line)["val_loss_epoch"] for line in f]


def test_train_pet_cnn_matches_the_jax_entry_point(split, tmp_path,
                                                   monkeypatch):
    """Two epochs at batch 4 on the split's 2-class PET rows (9 train, 11
    validation; last partial batches dropped on both sides), from the JAX
    model's weights."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("MMALZ_DATA_DIR", os.path.dirname(split["train"]))
    hp = train_pet_cnn.sample_hparams(_FixedTrial(), n_classes=2)
    hp.update(batch_size=4, max_epochs=2, best_k_checkpoints=1)
    hp_jax = dict(hp)
    assert jax_train_pet_cnn.sample_hparams(_FixedTrial(), n_classes=2) == \
        train_pet_cnn.sample_hparams(_FixedTrial(), n_classes=2)
    variables = random_flax_variables(JaxSmallPETCNN.from_hparams(hp), GRID,
                                      8, "pet1451")
    monkeypatch.setattr(jax_train_pet_cnn, "run_training", partial(
        jax_driver.run_training, num_workers=1, drop_last=True,
        variables_transform=lambda _: jax.tree.map(jnp.asarray, variables)))
    jax_last = jax_train_pet_cnn.train(hp_jax, "jax")

    last = train_pet_cnn.train(
        hp, "port", log_confusion_images=False, device="cpu", num_workers=1,
        drop_last=True,
        variables_transform=lambda sd: state_dict_from_flax(
            variables, SmallPETCNN.from_hparams(hp)))
    assert hp == hp_jax and min(hp["loss_class_weights"]) > 0
    logs = tmp_path / train_pet_cnn.LOG_DIRECTORY
    history = _history(logs / "port" / "version_0")
    assert len(history) == 2 and history[-1] == last
    np.testing.assert_allclose(history, _history(logs / "jax" / "version_0"),
                               rtol=1e-4)
    np.testing.assert_allclose(last, jax_last, rtol=1e-4)


def test_train_pet_resnet_cnn_runs_from_disk(split, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("MMALZ_DATA_DIR", os.path.dirname(split["train"]))
    hp = train_pet_resnet_cnn.sample_hparams(Trial(0))
    hp.update(resnet_depth=10, batch_size=4, max_epochs=1, fl_gamma=None,
              linear_out=(), lr_pretrained=1e-5)
    last = train_pet_resnet_cnn.train(hp, "pet_resnet",
                                      log_confusion_images=False,
                                      device="cpu", num_workers=1)
    assert np.isfinite(last)
    run = tmp_path / "lightning_logs" / "pet_resnet" / "version_0"
    names = sorted(os.listdir(run / "checkpoints"))
    assert len(names) == 2
    state_dict, hparams, _ = load_checkpoint(run / "checkpoints" / names[0])
    PETResNetCNN.from_hparams(hparams).load_state_dict(state_dict)


def test_test_pet_cnn_main_reads_the_registry(split, tmp_path, monkeypatch):
    """A port checkpoint named in path_config.yaml is evaluated on the
    paired test split with the checkpoint's PET z-score; no image is
    rendered and no plotting package imported."""
    monkeypatch.chdir(tmp_path)
    hp = dict(train_pet_cnn.sample_hparams(_FixedTrial(), n_classes=2),
              batch_size=4, loss_class_weights=[0.4, 0.6])
    model = SmallPETCNN.from_hparams(hp,
                                     generator=torch.Generator().manual_seed(1))
    save_checkpoint(tmp_path / "ckpt", model.state_dict(), hp)
    (tmp_path / "path_config.yaml").write_text(
        "relative:\n"
        f"  test_set_csv: '{split['test']}'\n"
        f"pet_cnn_2_class: '{tmp_path / 'ckpt'}'\n")
    got_model, state_dict, hparams, testset = \
        test_pet_cnn.pet_testset_and_model(str(tmp_path / "ckpt"))
    assert isinstance(got_model, SmallPETCNN) and len(testset) > 0
    assert test_pet_cnn._norms(hparams)[0] == {"mean": 0.5145,
                                               "std": 0.5383}
    with monkeypatch.context() as m:
        for name in PLOTTING:
            m.setitem(sys.modules, name, None)
        results = test_pet_cnn.main(confusion_pngs=False, device="cpu")
    metrics = results["pet_cnn_2_class"]
    assert all(np.isfinite(v) for v in metrics.values())
    with open(tmp_path / "lightning_logs" / "test_set_pet_2_class"
              / "version_0" / "confusion_matrix.json") as f:
        counts = json.load(f)["counts"]
    assert sum(map(sum, counts)) == len(testset)
