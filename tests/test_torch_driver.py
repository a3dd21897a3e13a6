"""The port's training driver and MRI entry points against the JAX package's,
on the CPU, from one synthetic split on disk.

``run_training`` at ResNet-10, batch 4, 2 epochs, starting on both sides
from the same weights (JAX's variables, carried to the port with
``models/convert.py`` through ``variables_transform``), must give JAX's
validation-loss history within rtol 1e-4, as tests/test_torch_trainer.py
holds ``Trainer.fit``. ``evaluate_checkpoint`` on a port checkpoint of the
same weights must give JAX ``evaluate``'s test loss and F1 within 1e-4; the
bootstrap draws differ by RNG, so only their finiteness is compared.
"""

import os
import sys

import jax
import numpy as np
import pytest

from multimodal_alzheimer_tpu.inference import harness as jax_harness
from multimodal_alzheimer_tpu.models.mri_models import (
    train_anat_cnn as jax_train_anat_cnn,
)
from multimodal_alzheimer_tpu.train import driver as jax_driver
from multimodal_alzheimer_tpu_torch.data.synthetic import (
    write_synthetic_split,
)
from multimodal_alzheimer_tpu_torch.inference import harness, test_anat_cnn
from multimodal_alzheimer_tpu_torch.models.convert import state_dict_from_flax
from multimodal_alzheimer_tpu_torch.models.mri_models import train_anat_cnn
from multimodal_alzheimer_tpu_torch.models.mri_models.anat_cnn import AnatCNN
from multimodal_alzheimer_tpu_torch.train import driver
from multimodal_alzheimer_tpu_torch.train.checkpoint import (
    load_checkpoint,
    save_checkpoint,
)
from torch_port_helpers import Trial, model_pair
from torch_threads import torch_threads  # noqa: F401 (autouse)

SHAPE = (12, 14, 12)
HPARAMS = {"n_classes": 2, "resnet_depth": 10, "lr": 1e-3,
           "lr_pretrained": 1e-5, "l2_reg": 1e-2, "batch_size": 4,
           "max_epochs": 2, "best_k_checkpoints": 1, "linear_out": (),
           "norm_percentile": 0.99}
MINMAX = {"per_scan_norm": "min_max"}
PLOTTING = ("matplotlib", "seaborn", "PIL", "pandas")


@pytest.fixture(scope="module")
def split(tmp_path_factory):
    root = tmp_path_factory.mktemp("driver_split")
    return write_synthetic_split(str(root / "data"), n_subjects=(8, 6, 8),
                                 seed=6, volume_shape=SHAPE)


def test_run_training_matches_the_jax_driver(split, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    data_dir = os.path.dirname(split["train"])
    hp_jax, hp = dict(HPARAMS), dict(HPARAMS)
    jax_train, jax_val = jax_driver.build_datasets(
        hp_jax, ["t1w"], normalize_mri=MINMAX, data_dir=data_dir)
    trainset, valset = driver.build_datasets(
        hp, ["t1w"], normalize_mri=MINMAX, data_dir=data_dir)
    assert (len(trainset), len(valset)) == (len(jax_train), len(jax_val))
    jax_driver.attach_class_weights(hp_jax, jax_train)
    driver.attach_class_weights(hp, trainset)
    assert hp == hp_jax
    assert 0 < min(hp["loss_class_weights"])  # both classes present

    jax_model, variables, port = model_pair(hp, SHAPE, seed=4)
    _, _, jax_last = jax_driver.run_training(
        jax_model, hp_jax, jax_train, jax_val, "jax",
        optimizer=jax_train_anat_cnn.backbone_head_optimizer(hp_jax, None),
        log_dir=str(tmp_path / "jax"), seed=7, num_workers=1,
        drop_last=True,
        variables_transform=lambda _: jax.tree_util.tree_map(
            jax.numpy.asarray, variables))
    jax_history = [float(v) for v in _history(tmp_path / "jax" / "jax")]

    trainer, state, last = driver.run_training(
        port, hp, trainset, valset, "port",
        optimizer=train_anat_cnn.backbone_head_optimizer(hp, port),
        log_dir=str(tmp_path / "port"), seed=7, num_workers=1,
        drop_last=True,
        variables_transform=lambda _: state_dict_from_flax(variables, port),
        log_confusion_images=False, device="cpu")
    trainer.logger.close()
    steps_per_epoch = len(trainset) // hp["batch_size"]
    assert state.step == 2 * steps_per_epoch
    assert len(trainer.val_loss_history) == 2
    np.testing.assert_allclose(trainer.val_loss_history, jax_history,
                               rtol=1e-4)
    np.testing.assert_allclose(last, jax_last, rtol=1e-4)
    names = sorted(os.listdir(tmp_path / "port" / "port" / "version_0"
                              / "checkpoints"))
    assert names == sorted(os.listdir(tmp_path / "jax" / "jax" / "version_0"
                                      / "checkpoints"))


def _history(root):
    import json

    with open(root / "version_0" / "metrics.jsonl") as f:
        return [json.loads(line)["val_loss_epoch"] for line in f]


def test_evaluate_checkpoint_matches_jax_evaluate(split, tmp_path,
                                                  monkeypatch):
    """The paired three-modality test set, memoised min-max at the
    checkpoint's quantile (test_anat_cnn._norms); the port's run renders no
    image and imports none of the plotting packages."""
    monkeypatch.chdir(tmp_path)
    hp = dict(HPARAMS, loss_class_weights=[0.4, 0.6])
    jax_model, variables, port = model_pair(hp, SHAPE, seed=5)
    jax_testset = jax_harness.build_testset(hp, None, MINMAX, 0.99,
                                            test_csv=split["test"])
    assert len(jax_testset) > 0
    want = jax_harness.evaluate(
        jax_model, jax.tree_util.tree_map(jax.numpy.asarray, variables), hp,
        jax_testset, "jax_eval", num_workers=1)

    checkpoint = tmp_path / "ckpt"
    save_checkpoint(checkpoint, state_dict_from_flax(variables, port), hp)
    with monkeypatch.context() as m:
        for name in PLOTTING:
            m.setitem(sys.modules, name, None)  # any import of them raises
        got = harness.evaluate_checkpoint(
            AnatCNN.from_hparams, str(checkpoint), "port_eval",
            normalization_from=test_anat_cnn._norms, confusion_pngs=False,
            device="cpu", test_csv=split["test"])
    assert set(got) == set(want)
    for key in ("test_loss_epoch", "test_f1_epoch", "test_f1_epoch_class_0",
                "test_f1_epoch_class_1"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-4,
                                   atol=1e-4, err_msg=key)
    assert all(np.isfinite(v) for v in got.values())

    log_dir = tmp_path / "lightning_logs" / "port_eval" / "version_0"
    import json

    with open(log_dir / "confusion_matrix.json") as f:
        confusion = json.load(f)
    assert confusion["labels"] == {"CN": 0, "AD": 1}
    assert sum(map(sum, confusion["counts"])) == len(jax_testset)
    assert not list(log_dir.glob("*.png"))


def test_confusion_pngs_are_the_callers_choice(split, tmp_path, monkeypatch):
    """``confusion_pngs=True`` renders the three PNGs beside the counts."""
    monkeypatch.chdir(tmp_path)
    hp = dict(HPARAMS, batch_size=8)
    _, variables, port = model_pair(hp, SHAPE, seed=6)
    checkpoint = tmp_path / "ckpt"
    save_checkpoint(checkpoint, state_dict_from_flax(variables, port), hp)
    harness.evaluate_checkpoint(
        AnatCNN.from_hparams, str(checkpoint), "pngs",
        normalization_from=test_anat_cnn._norms, confusion_pngs=True,
        device="cpu", test_csv=split["test"])
    log_dir = tmp_path / "lightning_logs" / "pngs" / "version_0"
    assert sorted(p.name for p in log_dir.glob("*.png")) == [
        "confusion_matrix.png", "confusion_matrix_color_branded.png",
        "confusion_matrix_normalized.png"]
    assert (log_dir / "confusion_matrix.json").exists()


def test_test_anat_cnn_main_reads_the_path_registry(split, tmp_path,
                                                    monkeypatch):
    """main() evaluates the checkpoint path_config.yaml names, on the test
    split it names."""
    monkeypatch.chdir(tmp_path)
    hp = dict(HPARAMS, batch_size=8)
    _, variables, port = model_pair(hp, SHAPE, seed=7)
    checkpoint = tmp_path / "ckpt"
    save_checkpoint(checkpoint, state_dict_from_flax(variables, port), hp)
    (tmp_path / "path_config.yaml").write_text(
        "relative:\n"
        f"  test_set_csv: '{os.path.relpath(split['test'], tmp_path)}'\n"
        f"mri_cnn_2_class: '{checkpoint}'  # the best stage-1 model\n")
    results = test_anat_cnn.main(confusion_pngs=False, device="cpu")
    assert set(results) == {"mri_cnn_2_class"}
    assert np.isfinite(results["mri_cnn_2_class"]["test_loss_epoch"])
    state_dict, hparams, _ = load_checkpoint(checkpoint)
    assert hparams["resnet_depth"] == 10 and len(state_dict) > 0


def _group_lrs(optimizer):
    """{parameter: lr} of a torch optimizer's groups."""
    return {id(p): g["lr"] for g in optimizer.param_groups
            for p in g["params"]}


@pytest.mark.parametrize("lr_pretrained", [None, 1e-5],
                         ids=["frozen", "pretrained"])
def test_backbone_head_optimizer_groups_match_jax(monkeypatch,
                                                  lr_pretrained):
    hp = dict(HPARAMS, lr_pretrained=lr_pretrained)
    captured = {}
    monkeypatch.setattr(
        jax_train_anat_cnn, "build_optimizer",
        lambda group_lrs, label, params, l2_reg: captured.update(
            group_lrs=group_lrs, label=label, l2_reg=l2_reg))
    jax_train_anat_cnn.backbone_head_optimizer(hp, None)
    _, variables, port = model_pair(hp, SHAPE, seed=0)
    optimizer = train_anat_cnn.backbone_head_optimizer(hp, port)
    lrs = _group_lrs(optimizer)
    assert all(g["weight_decay"] == captured["l2_reg"]
               for g in optimizer.param_groups)
    flat = jax.tree_util.tree_flatten_with_path(variables["params"])[0]
    jax_lr = {}
    for path, _ in flat:
        keys = tuple(p.key for p in path)
        jax_lr[keys[:-1]] = captured["group_lrs"].get(captured["label"](keys))
    for name, param in port.named_parameters():
        module = tuple(name.split(".")[:-1])
        assert lrs.get(id(param)) == jax_lr[module], name
    assert len(lrs) < len(list(port.parameters())) or lr_pretrained


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("n_classes", [2, 3])
def test_sample_hparams_matches_jax(seed, n_classes):
    port_trial, jax_trial = Trial(seed), Trial(seed)
    got = train_anat_cnn.sample_hparams(port_trial, n_classes)
    want = jax_train_anat_cnn.sample_hparams(jax_trial, n_classes)
    assert got == want
    assert port_trial.calls == jax_trial.calls
    assert train_anat_cnn.SEED == jax_train_anat_cnn.SEED == 15
    assert train_anat_cnn.LOG_DIRECTORY == jax_train_anat_cnn.LOG_DIRECTORY


def test_driver_helpers_match_jax(split, monkeypatch, tmp_path):
    monkeypatch.setenv("MMALZ_DATA_DIR", str(tmp_path / "d"))
    assert driver.data_csv("val") == jax_driver.data_csv("val")
    assert driver.data_csv("train", "x") == jax_driver.data_csv("train", "x")
    monkeypatch.delenv("MMALZ_DATA_DIR")
    monkeypatch.chdir(tmp_path)
    assert driver.data_csv("test") == jax_driver.data_csv("test")
    for n in (2, 3):
        assert driver.binary_from_hparams({"n_classes": n}) == \
            jax_driver.binary_from_hparams({"n_classes": n})
    with pytest.raises(ValueError):
        driver.binary_from_hparams({"n_classes": 4})
    data_dir = os.path.dirname(split["train"])
    for modalities in (["t1w"], ["pet1451", "t1w", "tabular"]):
        got = driver.build_datasets({"n_classes": 3}, modalities,
                                    data_dir=data_dir,
                                    modes=("train", "val", "test"))
        want = jax_driver.build_datasets({"n_classes": 3}, modalities,
                                         data_dir=data_dir,
                                         modes=("train", "val", "test"))
        assert [len(d) for d in got] == [len(d) for d in want]
        hp_got, hp_want = {}, {}
        driver.attach_class_weights(hp_got, got[0])
        jax_driver.attach_class_weights(hp_want, want[0])
        assert hp_got == hp_want


def test_train_anat_runs_from_disk(split, tmp_path, monkeypatch):
    """The entry point itself: one epoch on the split under
    MMALZ_DATA_DIR, checkpoints under lightning_logs/ in the CWD."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("MMALZ_DATA_DIR", os.path.dirname(split["train"]))
    hp = train_anat_cnn.sample_hparams(Trial(0))
    hp.update(resnet_depth=10, batch_size=4, max_epochs=1, fl_gamma=None,
              linear_out=(), lr_pretrained=1e-5)
    last = train_anat_cnn.train_anat(hp, "anat", log_confusion_images=False,
                                     device="cpu", num_workers=1)
    assert np.isfinite(last)
    run = tmp_path / train_anat_cnn.LOG_DIRECTORY / "anat" / "version_0"
    names = sorted(os.listdir(run / "checkpoints"))
    assert len(names) == 2 and "loss_class_weights" in hp
    state_dict, hparams, metrics = load_checkpoint(
        run / "checkpoints" / [n for n in names if "val_loss" in n][0])
    assert metrics["val_loss_epoch"] == last
    AnatCNN.from_hparams(hparams).load_state_dict(state_dict)
