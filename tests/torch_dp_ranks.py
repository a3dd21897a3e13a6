"""Rank functions of the port's data-parallel tests.

``parallel.launch.run_ranks`` spawns one process per rank, and a spawned
child imports the module that defines its target: this one, which imports
neither JAX nor the JAX package, so the children stay free of both. Each
function takes the rank's ``Mesh`` first and returns plain tensors, numbers
and numpy arrays, which the parent test compares with the one-process run
(``run_case`` with ``mesh=None``, in the parent) and with JAX.
"""

import numpy as np
import torch

from multimodal_alzheimer_tpu_torch.data.pipeline import DataLoader
from multimodal_alzheimer_tpu_torch.losses.classification import (
    make_criterion,
)
from multimodal_alzheimer_tpu_torch.models.fusion_models.all_modalities_fusion import (  # noqa: E501
    AllModalitiesFusion,
)
from multimodal_alzheimer_tpu_torch.models.mri_models.anat_cnn import AnatCNN
from multimodal_alzheimer_tpu_torch.models.pet_models.pet_cnn import (
    SmallPETCNN,
)
from multimodal_alzheimer_tpu_torch.parallel import (
    batch_sharding,
    make_mesh,
    replicate,
    shard_batch,
)
from multimodal_alzheimer_tpu_torch.train.optim import single_lr_optimizer
from multimodal_alzheimer_tpu_torch.train.state import (
    TrainState,
    make_train_step,
)
from multimodal_alzheimer_tpu_torch.utils.seeding import make_generator
from torch_threads import TORCH_THREADS

MODELS = {"small_pet": SmallPETCNN, "anat": AnatCNN}


def build_model(case: dict) -> torch.nn.Module:
    """The case's model with its state dict loaded."""
    if case["kind"] == "stage3":
        model = AllModalitiesFusion.from_hparams(*case["hp"])
    else:
        model = MODELS[case["kind"]].from_hparams(
            case["hp"], **case.get("overrides", {}))
    model.load_state_dict(case["state"])
    return model


def run_case(case: dict, mesh=None) -> dict:
    """``case['steps']`` train steps (SGD, or Adam with ``'adam'``) of the
    case's model on ``case['batch']``: one process with ``mesh=None``, else
    the rank's shard. Returns the reported losses, the final state dict,
    the gradients of the last step (summed over the ranks) and the last
    step's logits and labels."""
    model = build_model(case)
    hp = case["criterion"]
    if case.get("adam"):
        optimizer = single_lr_optimizer(model, case["lr"])
    else:
        optimizer = torch.optim.SGD(
            [p for p in model.parameters() if p.requires_grad],
            lr=case["lr"])
    generator = (make_generator(case["dropout_seed"])
                 if "dropout_seed" in case else None)
    step = make_train_step(model, make_criterion(hp), optimizer,
                           dropout_generator=generator, mesh=mesh)
    state = TrainState(model, optimizer)
    batch = {k: torch.from_numpy(v) for k, v in case["batch"].items()}
    if mesh is not None:
        replicate(state, mesh)
        batch = shard_batch(batch, mesh)
    losses = []
    for _ in range(case["steps"]):
        state, aux = step(state, batch)
        losses.append(float(aux["loss"]))
    return {"losses": losses,
            "state": {k: v.detach().clone()
                      for k, v in model.state_dict().items()},
            "grads": {n: p.grad.detach().clone()
                      for n, p in model.named_parameters()
                      if p.grad is not None},
            "logits": aux["logits"].clone(), "labels": aux["labels"].clone()}


def cases_on_ranks(mesh, cases: dict, layout_batch=None) -> dict:
    """``run_case`` of every case on this rank, with the collectives each
    took, and ``layout_on_ranks`` of ``layout_batch``."""
    torch.set_num_threads(TORCH_THREADS)
    out = {}
    for name, case in cases.items():
        mesh.reset_counts()
        out[name] = run_case(case, mesh)
        out[name]["counts"] = dict(mesh.counts)
    if layout_batch is not None:
        out["layout"] = layout_on_ranks(mesh, layout_batch)
    return out


def layout_on_ranks(mesh, batch: dict) -> dict:
    """The rank's shard of ``batch``, whether an odd batch is refused, a
    module and Adam state drawn per rank after ``replicate``, and the
    one-rank mesh ``make_mesh(1)`` gives this rank (None off it)."""
    shard = shard_batch(batch, mesh)
    try:
        shard_batch({k: v[:-1] for k, v in batch.items()}, mesh)
        refused = False
    except ValueError:
        refused = True
    model = torch.nn.Linear(3, 2)
    optimizer = torch.optim.Adam(model.parameters())
    with torch.random.fork_rng():
        torch.manual_seed(mesh.rank)
        model(torch.randn(4, 3)).sum().backward()
    optimizer.step()
    replicate(TrainState(model, optimizer), mesh)
    sub = make_mesh(1, device="cpu")
    return {"shard": {k: v.clone() for k, v in shard.items()},
            "offset": shard.offset, "global_rows": shard.global_rows,
            "replicated": batch_sharding(mesh).is_fully_replicated,
            "odd_refused": refused,
            "weights": {k: v.clone() for k, v in model.state_dict().items()},
            "adam": [optimizer.state[p]["exp_avg"].clone()
                     for p in model.parameters()],
            "sub": None if sub is None else (sub.rank, sub.size)}


# ------------------------------------------------------------- trainer --


class SeparableVolumes:
    """Volumes whose class sets their mean (0, 1 or 2) under unit noise."""

    def __init__(self, n: int, seed: int, shape=(16, 16, 16)):
        rng = np.random.default_rng(seed)
        self.labels = rng.integers(0, 3, n).astype(np.int32)
        self.volumes = (rng.normal(size=(n,) + shape)
                        + self.labels[:, None, None, None]).astype(np.float32)

    def __len__(self):
        return len(self.labels)

    def __getitem__(self, i):
        return {"pet1451": self.volumes[i], "label": self.labels[i]}


TRAINER_HP = {"n_classes": 3, "conv_out": (4, 8), "filter_size": (3, 3),
              "linear_out": 16, "lr": 1e-2, "batch_size": 16,
              "max_epochs": 8, "early_stopping_patience": 8,
              "reduce_factor_lr_schedule": None, "loss_class_weights": None,
              "batchnorm": True}


def fit_on_ranks(mesh, checkpoint_dir: str) -> dict:
    """``Trainer.fit`` of SmallPETCNN over 45 separable training volumes at
    batch 16 (a ragged tail of 13), then the val F1 and ``Trainer.test`` on
    the val set; rank 0 keeps the top-k checkpoints and writes the test's
    confusion counts."""
    from multimodal_alzheimer_tpu_torch.train.loop import Trainer

    torch.set_num_threads(TORCH_THREADS)
    hp = TRAINER_HP
    model = SmallPETCNN.from_hparams(hp, generator=make_generator(0))
    trainer = Trainer(model, hp, single_lr_optimizer(model, hp["lr"]),
                      make_criterion(hp), seed=0,
                      checkpoint_dir=checkpoint_dir,
                      log_confusion_images=False, mesh=mesh)
    state = trainer.init_state()
    sharding = batch_sharding(mesh)
    train = DataLoader(SeparableVolumes(45, 0), 16, shuffle=True,
                       num_workers=1, sharding=sharding)
    val = DataLoader(SeparableVolumes(20, 1), 16, num_workers=1,
                     sharding=sharding)
    state, last_val_loss = trainer.fit(state, train, val)
    metrics = trainer._run_eval_epoch(val, "val")
    test = trainer.test(val, out_dir=checkpoint_dir + "_test",
                        n_bootstrap=50, confusion_pngs=False)
    return {"last_val_loss": last_val_loss,
            "history": list(trainer.val_loss_history),
            "val_f1": metrics["val_f1_epoch"], "test": test,
            "params": {k: v.clone() for k, v in model.state_dict().items()}}


def loader_on_ranks(mesh, n: int, batch_size: int, pad_last: bool) -> list:
    """Every batch of a sharded, shuffled loader over ``n`` samples."""
    torch.set_num_threads(TORCH_THREADS)
    loader = DataLoader(SeparableVolumes(n, 2, shape=(2, 2, 2)), batch_size,
                        shuffle=True, seed=3, num_workers=2,
                        sharding=batch_sharding(mesh), pad_last=pad_last)
    return [{"arrays": {k: v.clone() for k, v in batch.items()},
             "global_rows": getattr(batch, "global_rows", None),
             "offset": getattr(batch, "offset", None)} for batch in loader]


def run_training_on_ranks(mesh, data_dir: str, log_dir: str) -> dict:
    """``train.driver.run_training`` of a small AnatCNN over the split in
    ``data_dir``."""
    from multimodal_alzheimer_tpu_torch.train.driver import (
        build_datasets,
        run_training,
    )

    torch.set_num_threads(TORCH_THREADS)
    hp = {"n_classes": 3, "resnet_depth": 10, "lr": 1e-3, "batch_size": 4,
          "max_epochs": 2, "early_stopping_patience": 5,
          "loss_class_weights": None}
    model = AnatCNN.from_hparams(hp, generator=make_generator(4))
    trainset, valset = build_datasets(
        hp, ["t1w"], normalize_mri={"per_scan_norm": "min_max"},
        data_dir=data_dir)
    trainer, _, last_val_loss = run_training(
        model, hp, trainset, valset, experiment_name="dp",
        log_dir=log_dir, num_workers=1, log_confusion_images=False,
        device="cpu", mesh=mesh)
    return {"last_val_loss": last_val_loss,
            "history": list(trainer.val_loss_history),
            "has_logger": trainer.logger is not None,
            "managers": len(trainer.ckpt_managers)}


def trainer_mesh_on_ranks(mesh, checkpoint_dir: str, data_dir: str,
                          log_dir: str) -> dict:
    """The Trainer file's three runs in one spawn."""
    return {"fit": fit_on_ranks(mesh, checkpoint_dir),
            "padded": loader_on_ranks(mesh, 21, 8, pad_last=True),
            "ragged": loader_on_ranks(mesh, 21, 8, pad_last=False),
            "run_training": run_training_on_ranks(mesh, data_dir, log_dir)}


# ------------------------------------------------- serving and searches --


def predictor_on_ranks(mesh, state: dict, hp: dict, data: dict) -> dict:
    """A mesh ``Predictor`` (batch 4, ladder (2,)) over ``AnatCNN`` weights:
    ``predict`` of ``data``, ``predict_batch`` of each 1-, 3- and 4-row
    slice, then a ``BatchingServer`` round trip of every sample, served
    from rank 0 while the other ranks follow."""
    from multimodal_alzheimer_tpu_torch.data.preprocess import (
        make_device_preprocess,
    )
    from multimodal_alzheimer_tpu_torch.data.synthetic import ArrayDataset
    from multimodal_alzheimer_tpu_torch.inference.predictor import Predictor
    from multimodal_alzheimer_tpu_torch.inference.server import (
        BatchingServer,
    )

    torch.set_num_threads(TORCH_THREADS)
    model = AnatCNN.from_hparams(hp)
    model.load_state_dict(state)
    pred = Predictor(model, batch_size=4, ladder=(2,), mesh=mesh,
                     preprocess=make_device_preprocess(
                         normalize_mri={"per_scan_norm": "min_max"},
                         quantile=0.99))
    out = {"predict": pred.predict(ArrayDataset(data)),
           "batches": [pred.predict_batch({k: v[lo:hi] for k, v in
                                           data.items() if k != "label"})
                       for lo, hi in ((0, 1), (1, 4), (3, 7))]}
    samples = [{k: v[i] for k, v in data.items() if k != "label"}
               for i in range(len(data["label"]))]
    if mesh.rank == 0:
        with BatchingServer(pred, max_wait_s=0.05) as server:
            futures = [server.submit(s) for s in samples]
            out["served"] = [f.result(timeout=60) for f in futures]
        out["histogram"] = dict(server.batch_histogram)
    else:
        out["followed"] = pred.follow()
    return out


def trials_on_ranks(mesh, model, hp, train, val, kwargs) -> tuple:
    """``run_parallel_trials`` with the trials sharded over the ranks, and
    a seed screen of two seeds."""
    from multimodal_alzheimer_tpu_torch.train.seed_screen import screen_seeds
    from multimodal_alzheimer_tpu_torch.train.vmap_hpo import (
        run_parallel_trials,
    )

    torch.set_num_threads(TORCH_THREADS)
    last, info = run_parallel_trials(model, hp, train, val, mesh=mesh,
                                     **kwargs)
    screen = screen_seeds(model, train, val, lr=3e-3, batch_size=16,
                          epochs=2, class_weights=kwargs["class_weights"],
                          seeds=(11, 22), mesh=mesh)
    return last, info, screen


def tabpfn_on_ranks(mesh, state_dict: dict, sizes: dict, fit, x_test,
                    ensemble: int) -> tuple:
    """A ``TabPFNClassifier`` with its members split over the ranks:
    probabilities and the decoder tap of ``x_test``."""
    from multimodal_alzheimer_tpu_torch.models.tabular_models.tabpfn import (
        TabPFNClassifier,
        TabPFNTransformer,
    )

    torch.set_num_threads(TORCH_THREADS)
    clf = TabPFNClassifier(state_dict=state_dict,
                           model=TabPFNTransformer(**sizes),
                           ensemble_size=ensemble, mesh=mesh).fit(*fit)
    return clf.predict_proba(x_test), clf.embed(x_test)
