"""Serving-oriented predictor: fixed-rung batched inference + embeddings.

Port of ``multimodal_alzheimer_tpu/inference/predictor.py``. A ragged batch
pads to the smallest rung of the batch-size ladder, so the
card runs a few fixed batch shapes; padding rows are stripped before the
outputs return as numpy. ``BatchingServer`` (``inference/server.py``) drives
it through ``batch_size``, ``stage_sample`` and ``predict_parts``. The serve
core is the model's eval forward (``model_serve_fn``) or a prebuilt one
(``serve_fn=``: the BN-folded and int8 graphs of ``inference/quantize.py``,
an exported artifact of ``inference/export.py``).

With ``mesh=`` (a ``parallel.Mesh``) every rung must be a multiple of the
ranks, each
rank runs its contiguous block of rows of the padded rung through the core
and the outputs are gathered to every rank (an all-reduce of a zero-filled
buffer). ``predict_batch`` and ``predict`` are SPMD calls: every rank
passes the same batch. ``predict_parts`` serves rank 0's samples: it
broadcasts the stacked batch, so that the other ranks either make the same
call or wait in ``follow()``, which serves every batch rank 0 sends until
``release_followers()``. That is how a ``BatchingServer`` on rank 0 drives
a mesh predictor.
"""

from __future__ import annotations

import numpy as np
import torch

from multimodal_alzheimer_tpu_torch.parallel.mesh import (
    DataParallel,
    gather_rows,
)
from multimodal_alzheimer_tpu_torch.utils.device import resolve_device


class StagedSample:
    """A sample copied to the device at submit time: ``.arrays`` maps key ->
    tensor. ``release()`` is a no-op: no host buffer is pooled."""

    def __init__(self, arrays: dict):
        self.arrays = arrays

    def release(self) -> None:
        pass


def _to_numpy(tree, n: int):
    """The first n rows of every tensor as numpy. numpy has no bfloat16: a
    bfloat16 output (a bf16 model's ``backbone_gap``) returns as float32,
    which holds every bfloat16 value exactly."""
    if isinstance(tree, dict):
        return {k: _to_numpy(v, n) for k, v in tree.items()}
    t = tree[:n].cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def model_serve_fn(model: torch.nn.Module, preprocess=None):
    """``batch -> {'logits', 'probs', 'embeddings'}`` of ``model``'s forward
    (in whatever mode the model is) on ``preprocess(batch)``: the float
    serve core, the ``'float'`` baseline of ``inference/quality.py``."""

    def serve(batch: dict) -> dict:
        with torch.no_grad():
            if preprocess is not None:
                batch = preprocess(batch)
            out = model(batch)
            return {"logits": out["logits"],
                    "probs": torch.softmax(out["logits"], dim=-1),
                    "embeddings": out["embeddings"]}

    return serve


class Predictor:
    def __init__(self, model: torch.nn.Module | None = None,
                 batch_size: int = 32, preprocess=None, device="cuda",
                 ladder=None, serve_fn=None, mesh=None):
        """Serve ``model`` (moved to ``device``, the card unless the caller
        asks for the CPU, and set to eval) on batches.

        ``preprocess`` maps a raw batch dict of tensors on the device to the
        model's inputs (``data.preprocess.make_device_preprocess``).
        ``ladder`` lists extra batch sizes below ``batch_size``: a ragged
        batch pads to the smallest rung that fits it. Results are the same
        per-sample computation at every rung.

        ``serve_fn`` replaces the model's forward with a prebuilt core,
        ``batch -> {'logits', 'probs'[, 'embeddings']}``, that applies its
        own preprocessing and holds its own weights: the predictor then runs
        no ``preprocess`` and does not touch ``model``, which (when given)
        only names the class count of an empty ``predict``. ``mesh``
        serves data-parallel on the mesh's device (it replaces ``device``):
        a rung that is not a multiple of the ranks raises ``ValueError``.
        """
        if model is None and serve_fn is None:
            raise ValueError("Predictor needs a model or a serve_fn")
        self.mesh = mesh
        self.device = mesh.device if mesh is not None else \
            resolve_device(device)
        self.model = model
        if serve_fn is None:
            self.model = model.to(self.device).eval()
            serve_fn = model_serve_fn(self.model, preprocess)
        self.serve_fn = serve_fn
        self.batch_size = batch_size
        rungs = sorted({int(r) for r in (ladder or ())} | {int(batch_size)})
        if rungs[-1] != batch_size:
            raise ValueError(
                f"ladder rungs {rungs} exceed batch_size {batch_size}")
        self.ladder = tuple(rungs)
        if mesh is not None:
            bad = [r for r in self.ladder if r % mesh.size]
            if bad:
                # at construction: a rung that cannot be split would fail
                # only at request time, on a live serving path
                raise ValueError(
                    f"ladder rungs {bad} are not multiples of the mesh's "
                    f"{mesh.size} ranks; every rung must shard evenly")

    def _pad_target(self, n: int) -> int:
        """Smallest ladder rung that fits n samples."""
        for rung in self.ladder:
            if n <= rung:
                return rung
        raise ValueError(f"batch of {n} exceeds batch_size "
                         f"{self.batch_size}")

    def _pad(self, batch: dict, n: int) -> dict:
        pad = self._pad_target(n) - n
        if pad == 0:
            return batch
        return {k: np.concatenate([v, np.zeros((pad,) + v.shape[1:], v.dtype)])
                for k, v in batch.items()}

    def _serve(self, batch: dict, n: int) -> dict:
        """Outputs of the first n rows of a rung's batch (host or device
        tensors), as numpy; under a mesh the rank serves its rows and the
        outputs are gathered."""
        rung = int(next(iter(batch.values())).shape[0])
        dp = None
        if self.mesh is not None:
            rows = self.mesh.rows(rung)
            batch = {k: v[rows] for k, v in batch.items()}
            dp = DataParallel(self.mesh, rung, rows.start)
        with torch.inference_mode():
            out = self.serve_fn({k: v.to(self.device)
                                 for k, v in batch.items()})
            out = {"logits": out["logits"], "probs": out["probs"],
                   "embeddings": out.get("embeddings", {})}
            if dp is not None:
                out = gather_rows(out, dp)
            return _to_numpy(out, n)

    def warmup(self, example_batch: dict, parts: bool = False) -> None:
        """Run every ladder rung once (one call per rung), and with
        ``parts`` every rung of ``predict_parts`` too, so no live request
        pays a first-call cost. ``example_batch`` needs >= 1 sample."""
        one = {k: np.asarray(v)[:1] for k, v in example_batch.items()}
        for rung in self.ladder:
            self.predict_batch(
                {k: np.concatenate([v] * rung) for k, v in one.items()})
        if parts:
            sample = {k: v[0] for k, v in one.items()}
            for rung in self.ladder:
                self.predict_parts([sample] * rung)

    def stage_sample(self, sample: dict) -> StagedSample:
        """Start this sample's host-to-device copy now (submit time): pinned
        host memory, then a non-blocking copy on the current stream."""
        arrays = {}
        for k, v in sample.items():
            t = torch.from_numpy(np.ascontiguousarray(v))
            if self.device.type == "cuda":
                t = t.pin_memory()
            arrays[k] = t.to(self.device, non_blocking=True)
        return StagedSample(arrays)

    def predict_parts(self, samples: list) -> dict:
        """Serve a list of per-sample dicts (no batch axis), stacking them
        on the device and padding to the rung by repeating the last sample,
        so only the real samples cross the host-device link."""
        if self.mesh is not None and self.mesh.rank != 0:
            return self._follow_one()
        n = len(samples)
        rung = self._pad_target(n)
        samples = [getattr(s, "arrays", s) for s in samples]
        parts = samples + [samples[-1]] * (rung - n)
        batch = {k: torch.stack([torch.as_tensor(p[k], device=self.device)
                                 for p in parts])
                 for k in parts[0]}
        if self.mesh is not None:
            self.mesh.broadcast_object(
                (n, {k: (tuple(v.shape), str(v.dtype)[len("torch."):])
                     for k, v in batch.items()}))
            for v in batch.values():
                self.mesh.broadcast_(v)
        return self._serve(batch, n)

    def _follow_one(self):
        """Serve the batch rank 0's ``predict_parts`` broadcasts; None when
        it broadcasts the release instead."""
        header = self.mesh.broadcast_object(None)
        if header is None:
            return None
        n, spec = header
        batch = {k: self.mesh.broadcast_(torch.empty(
            shape, dtype=getattr(torch, dtype), device=self.device))
            for k, (shape, dtype) in spec.items()}
        return self._serve(batch, n)

    def follow(self) -> int:
        """On a rank other than 0 of a mesh: serve each batch rank 0's
        ``predict_parts`` sends, until rank 0 calls ``release_followers``;
        returns the number of batches served."""
        if self.mesh is None or self.mesh.rank == 0:
            raise RuntimeError("follow() runs on the ranks other than 0 of "
                               "a mesh predictor")
        served = 0
        while self._follow_one() is not None:
            served += 1
        return served

    def release_followers(self) -> None:
        """On rank 0 of a mesh: end the other ranks' ``follow()``. A no-op
        without a mesh."""
        if self.mesh is not None and self.mesh.rank == 0:
            self.mesh.broadcast_object(None)

    def predict_batch(self, batch: dict) -> dict:
        """One batch dict (any leading size <= batch_size) -> outputs,
        zero-padded on the host to the smallest rung that fits."""
        n = len(next(iter(batch.values())))
        padded = self._pad({k: np.asarray(v) for k, v in batch.items()}, n)
        return self._serve({k: torch.from_numpy(np.ascontiguousarray(v))
                            for k, v in padded.items()}, n)

    def predict(self, dataset_or_batches) -> dict:
        """Iterate batches (or an indexable dataset, through the port's
        ``DataLoader`` on the host) and concatenate the outputs; ``'label'``
        is dropped. A core without embedding taps gives an empty
        ``embeddings`` dict. An empty dataset gives ``(0, n_classes)``
        logits and probs (the wrapped model's class count; 0 for a bare
        serve core)."""
        from multimodal_alzheimer_tpu_torch.data.pipeline import DataLoader

        if hasattr(dataset_or_batches, "__getitem__"):
            loader = DataLoader(dataset_or_batches, self.batch_size,
                                device="cpu")
        else:
            loader = dataset_or_batches
        outs = []
        for batch in loader:
            batch = dict(batch)
            batch.pop("label", None)
            outs.append(self.predict_batch(batch))
        if not outs:
            n_classes = int(getattr(self.model, "n_classes", 0) or 0)
            empty = np.zeros((0, n_classes), np.float32)
            return {"logits": empty, "probs": empty, "embeddings": {}}
        return {
            "logits": np.concatenate([o["logits"] for o in outs]),
            "probs": np.concatenate([o["probs"] for o in outs]),
            "embeddings": {k: np.concatenate([o["embeddings"][k]
                                              for o in outs])
                           for k in outs[0]["embeddings"]},
        }
