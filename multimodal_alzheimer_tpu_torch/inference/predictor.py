"""Serving-oriented predictor: fixed-rung batched inference + embeddings.

Port of ``multimodal_alzheimer_tpu/inference/predictor.py`` for one device.
A ragged batch pads to the smallest rung of the batch-size ladder, so the
card runs a few fixed batch shapes; padding rows are stripped before the
outputs return as numpy. ``BatchingServer`` (``inference/server.py``) drives
it through ``batch_size``, ``stage_sample`` and ``predict_parts``.
"""

from __future__ import annotations

import numpy as np
import torch

from multimodal_alzheimer_tpu_torch.utils.device import resolve_device


class StagedSample:
    """A sample copied to the device at submit time: ``.arrays`` maps key ->
    tensor. ``release()`` is a no-op: no host buffer is pooled."""

    def __init__(self, arrays: dict):
        self.arrays = arrays

    def release(self) -> None:
        pass


def _to_numpy(tree, n: int):
    if isinstance(tree, dict):
        return {k: _to_numpy(v, n) for k, v in tree.items()}
    return tree[:n].cpu().numpy()


class Predictor:
    def __init__(self, model: torch.nn.Module, batch_size: int = 32,
                 preprocess=None, device="cuda", ladder=None):
        """Serve ``model`` (moved to ``device``, the card unless the caller
        asks for the CPU, and set to eval) on batches.

        ``preprocess`` maps a raw batch dict of tensors on the device to the
        model's inputs (``data.preprocess.make_device_preprocess``).
        ``ladder`` lists extra batch sizes below ``batch_size``: a ragged
        batch pads to the smallest rung that fits it. Results are the same
        per-sample computation at every rung.
        """
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.batch_size = batch_size
        rungs = sorted({int(r) for r in (ladder or ())} | {int(batch_size)})
        if rungs[-1] != batch_size:
            raise ValueError(
                f"ladder rungs {rungs} exceed batch_size {batch_size}")
        self.ladder = tuple(rungs)
        self.preprocess = preprocess

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
        with torch.inference_mode():
            if self.preprocess is not None:
                batch = self.preprocess(batch)
            out = self.model(batch)
            probs = torch.softmax(out["logits"], dim=-1)
            result = {"logits": out["logits"], "probs": probs,
                      "embeddings": out["embeddings"]}
            return _to_numpy(result, n)

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
        n = len(samples)
        rung = self._pad_target(n)
        samples = [getattr(s, "arrays", s) for s in samples]
        parts = samples + [samples[-1]] * (rung - n)
        batch = {k: torch.stack([torch.as_tensor(p[k], device=self.device)
                                 for p in parts])
                 for k in parts[0]}
        return self._serve(batch, n)

    def predict_batch(self, batch: dict) -> dict:
        """One batch dict (any leading size <= batch_size) -> outputs,
        zero-padded on the host to the smallest rung that fits."""
        n = len(next(iter(batch.values())))
        padded = self._pad({k: np.asarray(v) for k, v in batch.items()}, n)
        tensors = {k: torch.from_numpy(np.ascontiguousarray(v)).to(self.device)
                   for k, v in padded.items()}
        return self._serve(tensors, n)
