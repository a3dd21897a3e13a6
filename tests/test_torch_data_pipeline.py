"""The port's synthetic data and loader against the JAX package (CPU).

The same seed must give the same volumes and the same batch order as the
JAX ``DataLoader`` (which yields numpy batches with ``device_put=False``).
The CUDA path (pinned buffers, side-stream copies) runs on the card in
``chip_smoke.py``'s ``Trainer.fit`` phase.
"""

import numpy as np
import pytest
import torch

from multimodal_alzheimer_tpu.data.pipeline import DataLoader as JaxLoader
from multimodal_alzheimer_tpu.data.synthetic import (
    ArrayDataset as JaxArrayDataset,
    make_labeled_volumes as jax_labeled_volumes,
)
from multimodal_alzheimer_tpu_torch.data.pipeline import (
    DataLoader,
    collate_into,
)
from multimodal_alzheimer_tpu_torch.data.synthetic import (
    ArrayDataset,
    make_labeled_volumes,
)
from torch_threads import torch_threads  # noqa: F401 (autouse)

MODALITIES = ("mri", "pet1451", "tabular")


@pytest.mark.parametrize("n_classes,jitter", [(2, 0.0), (3, 0.3)])
def test_labeled_volumes_equal_jaxs(n_classes, jitter):
    kwargs = dict(shape=(6, 5, 4), n_classes=n_classes, seed=4,
                  contrast_jitter=jitter, modalities=MODALITIES)
    got = make_labeled_volumes(7, **kwargs)
    want = jax_labeled_volumes(7, **kwargs)
    assert set(got) == set(want)
    for key, value in want.items():
        assert got[key].dtype == value.dtype, key
        np.testing.assert_array_equal(got[key], value, err_msg=key)


def _datasets(n):
    data = {"label": np.arange(n, dtype=np.int64),
            "x": np.random.default_rng(0).normal(size=(n, 3)).astype(
                np.float32)}
    return ArrayDataset(data), JaxArrayDataset(data)


@pytest.mark.parametrize("n,batch,shuffle,drop_last", [
    (10, 4, True, False), (10, 4, True, True), (9, 3, False, False)])
def test_batches_match_the_jax_loader(n, batch, shuffle, drop_last):
    ours_data, jax_data = _datasets(n)
    ours = DataLoader(ours_data, batch, shuffle=shuffle, drop_last=drop_last,
                      seed=7, num_workers=2, device="cpu")
    theirs = JaxLoader(jax_data, batch, shuffle=shuffle, drop_last=drop_last,
                       seed=7, num_workers=2, device_put=False)
    assert len(ours) == len(theirs)
    for _ in range(2):  # a second epoch reshuffles on both sides alike
        got, want = list(ours), list(theirs)
        assert len(got) == len(want) == len(ours)
        for g, w in zip(got, want):
            assert set(g) == set(w)
            for key in w:
                assert isinstance(g[key], torch.Tensor)
                np.testing.assert_array_equal(g[key].numpy(), w[key])


def test_cpu_batches_are_fresh_tensors():
    """On the CPU no buffer is recycled: every batch keeps its values."""
    ours, _ = _datasets(8)
    batches = list(DataLoader(ours, 4, device="cpu", num_workers=1,
                              prefetch=1))
    assert batches[0]["label"].tolist() == [0, 1, 2, 3]
    assert batches[1]["label"].tolist() == [4, 5, 6, 7]


def test_collate_into_reuses_full_buffers_only():
    samples = [{"a": np.full(2, i, np.float32)} for i in range(3)]
    bufs = {}
    first = collate_into(samples, bufs)
    assert first["a"] is bufs["a"]
    second = collate_into(samples[:2], bufs)  # ragged: fresh array
    assert second["a"] is not bufs["a"] and bufs["a"].shape == (3, 2)
    third = collate_into(samples[::-1], bufs)
    assert third["a"] is bufs["a"] and third["a"][0, 0] == 2


def test_loader_errors():
    ours, _ = _datasets(3)
    with pytest.raises(ValueError, match="batch_size"):
        DataLoader(ours, 0, device="cpu")
    with pytest.raises(ValueError, match="zero batches"):
        DataLoader(ours, 4, drop_last=True, device="cpu")
    with pytest.raises(ValueError, match="prefetch"):
        DataLoader(ours, 2, prefetch=0, device="cpu")


def test_default_device_is_the_card():
    ours, _ = _datasets(3)
    if torch.cuda.is_available():
        assert DataLoader(ours, 2).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            DataLoader(ours, 2)


class _Failing:
    def __len__(self):
        return 6

    def __getitem__(self, i):
        if i == 4:
            raise OSError("unreadable scan")
        return {"x": np.zeros(2, np.float32)}


def test_a_decode_failure_reaches_the_consumer():
    loader = DataLoader(_Failing(), 2, device="cpu", num_workers=1)
    with pytest.raises(OSError, match="unreadable"):
        list(loader)
