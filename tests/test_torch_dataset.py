"""The port's data stack against the JAX package's, on the CPU.

One synthetic split feeds both packages: the port's writer and JAX's write
the same manifests and the same volumes from one seed, the port's NIfTI
reader reads what JAX writes, pairing keeps JAX's rows in JAX's order, and
``MultiModalDataset`` gives the same items, memoised min-max bounds, label
distributions and host-normalised items. Volumes, bounds and tabular
vectors are compared exactly; host-normalised volumes within rtol 1e-6 (min-
max) and 2e-5 (z-score, reductions in another order).
"""

import gzip
import os
import struct

import numpy as np
import pandas as pd
import pytest
import yaml

from multimodal_alzheimer_tpu.data import nifti as jax_nifti
from multimodal_alzheimer_tpu.data import pairing as jax_pairing
from multimodal_alzheimer_tpu.data import synthetic as jax_synthetic
from multimodal_alzheimer_tpu.data.dataset import (
    MultiModalDataset as JaxDataset,
)
from multimodal_alzheimer_tpu.utils import path_config as jax_path_config
from multimodal_alzheimer_tpu_torch.data import nifti, pairing, synthetic
from multimodal_alzheimer_tpu_torch.data.dataset import (
    MultiModalDataset,
    read_manifest,
)
from multimodal_alzheimer_tpu_torch.data.tabular import tabular_vector
from multimodal_alzheimer_tpu_torch.utils import path_config
from torch_threads import torch_threads  # noqa: F401 (autouse)

SHAPE = (12, 14, 12)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def split(tmp_path_factory):
    """The same split written by both packages: (port paths, JAX paths)."""
    root = tmp_path_factory.mktemp("split")
    kw = dict(n_subjects=(8, 6, 8), seed=6, volume_shape=SHAPE)
    return (synthetic.write_synthetic_split(str(root / "port"), **kw),
            jax_synthetic.write_synthetic_split(str(root / "jax"), **kw))


def test_writers_give_the_same_manifests_and_volumes(split):
    port, jax = split
    for mode in ("train", "val", "test"):
        with open(port[mode]) as f:
            port_text = f.read().replace(os.path.dirname(port[mode]), "@")
        with open(jax[mode]) as f:
            jax_text = f.read().replace(os.path.dirname(jax[mode]), "@")
        assert port_text == jax_text
        pd.testing.assert_frame_equal(
            pd.read_csv(port[mode]).drop(columns=["path_pet1451", "path_anat",
                                                  "path_anat_mask"]),
            pd.read_csv(jax[mode]).drop(columns=["path_pet1451", "path_anat",
                                                 "path_anat_mask"]))
    port_images = os.path.join(os.path.dirname(port["train"]), "images")
    jax_images = os.path.join(os.path.dirname(jax["train"]), "images")
    names = sorted(os.listdir(port_images))
    assert names == sorted(os.listdir(jax_images)) and len(names) > 50
    for name in names:
        np.testing.assert_array_equal(
            nifti.load_nifti(os.path.join(port_images, name)),
            jax_nifti.load_nifti(os.path.join(jax_images, name)))


def test_manifest_rows_match_jax_frame():
    rows = synthetic.make_manifest_frame(n_subjects=5, seed=3)
    frame = jax_synthetic.make_manifest_frame(n_subjects=5, seed=3)
    assert list(frame.columns) == synthetic.MANIFEST_COLUMNS
    expected = frame.astype(object).where(frame.notna(), None)
    assert rows == expected.to_dict("records")


@pytest.mark.parametrize("compress", [False, True], ids=["nii", "nii.gz"])
@pytest.mark.parametrize("dtype", [np.float32, np.int16, np.uint8,
                                   np.float64])
def test_reads_jax_written_files(tmp_path, compress, dtype):
    rng = np.random.default_rng(0)
    if np.issubdtype(dtype, np.floating):
        vol = rng.normal(size=(7, 9, 5)).astype(dtype)
    else:
        vol = rng.integers(0, 100, size=(7, 9, 5)).astype(dtype)
    path = tmp_path / ("v.nii.gz" if compress else "v.nii")
    jax_nifti.save_nifti(path, vol)
    for out in (np.float32, np.float64):
        got = nifti.load_nifti(path, dtype=out)
        assert got.dtype == out and got.shape == vol.shape
        np.testing.assert_array_equal(got, vol.astype(out))
        np.testing.assert_array_equal(got, jax_nifti.load_nifti(path,
                                                                dtype=out))
    port_path = tmp_path / ("p.nii.gz" if compress else "p.nii")
    nifti.save_nifti(port_path, vol)
    opener = gzip.open if compress else open
    with opener(port_path, "rb") as a, opener(path, "rb") as b:
        assert a.read() == b.read()


def _write_raw(path, vol, end, slope, inter, datatype=16, magic=b"n+1\x00"):
    """A single-file NIfTI-1 with the given byte order and scaling."""
    header = bytearray(352)
    struct.pack_into(end + "i", header, 0, 348)
    dims = (vol.ndim,) + vol.shape + (1,) * (7 - vol.ndim)
    struct.pack_into(end + "8h", header, 40, *dims)
    struct.pack_into(end + "h", header, 70, datatype)
    struct.pack_into(end + "f", header, 108, 352.0)
    struct.pack_into(end + "f", header, 112, slope)
    struct.pack_into(end + "f", header, 116, inter)
    header[344:348] = magic
    data = vol.astype(vol.dtype.newbyteorder(end)).tobytes(order="F")
    with gzip.open(path, "wb") as f:
        f.write(bytes(header) + data)


@pytest.mark.parametrize("end", ["<", ">"], ids=["little", "big"])
@pytest.mark.parametrize("slope, inter", [(1.0, 0.0), (2.0, -3.5),
                                          (0.0, 7.0), (float("nan"), 1.0),
                                          (1.0, float("nan"))])
def test_byte_order_and_scaling_match_jax(tmp_path, end, slope, inter):
    vol = np.random.default_rng(1).normal(size=(5, 6, 4)).astype(np.float32)
    path = str(tmp_path / "s.nii.gz")
    _write_raw(path, vol, end, slope, inter)
    for apply_scaling in (True, False):
        got = nifti.load_nifti(path, apply_scaling=apply_scaling)
        want = jax_nifti.load_nifti(path, apply_scaling=apply_scaling)
        np.testing.assert_array_equal(got, want)
    if slope == 2.0:
        np.testing.assert_allclose(got, vol, rtol=0, atol=0)
        np.testing.assert_allclose(nifti.load_nifti(path),
                                   vol * np.float32(2.0) - np.float32(3.5))


@pytest.mark.parametrize("kind", ["truncated", "not_nifti", "magic",
                                  "datatype", "two_file"])
def test_errors_match_jax(tmp_path, kind):
    path = str(tmp_path / "bad.nii.gz")
    vol = np.zeros((2, 2, 2), np.float32)
    if kind == "truncated":
        with gzip.open(path, "wb") as f:
            f.write(b"\0" * 100)
    elif kind == "not_nifti":
        with gzip.open(path, "wb") as f:
            f.write(b"\1" * 400)
    else:
        _write_raw(path, vol, "<", 1.0, 0.0,
                   datatype=1024 if kind == "datatype" else 16,
                   magic={"magic": b"abc\x00",
                          "two_file": b"ni1\x00"}.get(kind, b"n+1\x00"))
    with pytest.raises(ValueError) as want:
        jax_nifti.load_nifti(path)
    with pytest.raises(ValueError) as got:
        nifti.load_nifti(path)
    assert str(got.value) == str(want.value)


def _frames(seed, n_subjects, modalities):
    """Per-modality frames of one manifest, for both packages."""
    from datetime import datetime

    frame = jax_synthetic.make_manifest_frame(n_subjects=n_subjects,
                                              seed=seed)
    rows = synthetic.make_manifest_frame(n_subjects=n_subjects, seed=seed)
    cols = {"pet1451": "path_pet1451", "t1w": "path_anat", "tabular": "AGE"}
    jax_frames, port_frames = [], []
    for m in modalities:
        f = frame.dropna(subset=cols[m]).reset_index(drop=True)
        f["ses"] = f["ses"].map(lambda x: datetime.strptime(x, "%Y-%m-%d"))
        jax_frames.append(f)
        port_frames.append([dict(r, ses=datetime.strptime(r["ses"],
                                                          "%Y-%m-%d"))
                            for r in rows if r[cols[m]] is not None])
    return jax_frames, port_frames


def _as_records(frame):
    frame = frame.astype(object).where(frame.notna(), None)
    return [{k: (pd.Timestamp(v) if k in ("min_time", "max_time") else v)
             for k, v in r.items()} for r in frame.to_dict("records")]


@pytest.mark.parametrize("seed", [0, 1, 2, 5])
@pytest.mark.parametrize("days", [30, 180, 400])
@pytest.mark.parametrize("modalities", [("pet1451", "t1w"),
                                        ("t1w", "tabular"),
                                        ("pet1451", "t1w", "tabular")],
                         ids=["pet_t1w", "t1w_tab", "all"])
def test_pairing_matches_jax_row_for_row(seed, days, modalities):
    jax_frames, port_frames = _frames(seed, 10, modalities)
    want = _as_records(jax_pairing.expand_pairings(jax_frames, days))
    got = [{k: (pd.Timestamp(v) if k in ("min_time", "max_time") else v)
            for k, v in r.items()}
           for r in pairing.expand_pairings(port_frames, days)]
    assert got == want


def test_pairing_fills_a_column_per_match_group():
    """The reference's group fill: a base value overwrites a column in
    every match of the group when ANY match lacks it."""
    from datetime import datetime

    day = datetime(2020, 1, 1)
    base = [{"ID": "a", "label": "CN", "ses": day, "x": 1.0, "y": None}]
    right = [{"ID": "a", "label": "CN", "ses": day, "x": None, "y": 5.0},
             {"ID": "a", "label": "CN", "ses": day, "x": 2.0, "y": 6.0}]
    got = pairing.expand_pairings([base, right])
    assert [r["x"] for r in got] == [1.0, 1.0]
    assert [r["y"] for r in got] == [5.0, 6.0]
    jax = jax_pairing.expand_pairings([pd.DataFrame(base),
                                       pd.DataFrame(right)])
    assert list(jax["x"]) == [1.0, 1.0] and list(jax["y"]) == [5.0, 6.0]


def _items_equal(got, want):
    assert set(got) == set(want)
    for key, value in want.items():
        assert np.asarray(got[key]).dtype == np.asarray(value).dtype, key
        np.testing.assert_array_equal(got[key], value, err_msg=key)


DATASETS = {
    "t1w_minmax": dict(modalities=["t1w"],
                       normalize_mri={"per_scan_norm": "min_max"},
                       quantile=0.98),
    "t1w_zscore": dict(modalities=["t1w"],
                       normalize_mri={"per_scan_norm": "normalize"}),
    "t1w_raw": dict(modalities=["t1w"]),
    "all_binary": dict(modalities=["tabular", "t1w", "pet1451"],
                       binary_classification=2,
                       normalize_pet={"mean": 0.5, "std": 0.6},
                       normalize_mri={"per_scan_norm": "min_max"}),
    "all_three_class": dict(normalize_pet={"mean": 0.5, "std": 0.6},
                            normalize_mri={"per_scan_norm": "normalize"},
                            compat_whole_brain_bug=False),
    "pet_tabular": dict(modalities=["pet1451", "tabular"],
                        binary_classification=True),
}


@pytest.mark.parametrize("mode", ["train", "test"])
@pytest.mark.parametrize("name", sorted(DATASETS))
def test_dataset_items_match_jax(split, name, mode):
    port_paths, jax_paths = split
    kw = DATASETS[name]
    got = MultiModalDataset(port_paths[mode], **kw)
    want = JaxDataset(jax_paths[mode], **kw)
    assert len(got) == len(want) > 0
    assert got.label_mapping == want.label_mapping
    for i in range(len(want)):
        _items_equal(got[i], want[i])
    for counts_got, counts_want in zip(got.get_label_distribution(),
                                       want.get_label_distribution()):
        np.testing.assert_array_equal(counts_got, counts_want)


@pytest.mark.parametrize("name", ["t1w_minmax", "t1w_zscore", "all_binary",
                                  "all_three_class"])
def test_host_normalized_items_match_jax(split, name):
    port_paths, jax_paths = split
    got = MultiModalDataset(port_paths["train"], **DATASETS[name])
    want = JaxDataset(jax_paths["train"], **DATASETS[name])
    tol = (dict(rtol=2e-5, atol=2e-5) if "zscore" in name
           or name == "all_three_class" else dict(rtol=1e-6, atol=1e-7))
    for i in range(min(3, len(want))):
        a, b = got.host_normalized_item(i), want.host_normalized_item(i)
        assert set(a) == set(b) and "mri_mask" not in a
        for key in b:
            np.testing.assert_allclose(a[key], b[key], err_msg=key,
                                       **(tol if key == "mri" else
                                          dict(rtol=1e-6, atol=1e-7)))


def test_memoised_bounds_and_sidecars_match_jax(split, tmp_path):
    """``mri_qminmax`` from the in-memory memo and from the sidecars beside
    the volume cache (float16 entries too) equal JAX's."""
    port_paths, jax_paths = split
    for dtype in (None, "float16"):
        kw = dict(modalities=["t1w"], normalize_mri={
            "per_scan_norm": "min_max"}, quantile=0.95, cache_dtype=dtype)
        got = MultiModalDataset(port_paths["train"],
                                cache_dir=str(tmp_path / f"p{dtype}"), **kw)
        want = JaxDataset(jax_paths["train"],
                          cache_dir=str(tmp_path / f"j{dtype}"), **kw)
        warm = MultiModalDataset(port_paths["train"],
                                 cache_dir=str(tmp_path / f"p{dtype}"), **kw)
        for i in range(len(want)):
            a, b = got[i], want[i]
            _items_equal(a, b)
            _items_equal(warm[i], b)  # read back from the cache
        sidecars = [f for f in os.listdir(tmp_path / f"p{dtype}")
                    if f.endswith(".q.npy")]
        assert len(sidecars) == len(want)
        got.quantile = 0.99  # a new quantile drops the old memo entries
        want.quantile = 0.99
        np.testing.assert_array_equal(got[0]["mri_qminmax"],
                                      want[0]["mri_qminmax"])
        assert {k[1] for k in got._minmax_memo} == {0.99}


def test_binary_classification_drops_mci(split):
    port_paths, _ = split
    ds3 = MultiModalDataset(port_paths["train"], modalities=["tabular"])
    ds2 = MultiModalDataset(port_paths["train"], modalities=["tabular"],
                            binary_classification=True)
    assert len(ds2) < len(ds3)
    assert {int(ds2[i]["label"]) for i in range(len(ds2))} <= {0, 1}
    assert all(r["label"] != "MCI" for r in ds2.rows)


def test_label_distribution_has_nan_for_an_absent_class(tmp_path):
    rows = [r for r in synthetic.make_manifest_frame(n_subjects=6, seed=0)
            if r["label"] != "MCI"]
    path = str(tmp_path / "no_mci.csv")
    synthetic.write_manifest(rows, path)
    counts, normalized = MultiModalDataset(
        path, modalities=["tabular"]).get_label_distribution()
    want_counts, want_normalized = JaxDataset(
        path, modalities=["tabular"]).get_label_distribution()
    assert np.isnan(counts[1]) and np.isnan(normalized[1])
    np.testing.assert_array_equal(counts, want_counts)
    np.testing.assert_array_equal(normalized, want_normalized)


def test_manifest_reader_infers_types_as_pandas(tmp_path):
    path = tmp_path / "m.csv"
    path.write_text("ID,a,b,c,label\n1,2,2.5,x,CN\n3,,NaN,,MCI\n")
    rows = read_manifest(str(path))
    assert rows == [{"ID": 1, "a": 2.0, "b": 2.5, "c": "x", "label": "CN"},
                    {"ID": 3, "a": None, "b": None, "c": None,
                     "label": "MCI"}]
    frame = pd.read_csv(path)
    assert frame["ID"].dtype == np.int64 and frame["a"].dtype == np.float64


def test_tabular_vector_keeps_the_whole_brain_quirk():
    row = synthetic.make_manifest_frame(n_subjects=2, seed=1)[-1]
    assert row["AGE"] is not None
    bug, fixed = tabular_vector(row), tabular_vector(row, False)
    assert bug[4] == bug[1] == np.float32(row["PTEDUCAT"])
    assert fixed[4] == np.float32(row["WholeBrain"])


def test_path_config_matches_yaml(tmp_path):
    config = os.path.join(REPO, "path_config.yaml")
    with open(config) as f:
        text = f.read()
    assert path_config.parse_path_config(text) == yaml.safe_load(text)
    assert (path_config.load_path_config(config, root=str(tmp_path))
            == jax_path_config.load_path_config(config, root=str(tmp_path)))
    more = text + "mri_cnn_2_class: 'runs/epoch=3-val_loss=0.512'\n"
    assert path_config.parse_path_config(more) == yaml.safe_load(more)


@pytest.mark.parametrize("text", ["a: [1, 2]\n", "a: {b: 1}\n",
                                  "relative:\n  a:\n    b: 'c'\n",
                                  "x: 'a'\nx: 'b'\n", "  a: 'b'\n",
                                  "a: - b\n"])
def test_path_config_raises_on_what_it_does_not_read(text):
    with pytest.raises(ValueError):
        path_config.parse_path_config(text)
