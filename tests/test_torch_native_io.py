"""The port's native NIfTI decoder against the JAX package's, on the CPU.

Ports ``tests/test_native_io.py`` (build, shape, single decode, batch
decode, bad path at (9, 11, 7), float32/float64/int16, gzip or not) and
holds every case bit for bit to JAX's ``native_io``: both libraries are
built from the same C++ code with the same flags on this host. The plain
reader (``data/nifti.load_nifti``) agrees bit for bit at ``scl_slope`` 1
and within 1 ulp otherwise (GCC may contract ``x * slope + inter`` into
an FMA under ``-march=native``). Also: a truncated gzip, a big-endian file
(the native parse rejects it, as JAX's does), the capacity retry, the
fallback when no compiler is found, concurrent builds, and the dataset
and ``VolumeCache`` decoding natively with JAX's arrays.
"""

import gzip
import os
import struct
import threading

import numpy as np
import pytest

from multimodal_alzheimer_tpu.data import native_io as jax_native_io
from multimodal_alzheimer_tpu.data.cache import VolumeCache as JaxCache
from multimodal_alzheimer_tpu.data.dataset import (
    MultiModalDataset as JaxDataset,
)
from multimodal_alzheimer_tpu_torch.data import native_io
from multimodal_alzheimer_tpu_torch.data.cache import VolumeCache
from multimodal_alzheimer_tpu_torch.data.dataset import MultiModalDataset
from multimodal_alzheimer_tpu_torch.data.nifti import load_nifti, save_nifti
from multimodal_alzheimer_tpu_torch.data.synthetic import (
    write_synthetic_split,
)
from torch_threads import torch_threads  # noqa: F401 (autouse)

SHAPE = (9, 11, 7)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CASES = [(False, np.float32), (True, np.float32), (True, np.int16),
         (False, np.float64), (True, np.uint8), (False, np.int32),
         (True, np.uint16), (True, np.int8), (False, np.uint32)]


def _volume(rng, dtype, shape=SHAPE):
    if np.issubdtype(dtype, np.floating):
        return rng.normal(size=shape).astype(dtype)
    info = np.iinfo(dtype)
    return rng.integers(max(info.min, -50), min(info.max, 50),
                        size=shape).astype(dtype)


@pytest.fixture(scope="module")
def volumes(tmp_path_factory):
    d = tmp_path_factory.mktemp("vols")
    rng = np.random.default_rng(0)
    paths, arrays = [], []
    for i, (compress, dtype) in enumerate(CASES):
        vol = _volume(rng, dtype)
        p = d / (f"v{i}.nii.gz" if compress else f"v{i}.nii")
        save_nifti(p, vol)
        paths.append(str(p))
        arrays.append(vol.astype(np.float32))
    return paths, arrays


def _with_scaling(path, slope, inter, compress):
    """Rewrite ``path`` (a .nii written by save_nifti) with another
    scl_slope / scl_inter, gzipped or not; returns the new path."""
    raw = bytearray(open(path, "rb").read())
    struct.pack_into("<ff", raw, 112, slope, inter)
    out = f"{path}.s{slope}_{inter}.nii" + (".gz" if compress else "")
    with (gzip.open if compress else open)(out, "wb") as f:
        f.write(bytes(raw))
    return out


def _big_endian(path, vol):
    """A big-endian NIfTI-1 of ``vol`` (float32): the plain reader reads
    it, the native parse does not."""
    header = bytearray(352)
    struct.pack_into(">i", header, 0, 348)
    struct.pack_into(">8h", header, 40, vol.ndim, *vol.shape,
                     *(1,) * (7 - vol.ndim))
    struct.pack_into(">hh", header, 70, 16, 32)
    struct.pack_into(">fff", header, 108, 352.0, 1.0, 0.0)
    header[344:348] = b"n+1\x00"
    with open(path, "wb") as f:
        f.write(bytes(header) + vol.astype(">f4").tobytes(order="F"))
    return str(path)


def _equal(got, want):
    """Bit for bit: dtype, shape and every value."""
    assert got.dtype == want.dtype == np.float32
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def test_native_builds():
    assert native_io.available(), native_io.build_log()
    assert native_io.build_log() == ""
    path = native_io.library_path()
    assert path.exists() and path.parent == native_io.BUILD_DIR


def test_the_source_is_the_jax_packages_code():
    """The port's copy differs from native/nifti_io.cc in comments only."""
    def code(path):
        return [line for line in open(path).read().splitlines()
                if not line.startswith("//")]

    assert code(native_io.SOURCE) == code(os.path.join(REPO, "native",
                                                       "nifti_io.cc"))


def test_shape(volumes):
    paths, arrays = volumes
    for p, a in zip(paths, arrays):
        assert native_io.nifti_shape(p) == jax_native_io.nifti_shape(p) \
            == a.shape


@pytest.mark.parametrize("case", range(len(CASES)),
                         ids=[f"{'gz' if c else 'nii'}-{np.dtype(d).name}"
                              for c, d in CASES])
def test_single_decode_matches_jax_and_python(volumes, case):
    paths, arrays = volumes
    got, want = native_io.decode(paths[case]), jax_native_io.decode(
        paths[case])
    _equal(got, want)
    assert got.strides == want.strides
    _equal(got, load_nifti(paths[case]))
    np.testing.assert_array_equal(got, arrays[case])


@pytest.mark.parametrize("threads", [1, 4, 16])
def test_batch_decode_matches_jax(volumes, threads):
    paths, arrays = volumes
    batch = native_io.decode_batch(paths, SHAPE, num_threads=threads)
    want = jax_native_io.decode_batch(paths, SHAPE, num_threads=threads)
    assert batch.shape == want.shape == (len(paths),) + SHAPE
    assert batch.strides == want.strides
    np.testing.assert_array_equal(batch.view(np.uint32),
                                  want.view(np.uint32))
    for i, a in enumerate(arrays):
        np.testing.assert_array_equal(batch[i], a)


def test_batch_decode_bad_path(volumes):
    paths, _ = volumes
    bad = [paths[0], "/nonexistent.nii"]
    with pytest.raises(IOError) as got:
        native_io.decode_batch(bad, SHAPE)
    with pytest.raises(IOError) as want:
        jax_native_io.decode_batch(bad, SHAPE)
    assert str(got.value) == str(want.value) == \
        "batch decode failed at file 1: /nonexistent.nii"


def test_missing_file_errors_match_jax():
    for fn in ("decode", "nifti_shape"):
        with pytest.raises(IOError) as got:
            getattr(native_io, fn)("/nonexistent.nii")
        with pytest.raises(IOError) as want:
            getattr(jax_native_io, fn)("/nonexistent.nii")
        assert str(got.value) == str(want.value)


@pytest.mark.parametrize("slope,inter", [(1.5, -3.25), (0.37, 0.0),
                                         (1.0, 12.5), (0.0, 7.0),
                                         (2.0, float("nan"))])
@pytest.mark.parametrize("compress", [False, True])
@pytest.mark.parametrize("dtype", [np.int16, np.float32])
def test_scaling_matches_jax_bit_for_bit_and_python_within_an_ulp(
        tmp_path, slope, inter, compress, dtype):
    vol = _volume(np.random.default_rng(3), dtype) * (
        1000 if dtype == np.float32 else 1)
    plain = tmp_path / "v.nii"
    save_nifti(plain, vol.astype(dtype))
    path = _with_scaling(str(plain), slope, inter, compress)
    got = native_io.decode(path)
    _equal(got, jax_native_io.decode(path))
    batch = native_io.decode_batch([path, path], SHAPE, num_threads=2)
    np.testing.assert_array_equal(batch[1], got)
    np.testing.assert_array_max_ulp(got, load_nifti(path), maxulp=1)


def test_nan_slope_adds_the_intercept_natively_as_in_jax(tmp_path):
    """A NaN scl_slope: the plain reader (as nibabel) leaves the data
    unscaled; the native decoder takes the slope as 1 and still adds
    scl_inter. The JAX package's decoder does so too (ROADMAP section C)."""
    vol = _volume(np.random.default_rng(7), np.int16)
    plain = tmp_path / "v.nii"
    save_nifti(plain, vol)
    path = _with_scaling(str(plain), float("nan"), 2.0, True)
    got = native_io.decode(path)
    _equal(got, jax_native_io.decode(path))
    np.testing.assert_array_equal(got, vol.astype(np.float32) + 2.0)
    np.testing.assert_array_equal(load_nifti(path), vol.astype(np.float32))


def test_truncated_gzip_raises_jax_error(volumes, tmp_path):
    paths, _ = volumes
    blob = open(paths[1], "rb").read()
    path = str(tmp_path / "cut.nii.gz")
    with open(path, "wb") as f:
        f.write(blob[:len(blob) // 2])
    with pytest.raises(IOError) as got:
        native_io.decode(path)
    with pytest.raises(IOError) as want:
        jax_native_io.decode(path)
    assert str(got.value) == str(want.value) == \
        f"mmalz_nifti_decode_auto({path}) failed: -1"


def test_big_endian_is_rejected_natively_as_in_jax(tmp_path):
    vol = _volume(np.random.default_rng(4), np.float32)
    path = _big_endian(tmp_path / "be.nii", vol)
    np.testing.assert_array_equal(load_nifti(path), vol)
    for fn in ("decode", "nifti_shape"):
        with pytest.raises(IOError) as got:
            getattr(native_io, fn)(path)
        with pytest.raises(IOError) as want:
            getattr(jax_native_io, fn)(path)
        assert str(got.value) == str(want.value)
        assert str(got.value).endswith("failed: -2")


def test_volume_above_the_capacity_guess_retries(tmp_path):
    vol = np.random.default_rng(5).normal(size=(92, 110, 92)).astype(
        np.float32)
    path = str(tmp_path / "big.nii.gz")
    save_nifti(path, vol)
    got = native_io.decode(path)
    _equal(got, jax_native_io.decode(path))
    np.testing.assert_array_equal(got, vol)


def test_without_a_compiler_it_falls_back_to_the_plain_reader(
        volumes, monkeypatch):
    paths, arrays = volumes
    monkeypatch.setattr(native_io, "CXX", "no-such-compiler")
    monkeypatch.setattr(native_io, "_lib", None)
    monkeypatch.setattr(native_io, "_build_failed", False)
    monkeypatch.setattr(native_io, "_build_log", "")
    assert not native_io.available()
    assert "no-such-compiler" in native_io.build_log()
    _equal(native_io.decode(paths[1]), load_nifti(paths[1]))
    assert native_io.nifti_shape(paths[0]) == SHAPE
    np.testing.assert_array_equal(
        native_io.decode_batch(paths[:2], SHAPE), np.stack(arrays[:2]))


def test_concurrent_builds_make_one_library(tmp_path, monkeypatch):
    """Builders that start together (xdist workers, loader threads) build
    once under the lock and leave no temporary file."""
    monkeypatch.setattr(native_io, "BUILD_DIR", tmp_path / "_build")
    out, errors = [], []

    def build():
        try:
            out.append(native_io.build())
        except Exception as exc:  # reported below
            errors.append(exc)

    threads = [threading.Thread(target=build) for _ in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
        assert not t.is_alive()
    assert not errors and len(set(out)) == 1
    assert sorted(p.name for p in (tmp_path / "_build").iterdir()) == \
        sorted([out[0].name, "libmmalz_io.lock"])


@pytest.fixture(scope="module")
def split(tmp_path_factory):
    root = tmp_path_factory.mktemp("split")
    return write_synthetic_split(str(root / "data"), n_subjects=(6, 2, 2),
                                 seed=3, volume_shape=(12, 14, 12))


def test_dataset_decodes_natively_with_jax_arrays(split, monkeypatch):
    calls = []
    decode = native_io.decode
    monkeypatch.setattr(native_io, "decode",
                        lambda p: calls.append(p) or decode(p))
    kw = dict(modalities=["pet1451", "t1w"],
              normalize_mri={"per_scan_norm": "min_max"})
    port = MultiModalDataset(split["train"], **kw)
    jax = JaxDataset(split["train"], **kw)
    assert len(port) == len(jax) > 0
    for i in range(len(port)):
        got, want = port[i], jax[i]
        assert set(got) >= {"pet1451", "mri", "mri_mask"}
        for key in ("pet1451", "mri", "mri_mask", "mri_qminmax"):
            _equal(np.asarray(got[key]), np.asarray(want[key]))
    assert len(calls) == 3 * len(port)


def test_volume_cache_decodes_natively_with_jax_arrays(split, tmp_path,
                                                        monkeypatch):
    calls = []
    decode = native_io.decode
    monkeypatch.setattr(native_io, "decode",
                        lambda p: calls.append(p) or decode(p))
    rows = MultiModalDataset(split["val"], modalities=["t1w"]).rows
    for dtype in (None, "float16"):
        port = VolumeCache(tmp_path / f"port-{dtype}", dtype=dtype)
        jax = JaxCache(str(tmp_path / f"jax-{dtype}"), dtype=dtype)
        for row in rows:
            path = row["path_anat"]
            miss, hit = port.get(path), port.get(path)
            want = jax.get(path)
            for got in (miss, hit):
                np.testing.assert_array_equal(got, want)
                assert got.dtype == want.dtype
    assert len(calls) == 2 * len(rows)  # misses only


def test_dataset_raises_for_big_endian_as_jax_does(tmp_path):
    vol = _volume(np.random.default_rng(6), np.float32, (12, 14, 12))
    path = _big_endian(tmp_path / "be.nii", vol)
    csv = tmp_path / "m.csv"
    csv.write_text("ID,ses,path_pet1451,path_anat,path_anat_mask,AGE,label\n"
                   f"sub-1,2018-01-01,,{path},,,CN\n")
    for cls in (MultiModalDataset, JaxDataset):
        with pytest.raises(IOError, match="failed: -2"):
            cls(str(csv), modalities=["t1w"])[0]
