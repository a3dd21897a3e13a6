"""The port's pandas-free provisioning against the JAX package's, on the CPU.

Ports the seven cases of ``tests/test_manifest.py`` (tables as row dicts
instead of DataFrames), then runs both ``prepare_data`` CLIs (JAX's root
``tools/prepare_data.py`` and the port's ``main``, in-process) on synthetic
raw ADNI layouts (``data/synthetic.write_synthetic_adni``) that reach every
branch: image and tabular rows, an all-digit ``RID`` (int64 in pandas,
never equal to a ``sub-...`` directory), an ``RID`` with a gap (float64, a
NaN in the split), directory names mixed with digits, no PET or diagnosis
table, an existing split file, empty val and test splits. The split JSON,
the three manifests and the printed lines must be equal byte for byte.
``split_ids`` is held to JAX's (``pandas.Series.sample``) draws.
"""

import contextlib
import csv
import importlib.util
import io
import os
from datetime import datetime

import numpy as np
import pandas as pd
import pytest

from multimodal_alzheimer_tpu.data import manifest as jax_manifest
from multimodal_alzheimer_tpu.data.split import split_ids as jax_split_ids
from multimodal_alzheimer_tpu_torch.data import manifest
from multimodal_alzheimer_tpu_torch.data.csv_table import (
    format_cell,
    read_csv_rows,
)
from multimodal_alzheimer_tpu_torch.data.manifest import (
    MANIFEST_COLUMNS,
    build_manifest,
    count_modalities,
    find_closest_timestamp,
    get_diag,
    get_rid_from_id,
)
from multimodal_alzheimer_tpu_torch.data.split import split_ids
from multimodal_alzheimer_tpu_torch.data.synthetic import (
    write_synthetic_adni,
)
from multimodal_alzheimer_tpu_torch.tools import prepare_data
from torch_threads import torch_threads  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VOLUME = (9, 11, 7)


def _jax_prepare_data():
    """The JAX package's root ``tools/prepare_data.py`` as a module."""
    spec = importlib.util.spec_from_file_location(
        "jax_prepare_data", os.path.join(REPO, "tools", "prepare_data.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _make_bids(tmp_path):
    """Two subjects: one full PET+MRI, one MRI-only w/ too-far diagnosis."""
    for sub, ses in (("sub-1001", "ses-2018-03-01"),
                     ("sub-1002", "ses-2019-05-10")):
        pet = tmp_path / sub / "pet-AV1451" / ses
        pet.mkdir(parents=True)
        (pet / f"{sub}_pet_MNI_2mm.nii.gz").touch()
        (pet / f"{sub}_pet_native.nii.gz").touch()  # must be ignored
        anat = tmp_path / sub / "anat" / ses
        anat.mkdir(parents=True)
        (anat / f"{sub}_T1w_reg_ants2_MNI_2mm.nii.gz").touch()
        (anat / f"{sub}_T1w_native.nii.gz").touch()
    return str(tmp_path)


def _csv_text(rows) -> str:
    """Manifest rows as the port writes them."""
    path = io.StringIO()
    writer = csv.writer(path, lineterminator="\n")
    writer.writerow(MANIFEST_COLUMNS)
    for row in rows:
        writer.writerow([format_cell(row[c]) for c in MANIFEST_COLUMNS])
    return path.getvalue()


def test_get_diag_codes():
    assert get_diag({"DXCURREN": 1}) == "CN"
    assert get_diag({"DXCHANGE": 7}) == "CN"   # MCI->CN
    assert get_diag({"DXCHANGE": 4}) == "MCI"  # CN->MCI
    assert get_diag({"DIAGNOSIS": 3}) == "Dementia"
    assert get_diag({"DXCHANGE": 5}) == "Dementia"
    assert get_diag({}) == "not defined"


@pytest.mark.parametrize("column", ["DXCURREN", "DXCHANGE", "DIAGNOSIS"])
def test_get_diag_matches_jax_on_every_code(column):
    for value in (None, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 1.0, 3.0, "1"):
        row = {"RID": 1, column: value}
        series = pd.Series({"RID": 1, column: np.nan if value is None
                            else value})
        assert get_diag(row) == jax_manifest.get_diag(series), value


def test_get_rid():
    assert get_rid_from_id("sub-ADNI123S4567") == 4567
    assert get_rid_from_id("sub-1001") == 1001


def test_find_closest_timestamp():
    rows = [{"EXAMDATE": d} for d in ("2018-01-01", "2018-06-01", None,
                                      "2017-12-01")]
    days, idx = find_closest_timestamp(datetime(2018, 2, 1), rows)
    assert (days, idx) == (31, 0)


@pytest.mark.parametrize("dates,when", [
    (("2018-01-02", "2018-01-04", "2018-01-02"), datetime(2018, 1, 3)),
    ((None, "2017-05-05", "2019-05-05"), datetime(2018, 5, 5)),
    (("2018-03-01", None, "2018-02-27"), datetime(2018, 2, 28, 12)),
])
def test_find_closest_timestamp_matches_jax(dates, when):
    """Ties take the first row; rows without a date are skipped; days
    floor as ``timedelta.days`` does."""
    rows = [{"EXAMDATE": d} for d in dates]
    frame = pd.DataFrame({"EXAMDATE": list(dates)})
    assert find_closest_timestamp(when, rows) == \
        jax_manifest.find_closest_timestamp(when, frame)


def test_build_manifest(tmp_path):
    root = _make_bids(tmp_path)
    tau = [{"ID": "sub-1001", "ses": "ses-2018-03-01",
            "pet.modality": "pet-AV1451", "DX": "CN"}]
    diag = [
        # close enough for sub-1001 (within 150 days)
        {"RID": 1001, "EXAMDATE": "2018-02-01", "DXCURREN": 2},
        # too far for sub-1002 (> 150 days)
        {"RID": 1002, "EXAMDATE": "2018-01-01", "DXCURREN": 1},
    ]
    rows = build_manifest(["sub-1001", "sub-1002"], root,
                          tau_status_table=tau, diagnosis_table=diag)
    assert all(list(r) == MANIFEST_COLUMNS for r in rows)
    # PET: only sub-1001 has a tau-table row; MNI_2mm file selected
    pet_rows = [r for r in rows if r["path_pet1451"] is not None]
    assert len(pet_rows) == 1
    assert "MNI_2mm" in pet_rows[0]["path_pet1451"]
    assert pet_rows[0]["label"] == "CN"
    assert pet_rows[0]["ses"] == "2018-03-01"
    # MRI: sub-1001 diagnosis 28 days away -> MCI; sub-1002 dropped (>150d)
    mri_rows = [r for r in rows if r["path_anat"] is not None]
    assert len(mri_rows) == 1
    assert mri_rows[0]["ID"] == "sub-1001"
    assert mri_rows[0]["label"] == "MCI"
    assert "BrainExtractionMask" in mri_rows[0]["path_anat_mask"]
    frame = jax_manifest.build_manifest(
        ["sub-1001", "sub-1002"], root, tau_status_table=pd.DataFrame(tau),
        diagnosis_table=pd.DataFrame(diag))
    assert _csv_text(rows) == frame.to_csv(index=False)


def test_build_manifest_with_tabular(tmp_path):
    root = _make_bids(tmp_path)
    tab = [{
        "RID": "sub-1001", "EXAMDATE": datetime(2018, 3, 15),
        "Ventricles": 1.0, "Hippocampus": 2.0, "WholeBrain": 3.0,
        "Entorhinal": 4.0, "Fusiform": 5.0, "MidTemp": 6.0, "ICV": 7.0,
        "AGE": 75.0, "PTEDUCAT": 16.0, "DX": "CN"}]
    rows = build_manifest(["sub-1001"], root, tabular_table=tab)
    tab_rows = [r for r in rows if r["AGE"] is not None]
    assert len(tab_rows) == 1
    assert tab_rows[0]["ses"] == "2018-03-15"
    assert tab_rows[0]["label"] == "CN"
    frame = jax_manifest.build_manifest(["sub-1001"], root,
                                        tabular_table=pd.DataFrame(tab))
    assert _csv_text(rows) == frame.to_csv(index=False)


def test_count_modalities(tmp_path):
    root = _make_bids(tmp_path)
    census = count_modalities(root)
    assert len(census) == 2
    assert all(r["has_pet1451"] and r["has_anat"] for r in census)
    assert census == jax_manifest.count_modalities(root).to_dict("records")


def test_prepare_data_cli(tmp_path):
    """The port's prepare_data end to end on the JAX test's tree and
    tables, in-process; JAX's script writes the same files."""
    root = _make_bids(tmp_path / "bids")
    pd.DataFrame({
        "RID": ["sub-1001", "sub-1002"],
        "EXAMDATE": ["01/03/2018", "10/05/2019"],
        "Ventricles": [1.0, 2.0], "Hippocampus": [1.0, 2.0],
        "WholeBrain": [1.0, 2.0], "Entorhinal": [1.0, 2.0],
        "Fusiform": [1.0, 2.0], "MidTemp": [1.0, 2.0],
        "ICV": [1.0, 2.0], "AGE": [70.0, 75.0],
        "Years_bl": [1.0, 2.0], "PTEDUCAT": [16, 12],
        "DX": ["CN", "Dementia"],
    }).to_csv(tmp_path / "adni_merged.csv", index=False)
    pd.DataFrame([
        {"ID": "sub-1001", "ses": "ses-2018-03-01",
         "pet.modality": "pet-AV1451", "DX": "CN"},
    ]).to_csv(tmp_path / "tau.csv", index=False)
    pd.DataFrame([
        {"RID": 1001, "EXAMDATE": "2018-02-01", "DXCURREN": 2},
    ]).to_csv(tmp_path / "diag.csv", index=False)
    tables = {"adni_merged": str(tmp_path / "adni_merged.csv"),
              "bids_root": root, "tau_status": str(tmp_path / "tau.csv"),
              "diagnosis": str(tmp_path / "diag.csv")}
    port, jax = _run_both(tmp_path, tables)
    for mode in ("train", "val", "test"):
        assert os.path.exists(
            tmp_path / "port" / "data" / f"{mode}_path_data_labels.csv")
    assert port == jax


def _argv(tables: dict, out: str, tau_and_diagnosis: bool = True) -> list:
    argv = ["--adni-merged", tables["adni_merged"],
            "--bids-root", tables["bids_root"],
            "--out-dir", os.path.join(out, "data"),
            "--split-json", os.path.join(out, "data_set_split.json")]
    if tau_and_diagnosis:
        argv += ["--tau-status", tables["tau_status"],
                 "--diagnosis", tables["diagnosis"]]
    return argv


def _run_both(tmp_path, tables, tau_and_diagnosis=True, split_json=None):
    """(port, JAX): each CLI's printed lines (its output directory written
    as ``@``) and the bytes of its split JSON and three manifests."""
    out = []
    for name, main in (("port", prepare_data.main),
                       ("jax", _jax_prepare_data().main)):
        where = str(tmp_path / name)
        os.makedirs(where, exist_ok=True)
        if split_json is not None:
            with open(os.path.join(where, "data_set_split.json"), "w") as f:
                f.write(split_json)
        printed = io.StringIO()
        with contextlib.redirect_stdout(printed):
            main(_argv(tables, where, tau_and_diagnosis))
        files = [os.path.join(where, "data_set_split.json")] + [
            os.path.join(where, "data", f"{m}_path_data_labels.csv")
            for m in ("train", "val", "test")]
        out.append((printed.getvalue().replace(where, "@"),
                    [open(p, "rb").read() for p in files]))
    return out


def _rewrite_rid(path: str, cell) -> None:
    """Replace each ``Adni_merged`` row's RID by ``cell(i, directory)``."""
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    for i, row in enumerate(rows[1:]):
        row[0] = cell(i, row[0])
    with open(path, "w", newline="") as f:
        csv.writer(f, lineterminator="\n").writerows(rows)


RID_STYLES = {
    "directory": None,
    "digits": lambda i, d: d[-4:],
    "digits_with_gap": lambda i, d: "" if i == 3 else d[-4:],
    "mixed": lambda i, d: d[-4:] if i % 3 == 0 else d,
}


@pytest.mark.parametrize("n_subjects", [5, 15, 25, 40])
@pytest.mark.parametrize("rid", list(RID_STYLES))
def test_prepare_data_equals_jax_byte_for_byte(tmp_path, n_subjects, rid):
    tables = write_synthetic_adni(str(tmp_path / "raw"), n_subjects,
                                  seed=n_subjects, volume_shape=VOLUME)
    if RID_STYLES[rid] is not None:
        _rewrite_rid(tables["adni_merged"], RID_STYLES[rid])
    port, jax = _run_both(tmp_path, tables)
    assert port[0] == jax[0]
    assert port[1] == jax[1]
    if rid == "directory" and n_subjects >= 15:
        rows = [read_csv_rows(str(tmp_path / "port" / "data" /
                              f"{m}_path_data_labels.csv"))
                for m in ("train", "val", "test")]
        assert all(any(r["path_anat"] for r in split) for split in rows)
        assert all(any(r["AGE"] is not None for r in split)
                   for split in rows)


@pytest.mark.parametrize("rid", ["directory", "digits"])
def test_prepare_data_without_pet_and_diagnosis_tables(tmp_path, rid):
    tables = write_synthetic_adni(str(tmp_path / "raw"), 15, seed=2,
                                  volume_shape=VOLUME)
    if RID_STYLES[rid] is not None:
        _rewrite_rid(tables["adni_merged"], RID_STYLES[rid])
    port, jax = _run_both(tmp_path, tables, tau_and_diagnosis=False)
    assert port == jax
    # tabular rows alone: PTEDUCAT stays an int column ("16", not "16.0")
    rows = read_csv_rows(str(tmp_path / "port" / "data" /
                             "train_path_data_labels.csv"))
    assert rows and all(isinstance(r["PTEDUCAT"], int) for r in rows)


def test_prepare_data_keeps_an_existing_split(tmp_path):
    tables = write_synthetic_adni(str(tmp_path / "raw"), 15, seed=4,
                                  volume_shape=VOLUME)
    split = '{"train": ["sub-2000", "sub-2001"], "val": ["sub-2003"], ' \
            '"test": []}'
    port, jax = _run_both(tmp_path, tables, split_json=split)
    assert port == jax
    assert port[0].startswith("using existing split")


def test_the_edge_cases_of_the_synthetic_layout_are_reached(tmp_path):
    """The layout's dropped diagnoses, tie, undated row, untabled PET
    sessions and gap row are where prepare_data meets them."""
    tables = write_synthetic_adni(str(tmp_path / "raw"), 40, seed=1,
                                  volume_shape=VOLUME)
    os.makedirs(tmp_path / "port")
    paths = prepare_data.main(_argv(tables, str(tmp_path / "port")))
    split = split_ids([r["RID"] for r in read_csv_rows(
        tables["adni_merged"])])
    train = split["train"]
    rows = read_csv_rows(paths["train"])
    mri = {r["ID"] for r in rows if r["path_anat"] is not None}
    assert train[0] not in mri and train[1] not in mri  # far, none
    assert {train[2], train[3]} <= mri  # tie, undated row
    diag = read_csv_rows(tables["diagnosis"])
    tie = [r for r in rows if r["ID"] == train[2]
           and r["path_anat"] is not None]
    first = next(r for r in diag if r["RID"] == int(train[2][-4:]))
    assert all(r["label"] == get_diag(first) for r in tie)
    pet = [r for r in rows if r["path_pet1451"] is not None]
    assert sum(r["ID"] == train[4] for r in pet) == 1
    assert sum(r["ID"] == train[5] for r in pet) == 1
    merged = read_csv_rows(tables["adni_merged"])
    tab = [r for r in rows if r["AGE"] is not None]
    assert len(tab) == sum(r["RID"] in train for r in merged) - 1
    assert all(isinstance(r["PTEDUCAT"], float) for r in tab)


def test_load_tabular_table_matches_jax(tmp_path):
    tables = write_synthetic_adni(str(tmp_path / "raw"), 15, seed=5,
                                  volume_shape=VOLUME)
    rows = manifest.load_tabular_table(tables["adni_merged"])
    frame = jax_manifest.load_tabular_table(tables["adni_merged"])
    want = frame.to_dict("records")
    assert len(rows) == len(want)
    for got, row in zip(rows, want):
        assert set(got) == set(row)
        for key, value in row.items():
            if key == "EXAMDATE":
                assert got[key] == value.to_pydatetime()
            else:
                assert got[key] == value and type(got[key]) is type(
                    value.item() if hasattr(value, "item") else value)


@pytest.mark.parametrize("n", [1, 5, 15, 25, 100, 2162])
@pytest.mark.parametrize("kind", ["int", "str"])
def test_split_ids_matches_pandas_sample(n, kind):
    rng = np.random.default_rng(n)
    ids = rng.permutation(10 * n)[:n].tolist()
    ids = ids + ids[:n // 3]  # duplicates: the first occurrence stays
    rng.shuffle(ids)
    if kind == "str":
        ids = [f"sub-{i}" for i in ids]
    got = split_ids(ids)
    assert got == jax_split_ids(pd.Series(ids))
    assert len(got["test"]) == round(0.1 * n)
    assert sorted(got["train"] + got["val"] + got["test"]) == \
        sorted(set(ids))
