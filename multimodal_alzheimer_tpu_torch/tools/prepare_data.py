"""One-command data provisioning: ADNI tables + BIDS tree -> manifests.

Port of the JAX package's ``tools/prepare_data.py``, without pandas. Chains
the reference's offline L0 steps (SURVEY §2.1) into a single CLI:
  1. patient-level split (DataSplit.py semantics, seeds 3551/4381) ->
     data_set_split.json (skipped if the file already exists),
  2. per-split manifest CSVs (create_csv/data_labels.py semantics),
  3. sanity checks: no subject leakage.

Same flags, same printed lines, and the same files byte for byte as the
JAX package's script writes from the same inputs.

Usage:
    python -m multimodal_alzheimer_tpu_torch.tools.prepare_data \\
        --adni-merged Adni_merged.csv \\
        --bids-root /data/adni/data_bids_processed \\
        --tau-status ADNI_Tau_Amyloid_SUVR_amyloid_tau_status_dems.csv \\
        --diagnosis DXSUM_PDXCONV_ADNIALL.csv \\
        --out-dir data
"""

from __future__ import annotations

import argparse
import json
import os

from multimodal_alzheimer_tpu_torch.data.csv_table import read_csv_rows
from multimodal_alzheimer_tpu_torch.data.manifest import (
    build_split_manifests,
)
from multimodal_alzheimer_tpu_torch.data.split import split_tabular
from multimodal_alzheimer_tpu_torch.utils.plots_dataset import (
    check_no_subject_leakage,
)


def main(argv=None) -> dict:
    """Run the CLI on ``argv``; returns the manifest paths by split."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--adni-merged", required=True,
                        help="Adni_merged.csv (tabular features + split IDs)")
    parser.add_argument("--bids-root", required=True,
                        help="data_bids_processed directory")
    parser.add_argument("--tau-status", default=None,
                        help="tau/amyloid status CSV (PET labels)")
    parser.add_argument("--diagnosis", default=None,
                        help="DXSUM_PDXCONV_ADNIALL.csv (MRI labels)")
    parser.add_argument("--out-dir", default="data")
    parser.add_argument("--split-json", default="data_set_split.json")
    args = parser.parse_args(argv)

    if os.path.exists(args.split_json):
        with open(args.split_json) as f:
            split = json.load(f)
        print(f"using existing split {args.split_json}")
    else:
        split = split_tabular(args.adni_merged, args.split_json)
        print(f"wrote {args.split_json} "
              f"({ {k: len(v) for k, v in split.items()} })")
    check_no_subject_leakage(split)

    paths = build_split_manifests(
        args.split_json, args.bids_root, args.out_dir,
        tau_status_csv=args.tau_status,
        diagnosis_csv=args.diagnosis,
        adni_merged_csv=args.adni_merged)
    for mode, path in paths.items():
        n = len(read_csv_rows(path))
        print(f"{mode}: {n} single-modality rows -> {path}")
    return paths


if __name__ == "__main__":
    main()
