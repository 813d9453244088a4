"""Keypoint files -> annotation lists (the part of the JAX package's
`data/dataset.py` that single-pair serving needs).

Keypoints come from a `.tsv` (tab, header x/y), `.csv` (comma, header) or
`.txt` (comma, headerless) file; labels are `{prefix}_{index}`.
"""
from __future__ import annotations

import csv
from pathlib import Path
from typing import Dict, List, Optional


def read_keypoints(anno_file: Path, prefix: str,
                   uid: Optional[str] = None) -> List[Dict]:
    """Parse one keypoint file into [{'labels', 'x', 'y'}, ...].

    `prefix` is the identity scope of the labels. Files may carry an `id`
    column (canonical pore id; negative = spurious detection, labelled per
    image through `uid` so it can never match across impressions)."""
    ext = anno_file.suffix.lower()
    uid = uid or prefix
    kpts: List[Dict] = []
    if ext == ".txt":
        with open(anno_file) as f:
            idx = 0
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    xs, ys = line.split(",")
                    kpts.append({"labels": f"{prefix}_{idx}",
                                 "x": float(xs), "y": float(ys)})
                    idx += 1
                except ValueError:
                    continue
    else:
        delim = "\t" if ext == ".tsv" else ","
        with open(anno_file) as f:
            reader = csv.DictReader(f, delimiter=delim)
            for i, row in enumerate(reader):
                try:
                    if "id" in row and row["id"] is not None:
                        pid = int(row["id"])
                        lab = (f"{prefix}_{pid}" if pid >= 0
                               else f"{uid}_sp{-pid}")
                    else:
                        lab = f"{prefix}_{i}"
                    kpts.append({"labels": lab,
                                 "x": float(row["x"]), "y": float(row["y"])})
                except (KeyError, ValueError):
                    continue
    return kpts
