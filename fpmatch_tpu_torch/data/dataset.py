"""Dataset indexing: image directories + keypoint files -> JSON annotation
index. The port's own copy of the JAX package's `data/dataset.py` (host code;
the same index, field for field).

Layouts supported:
  * L3SFV2Augmented / "Synthetic": root/R1..R3 = train, R4 = test, R5 = val
  * PolyU DBI / DBII, L3SF: root/{train,val,test} subdirectories

Keypoints come from a sibling `.tsv` (tab, header x/y), `.csv` (comma,
header) or `.txt` (comma, headerless) file; labels are
`{folder}_{stem}_{index}` so cross-impression identity is by position index.
Image sizes are read with `cv2`, imported inside the function that needs it.
"""
from __future__ import annotations

import csv
import json
import re
from pathlib import Path
from typing import Dict, List, Optional

IMAGE_EXTS = (".jpg", ".png", ".bmp")


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


def _image_size(img_path: Path):
    """(width, height) of an image file."""
    import cv2

    img = cv2.imread(str(img_path), cv2.IMREAD_UNCHANGED)
    if img is None:
        raise FileNotFoundError(str(img_path))
    return img.shape[1], img.shape[0]


def find_annotation_file(img_path: Path) -> Optional[Path]:
    for ext in (".tsv", ".csv", ".txt"):
        cand = img_path.parent / (img_path.stem + ext)
        if cand.exists():
            return cand
    return None


class FingerprintDataset:
    """Base dataset: scans split directories, builds/caches the JSON index."""

    name = "FingerprintDataset"

    def __init__(self, sets: str, root: str = "dataset/Synthetic",
                 obj_resize=(512, 512), output_dir: Optional[str] = None,
                 task: str = "match"):
        self.sets = sets
        self.root = Path(root)
        self.obj_resize = tuple(obj_resize)
        self.task = task
        self.output_dir = Path(output_dir or f"data/{self.name}")
        self.root_dirs = self.split_dirs(sets)
        self._kpt_cache: Dict = {}

    # -- layout ---------------------------------------------------------
    def split_dirs(self, sets: str) -> List[Path]:
        """Synthetic protocol: R1-R3 train / R4 test / R5 val."""
        if sets == "train":
            return [self.root / f"R{i}" for i in (1, 2, 3)]
        if sets == "test":
            return [self.root / "R4"]
        if sets == "val":
            return [self.root / "R5"]
        raise ValueError("sets must be 'train', 'test' or 'val'")

    # -- index build ----------------------------------------------------
    def image_files(self) -> List[Path]:
        out: List[Path] = []
        for d in self.root_dirs:
            if not d.exists():
                continue
            for ext in IMAGE_EXTS:
                out.extend(sorted(d.glob(f"*{ext}")))
        return out

    def index_path(self) -> Path:
        # the root participates in the cache key: two datasets with the same
        # name but different roots (e.g. smoke temp dirs) must never collide
        import hashlib
        root_tag = hashlib.sha1(
            str(self.root.resolve()).encode()).hexdigest()[:8]
        return (self.output_dir
                / f"{self.sets}-{self.obj_resize}-{root_tag}.json")

    def build_index(self, force: bool = False) -> Path:
        """Create the JSON annotation index (idempotent)."""
        out_file = self.index_path()
        if out_file.exists() and not force:
            return out_file
        data: Dict[str, Dict] = {}
        for img_path in self.image_files():
            uid = f"{img_path.parent.name}_{img_path.stem}"
            # stems shaped {finger}_{session}_{stance} are impressions of one
            # finger: the class (identity) is the finger, and keypoint labels
            # are scoped to it so GT correspondences hold across impressions
            cls = uid
            m = re.fullmatch(r"(.+)_(\d+)_(\d+)", img_path.stem)
            if m:
                cls = f"{img_path.parent.name}_{m.group(1)}"
            anno_file = find_annotation_file(img_path)
            kpts = (read_keypoints(anno_file, cls, uid) if anno_file else [])
            w, h = _image_size(img_path)
            data[uid] = {
                "path": str(img_path),
                "cls": cls,
                "bounds": [0, 0, min(320, w), min(240, h)],
                "kpts": kpts,
                "univ_size": len(kpts),
                "folder": img_path.parent.name,
            }
        self.output_dir.mkdir(parents=True, exist_ok=True)
        with open(out_file, "w") as f:
            json.dump(data, f)
        return out_file

    def load_index(self) -> Dict[str, Dict]:
        with open(self.build_index()) as f:
            return json.load(f)

    def clear(self):
        p = self.index_path()
        if p.exists():
            p.unlink()


class L3SFV2AugmentedDataset(FingerprintDataset):
    name = "L3SFV2AugmentedDataset"


class SplitDirDataset(FingerprintDataset):
    """Datasets organized as root/{train,val,test}."""

    def split_dirs(self, sets: str) -> List[Path]:
        if sets not in ("train", "test", "val"):
            raise ValueError("sets must be 'train', 'test' or 'val'")
        return [self.root / sets]


class PolyUDBII(SplitDirDataset):
    name = "PolyU-DBII"

    def __init__(self, sets, root="dataset/PolyU/DBII", **kw):
        super().__init__(sets, root=root, **kw)


class PolyUDBI(SplitDirDataset):
    name = "PolyU-DBI"

    def __init__(self, sets, root="dataset/PolyU/DBI", **kw):
        super().__init__(sets, root=root, **kw)


class L3SF(SplitDirDataset):
    name = "L3-SF"

    def __init__(self, sets, root="dataset/L3-SF", **kw):
        super().__init__(sets, root=root, **kw)
