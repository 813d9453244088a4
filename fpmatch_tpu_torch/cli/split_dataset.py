"""Person-level dataset split (the JAX package's `cli/split_dataset.py`, host
code with the same flags and outputs; parity with the reference's
dataset/split.py: 60/20/20 into R1-R3 train / R4 test / R5 val).

    python -m fpmatch_tpu_torch.cli.split_dataset --source FLAT --dest ROOT
"""
from __future__ import annotations

import argparse
import random
import shutil
from collections import defaultdict
from pathlib import Path


def person_of(stem: str) -> str:
    """Person id = stem up to the last underscore-separated numeric suffix."""
    parts = stem.split("_")
    return "_".join(parts[:-1]) if len(parts) > 1 else stem


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--source", required=True,
                    help="flat folder of images + keypoint files")
    ap.add_argument("--dest", required=True, help="output Synthetic-style root")
    ap.add_argument("--ratios", default="0.6,0.2,0.2",
                    help="train,test,val person-level ratios")
    ap.add_argument("--seed", type=int, default=123)
    args = ap.parse_args(argv)

    src = Path(args.source)
    dest = Path(args.dest)
    r_train, r_test, r_val = (float(x) for x in args.ratios.split(","))

    groups = defaultdict(list)
    for img in sorted(src.glob("*.jpg")) + sorted(src.glob("*.png")):
        groups[person_of(img.stem)].append(img)

    persons = sorted(groups)
    random.Random(args.seed).shuffle(persons)
    n = len(persons)
    n_train = int(n * r_train)
    n_test = int(n * r_test)
    splits = {
        "train": persons[:n_train],
        "test": persons[n_train:n_train + n_test],
        "val": persons[n_train + n_test:],
    }

    def copy_to(img: Path, folder: str):
        out = dest / folder
        out.mkdir(parents=True, exist_ok=True)
        shutil.copyfile(img, out / img.name)
        for ext in (".tsv", ".csv", ".txt"):
            anno = img.with_suffix(ext)
            if anno.exists():
                shutil.copyfile(anno, out / anno.name)

    counts = defaultdict(int)
    for i, person in enumerate(splits["train"]):
        for img in groups[person]:
            copy_to(img, f"R{i % 3 + 1}")
            counts["train"] += 1
    for person in splits["test"]:
        for img in groups[person]:
            copy_to(img, "R4")
            counts["test"] += 1
    for person in splits["val"]:
        for img in groups[person]:
            copy_to(img, "R5")
            counts["val"] += 1
    print(f"split {n} persons → {dict(counts)} images under {dest}")


if __name__ == "__main__":
    main()
