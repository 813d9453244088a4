"""Regenerate the second finger (f6) of the PolyU-mini validation fixture:
four 96 x 96 grayscale impressions (2 sessions x 2 stances, 12 pores) with
their keypoint files, in the committed fixture's format (PNG + TSV
`id / x / y`), from the port's `data.generator.render_impression`.

    python -m fpmatch_tpu_torch.scripts.extend_polyu_mini [--out DIR]

The fixture (`tests/fixtures/PolyU-mini/DBII/val/f6_*`) was written by the
JAX package's script of the same name; the port's generator gives the same
pixels and pores. Without `--out` the files go to a new temporary
directory, never into `tests/fixtures`. Prints one JSON line: the
directory, and the pores written per impression.
"""
from __future__ import annotations

import argparse
import json
import tempfile
from pathlib import Path
from typing import Dict

from ..data.generator import render_impression

FINGER_SEED = 600_017


def write(out: Path) -> Dict[str, int]:
    import cv2

    out.mkdir(parents=True, exist_ok=True)
    pores = {}
    for s in (1, 2):
        for t in (1, 2):
            img, pts, ids = render_impression(
                FINGER_SEED, s * 1000 + t, out_size=(96, 96), n_pores=12)
            name = f"f6_{s}_{t}"
            if not cv2.imwrite(str(out / f"{name}.png"), img):
                raise OSError(f"could not write {out / name}.png")
            with open(out / f"{name}.tsv", "w") as f:
                f.write("id\tx\ty\n")
                for (x, y), i in zip(pts, ids):
                    f.write(f"{int(i)}\t{x:.2f}\t{y:.2f}\n")
            pores[name] = len(pts)
    return pores


def main(argv=None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None,
                    help="directory to write (default: a new temporary "
                         "directory)")
    args = ap.parse_args(argv)
    out = Path(args.out or tempfile.mkdtemp(prefix="polyu_mini_f6_"))
    res = {"out": str(out), "pores": write(out)}
    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    main()
