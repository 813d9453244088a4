"""Subset metrics from an evaluate `scores.csv`: sibling hard impostors.

Sibling fingers (`data.generator`'s `sibling_fraction` and its
`--extend-partners` extension) share the ridge field of a partner finger
but carry an independent pore layout: the hardest impostor pairs for pore
verification. This report keeps every genuine pair and only the
sibling-partner impostors, recomputes EER and ROC-AUC on them
(`evaluation.metrics.verification_metrics`), and gives the siblings' FAR
at the full set's EER threshold.

    python -m fpmatch_tpu_torch.scripts.hard_impostor_report \\
        results/bc-v2-run3/scores.csv --sibling-offset 200 --partner-base 100

The JAX script's flags: the pairs come from the generator's
`siblings.json` sidecar where it exists (`--siblings-json`), else from the
fid arithmetic (sibling f{p + offset} of partner f{p}, p >= partner base).
Host numpy only. Prints one JSON line, its floats rounded to 5 places as
the JAX script prints them.
"""
from __future__ import annotations

import argparse
import csv
import gzip
import json
import os
import re
from typing import Dict

import numpy as np

from ..evaluation.metrics import verification_metrics


def person(img_id: str) -> str:
    stem = img_id.rsplit("/", 1)[-1]
    m = re.match(r"(.+?)_(\d+)_(\d+)$", stem)
    return m.group(1) if m else stem


def fid(p: str):
    m = re.search(r"f(\d+)$", p)
    return int(m.group(1)) if m else None


def bare(p: str) -> str:
    return p.split("_", 1)[1] if "_" in p else p


def sibling_mask(rows, labels, pair_set, offset: int, base: int):
    """True on the impostor rows of a sibling and its partner."""
    mask = np.zeros(len(rows), bool)
    for i, r in enumerate(rows):
        if labels[i] == 1:
            continue
        pa, pb = person(r["id_a"]), person(r["id_b"])
        if pair_set is not None:
            mask[i] = frozenset((bare(pa), bare(pb))) in pair_set
            continue
        fa, fb = fid(pa), fid(pb)
        if fa is None or fb is None:
            continue
        lo, hi = min(fa, fb), max(fa, fb)
        mask[i] = hi == lo + offset and lo >= base
    return mask


def report(scores_csv: str, sibling_offset: int = 200,
           partner_base: int = 100, siblings_json=None) -> Dict:
    opener = gzip.open if scores_csv.endswith(".gz") else open
    with opener(scores_csv, "rt") as fh:
        rows = list(csv.DictReader(fh))
    labels = np.array([int(r["label"]) for r in rows])
    scores = np.array([float(r["score"]) for r in rows])
    pair_set = None
    if siblings_json and os.path.exists(siblings_json):
        with open(siblings_json) as fh:
            pair_set = {frozenset(kv) for kv in json.load(fh).items()}
    sib = sibling_mask(rows, labels, pair_set, sibling_offset, partner_base)

    full = verification_metrics(labels, scores)
    out = {"n_pairs": len(rows), "n_sibling_impostors": int(sib.sum()),
           "full_eer": full["eer"], "full_threshold": full["threshold"]}
    if sib.any():
        sel = (labels == 1) | sib
        hard = verification_metrics(labels[sel], scores[sel])
        out["sibling_eer"] = hard["eer"]
        out["sibling_roc_auc"] = hard["roc_auc"]
        out["sibling_far_at_full_threshold"] = float(
            (scores[sib] >= full["threshold"]).mean())
    return {k: round(v, 5) if isinstance(v, float) else v
            for k, v in out.items()}


def main(argv=None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("scores_csv")
    ap.add_argument("--sibling-offset", type=int, default=200,
                    help="sibling fid = partner fid + offset (where there "
                         "is no siblings.json)")
    ap.add_argument("--partner-base", type=int, default=100)
    ap.add_argument("--siblings-json",
                    default="dataset/SyntheticV2/siblings.json",
                    help="the generator's sidecar mapping sibling finger -> "
                         "partner finger; used instead of the offset rule "
                         "where it exists")
    args = ap.parse_args(argv)
    out = report(args.scores_csv, args.sibling_offset, args.partner_base,
                 args.siblings_json)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
