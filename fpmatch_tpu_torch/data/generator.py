"""Synthetic fingerprint image + pore-annotation generator.

The port's own copy of the JAX package's `data/generator.py` (numpy + cv2;
the same random-number calls in the same order, so one seed writes the same
files in both packages). The pipeline expects
`dataset/Synthetic/R1..R5/{subject}.jpg + .tsv`; this module synthesizes that
layout so the full image pipeline — Delaunay graphs, verification ROC/EER —
runs end-to-end without external downloads.

Images are Gabor-style ridge fields: a smooth random orientation field θ(x,y)
drives cos(2π/λ·(x·cosθ + y·sinθ)) ridges; sweat pores are bright dots pinned
to ridge centers and recorded as keypoints. One RNG seed per finger makes
fingers distinct and impressions reproducible.

Round 2 — hard verification protocol: each finger renders MULTIPLE
IMPRESSIONS (sessions × stances, file stem `{finger}_{session}_{stance}`)
from one canonical ridge/pore identity, with the acquisition nuisances that
make real pore verification hard (the session protocol of
`data/benchmark.py` serves session1×session2 genuine pairs):

  * rigid placement: rotation ±12°, translation, slight scale;
  * elastic skin deformation (smooth displacement field);
  * partial overlap: random crop window — only a subset of pores shared;
  * pressure/contrast: gamma + ridge-thickness variation;
  * sensor noise + blur;
  * detector imperfection: per-pore jitter, dropout, spurious detections.

Pore annotations carry a canonical per-finger `id` column, so ground-truth
correspondences across impressions are exact by label equality while
spurious pores never match. The round-1 single-impression layout remains
available via sessions=1, stances=1.
"""
from __future__ import annotations

from pathlib import Path
from typing import Optional, Tuple

import cv2
import numpy as np


def _orientation_field(h: int, w: int, rng: np.random.Generator,
                       scale: int = 8) -> np.ndarray:
    """Smooth random orientation field in [0, π)."""
    coarse = rng.normal(size=(scale, scale, 2))
    field = cv2.resize(coarse, (w, h), interpolation=cv2.INTER_CUBIC)
    field = cv2.GaussianBlur(field, (0, 0), min(h, w) / 8)
    return 0.5 * np.arctan2(field[..., 0], field[..., 1])


def render_fingerprint(seed: int, size: Tuple[int, int] = (480, 400),
                       wavelength: float = 9.0, n_pores: int = 120
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """Render one canonical finger (float image in [0,1] domain internally).

    Returns (uint8 grayscale image, (n, 2) pore xy in canonical frame)."""
    img, pores = _render_canonical(seed, size, wavelength, n_pores)
    img8 = np.clip(img * 255, 0, 255).astype(np.uint8)
    img8 = cv2.GaussianBlur(img8, (3, 3), 0)
    return img8, pores


def _render_canonical(seed: int, size: Tuple[int, int], wavelength: float,
                      n_pores: int, draw_pores: bool = True,
                      pore_seed: Optional[int] = None
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """Float-domain canonical render shared by single- and multi-impression
    paths. Returns (float img in [0,1], (n,2) pore xy).

    `pore_seed` decouples the pore sampling from the ridge field: two
    fingers with the same `seed` but different `pore_seed` are "siblings" —
    identical ridge geometry, independent pore layouts. Sibling impostor
    pairs are the hard negatives of pore-based verification (the ridge
    background matches perfectly; only the pore constellation disagrees)."""
    rng = np.random.default_rng(seed)
    h, w = size
    theta = _orientation_field(h, w, rng)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    # integrate a locally-oriented phase: approximate with projection onto
    # the local orientation plus smooth phase jitter
    jitter = cv2.GaussianBlur(rng.normal(0, 1, (h, w)), (0, 0), 24) * 6
    phase = (xx * np.cos(theta) + yy * np.sin(theta)) / wavelength + jitter
    ridges = np.cos(2 * np.pi * phase)

    # elliptical fingerprint mask
    cy, cx = h / 2, w / 2
    mask = (((yy - cy) / (h * 0.45)) ** 2 + ((xx - cx) / (w * 0.42)) ** 2) < 1

    img = (0.55 - 0.35 * ridges)
    img = np.where(mask, img, 0.92)

    # pores: bright dots on ridge centers (ridges ≈ 1 → dark; pores sit on
    # the dark ridge line ridges > 0.6)
    ridge_zone = (ridges > 0.6) & mask
    ys, xs = np.nonzero(ridge_zone)
    pores = []
    if pore_seed is not None:
        rng = np.random.default_rng(pore_seed)
    if len(ys):
        order = rng.permutation(len(ys))
        taken = np.zeros((h // 8 + 2, w // 8 + 2), bool)  # spacing grid
        for idx in order:
            y, x = int(ys[idx]), int(xs[idx])
            gy, gx = y // 8, x // 8
            if taken[gy, gx]:
                continue
            taken[gy, gx] = True
            pores.append((x, y))
            if len(pores) >= n_pores:
                break
    if draw_pores:
        for (x, y) in pores:
            cv2.circle(img, (x, y), 1, 1.0, -1)

    return img, np.array(pores, np.float32).reshape(-1, 2)


def render_impression(finger_seed: int, impression_seed: int,
                      out_size: Tuple[int, int] = (480, 400),
                      canvas: Optional[Tuple[int, int]] = None,
                      wavelength: float = 9.0, n_pores: int = 130,
                      identity: bool = False,
                      pore_seed: Optional[int] = None
                      ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Render one acquisition of a finger.

    The canonical finger (deterministic in `finger_seed`) is placed on a
    larger canvas, then a rigid + elastic warp, partial-overlap crop,
    pressure/photometric variation, and detector noise are applied —
    deterministic in `impression_seed`.

    :param identity: skip all nuisances (canonical center crop) — useful as
                     a "session 0" easy reference
    :return: (uint8 image (out_h, out_w), pore xy (m, 2), canonical pore ids
              (m,) int32 — id < 0 marks a spurious detection)
    """
    oh, ow = out_size
    if canvas is None:
        # ~25% margin: enough head-room for rotation + the overlap crop
        # without making two impressions' windows near-disjoint
        canvas = (int(oh * 1.25), int(ow * 1.3))
    ch, cw = canvas
    # pores are stamped AFTER the warp at their exact transformed positions
    # (they are skin features riding the deformation) — warping 1-px dots
    # through the interpolating remap would wash them out
    img0, pores0 = _render_canonical(finger_seed, canvas, wavelength,
                                     n_pores, draw_pores=identity,
                                     pore_seed=pore_seed)
    ids0 = np.arange(len(pores0), dtype=np.int32)

    if identity:
        oy, ox = (ch - oh) // 2, (cw - ow) // 2
        img = img0[oy:oy + oh, ox:ox + ow]
        P = pores0 - np.array([ox, oy], np.float32)
        keep = ((P[:, 0] >= 1) & (P[:, 0] < ow - 1)
                & (P[:, 1] >= 1) & (P[:, 1] < oh - 1))
        img8 = np.clip(img * 255, 0, 255).astype(np.uint8)
        img8 = cv2.GaussianBlur(img8, (3, 3), 0)
        return img8, P[keep], ids0[keep]

    rng = np.random.default_rng(
        np.random.SeedSequence([finger_seed & 0x7FFFFFFF, impression_seed]))

    # -- rigid placement (forward affine on the canvas) --------------------
    angle = rng.uniform(-12, 12)
    scale = rng.uniform(0.95, 1.05)
    M = cv2.getRotationMatrix2D((cw / 2, ch / 2), angle, scale)
    M[:, 2] += rng.uniform(-12, 12, size=2)
    img = cv2.warpAffine(img0, M, (cw, ch), flags=cv2.INTER_LINEAR,
                         borderValue=0.92)
    P = pores0 @ M[:, :2].T + M[:, 2]

    # -- elastic skin deformation ------------------------------------------
    # remap is a backward map: out(q) = in(q + d(q)); a feature at input p
    # therefore appears at q ≈ p − d(p) for smooth fields (the first-order
    # inverse; moving keypoints by +d would misplace them by ~2|d|)
    sigma = rng.uniform(18, 30)
    alpha = rng.uniform(120, 320)
    dx = cv2.GaussianBlur(rng.random((ch, cw)) * 2 - 1, (0, 0), sigma) * alpha
    dy = cv2.GaussianBlur(rng.random((ch, cw)) * 2 - 1, (0, 0), sigma) * alpha
    xg, yg = np.meshgrid(np.arange(cw), np.arange(ch))
    img = cv2.remap(img, (xg + dx).astype(np.float32),
                    (yg + dy).astype(np.float32),
                    interpolation=cv2.INTER_LINEAR, borderValue=0.92)
    xi = np.clip(P[:, 0].astype(np.int32), 0, cw - 1)
    yi = np.clip(P[:, 1].astype(np.int32), 0, ch - 1)
    P = P - np.stack([dx[yi, xi], dy[yi, xi]], axis=1)

    # -- partial-overlap crop ----------------------------------------------
    max_oy, max_ox = ch - oh, cw - ow
    oy = int(rng.uniform(0.15, 0.85) * max_oy)
    ox = int(rng.uniform(0.15, 0.85) * max_ox)
    img = img[oy:oy + oh, ox:ox + ow].copy()
    P = P - np.array([ox, oy], np.float32)

    # stamp pores at their exact warped positions (crisp skin features)
    for x, y in P:
        if 0 <= x < ow and 0 <= y < oh:
            cv2.circle(img, (int(round(x)), int(round(y))), 1, 1.0, -1)

    # -- pressure / photometric --------------------------------------------
    gamma = rng.uniform(0.7, 1.5)
    img = np.clip(img, 0.0, 1.0) ** gamma
    contrast = rng.uniform(0.75, 1.1)
    img = 0.5 + (img - 0.5) * contrast
    img = img + rng.normal(0, rng.uniform(0.01, 0.05), img.shape)
    if rng.uniform() < 0.5:
        img = cv2.GaussianBlur(img, (0, 0), rng.uniform(0.6, 1.4))

    # -- detector imperfection ---------------------------------------------
    ids = ids0.copy()
    P = P + rng.normal(0, 1.0, P.shape)                 # localization jitter
    inb = ((P[:, 0] >= 1) & (P[:, 0] < ow - 1)
           & (P[:, 1] >= 1) & (P[:, 1] < oh - 1))
    P, ids = P[inb], ids[inb]
    keep = rng.uniform(size=len(P)) > 0.08              # ~8% missed pores
    P, ids = P[keep], ids[keep]
    n_spur = rng.poisson(0.06 * max(len(P), 1))         # ~6% spurious
    if n_spur:
        spur = rng.uniform([2, 2], [ow - 2, oh - 2],
                           size=(n_spur, 2)).astype(np.float32)
        P = np.concatenate([P, spur], axis=0)
        ids = np.concatenate(
            [ids, -(np.arange(n_spur, dtype=np.int32) + 1)])

    img8 = np.clip(img * 255, 0, 255).astype(np.uint8)
    return img8, P.astype(np.float32), ids


def write_subject(out_dir: Path, subject: str, img: np.ndarray,
                  pores: np.ndarray, ids: Optional[np.ndarray] = None
                  ) -> None:
    out_dir.mkdir(parents=True, exist_ok=True)
    cv2.imwrite(str(out_dir / f"{subject}.jpg"),
                cv2.cvtColor(img, cv2.COLOR_GRAY2BGR))
    with open(out_dir / f"{subject}.tsv", "w") as f:
        if ids is None:
            f.write("x\ty\n")
            for x, y in pores:
                f.write(f"{x:.2f}\t{y:.2f}\n")
        else:
            f.write("x\ty\tid\n")
            for (x, y), i in zip(pores, ids):
                f.write(f"{x:.2f}\t{y:.2f}\t{int(i)}\n")


def generate_synthetic_dataset(root: str, *, fingers_per_split=(12, 4, 4),
                               n_pores: int = 110, seed: int = 0,
                               size=(480, 400), sessions: int = 1,
                               stances: int = 1,
                               sibling_fraction: float = 0.0) -> Path:
    """Create dataset/Synthetic-style R1..R5 layout.

    fingers_per_split = (train, test, val) counts; train fingers spread over
    R1-R3 round-robin (a person-level split protocol).

    With sessions/stances > 1, every finger is written as
    `f{fid}_{session}_{stance}` impressions rendered through the acquisition
    model (rigid+elastic+overlap+pressure+detector noise) — the benchmark
    then serves cross-session genuine pairs, which is what makes the
    verification protocol hard (EER > 0).

    `sibling_fraction` > 0 (multi-impression mode only) additionally writes,
    for that fraction of each split's fingers, a SIBLING finger: same
    canonical ridge field, independently sampled pores. Sibling impostor
    pairs are the hard negatives of pore verification — the ridge background
    matches perfectly, so a matcher keying on ridge texture (rather than the
    pore constellation) cannot separate them. Siblings get their own finger
    id (label-equality GT is unaffected)."""
    root = Path(root)
    train_n, test_n, val_n = fingers_per_split
    multi = sessions > 1 or stances > 1

    def write_finger(split_dir: Path, fid: int, ridge_seed: int,
                     pore_seed: Optional[int] = None):
        if not multi:
            img, pores = render_fingerprint(ridge_seed, size,
                                            n_pores=n_pores)
            write_subject(root / split_dir, f"f{fid:04d}", img, pores)
            return
        for s in range(1, sessions + 1):
            for t in range(1, stances + 1):
                img, pores, ids = render_impression(
                    ridge_seed, s * 1000 + t, out_size=size,
                    n_pores=n_pores, pore_seed=pore_seed)
                write_subject(root / split_dir, f"f{fid:04d}_{s}_{t}",
                              img, pores, ids)

    fid = 0
    sib_map: dict = {}
    for split_n, dirs in ((train_n, ("R1", "R2", "R3")),
                          (test_n, ("R4",)), (val_n, ("R5",))):
        n_sib = int(round(split_n * sibling_fraction)) if multi else 0
        for i in range(split_n):
            ridge_seed = seed * 100_003 + fid
            write_finger(Path(dirs[i % len(dirs)]), fid, ridge_seed)
            partner = fid
            fid += 1
            if i < n_sib:
                # sibling rides the PREVIOUS finger's ridge field; its pore
                # layout is seeded by its own fid so it is independent
                write_finger(Path(dirs[i % len(dirs)]), fid, ridge_seed,
                             pore_seed=seed * 900_007 + fid)
                sib_map[f"f{fid:04d}"] = f"f{partner:04d}"
                fid += 1
    if sib_map:
        update_sibling_map(root, sib_map)
    return root


def update_sibling_map(root, mapping: dict) -> Path:
    """Merge `mapping` (sibling finger name -> partner finger name) into
    <root>/siblings.json — the sidecar the Benchmark pair protocols read to
    guarantee sibling hard-impostor pairs are served (data/benchmark.py)."""
    import json
    path = Path(root) / "siblings.json"
    current = json.loads(path.read_text()) if path.exists() else {}
    current.update(mapping)
    path.write_text(json.dumps(current, indent=0, sort_keys=True))
    return path


def add_sibling_fingers(root, partner_fids, *, offset: int, seed: int,
                        n_pores: int = 120, size=(480, 400), sessions: int = 2,
                        stances: int = 2) -> dict:
    """Extend an EXISTING multi-impression dataset with sibling fingers.

    For each partner fid, re-derives its ridge seed (`seed` must be the
    dataset's original generation seed — seed*100_003+fid), renders a new
    finger with the SAME ridge field but an independently seeded pore layout,
    and writes it as f{fid+offset:04d} into the partner's split directory.
    Records the pairs in <root>/siblings.json. Returns the new mapping."""
    root = Path(root)
    mapping = {}
    for fid in partner_fids:
        hits = [d for d in ("R1", "R2", "R3", "R4", "R5")
                if list((root / d).glob(f"f{fid:04d}_1_1.*"))]
        if not hits:
            raise FileNotFoundError(f"partner f{fid:04d} not found under {root}")
        split_dir = root / hits[0]
        sib = fid + offset
        ridge_seed = seed * 100_003 + fid
        pore_seed = seed * 900_007 + sib
        for s in range(1, sessions + 1):
            for t in range(1, stances + 1):
                img, pores, ids = render_impression(
                    ridge_seed, s * 1000 + t, out_size=size,
                    n_pores=n_pores, pore_seed=pore_seed)
                write_subject(split_dir, f"f{sib:04d}_{s}_{t}", img, pores, ids)
        mapping[f"f{sib:04d}"] = f"f{fid:04d}"
    update_sibling_map(root, mapping)
    return mapping


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default="dataset/Synthetic")
    ap.add_argument("--train", type=int, default=60)
    ap.add_argument("--test", type=int, default=20)
    ap.add_argument("--val", type=int, default=20)
    ap.add_argument("--pores", type=int, default=110)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--sessions", type=int, default=1)
    ap.add_argument("--stances", type=int, default=1)
    ap.add_argument("--sibling-fraction", type=float, default=0.0,
                    help="fraction of fingers that get a same-ridge-field "
                         "sibling (hard impostors)")
    ap.add_argument("--extend-partners", default=None,
                    help="extend an EXISTING dataset instead of generating: "
                         "a-b fid range of partner fingers to grow siblings "
                         "for (e.g. 0-29); --seed must be the original "
                         "generation seed")
    ap.add_argument("--extend-offset", type=int, default=400,
                    help="sibling fid = partner fid + this offset")
    args = ap.parse_args()
    if args.extend_partners:
        a, b = (int(x) for x in args.extend_partners.split("-"))
        mapping = add_sibling_fingers(
            args.root, range(a, b + 1), offset=args.extend_offset,
            seed=args.seed, n_pores=args.pores,
            sessions=args.sessions, stances=args.stances)
        print(f"wrote {len(mapping)} siblings into {args.root} "
              f"(siblings.json updated)")
    else:
        out = generate_synthetic_dataset(
            args.root, fingers_per_split=(args.train, args.test, args.val),
            n_pores=args.pores, seed=args.seed, sessions=args.sessions,
            stances=args.stances, sibling_fraction=args.sibling_fraction)
        print(f"synthetic dataset written to {out}")
