"""DPF — classical dynamic pore filtering detectors (host side, numpy/cv2).

Two detectors:

* `detect_pores_dpf` — a compact original detector in the same spirit
  (Otsu → component size gate → ring enclosure), kept for speed;
* `detect_pores_lemes` — a faithful *vectorized* port of the Lemes et al.
  dynamic-pore-filtering algorithm (pore-detection/dpf.py:133-592): the
  pixel-loop run-length scans become cumulative-index maps, the local
  window statistics become box filters, and the per-pixel adaptive ring
  walk is batched per radius; the decision rules (side-length saturation
  gate, 33% bright-ring gate, ≥2-arcs gate, dark-ring mean test, 17-px NMS,
  geometric centroids) match the reference step for step.

The port's own copy of the JAX package's module (host numpy / cv2 / scipy code,
the same in both packages).
"""
from __future__ import annotations

import math

import cv2
import numpy as np


def estimate_ridge_period(binary: np.ndarray) -> float:
    """Median run-length of the ridge phase along rows ≈ ridge period/2."""
    runs = []
    for row in binary[:: max(1, binary.shape[0] // 64)]:
        changes = np.nonzero(np.diff(row.astype(np.int8)))[0]
        if len(changes) > 2:
            runs.extend(np.diff(changes))
    return float(np.median(runs)) if runs else 8.0


def detect_pores_dpf(image: np.ndarray, *, min_area: int = 1,
                     max_area_scale: float = 1.2,
                     ring_scale: float = 1.6,
                     enclosure: float = 0.55) -> np.ndarray:
    """Detect pores in a grayscale fingerprint. Returns (n, 2) xy.

    :param enclosure: minimum dark fraction on the surrounding ring
    """
    if image.ndim == 3:
        image = cv2.cvtColor(image, cv2.COLOR_BGR2GRAY)
    blur = cv2.GaussianBlur(image, (3, 3), 0)
    _, binary = cv2.threshold(blur, 0, 255,
                              cv2.THRESH_BINARY + cv2.THRESH_OTSU)
    bright = binary > 0                  # valleys + pores are bright
    dark = ~bright                       # ridges

    period = estimate_ridge_period(dark)
    max_area = int(np.ceil((period * max_area_scale) ** 2))

    n_comp, labels, stats, centroids = cv2.connectedComponentsWithStats(
        bright.astype(np.uint8), connectivity=8)

    h, w = image.shape
    yy, xx = np.mgrid[-16:17, -16:17]
    rr = np.sqrt(xx ** 2 + yy ** 2)
    pores = []
    for c in range(1, n_comp):
        area = stats[c, cv2.CC_STAT_AREA]
        if not (min_area <= area <= max_area):
            continue
        cx, cy = centroids[c]
        icx, icy = int(round(cx)), int(round(cy))
        radius = max(2.0, ring_scale * np.sqrt(area / np.pi))
        if radius > 15:
            continue
        if not (16 <= icx < w - 16 and 16 <= icy < h - 16):
            continue
        ring = (rr >= radius) & (rr < radius + 2)
        patch_dark = dark[icy - 16:icy + 17, icx - 16:icx + 17]
        frac = patch_dark[ring].mean() if ring.any() else 0.0
        if frac >= enclosure:
            pores.append((cx, cy))
    return np.asarray(pores, np.float32).reshape(-1, 2)


# ---------------------------------------------------------------------------
# Faithful vectorized Lemes port
# ---------------------------------------------------------------------------

_T_CAP = 20          # tamLatPor — run-length cap
_NMS_WINDOW = 17     # reference nmsWindow (dpf.py:530)


def _ring_offsets(radius: int):
    """Angularly-ordered ring offsets matching the reference's RX/RY tables
    (pore-detection/dpf.py:92-95) EXACTLY, derived rather than copied: for
    j >= 2 the table is the rounded annulus {p != 0 : floor(|p| + 0.5) == j}
    (verified point-set-identical for every j, and every ring size equals
    tamRaio); j == 1 is special-cased in the tables as the radius-2 diamond
    (|dx| + |dy| == 2). The earlier midpoint-circle rings were thinner
    (24 vs 32 points at j=4) and wrong at j=1 (4-point radius-1 ring vs the
    reference's 8-point radius-2 diamond) — j=1 is the COMMON case on
    thin-ridge images, and the too-tight ring sat inside the pore, failing
    the 33%-bright gate: the round-3 recall gap (0.46 vs compact 0.53).
    Only the cyclic order matters for arc counting (the wrap correction
    handles the seam), so sorting by angle is equivalent to the tables'
    clockwise order."""
    if radius == 1:
        pts = [(dx, dy) for dx in range(-2, 3) for dy in range(-2, 3)
               if abs(dx) + abs(dy) == 2]
    else:
        pts = [(dx, dy)
               for dx in range(-radius - 1, radius + 2)
               for dy in range(-radius - 1, radius + 2)
               if (dx, dy) != (0, 0)
               and math.floor(math.hypot(dx, dy) + 0.5) == radius]
    pts = sorted(pts, key=lambda p: math.atan2(p[1], p[0]))
    arr = np.asarray(pts, np.int32)
    return arr[:, 0], arr[:, 1]          # (k,) dx, dy


_RINGS = {j: _ring_offsets(j) for j in range(1, _T_CAP + 1)}


def _run_maps(flag: np.ndarray, cap: int = _T_CAP):
    """Distances to the previous/next True pixel along both axes
    (the reference's tamVales/tamCristas scans, dpf.py:184-351).

    flag marks the "stopping" phase; distances are measured at pixels of
    the other phase. Returns (up, down, left, right), each capped."""
    h, w = flag.shape
    yy = np.arange(h, dtype=np.int32)[:, None]
    xx = np.arange(w, dtype=np.int32)[None, :]
    last_u = np.maximum.accumulate(np.where(flag, yy, 0), axis=0)
    up = np.minimum(yy - last_u, cap)
    nxt_d = np.minimum.accumulate(np.where(flag, yy, h)[::-1], axis=0)[::-1]
    down = np.minimum(nxt_d - yy, cap)
    last_l = np.maximum.accumulate(np.where(flag, xx, 0), axis=1)
    left = np.minimum(xx - last_l, cap)
    nxt_r = np.minimum.accumulate(np.where(flag, xx, w)[:, ::-1],
                                  axis=1)[:, ::-1]
    right = np.minimum(nxt_r - xx, cap)
    return (up.astype(np.float32), down.astype(np.float32),
            left.astype(np.float32), right.astype(np.float32))


def _box_mean(values: np.ndarray, where: np.ndarray, radius: int):
    """Masked local mean over a (2r+1)² window clipped at the borders —
    the reference's bounds-checked accumulation loop (dpf.py:436-459)."""
    ksz = (2 * radius + 1, 2 * radius + 1)
    s = cv2.boxFilter(values * where, cv2.CV_64F, ksz, normalize=False,
                      borderType=cv2.BORDER_CONSTANT)
    c = cv2.boxFilter(where.astype(np.float64), cv2.CV_64F, ksz,
                      normalize=False, borderType=cv2.BORDER_CONSTANT)
    with np.errstate(divide="ignore", invalid="ignore"):
        return s / c


def detect_pores_lemes(image: np.ndarray,
                       mask: np.ndarray | None = None) -> np.ndarray:
    """Lemes dynamic pore filtering (vectorized port of
    pore-detection/dpf.py:133-592). Returns (n, 2) float32 xy centroids.

    :param mask: foreground mask (the reference's imgVar); default = all
    """
    if image.ndim == 3:
        image = cv2.cvtColor(image, cv2.COLOR_BGR2GRAY)
    img = image.astype(np.float32)
    h, w = img.shape
    if mask is None:
        mask = np.ones((h, w), bool)
    else:
        mask = np.asarray(mask) > 0

    # Otsu over the masked region (binarizacaoOtsuGlobal)
    thr, _ = cv2.threshold(image[mask].reshape(-1, 1).astype(np.uint8), 0,
                           255, cv2.THRESH_BINARY + cv2.THRESH_OTSU)
    below = img < thr                       # valley phase
    above = ~below

    # run-length side maps: valleys stop bright runs, ridges stop dark runs
    vC, vB, vE, vD = _run_maps(below)       # tamVales (alt C/B, larg E/D)
    cC, cB, cE, cD = _run_maps(above)       # tamCristas

    bright_m = above & mask
    dark_m = below & mask
    if not bright_m.any() or not dark_m.any():
        return np.zeros((0, 2), np.float32)
    ml = [np.minimum(m[bright_m].mean(), _T_CAP) for m in (vD, vE, vC, vB)]
    mlp = [np.minimum(m[dark_m].mean(), _T_CAP) for m in (cD, cE, cC, cB)]
    lados_geral = float(np.mean(ml))
    lados_geral_pr = float(np.mean(mlp))

    thr_low = thr - 15                      # mediaGlobal -= 15 (dpf.py:409)
    bright2 = img > thr_low

    # local means over the (2·⌊2·lados_geral_pr⌋+1)² window
    rad = int(lados_geral_pr * 2)
    s_vale = np.floor((vD + vE + vC + vB) / 4)      # integer //4 semantics
    s_crista = np.floor((cD + cE + cC + cB) / 4)
    lados_local = np.minimum(
        np.nan_to_num(_box_mean(s_vale, bright2, rad)), lados_geral)
    lados_local_pr = np.minimum(
        np.nan_to_num(_box_mean(s_crista, ~bright2, rad)), lados_geral_pr)
    media_local = _box_mean(img.astype(np.float64),
                            np.ones_like(img, bool), rad)

    # candidate gate: bright (lowered threshold), masked, inside margin,
    # < 2 saturated valley side-lengths
    sat = sum((m >= _T_CAP).astype(np.int8) for m in (vD, vE, vC, vB))
    cand = bright2 & mask & (sat < 2)
    cand[:5] = cand[-5:] = False
    cand[:, :5] = cand[:, -5:] = False

    # adaptive ring radius per candidate
    jmap = np.clip(np.round(lados_local_pr / 2) - 1, 1, _T_CAP).astype(int)
    ys, xs = np.nonzero(cand)
    if not len(ys):
        return np.zeros((0, 2), np.float32)
    js = jmap[ys, xs]
    # shrink at borders (reference shrinks until the ring fits)
    lim = np.minimum.reduce([ys, xs, h - 1 - ys, w - 1 - xs])
    js = np.minimum(js, np.maximum(lim, 1))

    keep_mask = np.zeros(len(ys), bool)
    for j in np.unique(js):
        sel = js == j
        cy, cx = ys[sel], xs[sel]
        dx, dy = _RINGS[int(j)]
        ring = img[np.clip(cy[:, None] + dy[None, :], 0, h - 1),
                   np.clip(cx[:, None] + dx[None, :], 0, w - 1)]
        loc = media_local[cy, cx][:, None]
        bright_ring = ring > loc
        k = ring.shape[1]
        # arcs: rising edges, corrected for wrap-around (dpf.py:481-507)
        rises = (bright_ring[:, 1:] & ~bright_ring[:, :-1]).sum(1) \
            + bright_ring[:, 0]
        wrap = bright_ring[:, 0] & bright_ring[:, -1]
        cont = rises - wrap
        nB = bright_ring.sum(1)
        ring_mean = ring.mean(1)
        keep_mask[sel] = ((nB <= k * 0.33) & (cont < 2)
                          & (ring_mean <= loc[:, 0]))

    ys, xs = ys[keep_mask], xs[keep_mask]
    if not len(ys):
        return np.zeros((0, 2), np.float32)

    # 17-px fixed-box NMS (row-major tie order, IoU 0.2) then geometric
    # centroids of the surviving 8-connected components
    from .inference import nms_boxes

    coords = np.stack([ys, xs], 1).astype(np.int32)
    keep = nms_boxes(coords, np.full(len(ys), 255.0, np.float32),
                     _NMS_WINDOW, 0.2)
    pmap = np.zeros((h, w), np.uint8)
    pmap[ys[keep], xs[keep]] = 1
    n_comp, _, _, centroids = cv2.connectedComponentsWithStats(pmap, 8)
    return centroids[1:].astype(np.float32).reshape(-1, 2)
