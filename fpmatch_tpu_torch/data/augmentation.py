"""Keypoint-aware photometric + geometric augmentation (host side, numpy +
cv2): the port's own copy of the JAX package's `data/augmentation.py`.

The 8 transform families (affine jitter, elastic deformation, gaussian blur,
motion blur, sensor noise, brightness/contrast/gamma, CLAHE, JPEG artifacts),
each keeping keypoint annotations consistent; a random subset of 1..4
transforms per view, retry-with-fewer on keypoint starvation, the
identity-geometry `standardize` fallback; pair generation intersects the
surviving keypoint labels. Every transform draws from an explicit
`numpy.random.Generator`, so a sample is a function of its seed: with the
same seed and the same cv2 the output is the JAX package's, bit for bit.
cv2's version changes some transforms' pixels, so two machines with different
cv2 builds do not agree. `cv2` is imported inside the functions that use it,
so modules that import this one do not need it.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Tuple

import numpy as np

Annotation = List[List]  # [label, x, y]

STANDARD_SIZE = 320           # resize target before crop
CROP_W, CROP_H = 320, 240     # final geometry (W, H)


def _resize_and_crop(image: np.ndarray, annos: Annotation
                     ) -> Tuple[np.ndarray, Annotation]:
    """Resize to 320x320 then centre-crop to 240x320, dropping keypoints
    that leave the crop."""
    import cv2

    h, w = image.shape[:2]
    resized = cv2.resize(image, (STANDARD_SIZE, STANDARD_SIZE),
                         interpolation=cv2.INTER_LINEAR)
    sx, sy = STANDARD_SIZE / w, STANDARD_SIZE / h
    x0 = (STANDARD_SIZE - CROP_W) // 2
    y0 = (STANDARD_SIZE - CROP_H) // 2
    cropped = resized[y0:y0 + CROP_H, x0:x0 + CROP_W]
    out = []
    for lab, x, y in annos:
        nx, ny = x * sx - x0, y * sy - y0
        if 0 <= nx < CROP_W and 0 <= ny < CROP_H:
            out.append([lab, nx, ny])
    return cropped, out


def standardize(image: np.ndarray, annos: Annotation
                ) -> Tuple[np.ndarray, Annotation]:
    """Identity-geometry view."""
    return _resize_and_crop(image, annos)


# --------------------------------------------------------------- transforms

def _t_affine(img, annos, rng):
    import cv2
    h, w = img.shape[:2]
    angle = rng.uniform(-15, 15)
    dx, dy = rng.integers(-20, 21), rng.integers(-20, 21)
    scale = rng.uniform(0.9, 1.1)
    shear = math.tan(math.radians(rng.uniform(-5, 5)))
    cx, cy = w / 2.0, h / 2.0
    ca, sa = math.cos(math.radians(angle)), math.sin(math.radians(angle))
    T1 = np.array([[1, 0, -cx], [0, 1, -cy], [0, 0, 1]], np.float32)
    RS = np.array([[scale * ca, -scale * sa, 0],
                   [scale * sa, scale * ca, 0], [0, 0, 1]], np.float32)
    SH = np.array([[1, shear, 0], [0, 1, 0], [0, 0, 1]], np.float32)
    T2 = np.array([[1, 0, cx + dx], [0, 1, cy + dy], [0, 0, 1]], np.float32)
    M = T2 @ SH @ RS @ T1
    out = cv2.warpAffine(img, M[:2], (w, h), flags=cv2.INTER_LINEAR,
                         borderMode=cv2.BORDER_REFLECT_101)
    new_annos = []
    for lab, x, y in annos:
        v = M @ np.array([x, y, 1.0], np.float32)
        if 0 <= v[0] < w and 0 <= v[1] < h:
            new_annos.append([lab, float(v[0]), float(v[1])])
    return out, new_annos


def _t_elastic(img, annos, rng):
    import cv2
    h, w = img.shape[:2]
    sigma = rng.uniform(8, 20)
    alpha = rng.uniform(0, 120)
    # the field is smooth at scale sigma ≥ 8, so generate + blur it at 1/4
    # resolution and bilinearly upsample — ~16x cheaper, visually identical
    hs, ws = max(h // 4, 2), max(w // 4, 2)
    dx = cv2.GaussianBlur(rng.random((hs, ws)) * 2 - 1, (0, 0),
                          sigma / 4) * alpha
    dy = cv2.GaussianBlur(rng.random((hs, ws)) * 2 - 1, (0, 0),
                          sigma / 4) * alpha
    dx = cv2.resize(dx, (w, h), interpolation=cv2.INTER_LINEAR)
    dy = cv2.resize(dy, (w, h), interpolation=cv2.INTER_LINEAR)
    xg, yg = np.meshgrid(np.arange(w), np.arange(h))
    out = cv2.remap(img, (xg + dx).astype(np.float32),
                    (yg + dy).astype(np.float32),
                    interpolation=cv2.INTER_LINEAR,
                    borderMode=cv2.BORDER_REFLECT_101)

    def sample(d, x, y):
        xi, yi = int(np.clip(x, 0, w - 2)), int(np.clip(y, 0, h - 2))
        fx, fy = x - xi, y - yi
        return (d[yi, xi] * (1 - fx) * (1 - fy) + d[yi, xi + 1] * fx * (1 - fy)
                + d[yi + 1, xi] * (1 - fx) * fy + d[yi + 1, xi + 1] * fx * fy)

    # remap is a BACKWARD map (out(q) = img(q + d(q))), so a feature at
    # input p lands at q ≈ p − d(p) for smooth fields: keypoints move by the
    # first-order inverse, which keeps them on their pores
    new_annos = []
    for lab, x, y in annos:
        if 0 <= x < w and 0 <= y < h:
            nx, ny = x - sample(dx, x, y), y - sample(dy, x, y)
            if 0 <= nx < w and 0 <= ny < h:
                new_annos.append([lab, float(nx), float(ny)])
    return out, new_annos


def _t_gaussian_blur(img, annos, rng):
    import cv2
    k = int(rng.choice([3, 5]))
    return cv2.GaussianBlur(img, (k, k), 0), list(annos)


def _t_motion_blur(img, annos, rng):
    import cv2
    degree = int(rng.choice([7, 9, 11, 13]))
    angle = float(rng.integers(0, 181))
    kernel = np.zeros((degree, degree), np.float32)
    kernel[(degree - 1) // 2, :] = 1.0
    M = cv2.getRotationMatrix2D((degree / 2, degree / 2), angle, 1)
    kernel = cv2.warpAffine(kernel, M, (degree, degree))
    kernel /= max(kernel.sum(), 1e-6)
    return cv2.filter2D(img, -1, kernel), list(annos)


def _t_noise(img, annos, rng):
    if rng.uniform() < 0.5:
        sigma = rng.uniform(0.5, 2.0)
        # float32 generation + in-place ops: ~10x cheaper than the float64
        # rng.normal path (this transform dominated the loader profile)
        noise = rng.standard_normal(img.shape, dtype=np.float32)
        noise *= sigma
        noise += img
        out = np.clip(noise, 0, 255, out=noise).astype(np.uint8)
    else:
        out = img.copy()
        amount = rng.uniform(0.003, 0.01)
        svp = rng.uniform(0.3, 0.7)
        n_salt = int(np.ceil(amount * img.size * svp))
        n_pep = int(np.ceil(amount * img.size * (1 - svp)))
        for n, val in ((n_salt, 255), (n_pep, 0)):
            ys = rng.integers(0, img.shape[0], n)
            xs = rng.integers(0, img.shape[1], n)
            out[ys, xs] = val
    return out, list(annos)


def _t_photometric(img, annos, rng):
    import cv2
    # gain/bias/gamma composed into one 256-entry LUT (uint8 domain) —
    # ~100x cheaper than full-image np.power
    gain = rng.uniform(0.9, 1.1)
    bias = rng.uniform(-20, 20)
    gamma = rng.uniform(0.8, 1.2)
    lut = np.clip(np.arange(256, dtype=np.float32) * gain + bias, 0, 255)
    lut = np.power(lut / 255.0, 1.0 / max(gamma, 1e-6)) * 255.0
    lut = np.clip(lut, 0, 255).astype(np.uint8)
    return cv2.LUT(img, lut), list(annos)


def _t_clahe(img, annos, rng):
    import cv2
    gray = cv2.cvtColor(img, cv2.COLOR_BGR2GRAY) if img.ndim == 3 else img
    clahe = cv2.createCLAHE(clipLimit=float(rng.uniform(2.0, 3.0)),
                            tileGridSize=(8, 8))
    cl = clahe.apply(gray)
    out = cv2.cvtColor(cl, cv2.COLOR_GRAY2BGR) if img.ndim == 3 else cl
    return out, list(annos)


def _t_jpeg(img, annos, rng):
    import cv2
    quality = int(rng.integers(50, 96))
    ok, enc = cv2.imencode(".jpg", img,
                           [int(cv2.IMWRITE_JPEG_QUALITY), quality])
    out = cv2.imdecode(enc, cv2.IMREAD_UNCHANGED) if ok else img
    if out.ndim == 2 and img.ndim == 3:
        out = cv2.cvtColor(out, cv2.COLOR_GRAY2BGR)
    return out, list(annos)


TRANSFORMS: Dict[str, Callable] = {
    "affine": _t_affine,
    "elastic_transform": _t_elastic,
    "gaussian_blur": _t_gaussian_blur,
    "motion_blur": _t_motion_blur,
    "noise": _t_noise,
    "brightness_contrast_gamma": _t_photometric,
    "clahe": _t_clahe,
    "jpeg_compress": _t_jpeg,
}


def apply_single_transform(image, annos, name: str,
                           rng: np.random.Generator):
    """One named transform followed by the standard resize+crop."""
    img, ann = TRANSFORMS[name](image, annos, rng)
    return _resize_and_crop(img, ann)


def augment_image(image, annos, rng: np.random.Generator,
                  min_points: int = 5):
    """Random-subset augmentation with keypoint-starvation retry."""
    names = list(TRANSFORMS)
    perm = list(rng.permutation(names))
    n_apply = int(rng.integers(1, max(2, math.ceil(len(names) / 2)) + 1))
    for attempt in range(3):
        chosen = perm[:max(1, n_apply - attempt)]
        img, ann = image, annos
        for name in chosen:
            img, ann = TRANSFORMS[name](img, ann, rng)
        img, ann = _resize_and_crop(img, ann)
        if len(ann) >= min_points:
            return img, ann
    img, ann = standardize(image, annos)
    if len(ann) >= min_points:
        return img, ann
    return image, annos


def augment_image_pair(image, annos, rng: np.random.Generator,
                       min_points: int = 5, min_common: int = 4,
                       max_attempts: int = 5):
    """Two augmented views of one image with ≥ min_common shared labels;
    views are label-filtered to the intersection (order-preserving, so the
    GT assignment is identity)."""
    for _ in range(max_attempts):
        img1, ann1 = augment_image(image, annos, rng, min_points)
        img2, ann2 = augment_image(image, annos, rng, min_points)
        common = {a[0] for a in ann1} & {a[0] for a in ann2}
        if len(common) >= min_common:
            return ((img1, [a for a in ann1 if a[0] in common]),
                    (img2, [a for a in ann2 if a[0] in common]))
    img1, ann1 = standardize(image, annos)
    img2, ann2 = standardize(image, annos)
    labels = {a[0] for a in ann1}
    return (img1, ann1), (img2, [a for a in ann2 if a[0] in labels])


def augment_two_images(image1, annos1, image2, annos2,
                       rng: np.random.Generator, min_points: int = 5):
    """Independent augmentation of two different fingerprints (imposters)."""
    return (augment_image(image1, annos1, rng, min_points),
            augment_image(image2, annos2, rng, min_points))
