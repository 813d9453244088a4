"""Pore-detector training: balanced patch classification, full-image
validation and the threshold grid search (the JAX package's
`poredet/train.py`; reference pore-detection/train.py:218-846).

  * patch BCE training of any of the 18 architectures (`make_patch_bank`,
    `train_pore_detector`: Adam, a numpy permutation per epoch, drop-last
    batches, per-epoch validation on whole images, keep-best);
  * the grid search over detection probability, then NMS IoU;
  * the TEST I / TEST II final phases.

Weights are read and written in that package's flat `.npz` layout (keys such
as `params/LayerBlock_0/Conv_0/kernel`, `batch_stats/LayerBlock_0/
BatchNorm_0/mean`; Flax shapes, HWIO kernels), so a trained detector such as
`results/poredet/net17nomax.npz` loads here without JAX: `load_detector`
builds the architecture and converts the variables with
`convert.pore_variables_to_state_dict`.

The validation helpers take a model that carries its weights (the JAX
package's take `model, variables`). A detector trained here is written by
`save_variables` in that layout, so the JAX package's `load_variables`
reads it too.
"""
from __future__ import annotations

import time
from typing import Dict, Mapping, Sequence, Tuple

import numpy as np
import torch

from .evaluate import aggregate_scores, detection_scores
from .inference import detect_pores_in_image
from .patches import extract_balanced_patches

# the centre output is clipped to [P_EPS, 1 - P_EPS] before the BCE
P_EPS = 1e-6


def make_patch_bank(images: Sequence[np.ndarray],
                    pore_sets: Sequence[np.ndarray], window: int,
                    seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """Balanced patches of every image, negatives drawn from one
    `default_rng(seed)` stream across the images: ((N, window, window, 1)
    float32 in [0, 1], (N,) float32 labels), the JAX package's arrays."""
    rng = np.random.default_rng(seed)
    xs, ys = [], []
    for img, pores in zip(images, pore_sets):
        x, y = extract_balanced_patches(img, pores, window=window, rng=rng)
        xs.append(x)
        ys.append(y)
    return np.concatenate(xs), np.concatenate(ys)


def patch_loss(model, xb: torch.Tensor, yb: torch.Tensor) -> torch.Tensor:
    """Mean BCE of the centre output (the (1, 1) map of a window-sized
    patch), clipped to [P_EPS, 1 - P_EPS]. xb (B, 1, w, w), yb (B,)."""
    p = torch.clamp(model(xb)[:, 0, 0, 0], P_EPS, 1 - P_EPS)
    return -torch.mean(yb * torch.log(p) + (1 - yb) * torch.log(1 - p))


def make_optimizer(model, lr: float = 1e-3) -> torch.optim.Adam:
    """`optax.adam(lr)`: b1 0.9, b2 0.999, eps 1e-8 outside the square root,
    no weight decay."""
    return torch.optim.Adam(model.parameters(), lr=lr, betas=(0.9, 0.999),
                            eps=1e-8)


def train_step(model, opt, xb: torch.Tensor, yb: torch.Tensor
               ) -> torch.Tensor:
    """One Adam step of the patch loss in train mode (batch statistics
    normalize and move the running ones); returns the loss (on the
    device)."""
    model.train()
    opt.zero_grad(set_to_none=True)
    loss = patch_loss(model, xb, yb)
    loss.backward()
    opt.step()
    return loss.detach()


def train_pore_detector(arch: str, images, pore_sets, val_images,
                        val_pore_sets, *, features: int = 40,
                        epochs: int = 5, batch_size: int = 256,
                        lr: float = 1e-3, seed: int = 0,
                        probability: float = 0.65, nms_iou: float = 0.2,
                        device="cuda", log_fn=print) -> Dict:
    """Train one architecture on `device` (`cuda` without a GPU raises).

    Weights are drawn by `architectures.lecun_init_` from a `torch.Generator`
    seeded with `seed` (and gabriel's dropout from one seeded with
    `seed + 1`); the patch bank and the per-epoch order of the patches come
    from `default_rng(seed)` streams, as in the JAX package. Each epoch
    takes the full batches of its permutation (the last, short one is
    dropped), then validates on the whole `val_images`; the epoch with the
    best F-score is kept.

    :return: the best epoch's validation report with "variables" (nested
        numpy, `save_variables`' input), "model" (the architecture with those
        weights, eval mode, on `device`), "epoch", "n_patches", and per
        epoch (all epochs) "losses", "val_f" and "step_ms" (host ms per
        step, the epoch's steps ending in a wait for the device)
    """
    from .. import resolve_device
    from ..convert import state_dict_to_pore_variables
    from .architectures import lecun_init_, make_architecture, \
        receptive_field

    dev = resolve_device(device)
    window = receptive_field(arch)
    X, Y = make_patch_bank(images, pore_sets, window, seed)
    log_fn(f"[poredet] {arch}: {len(X)} patches (window {window})")
    model = make_architecture(arch, features=features)
    lecun_init_(model, torch.Generator().manual_seed(seed)).to(dev)
    if hasattr(model, "dropout_generator"):
        model.dropout_generator = torch.Generator(dev).manual_seed(seed + 1)
    opt = make_optimizer(model, lr)
    Xd = torch.from_numpy(X).permute(0, 3, 1, 2).contiguous().to(dev)
    Yd = torch.from_numpy(Y).to(dev)

    rng = np.random.default_rng(seed)
    best = {"f_score": -1.0}
    curve = {"losses": [], "val_f": [], "step_ms": []}
    for epoch in range(epochs):
        order = rng.permutation(len(X))
        losses = []
        t0 = time.perf_counter()
        for i in range(0, len(order) - batch_size + 1, batch_size):
            idx = torch.from_numpy(order[i:i + batch_size]).to(dev)
            losses.append(train_step(model, opt, Xd[idx], Yd[idx]))
        # float() waits for the device
        loss = float(torch.stack(losses).mean()) if losses else float("nan")
        curve["step_ms"].append(
            (time.perf_counter() - t0) * 1e3 / max(len(losses), 1))
        model.eval()
        report = validate_full_images(model, val_images, val_pore_sets,
                                      window=window, probability=probability,
                                      nms_iou=nms_iou)
        curve["losses"].append(loss)
        curve["val_f"].append(report["f_score"])
        log_fn(f"[poredet] {arch} epoch {epoch}: "
               f"loss={loss:.4f} val_f={report['f_score']:.4f}")
        if report["f_score"] > best["f_score"]:
            best = {**report, "epoch": epoch, "variables":
                    state_dict_to_pore_variables(model.state_dict())}
    best["model"] = variables_to_model(arch, best["variables"], dev,
                                       features=features)
    return {**best, **curve, "n_patches": len(X)}


def variables_to_model(arch: str, variables: Mapping, device="cuda",
                       features: int = 40):
    """`make_architecture(arch, features)` holding `variables` (nested
    numpy, Flax layout), in eval mode on `device`."""
    from .. import resolve_device
    from ..convert import pore_variables_to_state_dict
    from .architectures import make_architecture

    model = make_architecture(arch, features=features)
    model.load_state_dict(pore_variables_to_state_dict(variables))
    return model.to(resolve_device(device)).eval()


def save_variables(path, variables: Mapping) -> None:
    """Write detector variables ({"params": ..., "batch_stats": ...} of
    arrays, nested by module) as the flat `.npz` the JAX package writes."""

    def flat(tree, prefix=()):
        for k, v in tree.items():
            if isinstance(v, Mapping):
                yield from flat(v, prefix + (str(k),))
            else:
                yield "/".join(prefix + (str(k),)), np.asarray(v)

    np.savez(path, **dict(flat(variables)))


def load_variables(path) -> Dict:
    """Read a flat detector `.npz` back into nested numpy variables."""
    from ..convert import read_flax_npz

    return read_flax_npz(path)


def load_detector(arch: str, path, device="cuda"):
    """`make_architecture(arch)` with the variables of the `.npz` at `path`,
    in eval mode on `device` (`cuda` without a GPU raises). A Flax msgpack
    checkpoint cannot be read here (no flax): convert it to the `.npz`
    layout with the JAX package's `poredet.train.save_variables`."""
    if not str(path).endswith(".npz"):
        raise ValueError(
            f"{path}: detector weights are read from the flat .npz layout "
            f"(e.g. results/poredet/net17nomax.npz); Flax msgpack checkpoints "
            f"need flax, which this package does not use — write them as "
            f".npz with the JAX package's poredet.train.save_variables")
    return variables_to_model(arch, load_variables(path), device)


def validate_full_images(model, images, pore_sets, *, window, probability,
                         nms_iou) -> Dict[str, float]:
    """Mutual-nearest-neighbour precision / recall / F-score of the model's
    detections over whole images."""
    per_image = []
    for img, gt in zip(images, pore_sets):
        pred, _ = detect_pores_in_image(model, img, probability=probability,
                                        window=window, nms_iou=nms_iou)
        per_image.append(detection_scores(np.asarray(gt), pred))
    return aggregate_scores(per_image)


def final_test_phases(model, test_sets: Dict[str, Tuple], *, window,
                      probability, nms_iou, log_fn=print
                      ) -> Dict[str, Dict[str, float]]:
    """The reference's TEST I / TEST II final-evaluation phases
    (pore-detection/train.py:694-830): the model with the grid-searched
    (probability, NMS) on each held-out test range, reporting F-score,
    true-detection rate (precision) and false-detection rate (1 - recall).

    :param test_sets: {"test_i": (images, pore_sets), "test_ii": (...)}
    """
    reports = {}
    for name, (images, pore_sets) in test_sets.items():
        if not images:
            continue
        r = validate_full_images(model, images, pore_sets, window=window,
                                 probability=probability, nms_iou=nms_iou)
        r["true_detection_rate"] = r.get("precision", 0.0)
        r["false_detection_rate"] = 1.0 - r.get("recall", 0.0)
        log_fn(f"[poredet] {name.upper()}: F={r['f_score']:.4f} "
               f"TDR={r['true_detection_rate']:.4f} "
               f"FDR={r['false_detection_rate']:.4f}")
        reports[name] = r
    return reports


def grid_search_thresholds(model, images, pore_sets, *, window,
                           probabilities=(0.5, 0.6, 0.65, 0.7, 0.8),
                           nms_ious=(0.1, 0.2, 0.3), log_fn=print) -> Dict:
    """Two-stage grid search as in the reference (train.py:512-692):
    probability first at IoU 0.2, then IoU at the best probability."""
    best_p, best_f = None, -1.0
    for p in probabilities:
        r = validate_full_images(model, images, pore_sets, window=window,
                                 probability=p, nms_iou=0.2)
        log_fn(f"[grid] prob={p}: f={r['f_score']:.4f}")
        if r["f_score"] > best_f:
            best_p, best_f = p, r["f_score"]
    best_iou = 0.2
    for iou in nms_ious:
        r = validate_full_images(model, images, pore_sets, window=window,
                                 probability=best_p, nms_iou=iou)
        log_fn(f"[grid] iou={iou}: f={r['f_score']:.4f}")
        if r["f_score"] > best_f:
            best_iou, best_f = iou, r["f_score"]
    return {"probability": best_p, "nms_iou": best_iou, "f_score": best_f}
