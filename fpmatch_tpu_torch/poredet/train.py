"""Pore-detector weights on disk, full-image validation and the threshold
grid search: the inference half of the JAX package's `poredet/train.py`.

Weights are read and written in that package's flat `.npz` layout (keys such
as `params/LayerBlock_0/Conv_0/kernel`, `batch_stats/LayerBlock_0/
BatchNorm_0/mean`; Flax shapes, HWIO kernels), so a trained detector such as
`results/poredet/net17nomax.npz` loads here without JAX: `load_detector`
builds the architecture and converts the variables with
`convert.pore_variables_to_state_dict`.

The validation helpers take a model that carries its weights (the JAX
package's take `model, variables`). Patch training (`make_patch_bank`,
`train_pore_detector`) is not ported yet (ROADMAP.md, Queue A: training).
"""
from __future__ import annotations

from typing import Dict, Mapping, Tuple

import numpy as np

from .evaluate import aggregate_scores, detection_scores
from .inference import detect_pores_in_image


def _waits(what: str):
    return NotImplementedError(
        f"{what} is not ported to fpmatch_tpu_torch yet (ROADMAP.md, "
        f"Queue A: training)")


def make_patch_bank(*args, **kwargs):
    raise _waits("pore-detector patch training (make_patch_bank)")


def train_pore_detector(*args, **kwargs):
    raise _waits("pore-detector training (train_pore_detector)")


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
    out: Dict = {}
    with np.load(path) as z:
        for key in z.files:
            *mods, leaf = key.split("/")
            node = out
            for m in mods:
                node = node.setdefault(m, {})
            node[leaf] = z[key]
    return out


def load_detector(arch: str, path, device="cuda"):
    """`make_architecture(arch)` with the variables of the `.npz` at `path`,
    in eval mode on `device` (`cuda` without a GPU raises). A Flax msgpack
    checkpoint cannot be read here (no flax): convert it to the `.npz`
    layout with the JAX package's `poredet.train.save_variables`."""
    from .. import resolve_device
    from ..convert import pore_variables_to_state_dict
    from .architectures import make_architecture

    dev = resolve_device(device)
    if not str(path).endswith(".npz"):
        raise ValueError(
            f"{path}: detector weights are read from the flat .npz layout "
            f"(e.g. results/poredet/net17nomax.npz); Flax msgpack checkpoints "
            f"need flax, which this package does not use — write them as "
            f".npz with the JAX package's poredet.train.save_variables")
    model = make_architecture(arch)
    model.load_state_dict(pore_variables_to_state_dict(load_variables(path)))
    return model.to(dev).eval()


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
