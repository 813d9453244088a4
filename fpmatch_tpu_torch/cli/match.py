"""One-shot fingerprint pair verification: two images -> match verdict.

Give two fingerprint images (with optional keypoint files) and get a
verification score, the predicted matchable-keypoint count and the keypoint
correspondence as one JSON line on stdout. Same flags and JSON keys as the
JAX package's `cli/match.py`, plus `--device` (default `cuda`; `cuda` without
a GPU is an error, never a silent CPU run).

Keypoints come from `--kpts1/--kpts2` files (.tsv/.csv/.txt), or are detected
when a file is omitted: the classical DPF detector (`--detector dpf`, the
default, host numpy / cv2 work, no weights) or a trained patch CNN
(`--detector cnn --detector-checkpoint results/poredet/net17nomax.npz`, its
forward on `--device`). Pairs in a bucket of `--n-max >= 256` keypoints (or
`--univ-kernel`) take the UNIV route: the three association-GNN aggregations
run through the CUDA kernel of `kernels/assoc_univ_v3`.

`--hyperedge` adds the third-order triangle term (the request carries each
view's Delaunay triangles; the UNIV route raises with it, as the JAX CLI's
model does) and `--cls-k-features` the classifier's k statistics; both must
match the checkpoint. `--viz PATH` draws the pair with its matches
(`utils.visualize.visualize_match`) and adds `"viz": PATH` to the JSON.

`--discretize hungarian` reproduces the reference's full discretization: the
first forward's `ds_mat` goes to the host, the native LAPJV solver
(`ops.hungarian`) solves its valid block, and a second full forward
(`train.step.make_eval_step_masked`, with the UNIV plan on the UNIV route)
ranks its greedy fill by `mask * ds_mat`.

Weights: `--checkpoint-dir D --checkpoint NAME` loads the state_dict file
`D/NAME.pt` (as `convert.from_flax_variables` produces; `torch.save`); with
no checkpoint the weights are initialised from `--seed`.

The work is split so that a server (or a script without image files) can
enter below the file reading: `read_pair` is the only function that touches
files and `cv2` (and runs the detector where a keypoint file is missing);
`match_arrays` takes two standardized image arrays and two keypoint arrays
and returns the result dict.

Example:
    python -m fpmatch_tpu_torch.cli.match a.png b.png \
        --kpts1 a.tsv --kpts2 b.tsv --n-max 600 --e-max 3840
    python -m fpmatch_tpu_torch.cli.match a.png b.png --discretize hungarian
    python -m fpmatch_tpu_torch.cli.match a.png b.png --kpts1 a.tsv \
        --kpts2 b.tsv --hyperedge --cls-k-features --viz pair.png
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description="Verify whether two fingerprint images match")
    ap.add_argument("image1")
    ap.add_argument("image2")
    ap.add_argument("--kpts1", default=None,
                    help="keypoint file for image1 (.tsv/.csv/.txt)")
    ap.add_argument("--kpts2", default=None)
    ap.add_argument("--detector", default="dpf", choices=["dpf", "cnn"],
                    help="pore detector when no keypoint file is given")
    ap.add_argument("--detector-arch", default="net17nomax")
    ap.add_argument("--detector-checkpoint", default=None,
                    help=".npz of detector variables (--detector cnn), e.g. "
                         "results/poredet/net17nomax.npz")
    ap.add_argument("--detector-probability", type=float, default=0.65)
    ap.add_argument("--detector-nms-iou", type=float, default=0.2)
    ap.add_argument("--checkpoint-dir", default="checkpoints")
    ap.add_argument("--checkpoint", default=None,
                    help="checkpoint name (default: latest in meta)")
    ap.add_argument("--score", default="fused",
                    choices=["fused", "cls", "k"],
                    help="verification score: fused cls*k (default), cls, "
                         "or k alone")
    ap.add_argument("--discretize", default="greedy",
                    choices=["greedy", "hungarian"],
                    help="'hungarian' reproduces the reference's full "
                         "discretization (host LAPJV between two forwards); "
                         "'greedy' (default) ranks by the soft-top-k map "
                         "directly")
    ap.add_argument("--threshold", type=float, default=None,
                    help="decision threshold; when set, the JSON carries "
                         "a genuine true/false verdict")
    ap.add_argument("--viz", default=None,
                    help="write a side-by-side match visualization (PNG)")
    ap.add_argument("--n-max", type=int, default=64)
    ap.add_argument("--e-max", type=int, default=384)
    ap.add_argument("--univ", type=int, default=600)
    ap.add_argument("--node-taps", default="layer3")
    ap.add_argument("--cls-k-features", action="store_true",
                    help="the checkpoint's match classifier reads the "
                         "k statistics")
    ap.add_argument("--hyperedge", action="store_true",
                    help="third-order (triangle hyperedge) association term "
                         "(bucket route only; must match the checkpoint)")
    ap.add_argument("--bf16", action="store_true",
                    help="bfloat16 compute in the backbone and the graph-side "
                         "hot path (params stay f32: f32 checkpoints load "
                         "unchanged)")
    ap.add_argument("--univ-kernel", action=argparse.BooleanOptionalAction,
                    default=None,
                    help="route the assoc-GNN aggregations through the "
                         "assoc_univ_v3 kernel (default: auto, on when "
                         "--n-max >= 256)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; pass cpu to run on "
                         "the CPU)")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the weight init used without a checkpoint")
    return ap


def gray_for_detector(image: np.ndarray) -> np.ndarray:
    """The gray image the JAX CLI hands its detectors: float32 luma
    `image[..., :3] @ [0.299, 0.587, 0.114]`, then a truncating uint8 cast
    (not `data.pipeline.rgb_to_gray`, which rounds as cv2 does)."""
    gray = image if image.ndim == 2 else np.asarray(
        image[..., :3] @ [0.299, 0.587, 0.114], np.float32)
    return gray.astype(np.uint8)


def make_detector(args):
    """The pore detector `--detector` names: a function (H, W) uint8 gray
    image -> (n, 2) float32 xy pores. `cnn` loads `--detector-arch` with the
    weights of `--detector-checkpoint` on `--device` and detects with the
    default window (17), as the JAX CLI does."""
    if args.detector == "dpf":
        from ..poredet.dpf import detect_pores_lemes
        return detect_pores_lemes
    if not args.detector_checkpoint:
        raise ValueError("--detector cnn needs --detector-checkpoint (an .npz "
                         "of detector variables, e.g. "
                         "results/poredet/net17nomax.npz)")
    from ..poredet.inference import detect_pores_in_image
    from ..poredet.train import load_detector

    model = load_detector(args.detector_arch, args.detector_checkpoint,
                          device=args.device)

    def detect(gray):
        coords, _ = detect_pores_in_image(
            model, gray, probability=args.detector_probability,
            nms_iou=args.detector_nms_iou)
        return coords

    return detect


def read_pair(args, detector=None):
    """Everything that reads files: both images, both keypoint files (or the
    pore detector where one is omitted: `detector`, else `make_detector`),
    the standardize step. Returns ((img1, P1), (img2, P2)) — (240, 320, 3)
    uint8 images and (n, 2) float32 keypoints inside the crop — or an error
    dict."""
    from pathlib import Path

    from ..data.augmentation import standardize
    from ..data.dataset import read_keypoints
    from ..data.pipeline import _annos_of, _load_image

    views = []
    for path, kpts, prefix in ((args.image1, args.kpts1, "q1"),
                               (args.image2, args.kpts2, "q2")):
        img = _load_image(path)
        if kpts:
            annos = _annos_of(read_keypoints(Path(kpts), prefix))
        else:
            detector = detector or make_detector(args)
            annos = [[f"{prefix}_{i}", float(x), float(y)] for i, (x, y)
                     in enumerate(np.asarray(detector(gray_for_detector(img))))]
        views.append((img, annos))
    if not views[0][1] or not views[1][1]:
        return {"error": "no keypoints found",
                "n_kpts": [len(views[0][1]), len(views[1][1])]}
    out = []
    for img, annos in views:
        im, an = standardize(img, annos)
        out.append((im, an[:args.n_max]))
    if not out[0][1] or not out[1][1]:
        # standardize's 240x320 centre crop can drop every keypoint
        return {"error": "no keypoints inside the standardized 240x320 crop",
                "n_kpts": [len(out[0][1]), len(out[1][1])]}
    return tuple(
        (im, np.array([[x, y] for _, x, y in an], np.float32).reshape(-1, 2))
        for im, an in out)


def build_request(img1, P1, img2, P2, cfg, univ_kernel=None):
    """Host side of one request: Delaunay graphs (and triangles, with
    `cfg.ngm.hyperedge`), the padded single-pair batch and, on the UNIV
    route, the kernel's plan. Returns (batch of numpy arrays, plan or
    None)."""
    from ..core.build_graphs import build_edges, delaunay_triangles
    from ..data.pipeline import PairSample, collate

    n_max, e_max = cfg.shapes.n_max, cfg.shapes.e_max
    P1 = np.asarray(P1, np.float32).reshape(-1, 2)[:n_max]
    P2 = np.asarray(P2, np.float32).reshape(-1, 2)[:n_max]
    _, s1, d1 = build_edges(P1, stg=cfg.data.src_graph_construct)
    _, s2, d2 = build_edges(P2, stg=cfg.data.src_graph_construct)
    s1, d1 = s1[:e_max], d1[:e_max]
    s2, d2 = s2[:e_max], d2[:e_max]
    tris = None
    if cfg.ngm.hyperedge:
        tris = (delaunay_triangles(P1)[:cfg.shapes.t_max],
                delaunay_triangles(P2)[:cfg.shapes.t_max])
    sample = PairSample(images=(img1, img2), points=(P1, P2),
                        edges=((s1, d1), (s2, d2)),
                        perm=np.zeros((len(P1), len(P2)), np.float32),
                        label=0.0, cls=("q1", "q2"), tris=tris)
    batch = collate([sample], cfg)
    plan = None
    if univ_kernel or (univ_kernel is None and n_max >= 256):
        # plan over the PADDED bucket: pad nodes have no edges, Kp/Ke = 0
        # and x = +inf-ish coordinates (sorted last), as the JAX CLI pads
        from ..kernels.assoc_univ_v3 import pad_points, plan_univ_v3
        plan = plan_univ_v3(pad_points(P2, n_max), s1, d1, s2, d2,
                            transpose=True, n1=n_max)
    return batch, plan


def match_arrays(model, img1, P1, img2, P2, *, score: str = "fused",
                 threshold=None, univ_kernel=None, checkpoint=None,
                 return_outputs: bool = False, discretize: str = "greedy",
                 viz=None):
    """Serve one request below the file reading.

    :param model: an NGMNet (its device is where the request runs)
    :param img1, img2: standardized (240, 320, 3) RGB or (240, 320[, 1])
        grayscale uint8 images
    :param P1, P2: (n, 2) float32 keypoints (x, y) in image pixels
    :param discretize: "greedy", or "hungarian" for the host LAPJV and a
        second, masked forward
    :param viz: path of a PNG to draw the pair and its matches into
        (`result["viz"]`)
    :return: the result dict the CLI prints (and, with `return_outputs`,
        the model's output dict: the second pass's eval outputs with
        "hungarian")
    """
    if discretize not in ("greedy", "hungarian"):
        raise ValueError(f"discretize must be greedy or hungarian, not "
                         f"{discretize!r}")
    cfg = model.cfg
    batch, plan = build_request(img1, P1, img2, P2, cfg, univ_kernel)
    dev = next(model.parameters()).device
    batch = batch.to(dev)
    out = model(batch, univ_plan=plan)
    if discretize == "hungarian":
        out = hungarian_pass(model, batch, out, plan)

    cls_prob = float(out["cls_prob"][0])
    k_prob = float(out["k_prob"][0])
    sc = {"fused": cls_prob * k_prob, "cls": cls_prob, "k": k_prob}[score]
    n1, n2 = int(batch.n_nodes[0, 0]), int(batch.n_nodes[0, 1])
    perm = out["perm_mat"][0, :n1, :n2].cpu().numpy()
    pairs = [[int(i), int(j)] for i, j in zip(*np.nonzero(perm))]
    result = {
        "score": round(sc, 6),
        "score_kind": score,
        "cls_prob": round(cls_prob, 6),
        "k_prob": round(k_prob, 6),
        "k_pred": round(k_prob * min(n1, n2), 2),
        "n_kpts": [n1, n2],
        "n_matched": len(pairs),
        "matches": pairs,
        "checkpoint": checkpoint,
    }
    if threshold is not None:
        result["threshold"] = threshold
        result["genuine"] = bool(sc >= threshold)
    if viz:
        from ..utils.visualize import visualize_match
        visualize_match(batch.images[0].cpu().numpy(),
                        batch.points[0].cpu().numpy(),
                        batch.n_nodes[0].cpu().numpy(),
                        out["perm_mat"][0].cpu().numpy(),
                        float(result.get("genuine", -1.0)), sc, viz,
                        unknown_label=threshold is None)
        result["viz"] = viz
    return (result, out) if return_outputs else result


def hungarian_pass(model, batch, out, plan=None):
    """The second half of `--discretize hungarian`: the host LAPJV solve of
    the first pass's `ds_mat` on each valid block, then a full forward whose
    greedy fill ranks by `mask * ds_mat` (with the same UNIV plan). Returns
    the masked step's outputs (cls_prob, k_prob, perm_mat, ds_mat)."""
    from ..core.config import default_stages
    from ..ops.hungarian import hungarian
    from ..train.step import make_eval_step_masked

    mask = hungarian(out["ds_mat"], batch.n_nodes[:, 0], batch.n_nodes[:, 1])
    _, out = make_eval_step_masked(model, default_stages()[-1],
                                   univ_plan=plan)(batch, mask)
    return out


def load_model(cfg, args):
    """The serving model on `args.device`: checkpoint weights when one is
    named or recorded as latest, else weights initialised from `--seed`.
    Returns (model, checkpoint name or None)."""
    from ..models.ngm import build_model
    from ..train.checkpoints import read_meta, restore_params

    ckpt_name = args.checkpoint or read_meta(args.checkpoint_dir).get(
        "latest")
    state_dict = None
    if ckpt_name:
        state_dict = restore_params(args.checkpoint_dir, ckpt_name, cfg)
    else:
        print("WARNING: no checkpoint found — scoring with random weights",
              file=sys.stderr)
    return build_model(cfg, device=args.device, seed=args.seed,
                       state_dict=state_dict), ckpt_name


def main(argv=None):
    args = build_parser().parse_args(argv)

    from . import model_config_from_args
    from .. import resolve_device

    resolve_device(args.device)          # fail before any work without a GPU
    cfg = model_config_from_args(args)

    pair = read_pair(args)
    if isinstance(pair, dict):
        print(json.dumps(pair))
        return 2
    (i1, P1), (i2, P2) = pair

    model, ckpt_name = load_model(cfg, args)
    result = match_arrays(model, i1, P1, i2, P2, score=args.score,
                          threshold=args.threshold,
                          univ_kernel=args.univ_kernel, checkpoint=ckpt_name,
                          discretize=args.discretize, viz=args.viz)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
