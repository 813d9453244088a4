"""Time the any-size association kernel (K3, `kernels/assoc_bucket`'s
`assoc_matvec_large`) beside the bucket kernel (K2) on the same inputs, in
this checkout or in another one.

    python fpmatch_tpu_torch/scripts/time_assoc_large.py [--tree DIR]
                                                         [--reps 20]

The inputs are made from seed 0 with numpy: padded batches of Delaunay pairs
as the evaluate path gives K3 (E1·E2 >= 1 M edge slots), B=2 / N=256 /
E=1536 with 200-256 nodes per graph and B=1 / N=600 / E=3840 with 560-600,
Ke zero on padded slots, edge masks from the counts, K^T, C = 1 and 17, f32
and bf16 X. Each case holds one K3 launch against its plain version (1e-5
of the range) and a second launch bit for bit (the script exits non-zero at
the end if any case disagrees), then times K3 and K2: median of `--reps`
CUDA-event times of one wrapper call, the L2 cache flushed before each
(`ms`, `k2_ms`), and each kernel's own device time from
torch.profiler over 10 such calls (`kernel_ms`, `k2_kernel_ms`, null where
the profiler did not catch every launch). One JSON line per case, then the
card's name and power limit.

`--tree DIR` imports `fpmatch_tpu_torch` from DIR instead of this checkout,
for example an unpacked `git archive` of another commit, so that two
commits are timed on the same inputs in one call, in turns (A, B, B, A).
Run it as a file (not with -m), so that the package comes from the tree
named. Needs a GPU.
"""
import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

SEED = 0
# (B, bucket N, padded E, fewest and most nodes per graph)
SHAPES = ((2, 256, 1536, 200, 256), (1, 600, 3840, 560, 600))


def make_batch(rng, build_edges, B, N, E, n_lo, n_hi):
    """Edge lists (4, B, E) int32, real edge counts (B, 2), node counts
    (B, 2) and Ke (B, E, E) f32 zero on padded slots, all numpy."""
    idx = np.zeros((4, B, E), np.int32)
    n_e = np.zeros((B, 2), np.int64)
    n_v = rng.integers(n_lo, n_hi + 1, size=(B, 2))
    for b in range(B):
        for g in range(2):
            pts = rng.uniform([8, 8], [312, 232],
                              size=(n_v[b, g], 2)).astype(np.float32)
            _, s, d = build_edges(pts)
            idx[2 * g, b, :len(s)] = s
            idx[2 * g + 1, b, :len(d)] = d
            n_e[b, g] = len(s)
    Ke = np.zeros((B, E, E), np.float32)
    for b in range(B):
        Ke[b, :n_e[b, 0], :n_e[b, 1]] = rng.normal(size=tuple(n_e[b]))
    return idx, n_e, n_v, Ke


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=str(Path(__file__).resolve()
                                          .parents[2]),
                    help="checkout whose fpmatch_tpu_torch is timed")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(args.tree).resolve()))

    import torch
    if not torch.cuda.is_available():
        sys.exit("time_assoc_large: needs a CUDA device")
    from fpmatch_tpu_torch.core.build_graphs import build_edges
    from fpmatch_tpu_torch.kernels import _build
    from fpmatch_tpu_torch.kernels import assoc_bucket as kb
    from fpmatch_tpu_torch.scripts import tune_univ

    dev = torch.device("cuda")
    _build.build(["assoc_bucket"])
    rng = np.random.default_rng(SEED)
    flush = tune_univ.l2_flush(dev)
    wrong = []
    for B, N, E, n_lo, n_hi in SHAPES:
        idx, n_e, n_v, Ke = make_batch(rng, build_edges, B, N, E, n_lo, n_hi)
        edges = [torch.from_numpy(a).to(dev) for a in idx]
        ar = np.arange(E)[None]
        masks = dict(e1_mask=torch.from_numpy(ar < n_e[:, :1]).to(dev),
                     e2_mask=torch.from_numpy(ar < n_e[:, 1:]).to(dev))
        Ke = torch.from_numpy(Ke).to(dev)
        for C in (1, 17):
            X = np.zeros((B, N, N, C), np.float32)
            Kp = np.zeros((B, N, N), np.float32)
            for b in range(B):
                n1, n2 = n_v[b]
                X[b, :n1, :n2] = rng.normal(size=(n1, n2, C))
                Kp[b, :n1, :n2] = rng.normal(size=(n1, n2))
            X, Kp = torch.from_numpy(X).to(dev), torch.from_numpy(Kp).to(dev)
            for x in (X, X.bfloat16()):
                args_ = (x, Kp, Ke, *edges)
                got = kb.assoc_matvec_large(*args_, transpose=True, **masks)
                again = kb.assoc_matvec_large(*args_, transpose=True, **masks)
                want = kb.assoc_matvec_large_plain(*args_, transpose=True,
                                                   **masks)
                torch.cuda.synchronize()
                err = float((got - want).abs().max()) / float(
                    want.abs().max())
                k3 = lambda: kb.assoc_matvec_large(*args_, transpose=True,
                                                   **masks)
                k2 = lambda: kb.assoc_matvec_bucket(*args_, transpose=True,
                                                    **masks)
                row = {"tree": args.tree, "B": B, "N": N, "E": E, "C": C,
                       "x": str(x.dtype)[6:],
                       "assoc_edges": int((n_e[:, 0] * n_e[:, 1]).sum()),
                       "rel_err_vs_plain": err,
                       "bit_identical": bool(torch.equal(got, again)),
                       "ms": tune_univ.time_ms(k3, dev, args.reps, flush),
                       "kernel_ms": tune_univ.profiled_ms(
                           k3, "assoc_large", flush=flush),
                       "k2_ms": tune_univ.time_ms(k2, dev, args.reps, flush),
                       "k2_kernel_ms": tune_univ.profiled_ms(
                           k2, "assoc_bucket", flush=flush)}
                print(json.dumps(row), flush=True)
                if not (err <= 1e-5 and row["bit_identical"]):
                    wrong.append(row)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    if wrong:
        sys.exit(f"time_assoc_large: the kernel disagrees in {len(wrong)} "
                 f"case(s)")


if __name__ == "__main__":
    main()
