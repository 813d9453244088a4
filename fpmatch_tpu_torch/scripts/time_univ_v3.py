"""Time the UNIV kernel (K1, `kernels/assoc_univ_v3`) on serving-shaped
inputs, in this checkout or in another one.

    python fpmatch_tpu_torch/scripts/time_univ_v3.py [--tree DIR] [--reps 20]

The inputs are made from seed 0 with numpy: a Delaunay pair of 600 points
each in a bucket of 600, Ke padded to 3840 x 3840 (the serving shapes of
`cli/match` at n_max=600), C = 1 and 17 in both orientations, f32 and bf16
X. Each case holds one launch against the plain version (1e-5 of the range)
and a second launch bit for bit, then times the kernel: median of `--reps`
CUDA-event times, the L2 cache flushed before each call (`ms`, which holds
whatever of the wrapper's host time outlasts the flush), and the kernel's
own device time from torch.profiler over 10 such calls (`kernel_ms`, null
where the profiler did not catch every launch). One JSON line per case,
then the card's name and power limit.

`--tree DIR` imports `fpmatch_tpu_torch` from DIR instead of this checkout,
for example an unpacked `git archive` of another commit with the same
`plan_univ_v3` arguments, so that two commits are timed on the same inputs
in one call, in turns (A, B, B, A). Run it as a file (not with -m), so that
the package comes from the tree named. Needs a GPU.
"""
import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

N = 600        # nodes per graph, and the bucket
E_MAX = 3840   # Ke's padded side
SEED = 0


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
        sys.exit("time_univ_v3: needs a CUDA device")
    from fpmatch_tpu_torch.core.build_graphs import build_edges
    from fpmatch_tpu_torch.kernels import _build
    from fpmatch_tpu_torch.kernels import assoc_univ_v3 as k1
    from fpmatch_tpu_torch.scripts import tune_univ

    dev = torch.device("cuda")
    _build.build(["assoc_univ_v3"])
    rng = np.random.default_rng(SEED)
    pts = [rng.uniform([8, 8], [312, 232], size=(N, 2)).astype(np.float32)
           for _ in range(2)]
    (_, s1, d1), (_, s2, d2) = (build_edges(p) for p in pts)
    flush = tune_univ.l2_flush(dev)
    for C in (1, 17):
        X = torch.from_numpy(rng.normal(size=(N, N, C)).astype(np.float32))
        Kp = torch.from_numpy(rng.normal(size=(N, N)).astype(np.float32))
        Ke = torch.zeros(E_MAX, E_MAX)
        Ke[:len(s1), :len(s2)] = torch.from_numpy(
            rng.normal(size=(len(s1), len(s2))).astype(np.float32))
        X, Kp, Ke = X.to(dev), Kp.to(dev), Ke.to(dev)
        for transpose in (True, False):
            plan = k1.plan_univ_v3(pts[1], s1, d1, s2, d2,
                                   transpose=transpose, n1=N).to(dev)
            for x in (X, X.bfloat16()):
                got = k1.assoc_matvec_univ_v3(x, Kp, Ke, plan)
                again = k1.assoc_matvec_univ_v3(x, Kp, Ke, plan)
                want = k1.assoc_matvec_univ_v3_plain(x, Kp, Ke, plan)
                torch.cuda.synchronize()
                err = float((got - want).abs().max()) / float(
                    want.abs().max())
                call = lambda: k1.assoc_matvec_univ_v3(x, Kp, Ke, plan)
                row = {"tree": args.tree, "C": C, "transpose": transpose,
                       "x": str(x.dtype)[6:], "E1": len(s1), "E2": len(s2),
                       "rel_err_vs_plain": err,
                       "bit_identical": bool(torch.equal(got, again)),
                       "ms": tune_univ.time_ms(call, dev, args.reps, flush),
                       "kernel_ms": tune_univ.profiled_ms(
                           call, "assoc_univ_v3", flush=flush)}
                print(json.dumps(row), flush=True)
                if not (err <= 1e-5 and row["bit_identical"]):
                    sys.exit(f"time_univ_v3: the kernel disagrees: {row}")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)


if __name__ == "__main__":
    main()
