"""Time the UNIV kernel (K1, `kernels/assoc_univ_v3`) on serving-shaped
inputs, in this checkout or in another one.

    python fpmatch_tpu_torch/scripts/time_univ_v3.py [--tree DIR] [--reps 20]
        [--caps 8,16,24]

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

`--caps` adds the JAX package's slot-cap sweep (`scripts/sweep_univ_v3.py`)
on its own inputs: n = 600 points uniform on [0, 400] x [0, 300] in each
graph, Delaunay edges, C = 16, X in bf16, K^T, seed 0. Per cap, the plan
`plan_univ_v3(..., s1_cap=cap, s2_cap=cap)` (the caps decide which edges
the JAX kernel keeps and which it spills, and so which pairs round Ke to
bf16 with bf16 X), the plan's slots per output row and column (`s1`,
`s2`: the largest degrees, whatever the caps, since the port's kernel
reads every edge), the spilled-edge counts, the error against the plain
version on the same inputs (1e-5 of the range, or the script fails) and
against the f32 product, the kernel's ms and kernel-alone ms, and ten calls
under torch.profiler (their K1 launches beside the wrapper's count). One
JSON line per cap.

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
    ap.add_argument("--caps", default=None,
                    help="comma-separated slot caps to sweep, e.g. 8,16,24")
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
    if args.caps:
        for row in sweep_caps([int(c) for c in args.caps.split(",")], dev,
                              args.reps, flush):
            print(json.dumps(row), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)


def sweep_caps(caps, dev, reps: int = 20, flush=None):
    """The cap sweep's rows (see the module docstring); fails on a kernel
    that disagrees with its plain version."""
    import torch
    from fpmatch_tpu_torch.core.build_graphs import build_edges
    from fpmatch_tpu_torch.kernels import assoc_univ_v3 as k1
    from fpmatch_tpu_torch.scripts import _measure, tune_univ

    n, c = 600, 16
    rng = np.random.default_rng(SEED)
    pts1 = (rng.uniform(size=(n, 2)) * [400, 300]).astype(np.float32)
    pts2 = (rng.uniform(size=(n, 2)) * [400, 300]).astype(np.float32)
    _, s1, d1 = build_edges(pts1, stg="tri")
    _, s2, d2 = build_edges(pts2, stg="tri")
    t = lambda a: torch.from_numpy(a.astype(np.float32)).to(dev)  # noqa
    X = t(rng.normal(size=(n, n, c)))
    Kp = t(rng.normal(size=(n, n)))
    Ke = t(rng.normal(size=(len(s1), len(s2))))
    Xb = X.bfloat16()
    rows = []
    for cap in caps:
        plan = k1.plan_univ_v3(pts2, s1, d1, s2, d2, transpose=True,
                               s1_cap=cap, s2_cap=cap).to(dev)
        got = k1.assoc_matvec_univ_v3(Xb, Kp, Ke, plan)
        want = k1.assoc_matvec_univ_v3_plain(Xb, Kp, Ke, plan)
        f32 = k1.assoc_matvec_univ_v3_plain(X, Kp, Ke, plan)
        call = lambda: k1.assoc_matvec_univ_v3(Xb, Kp, Ke, plan)  # noqa
        rel = lambda a, b: float((a - b).abs().max()) / float(  # noqa
            b.abs().max())
        prof = _measure.profiled(call, dev, _measure.LAUNCH_CHECK_CALLS)
        row = {"cap": cap, "n": n, "C": c, "x": "bfloat16",
               "E1": len(s1), "E2": len(s2), "s1": plan.s1, "s2": plan.s2,
               "spill1": int((~plan.keep1).sum()),
               "spill2": int((~plan.keep2).sum()),
               "rel_err_vs_plain": rel(got, want),
               "rel_err_vs_f32": rel(got, f32),
               "ms": tune_univ.time_ms(call, dev, reps, flush),
               "kernel_ms": (tune_univ.profiled_ms(call, "assoc_univ_v3",
                                                   flush=flush)
                             if dev.type == "cuda" else None),
               "launches": {"wrappers": prof["wrapper_launches"],
                            "profiler": prof["profiler_launches"]}}
        if not row["rel_err_vs_plain"] <= 1e-5:
            sys.exit(f"time_univ_v3: the kernel disagrees: {row}")
        rows.append(row)
    return rows


if __name__ == "__main__":
    main()
