"""Time the training path's association kernels — K2 (`assoc_matvec_bucket`)
in f32 and bf16, the bf16 dX launch in both orientations, K6
(`assoc_edge_grad`) in f32 and bf16 — on the same inputs, in this checkout
or in another one.

    python fpmatch_tpu_torch/scripts/time_assoc_grad.py [--tree DIR]
        [--reps 20] [--dump FILE] [--against FILE]

The inputs are made from seed 0 with numpy: padded batches of Delaunay
pairs as the training path gives them, B=8 / N=64 / E=384 with 40-64 nodes
per graph and B=2 / N=256 / E=1536 with 200-256, Ke zero on padded slots,
edge masks from the counts, an upstream gradient dY, C = 17 (and C = 1 at
N=64). Rows: `fwd_f32` / `fwd_bf16` (K2 on X, K^T), `dx_bf16_T` /
`dx_bf16_N` (the bf16 dX launch: K2 on bf16(dY) with Kp = 0, `transpose`
False / True, as the backward of a K^T / K forward makes it), `k6_f32` /
`k6_bf16` (K^T). Each row: the median of `--reps` CUDA-event times of one
wrapper call with the L2 cache flushed before each (`ms`), the kernel's
own device time from torch.profiler over 10 such calls (`kernel_ms`, null
where the profiler did not catch every launch), each output checked
bit-identical over two calls. `--dump FILE` saves every output;
`--against FILE` reports for each row whether its output is bit for bit
the one FILE holds (`same_bits_as_other`, e.g. the parent commit's). One
JSON line per row, then the card's name and power limit.

`--tree DIR` imports `fpmatch_tpu_torch` from DIR instead of this checkout,
for example an unpacked `git archive` of another commit, so that two
commits are timed on the same inputs in one call, in turns (A, B, B, A);
both trees need the signatures the functions timed have here. Run it as a file
(not with -m), so that the package comes from the tree named. Needs a GPU.
"""
import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

SEED = 0
# (B, bucket N, padded E, fewest and most nodes per graph, channel counts)
SHAPES = ((8, 64, 384, 40, 64, (17, 1)), (2, 256, 1536, 200, 256, (17,)))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=str(Path(__file__).resolve()
                                          .parents[2]),
                    help="checkout whose fpmatch_tpu_torch is timed")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--dump", help="save every output to this file")
    ap.add_argument("--against", help="compare every output with this file")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(args.tree).resolve()))

    import torch
    if not torch.cuda.is_available():
        sys.exit("time_assoc_grad: needs a CUDA device")
    from fpmatch_tpu_torch.core.build_graphs import build_edges
    from fpmatch_tpu_torch.kernels import _build
    from fpmatch_tpu_torch.kernels import assoc_bucket as kb
    from fpmatch_tpu_torch.kernels import assoc_grad as k6
    from fpmatch_tpu_torch.scripts import tune_univ
    from fpmatch_tpu_torch.scripts.time_assoc_large import make_batch

    dev = torch.device("cuda")
    _build.build(["assoc_bucket", "assoc_grad"])
    rng = np.random.default_rng(SEED)
    flush = tune_univ.l2_flush(dev)
    other = torch.load(args.against) if args.against else None
    outputs, wrong = {}, []
    for B, N, E, n_lo, n_hi, Cs in SHAPES:
        idx, n_e, n_v, Ke = make_batch(rng, build_edges, B, N, E, n_lo, n_hi)
        edges = [torch.from_numpy(a).to(dev) for a in idx]
        ar = np.arange(E)[None]
        masks = dict(e1_mask=torch.from_numpy(ar < n_e[:, :1]).to(dev),
                     e2_mask=torch.from_numpy(ar < n_e[:, 1:]).to(dev))
        Ke = torch.from_numpy(Ke).to(dev)
        for C in Cs:
            X = np.zeros((B, N, N, C), np.float32)
            Kp = np.zeros((B, N, N), np.float32)
            dY = rng.normal(size=(B, N, N, C)).astype(np.float32)
            for b in range(B):
                n1, n2 = n_v[b]
                X[b, :n1, :n2] = rng.normal(size=(n1, n2, C))
                Kp[b, :n1, :n2] = rng.normal(size=(n1, n2))
            X, Kp, dY = (torch.from_numpy(a).to(dev) for a in (X, Kp, dY))
            Xb, dYb, zero = X.bfloat16(), dY.bfloat16(), torch.zeros_like(Kp)
            calls = {
                "fwd_f32": lambda: kb.assoc_matvec_bucket(
                    X, Kp, Ke, *edges, transpose=True, **masks),
                "fwd_bf16": lambda: kb.assoc_matvec_bucket(
                    Xb, Kp, Ke, *edges, transpose=True, **masks),
                "dx_bf16_T": lambda: kb.assoc_matvec_bucket(
                    dYb, zero, Ke, *edges, transpose=False, **masks),
                "dx_bf16_N": lambda: kb.assoc_matvec_bucket(
                    dYb, zero, Ke, *edges, transpose=True, **masks),
                "k6_f32": lambda: k6.assoc_edge_grad(
                    dY, X, *edges, transpose=True, **masks),
                "k6_bf16": lambda: k6.assoc_edge_grad(
                    dY, Xb, *edges, transpose=True, **masks)}
            for name, call in calls.items():
                got, again = call(), call()
                torch.cuda.synchronize()
                got = got if isinstance(got, tuple) else (got,)
                again = again if isinstance(again, tuple) else (again,)
                key = f"{name}/B{B}/N{N}/C{C}"
                outputs[key] = [t.cpu() for t in got]
                row = {"tree": args.tree, "row": name, "B": B, "N": N,
                       "E": E, "C": C,
                       "assoc_edges": int((n_e[:, 0] * n_e[:, 1]).sum()),
                       "bit_identical": all(torch.equal(a, b)
                                            for a, b in zip(got, again)),
                       "ms": tune_univ.time_ms(call, dev, args.reps, flush),
                       "kernel_ms": tune_univ.profiled_ms(
                           call, "assoc_grad_kernel" if name.startswith("k6")
                           else "assoc_bucket_kernel", flush=flush)}
                if other is not None and key in other:
                    row["same_bits_as_other"] = all(
                        torch.equal(a, b) for a, b in zip(outputs[key],
                                                          other[key]))
                print(json.dumps(row), flush=True)
                if not row["bit_identical"]:
                    wrong.append(row)
    if args.dump:
        torch.save(outputs, args.dump)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    if wrong:
        sys.exit(f"time_assoc_grad: two calls differ in {len(wrong)} row(s)")


if __name__ == "__main__":
    main()
