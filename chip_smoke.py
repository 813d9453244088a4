#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving path on one NVIDIA GPU.

    python3 chip_smoke.py            # needs one CUDA device and nvcc
    python3 chip_smoke.py --profile  # + a torch.profiler table of one request

Phases (each prints its own lines; any failure exits non-zero):

  1. device   card name + power limit, torch / CUDA / nvcc versions
  2. build    every kernel source under fpmatch_tpu_torch/kernels/csrc/
  3. kernels  assoc_univ_v3 (CUDA) against its plain PyTorch version and
              against ops.assoc (no plan) on the card, at the serving
              shapes; times by CUDA events
  4. serve    UNIV route (n_max=600, e_max=3840, univ=600) at full model
              width, a few requests through cli.match.match_arrays
  5. parity   one UNIV request against the port's own CPU run (plain kernel
              version), TF32 off
  6. serve    bucket route (n_max=64, e_max=384), 3 requests

Weights are initialised from a seed, images and keypoints are made from a
seed; nothing is read from disk but the package itself. The second-to-last
lines carry the per-kernel JSON and the card; the last line is
{"ok": true, "device": {...}}.
"""
import json
import subprocess
import sys
import time

import numpy as np
import torch

if not torch.cuda.is_available():
    print("chip_smoke: torch.cuda.is_available() is False — this script "
          "needs an NVIDIA GPU", file=sys.stderr)
    sys.exit(1)

from fpmatch_tpu_torch.cli import model_config_from_args
from fpmatch_tpu_torch.cli.match import build_parser, match_arrays
from fpmatch_tpu_torch.core.build_graphs import build_edges
from fpmatch_tpu_torch.kernels import _build
from fpmatch_tpu_torch.kernels import assoc_univ_v3 as k1
from fpmatch_tpu_torch.models.ngm import build_model
from fpmatch_tpu_torch.ops.assoc import assoc_matvec_auto

SEED = 0
DEV = torch.device("cuda")
# published peaks of one H100 SXM (dense): HBM bytes/s, f32 FLOP/s outside
# the tensor cores
PEAK_BYTES_S = 3.35e12
PEAK_F32_FLOPS = 67e12
T0 = time.time()


def say(*a):
    print(*a, flush=True)


def fail(msg):
    say(f"FAIL: {msg}")
    sys.exit(1)


def sh(cmd):
    return subprocess.run(cmd, capture_output=True, text=True,
                          timeout=60).stdout.strip()


# ------------------------------------------------------------------ 1 device
def phase_device():
    card = sh(["nvidia-smi", "--query-gpu=name,power.limit",
               "--format=csv,noheader"]).splitlines()[0]
    nvcc = sh([_build.find_nvcc(), "--version"]).splitlines()[-2:]
    say(f"[1 device] {card}")
    say(f"[1 device] python {sys.version.split()[0]} torch "
        f"{torch.__version__} cuda {torch.version.cuda} cudnn "
        f"{torch.backends.cudnn.version()} | nvcc: {' '.join(nvcc)}")
    say(f"[1 device] defaults: cudnn.allow_tf32="
        f"{torch.backends.cudnn.allow_tf32} matmul.allow_tf32="
        f"{torch.backends.cuda.matmul.allow_tf32}")
    return card


# ------------------------------------------------------------------- 2 build
def phase_build():
    t = time.time()
    libs = _build.build(verbose=True)
    for name in libs:
        _build.load(name)
    say(f"[2 build] {len(libs)} source(s) {sorted(libs)} built with nvcc "
        f"for sm_90a and loaded in {time.time() - t:.1f} s")


# ----------------------------------------------------------------- 3 kernels
def delaunay(rng, n):
    P = rng.uniform([8, 8], [312, 232], size=(n, 2)).astype(np.float32)
    _, s, d = build_edges(P)
    return P, s, d


def relerr(a, b):
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)


def time_ms(fn, reps=20, flush=None):
    """Median CUDA-event time of one call; `flush` (a big tensor) is
    overwritten before each call so the call finds the L2 cache cold."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        if flush is not None:
            flush.zero_()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def kernel_case(rng, N, n1, n2, E, C, transpose, flush, timed):
    """One comparison at bucket N with n1 / n2 real nodes, Ke padded to
    (E, E). Returns a dict of errors (and times when `timed`)."""
    _, s1, d1 = delaunay(rng, n1)
    _, s2, d2 = delaunay(rng, n2)
    if len(s1) > E or len(s2) > E:
        fail(f"e_max {E} too small for {len(s1)} / {len(s2)} edges")
    g = torch.Generator().manual_seed(int(rng.integers(1 << 30)))
    X = torch.zeros(N, N, C)
    X[:n1, :n2] = torch.randn(n1, n2, C, generator=g)
    Kp = torch.zeros(N, N)
    Kp[:n1, :n2] = torch.randn(n1, n2, generator=g)
    Ke = torch.zeros(E, E)
    Ke[:len(s1), :len(s2)] = torch.randn(len(s1), len(s2), generator=g)
    X, Kp, Ke = X.to(DEV), Kp.to(DEV), Ke.to(DEV)
    plan = k1.plan_univ_v3(N, N, s1, d1, s2, d2, transpose=transpose).to(DEV)

    got = k1.assoc_matvec_univ_v3(X, Kp, Ke, plan)
    torch.cuda.synchronize()
    plain = k1.assoc_matvec_univ_v3_plain(X, Kp, Ke, plan)
    pad = lambda a: torch.from_numpy(np.pad(a, (0, E - len(a)))
                                     ).to(DEV)[None]
    noplan = assoc_matvec_auto(X[None], Kp[None], Ke[None], pad(s1), pad(d1),
                               pad(s2), pad(d2), transpose=transpose)[0]
    Xb = X.bfloat16()
    got_bf = k1.assoc_matvec_univ_v3(Xb, Kp, Ke, plan)
    plain_bf = k1.assoc_matvec_univ_v3_plain(Xb, Kp, Ke, plan)
    torch.cuda.synchronize()
    r = {"N": N, "n1": n1, "n2": n2, "C": C, "transpose": transpose,
         "E1": len(s1), "E2": len(s2), "S1": plan.s1, "S2": plan.s2,
         "err_vs_plain": relerr(got, plain),
         "err_vs_noplan": relerr(got, noplan),
         "bf16_err_vs_plain_bf16": relerr(got_bf, plain_bf),
         "bf16_err_vs_f32": relerr(got_bf, got),
         "max_abs_err": float((got - plain).abs().max())}
    for k in ("err_vs_plain", "err_vs_noplan", "bf16_err_vs_plain_bf16"):
        if not r[k] <= 1e-5:
            fail(f"assoc_univ_v3 {k} = {r[k]:.3e} > 1e-5 at {r}")
    if not torch.isfinite(got).all():
        fail("assoc_univ_v3 produced non-finite values")
    if timed:
        # least work for THIS input: X, Kp and the real block of Ke read
        # once, the slot tables read once, Y written once; 2 flops per
        # (association edge, channel) + the Kp term
        e1r, e2r = len(s1), len(s2)
        tables = 2 * 4 * (N * plan.s1 + N * plan.s2)
        nbytes = 4 * (2 * N * N * C + N * N + e1r * e2r) + tables
        flops = 2.0 * C * e1r * e2r + 2.0 * N * N * C
        t_bytes = nbytes / PEAK_BYTES_S * 1e3
        t_ops = flops / PEAK_F32_FLOPS * 1e3
        r.update(
            ms=time_ms(lambda: k1.assoc_matvec_univ_v3(X, Kp, Ke, plan),
                       flush=flush),
            ms_warm_l2=time_ms(
                lambda: k1.assoc_matvec_univ_v3(X, Kp, Ke, plan)),
            ms_bf16=time_ms(
                lambda: k1.assoc_matvec_univ_v3(Xb, Kp, Ke, plan),
                flush=flush),
            plain_ms=time_ms(
                lambda: k1.assoc_matvec_univ_v3_plain(X, Kp, Ke, plan),
                reps=5, flush=flush),
            noplan_ms=time_ms(
                lambda: assoc_matvec_auto(
                    X[None], Kp[None], Ke[None], pad(s1), pad(d1), pad(s2),
                    pad(d2), transpose=transpose), reps=5, flush=flush),
            bytes=nbytes, flops=flops, bound_ms=max(t_bytes, t_ops),
            bound_by="bytes" if t_bytes >= t_ops else "operations")
    return r


def phase_kernels():
    rng = np.random.default_rng(SEED)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=DEV)
    rows = []
    for (n1, n2) in ((600, 600), (520, 600)):
        for C in (1, 17):
            for transpose in (True, False):
                timed = (n1, n2) == (600, 600) and transpose
                r = kernel_case(rng, 600, n1, n2, 3840, C, transpose, flush,
                                timed)
                rows.append(r)
                say("[3 kernels] " + json.dumps(r))
    # zero-edge sides: Ke[:0] with edges on side 2 only, then no edges
    n, C = 130, 4
    _, s2, d2 = delaunay(rng, n)
    empty = np.zeros(0, np.int64)
    X = torch.randn(n, n, C, device=DEV)
    Kp = torch.randn(n, n, device=DEV)
    for (a, b) in ((s2, d2), (empty, empty)):
        Ke = torch.zeros(8, len(a), device=DEV)[:0]
        plan = k1.plan_univ_v3(n, n, empty, empty, a, b).to(DEV)
        got = k1.assoc_matvec_univ_v3(X, Kp, Ke, plan)
        torch.cuda.synchronize()
        e = relerr(got, Kp[..., None] * X)
        say(f"[3 kernels] zero-edge side, E2={len(a)}: S1={plan.s1} "
            f"S2={plan.s2} err vs Kp*X = {e:.2e}")
        if not e <= 1e-6:
            fail("zero-edge case disagrees with the Kp diagonal")
    del flush
    return rows


# ------------------------------------------------------------------- serving
def cli_config(n_max, e_max, univ):
    args = build_parser().parse_args(
        ["a", "b", "--n-max", str(n_max), "--e-max", str(e_max), "--univ",
         str(univ)])
    return model_config_from_args(args)


def make_request(rng, kind, n_lo, n_hi):
    """(img1, P1, img2, P2): 240x320 grayscale uint8 images and keypoints.
    genuine = jittered copy; impostor = independent cloud; ragged = n1 != n2
    (a subset of the jittered copy)."""
    img = lambda: rng.integers(0, 256, size=(240, 320), dtype=np.uint8)
    n = int(rng.integers(n_lo, n_hi + 1))
    P1 = rng.uniform([8, 8], [312, 232], size=(n, 2)).astype(np.float32)
    if kind == "impostor":
        m = int(rng.integers(n_lo, n_hi + 1))
        P2 = rng.uniform([8, 8], [312, 232], size=(m, 2)).astype(np.float32)
    else:
        P2 = np.clip(P1 + rng.normal(0, 1.5, P1.shape), 0,
                     [319, 239]).astype(np.float32)
        if kind == "ragged":
            P2 = P2[:int(0.87 * n)]
    return img(), P1, img(), P2


def check_outputs(tag, result, out, n1, n2):
    for k, v in out.items():
        if not torch.isfinite(v).all():
            fail(f"{tag}: output {k} has non-finite values")
    perm = out["perm_mat"][0]
    if not ((perm == 0) | (perm == 1)).all():
        fail(f"{tag}: perm_mat is not 0/1")
    if perm.sum(0).max() > 1 or perm.sum(1).max() > 1:
        fail(f"{tag}: perm_mat row/column sums exceed 1")
    if perm[n1:].sum() != 0 or perm[:, n2:].sum() != 0:
        fail(f"{tag}: perm_mat has matches outside the valid block")
    m = min(n1, n2)
    k_round = int(torch.round(out["k_prob"][0] * float(m)))
    want = min(max(k_round, 0), m)
    if result["n_matched"] != want or int(perm.sum()) != want:
        fail(f"{tag}: n_matched {result['n_matched']} != round(k_pred) "
             f"clipped = {want}")
    if result["n_kpts"] != [n1, n2]:
        fail(f"{tag}: n_kpts {result['n_kpts']} != {[n1, n2]}")


def serve(tag, model, requests):
    times = []
    for kind, req in requests:
        torch.cuda.synchronize()
        t = time.time()
        result, out = match_arrays(model, *req, return_outputs=True)
        torch.cuda.synchronize()
        dt = time.time() - t
        times.append(dt)
        check_outputs(f"{tag} {kind}", result, out, len(req[1]), len(req[3]))
        say(f"[{tag}] {kind}: {dt * 1e3:.1f} ms  {json.dumps(result)}")
    return times


def phase_serve_univ(model):
    rng = np.random.default_rng(SEED + 1)
    requests = [("genuine (first request, includes warm-up)",
                 make_request(rng, "genuine", 540, 600)),
                ("genuine", make_request(rng, "genuine", 540, 600)),
                ("impostor", make_request(rng, "impostor", 500, 600)),
                ("ragged n1!=n2", make_request(rng, "ragged", 580, 600))]
    for k in k1.LAUNCHES:
        k1.LAUNCHES[k] = 0
    times = serve("4 serve univ", model, requests)
    launches = dict(k1.LAUNCHES)
    want = 3 * len(requests)
    say(f"[4 serve univ] kernel launches on the main path: {launches} "
        f"(expected {want}: one per GNN layer per request)")
    if launches["assoc_univ_v3"] != want:
        fail("the UNIV route did not go through the assoc_univ_v3 kernel "
             "once per GNN layer")
    say(f"[4 serve univ] wall ms per request after the first: "
        f"{[round(t * 1e3, 1) for t in times[1:]]}")
    return launches, times, requests[1][1]


def phase_profile(model, req):
    """Optional (`--profile`): where one UNIV request's device time goes, by
    kernel name, from torch.profiler. Not part of the default run."""
    from torch.profiler import ProfilerActivity, profile

    launches = dict(k1.LAUNCHES)
    torch.cuda.synchronize()
    t = time.time()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        match_arrays(model, *req)
        torch.cuda.synchronize()
    wall = time.time() - t
    k1.LAUNCHES.update(launches)
    evs = [e for e in prof.key_averages() if e.device_time_total > 0
           and e.device_type.name == "CUDA"]
    total = sum(e.device_time_total for e in evs)
    n = sum(e.count for e in evs)
    say(f"[profile] one UNIV request under the profiler: wall "
        f"{wall * 1e3:.1f} ms, device busy {total / 1e3:.1f} ms in {n} "
        f"kernel launches")
    for e in sorted(evs, key=lambda e: -e.device_time_total)[:14]:
        say(f"[profile] {e.device_time_total / 1e3:8.2f} ms {e.count:6d}x  "
            f"{e.key[:90]}")


def phase_parity(model, cfg, req):
    """The card's result against the port's own CPU run (plain kernel
    version) of the same weights and inputs, TF32 off on both sides."""
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    launches = dict(k1.LAUNCHES)
    res_g, out_g = match_arrays(model, *req, return_outputs=True)
    torch.cuda.synchronize()
    t = time.time()
    cpu = build_model(cfg, device="cpu", state_dict={
        k: v.cpu() for k, v in model.state_dict().items()})
    res_c, out_c = match_arrays(cpu, *req, return_outputs=True)
    say(f"[5 parity] CPU run (plain kernel version): {time.time() - t:.1f} s")
    k1.LAUNCHES.update(launches)    # comparison launches do not count
    torch.backends.cudnn.allow_tf32, \
        torch.backends.cuda.matmul.allow_tf32 = saved
    errs = {}
    for k in ("Kp", "raw_scores", "sinkhorn", "ds_mat", "cls_prob",
              "k_prob"):
        a, b = out_g[k].cpu().float(), out_c[k].float()
        errs[k] = {"max_abs": float((a - b).abs().max()),
                   "ref_max": float(b.abs().max())}
    pg, pc = out_g["perm_mat"][0].cpu(), out_c["perm_mat"][0]
    agree = float((pg == pc).all(dim=1).float().mean())
    say(f"[5 parity] gpu vs cpu: {json.dumps(errs)}")
    say(f"[5 parity] perm_mat rows identical: {agree:.4f}; n_matched gpu "
        f"{res_g['n_matched']} cpu {res_c['n_matched']}")
    # float32 on both sides with TF32 off; only the order of sums differs.
    # raw_scores pass three embedded Sinkhorns at tau = 0.01 (score
    # differences x100 before 20 normalization sweeps) and the final Sinkhorn
    # divides by tau once more, so rounding noise of ~1e-7 is amplified stage
    # by stage: limits are relative to each output's largest value.
    tol = {"Kp": 1e-5, "raw_scores": 1e-4, "sinkhorn": 1e-3}
    for k, rel in tol.items():
        lim = rel * max(errs[k]["ref_max"], 1e-30)
        if not errs[k]["max_abs"] <= lim:
            fail(f"parity: {k} differs by {errs[k]['max_abs']:.3e} > "
                 f"{lim:.3e}")
    for k in ("cls_prob", "k_prob"):
        if not errs[k]["max_abs"] <= 1e-3:
            fail(f"parity: {k} differs by {errs[k]['max_abs']:.3e} > 1e-3")
    return errs, agree


def phase_serve_bucket():
    cfg = cli_config(64, 384, 600)
    model = build_model(cfg, device="cuda", seed=SEED)
    rng = np.random.default_rng(SEED + 2)
    requests = [(k, make_request(rng, k, 40, 60))
                for k in ("genuine", "impostor", "ragged")]
    before = dict(k1.LAUNCHES)
    times = serve("6 serve bucket", model, requests)
    if k1.LAUNCHES != before:
        fail("the bucket route must not launch the UNIV kernel")
    say(f"[6 serve bucket] wall ms per request: "
        f"{[round(t * 1e3, 1) for t in times]}")
    return times


def main():
    card = phase_device()
    phase_build()
    rows = phase_kernels()

    cfg = cli_config(600, 3840, 600)
    t = time.time()
    model = build_model(cfg, device="cuda", seed=SEED)
    n_par = sum(p.numel() for p in model.parameters())
    say(f"[4 serve univ] full-width model ({n_par / 1e6:.1f} M parameters) "
        f"initialised from seed {SEED} in {time.time() - t:.1f} s")
    launches, t_univ, req = phase_serve_univ(model)
    if "--profile" in sys.argv[1:]:
        phase_profile(model, req)
    phase_parity(model, cfg, req)
    del model
    torch.cuda.empty_cache()
    phase_serve_bucket()

    c17 = next(r for r in rows if "ms" in r and r["C"] == 17)
    c1 = next(r for r in rows if "ms" in r and r["C"] == 1)
    shape = lambda r: {k: r[k] for k in (
        "C", "N", "E1", "E2", "S1", "S2", "ms", "ms_warm_l2", "ms_bf16",
        "plain_ms", "noplan_ms", "bound_ms", "bound_by", "bytes", "flops")}
    kernels = {"kernels": [{
        "name": "assoc_univ_v3", "route": "cuda",
        "source": k1.SOURCE, "replaces": k1.REPLACES,
        "launches": launches["assoc_univ_v3"],
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "max_rel_err": max(r["err_vs_plain"] for r in rows),
        "ms": c17["ms"], "plain_ms": c17["plain_ms"],
        "bound_ms": c17["bound_ms"], "bound_by": c17["bound_by"],
        "library_ms": None,
        "shapes": [shape(c1), shape(c17)]}]}
    say(json.dumps(kernels))
    say(card)
    say(f"[done] {time.time() - T0:.0f} s in all")
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
