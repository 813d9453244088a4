"""The masked Sinkhorn's CUDA kernels (`kernels.sinkhorn`) and the rule by
which `ops.sinkhorn.sinkhorn_batch` takes them.

On the CPU: the dispatch rule over (device, dtype, shape, sweeps), and that
calls the rule sends to the plain ops count in `PLAIN_CALLS` and launch
nothing. On the card (`pytest -m gpu`; skipped without CUDA, the kernels
have no interpret mode): the kernels' forward and gradient against the
plain ops' float64 run on the same inputs, beside the plain ops' own float32
run, over bucket sizes, counts 0 / 1 / S, both orientations in one batch,
with and without the dummy band, odd and even sweep counts and two
temperatures; and the launch counts, with and without `remat`.

Tolerances: the plain float32 path sits within 3e-6 (forward) and 5e-6 of
the gradient's largest value of its float64 run at these shapes (tau 0.01
amplifies float32 rounding ~100x); the kernels sum in another order and
rebuild each sweep's input in the backward from its output and normalizer,
so they are held to 2e-5 and 5e-5. A wrong orientation, band or sweep order
is off by O(1).
"""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from fpmatch_tpu_torch.kernels import sinkhorn as k_sk
from fpmatch_tpu_torch.models.layers import remat
from fpmatch_tpu_torch.ops import sinkhorn as t_sk


def probe(device, dtype, shape):
    """What `takes_kernel` reads of a tensor, for devices this host lacks."""
    return SimpleNamespace(device=torch.device(device), dtype=dtype,
                           shape=torch.Size(shape), dim=lambda: len(shape))


@pytest.mark.parametrize("device,dtype,shape,max_iter,takes", [
    ("cuda", torch.float32, (512, 64, 64), 20, True),
    ("cuda", torch.float32, (512, 64, 64), 10, True),
    ("cuda", torch.float32, (1, 8, 8), 1, True),
    ("cuda", torch.float32, (5, 128, 128), 20, True),
    ("cuda", torch.float32, (5, 128, 128), 0, True),
    ("cuda", torch.float32, (4, 256, 256), 20, False),     # S > 128
    ("cuda", torch.float32, (4, 129, 129), 20, False),
    ("cuda", torch.float32, (4, 64, 80), 20, False),       # rectangular
    ("cuda", torch.float32, (0, 64, 64), 20, False),       # empty batch
    ("cuda", torch.float32, (4, 0, 0), 20, False),
    ("cuda", torch.float32, (64, 64), 20, False),          # not batched
    ("cuda", torch.float64, (4, 64, 64), 20, False),
    ("cuda", torch.bfloat16, (4, 64, 64), 20, False),
    ("cuda", torch.float32, (4, 128, 128), 200, False),    # normalizers
    ("cpu", torch.float32, (512, 64, 64), 20, False),
    ("cpu", torch.float32, (4, 8, 8), 5, False),
])
def test_dispatch_rule(device, dtype, shape, max_iter, takes):
    assert k_sk.takes_kernel(probe(device, dtype, shape), max_iter) is takes


@pytest.mark.parametrize("S,max_iter,threads,vals,smem_fwd,smem_bwd", [
    (8, 5, 32, 1, 288, 736),
    (64, 20, 256, 2, 16640, 38400),
    (64, 10, 256, 2, 16640, 35840),
    (65, 20, 288, 4, 17160, 39520),
    (100, 20, 416, 4, 40400, 88800),
    (128, 20, 512, 4, 66048, 142336),
    (128, 185, 512, 4, 66048, 226816),
])
def test_geometry(S, max_iter, threads, vals, smem_fwd, smem_bwd):
    g = k_sk.sinkhorn_geometry(7, S, max_iter)
    assert (g.threads, g.vals, g.smem_fwd, g.smem_bwd) == (
        threads, vals, smem_fwd, smem_bwd)
    assert g.smem_bwd <= k_sk.SMEM_LIMIT


@pytest.mark.parametrize("shape", [(3, 8, 8), (3, 8, 12), (2, 130, 130)])
def test_plain_calls_launch_nothing(shape):
    """CPU, rectangular and S > 128 calls (all CPU here) run the plain ops:
    PLAIN_CALLS rises by one a call, the kernels' counts stay, and the
    result is the plain function's."""
    g = torch.Generator().manual_seed(3)
    s = torch.randn(shape, generator=g)
    n1 = torch.tensor([shape[1], 1, 0][:shape[0]])
    n2 = torch.tensor([shape[2] - 1, shape[2], 2][:shape[0]])
    launches = dict(k_sk.LAUNCHES)
    before = t_sk.PLAIN_CALLS["sinkhorn_plain"]
    got = t_sk.sinkhorn_batch(s, n1, n2, tau=0.05, max_iter=7)
    assert t_sk.PLAIN_CALLS["sinkhorn_plain"] == before + 1
    assert k_sk.LAUNCHES == launches
    assert torch.equal(got, t_sk.sinkhorn_batch_plain(s, n1, n2, tau=0.05,
                                                      max_iter=7))


@pytest.mark.parametrize("shape", [(3, 8, 8), (3, 8, 12)])
def test_kernel_refuses_what_the_rule_does_not_take(shape):
    """Called directly, the kernels' wrapper raises on a tensor the rule
    sends to the plain ops (here: every CPU tensor) and launches nothing."""
    launches = dict(k_sk.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA float32"):
        k_sk.sinkhorn_kernel(torch.zeros(shape), torch.tensor([1, 2, 3]),
                             torch.tensor([3, 2, 1]), max_iter=4)
    assert k_sk.LAUNCHES == launches


# ------------------------------------------------------------ on the card

def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernels have no interpret mode")
    return torch.device("cuda")


def counts_for(S):
    """(n1, n2) of one batch: empty sides, single rows and columns, full
    buckets, both orientations and square samples."""
    half = max(S // 2, 1)
    return [(0, 0), (0, S), (S, 0), (1, 1), (1, S), (S, 1), (S, S),
            (half, S), (S, half), (half, half), (S - 1, half + 1),
            (half + 1, S - 1)]


@pytest.mark.gpu
@pytest.mark.parametrize("S", [8, 64, 128])
@pytest.mark.parametrize("dummy_row", [True, False])
@pytest.mark.parametrize("max_iter", [5, 10, 20])
@pytest.mark.parametrize("tau", [0.01, 1.0])
@pytest.mark.parametrize("layout", ["contiguous", "strided"])
def test_kernel_against_plain_on_the_card(S, dummy_row, max_iter, tau,
                                          layout):
    """Forward and gradient of `sinkhorn_batch` on the kernels against the
    plain ops in float64 on the same inputs, and no further from them than
    the plain float32 run by the module's tolerances. "strided": the scores
    a channel of a (B, S, S, 2) tensor and the counts int32 columns of a
    (B, 2) one, as the model hands them over, read in place."""
    dev = card()
    pairs = counts_for(S)
    B = len(pairs)
    g = torch.Generator().manual_seed(S * 1000 + max_iter)
    s = torch.randn(B, S, S, generator=g, dtype=torch.float64)
    dy = torch.randn(B, S, S, generator=g, dtype=torch.float64)
    nn = torch.tensor(pairs, dtype=torch.int64)
    kw = dict(tau=tau, max_iter=max_iter, dummy_row=dummy_row)

    def run(fn, x, counts, channel=None):
        """fn's output and the gradient of its input: x itself, or channel
        `channel` of x's last axis (a strided view)."""
        x = x.clone().requires_grad_(True)
        xin = x if channel is None else x[..., channel]
        out = fn(xin, counts[:, 0], counts[:, 1], **kw)
        out.backward(dy.to(dev, x.dtype))
        grad = x.grad if channel is None else x.grad[..., channel]
        return out.detach().double(), grad.double()

    want = run(t_sk.sinkhorn_batch_plain, s.to(dev), nn.to(dev))
    plain32 = run(t_sk.sinkhorn_batch_plain, s.to(dev).float(), nn.to(dev))
    launches = dict(k_sk.LAUNCHES)
    plain_calls = dict(t_sk.PLAIN_CALLS)
    if layout == "strided":
        wide = torch.randn(B, S, S, 2, generator=g).to(dev)
        wide[..., 1] = s.float().to(dev)
        got = run(t_sk.sinkhorn_batch, wide, nn.to(dev, torch.int32), 1)
    else:
        got = run(t_sk.sinkhorn_batch, s.float().to(dev), nn.to(dev))
    torch.cuda.synchronize()
    assert k_sk.LAUNCHES == {"sinkhorn_fwd": launches["sinkhorn_fwd"] + 1,
                             "sinkhorn_bwd": launches["sinkhorn_bwd"] + 1}
    assert t_sk.PLAIN_CALLS == plain_calls
    scale = float(want[1].abs().max())
    for name, a, p, w, tol in (
            ("forward", got[0], plain32[0], want[0], 2e-5),
            ("gradient", got[1], plain32[1], want[1], 5e-5 * scale)):
        err = float((a - w).abs().max())
        err_plain = float((p - w).abs().max())
        assert torch.isfinite(a).all(), name
        assert err <= tol, (name, err, err_plain, tol)
    # zero outside each sample's valid block, in both
    valid = ((torch.arange(S)[None, :, None] < nn[:, 0, None, None])
             & (torch.arange(S)[None, None, :] < nn[:, 1, None, None]))
    for a in got:
        assert not a.cpu()[~valid].any()


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["no_grad", "grad", "remat"])
def test_kernel_launches_on_the_card(case):
    """One forward launch a call, one backward launch a backward; under
    `remat` (checkpoint) the backward recomputes the forward (two forward
    launches) and its gradient has the bits of the plain autograd run of
    the same kernels; two calls give the same bits."""
    dev = card()
    g = torch.Generator().manual_seed(11)
    B, S = 6, 64
    s = torch.randn(B, S, S, generator=g).to(dev)
    dy = torch.randn(B, S, S, generator=g).to(dev)
    n1 = torch.tensor([64, 40, 64, 1, 0, 50], device=dev)
    n2 = torch.tensor([40, 64, 64, 64, 3, 50], device=dev)
    fn = lambda x: t_sk.sinkhorn_batch(x, n1, n2, tau=0.01, max_iter=20)
    before = dict(k_sk.LAUNCHES)
    if case == "no_grad":
        with torch.no_grad():
            out, again = fn(s), fn(s)
        want = {"sinkhorn_fwd": 2, "sinkhorn_bwd": 0}
        assert torch.equal(out, again)
    else:
        x = s.clone().requires_grad_(True)
        out = remat(fn, x) if case == "remat" else fn(x)
        out.backward(dy)
        want = {"sinkhorn_fwd": 2 if case == "remat" else 1,
                "sinkhorn_bwd": 1}
        y = s.clone().requires_grad_(True)
        fn(y).backward(dy)         # one launch each way more
        want = {k: v + 1 for k, v in want.items()}
        assert torch.equal(x.grad, y.grad)
    torch.cuda.synchronize()
    assert {k: k_sk.LAUNCHES[k] - before[k] for k in before} == want
    assert np.isfinite(out.detach().cpu().numpy()).all()
