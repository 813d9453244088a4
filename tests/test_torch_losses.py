"""The port's library losses (`fpmatch_tpu_torch.train.losses`) and
Gumbel-Sinkhorn (`ops.sinkhorn.gumbel_sinkhorn`) against the JAX package's
on the CPU, on the same numpy inputs: every loss and its gradients with
respect to its differentiable inputs within 1e-6; Gumbel-Sinkhorn fed JAX's
own uniform draws within 1e-5.

The batches mix orientations (n1 < n2, n1 > n2, n1 == n2) with padding
outside the valid blocks; predictions hold exact 0 and 1 cells, which the
EPS clip must keep finite.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fpmatch_tpu.ops import sinkhorn as j_sk
from fpmatch_tpu.train import losses as jl
from fpmatch_tpu_torch.ops import sinkhorn as t_sk
from fpmatch_tpu_torch.train import losses as tl
from test_torch_utils import t2n

TOL = dict(rtol=1e-6, atol=1e-6)
NS1 = np.array([4, 7, 6], np.int32)
NS2 = np.array([6, 5, 6], np.int32)
S = 8


def _perm_inputs(seed):
    rng = np.random.default_rng(seed)
    pred = rng.uniform(size=(3, S, S)).astype(np.float32)
    pred[0, 0, 0], pred[1, 1, 1] = 1.0, 0.0          # the clip's two ends
    gt = np.zeros((3, S, S), np.float32)
    for b in range(3):
        k = min(NS1[b], NS2[b]) - 1                    # one unmatched row
        cols = rng.permutation(NS2[b])[:k]
        gt[b, np.arange(k), cols] = 1.0
    hard = (rng.uniform(size=(3, S, S)) < 0.15).astype(np.float32)
    return pred, gt, hard


def _check(jfn, tfn, args, grad_argnums):
    """Value and the gradients w.r.t. `grad_argnums` of JAX's `jfn` and the
    port's `tfn` on the same numpy `args`."""
    want, wgrads = jax.jit(jax.value_and_grad(jfn, argnums=grad_argnums))(
        *[jnp.asarray(a) for a in args])
    targs = [torch.tensor(a, requires_grad=i in grad_argnums
                          and a.dtype == np.float32)
             for i, a in enumerate(args)]
    got = tfn(*targs)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), **TOL)
    assert np.isfinite(float(got.detach()))
    for i, g in zip(grad_argnums, wgrads):
        # a detached input gets no gradient: JAX's stop_gradient gives zeros
        tg = targs[i].grad
        tg = torch.zeros_like(targs[i]) if tg is None else tg
        np.testing.assert_allclose(t2n(tg), np.asarray(g), **TOL)


@pytest.mark.parametrize("name", ["permutation_loss", "cross_entropy_loss",
                                  "focal_loss", "inner_product_loss",
                                  "hamming_loss"])
def test_permutation_family_and_gradients(name):
    pred, gt, _ = _perm_inputs(1)
    j, t = getattr(jl, name), getattr(tl, name)
    _check(j, t, (pred, gt, NS1, NS2), (0, 1))
    if name == "focal_loss":                    # and its non-default form
        pred, gt, _ = _perm_inputs(2)
        kw = dict(gamma=2.0, alpha=0.25)
        _check(lambda p, g, a, b: j(p, g, a, b, **kw),
               lambda p, g, a, b: t(p, g, a, b, **kw),
               (pred, gt, NS1, NS2), (0, 1))


def test_permutation_loss_hung_stops_the_gradient_of_the_prediction():
    pred, gt, hard = _perm_inputs(3)
    _check(jl.permutation_loss_hung, tl.permutation_loss_hung,
           (pred, hard, gt, NS1, NS2), (0, 1, 2))


def test_offset_loss():
    rng = np.random.default_rng(4)
    p = rng.normal(size=(3, 9, 2)).astype(np.float32) * 20
    q = p + rng.normal(size=p.shape).astype(np.float32)
    r = q.copy()
    r[0, 1] = q[0, 1]                     # a zero displacement: sqrt(1e-12)
    r[:, 2:] += rng.normal(size=r[:, 2:].shape).astype(np.float32)
    ns = np.array([5, 9, 0], np.int32)
    for norm in (1.0, 16.0):
        _check(lambda a, b, c, n: jl.offset_loss(a, b, c, n, norm=norm),
               lambda a, b, c, n: tl.offset_loss(a, b, c, n, norm=norm),
               (p, q, r, ns), (1, 2))


def test_bce_with_logits():
    rng = np.random.default_rng(5)
    logits = (rng.normal(size=(17,)) * 30).astype(np.float32)
    labels = (rng.uniform(size=(17,)) < 0.5).astype(np.float32)
    _check(jl.bce_with_logits, tl.bce_with_logits, (logits, labels), (0, 1))


def test_distill_infonce():
    """No valid node, some, all."""
    rng = np.random.default_rng(6)
    fs = rng.normal(size=(9, 12)).astype(np.float32)
    ft = (fs + 0.3 * rng.normal(size=fs.shape)).astype(np.float32)
    for ns in (0, 5, 9):
        _check(jl.distill_infonce, tl.distill_infonce,
               (fs, ft, np.int32(ns)), (0, 1))


def test_distill_quadratic_contrast_detaches_the_teacher():
    rng = np.random.default_rng(7)
    s = rng.normal(size=(3, S, S)).astype(np.float32)
    t = rng.normal(size=(3, S, S)).astype(np.float32)
    _check(jl.distill_quadratic_contrast, tl.distill_quadratic_contrast,
           (s, t, NS1, NS2), (0, 1))


def test_gumbel_sinkhorn_on_jax_draws():
    """JAX's noise cannot be drawn in torch: its uniforms, drawn as
    `gumbel_sinkhorn` draws them (split key, one uniform per sample), go to
    the port as `u`; the samples agree within 1e-5 (n1 < n2, n1 > n2, and
    square without the dummy band). Without `u` the port draws from a
    seeded generator: reproducible, in [0, 1], zero outside the valid
    block."""
    rng = np.random.default_rng(8)
    s = rng.normal(size=(S, S)).astype(np.float32)
    key = jax.random.PRNGKey(3)
    u = np.stack([np.asarray(jax.random.uniform(k, s.shape, minval=1e-20,
                                                maxval=1.0))
                  for k in jax.random.split(key, 4)])
    for n1, n2, dummy_row in ((5, 7, True), (7, 4, True), (6, 6, False)):
        want = np.asarray(j_sk.gumbel_sinkhorn(
            key, jnp.asarray(s), n1, n2, tau=0.5, max_iter=10,
            sample_num=4, dummy_row=dummy_row))
        got = t2n(t_sk.gumbel_sinkhorn(torch.from_numpy(s), n1, n2, tau=0.5,
                                       max_iter=10, sample_num=4,
                                       dummy_row=dummy_row,
                                       u=torch.from_numpy(u)))
        assert got.shape == (4, S, S)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
        draw = lambda: t2n(t_sk.gumbel_sinkhorn(
            torch.from_numpy(s), n1, n2, tau=0.5, sample_num=3,
            dummy_row=dummy_row, generator=torch.Generator().manual_seed(0)))
        a, b = draw(), draw()
        assert np.array_equal(a, b) and np.isfinite(a).all()
        assert not np.allclose(a[0], a[1])
        assert (a >= 0).all() and (a <= 1 + 1e-6).all()
        assert (a[:, n1:] == 0).all() and (a[:, :, n2:] == 0).all()
