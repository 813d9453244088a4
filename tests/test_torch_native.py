"""The port's host-native library (`fpmatch_tpu_torch.native`: LAPJV and
fixed-box NMS in C++, built with g++ into build/) and `ops.hungarian` on the
CPU, against the JAX package's native library, scipy and the numpy NMS on the
same inputs from a seed. LAPJV masks and NMS indices must be identical; the
assignment's objective equals scipy's to float32 rounding (1e-5 relative).
A build that cannot succeed raises."""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from scipy.optimize import linear_sum_assignment

from fpmatch_tpu import native as j_native
from fpmatch_tpu.ops.hungarian import hungarian_host as j_hungarian_host
from fpmatch_tpu.poredet.inference import nms_boxes as j_nms_boxes
from fpmatch_tpu_torch import native
from fpmatch_tpu_torch.ops import hungarian as t_hungarian
from fpmatch_tpu_torch.poredet.inference import nms_boxes

REPO = Path(__file__).resolve().parents[1]


def _lap_case(seed, B, S1, S2, ties=False):
    rng = np.random.default_rng(seed)
    scores = rng.normal(size=(B, S1, S2)).astype(np.float32)
    if ties:
        scores = np.round(scores, 1)
    n1 = rng.integers(0, S1 + 1, size=B)
    n2 = rng.integers(0, S2 + 1, size=B)
    n1[0], n2[0] = S1, S2                   # one full block
    if B > 2:
        n1[1] = 0                           # one empty block
    return scores, n1, n2


@pytest.mark.parametrize("seed,B,S1,S2,ties", [
    (0, 6, 12, 12, False),                  # square buckets, ragged blocks
    (1, 5, 9, 14, False),                   # rectangular buckets
    (2, 5, 14, 9, True),                    # ties
    (3, 3, 60, 60, False),
    (4, 1, 0, 0, False),                    # n = 0
])
def test_lapjv_masks_identical_to_jax_native(seed, B, S1, S2, ties):
    scores, n1, n2 = _lap_case(seed, B, S1, S2, ties)
    got = native.lap_maximize_batch(scores, n1, n2)
    want = j_native.lap_maximize_batch(scores, n1, n2)
    assert got.dtype == np.float32 and got.shape == scores.shape
    assert np.array_equal(got, want)
    for b in range(B):
        a, c = int(n1[b]), int(n2[b])
        assert got[b].sum() == min(a, c)
        assert got[b, a:].sum() == 0 and got[b, :, c:].sum() == 0
        assert (got[b].sum(0) <= 1).all() and (got[b].sum(1) <= 1).all()
        if a and c:
            r, col = linear_sum_assignment(-scores[b, :a, :c])
            np.testing.assert_allclose((got[b] * scores[b]).sum(),
                                       scores[b, :a, :c][r, col].sum(),
                                       rtol=1e-5, atol=1e-5)


def test_lapjv_input_checks():
    s = np.zeros((2, 4, 4), np.float32)
    with pytest.raises(ValueError):
        native.lap_maximize_batch(s[0], [4], [4])           # not batched
    with pytest.raises(ValueError):
        native.lap_maximize_batch(s, [4, 5], [4, 4])        # n1 > S1
    with pytest.raises(ValueError):
        native.lap_maximize_batch(s, [4], [4])              # one n per block


@pytest.mark.parametrize("seed,m,ties", [(0, 200, False), (1, 300, True),
                                         (2, 1, False), (3, 0, False)])
def test_nms_identical_to_jax_native_and_numpy(seed, m, ties):
    rng = np.random.default_rng(seed)
    coords = rng.integers(0, 100, size=(m, 2)).astype(np.int32)
    scores = rng.uniform(size=m).astype(np.float32)
    if ties:
        scores = np.round(scores, 1)
    for box, iou in ((17, 0.2), (9, 0.5)):
        got = native.nms_fixed_boxes(coords, scores, box, iou)
        assert np.array_equal(got, j_native.nms_fixed_boxes(coords, scores,
                                                             box, iou))
        if not ties:     # tie order is std::sort's in C++, stable in numpy
            assert np.array_equal(got, nms_boxes(coords, scores, box, iou))
            assert np.array_equal(got, j_nms_boxes(coords, scores, box,
                                                   iou))


def test_hungarian_host_and_tensor_version_match_jax():
    scores, n1, n2 = _lap_case(5, 4, 10, 13)
    want = j_hungarian_host(scores, n1, n2)
    assert np.array_equal(t_hungarian.hungarian_host(scores, n1, n2), want)
    got = t_hungarian.hungarian(torch.from_numpy(scores),
                                torch.from_numpy(n1), torch.from_numpy(n2))
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    assert np.array_equal(got.numpy(), want)
    # 2-D scores: the host version keeps a batch axis (as JAX's does), the
    # tensor version returns the scores' shape
    two_d = t_hungarian.hungarian_host(scores[0], n1[0], n2[0])
    assert two_d.shape == (1, 10, 13)
    assert np.array_equal(two_d, j_hungarian_host(scores[0], n1[0], n2[0]))
    one = t_hungarian.hungarian(torch.from_numpy(scores[0]),
                                torch.tensor(n1[0]), torch.tensor(n2[0]))
    assert one.shape == (10, 13) and torch.equal(one, got[0])


def test_batched_solve_after_torch_threaded_ops():
    """torch's wheel ships its own libgomp; a batched OpenMP solve in a
    process where torch has run threaded ops must finish and be right."""
    code = (
        "import numpy as np, torch\n"
        "torch.set_num_threads(4)\n"
        "x = torch.randn(256, 256)\n"
        "for _ in range(20): x = torch.tanh(x @ x)\n"
        "from fpmatch_tpu_torch import native\n"
        "rng = np.random.default_rng(0)\n"
        "s = rng.normal(size=(32, 80, 80)).astype(np.float32)\n"
        "n = np.full(32, 80)\n"
        "out = native.lap_maximize_batch(s, n, n)\n"
        "y = torch.randn(256, 256) @ torch.randn(256, 256)\n"
        "assert (out.sum(axis=(1, 2)) == 80).all()\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="4")
    r = subprocess.run([sys.executable, "-c", code], cwd=str(REPO), env=env,
                       capture_output=True, text=True, timeout=240)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr


def test_library_is_keyed_by_source_flags_and_machine(monkeypatch):
    path = native.library_path()
    assert path.parent == REPO / "build" / "fpmatch_tpu_torch"
    assert native.build() == path and path.exists()
    with monkeypatch.context() as m:
        m.setattr(native, "CXX_FLAGS", native.CXX_FLAGS + ["-g"])
        assert native.library_path() != path
    with monkeypatch.context() as m:                 # another host CPU
        m.setattr(native, "_native_target", lambda cxx: "-march=other")
        assert native.library_path() != path
    assert native.library_path() == path


def test_a_build_that_fails_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "CXX", str(tmp_path / "no-such-g++"))
    with pytest.raises(RuntimeError, match="not found"):
        native.build()
    monkeypatch.undo()
    bad = tmp_path / "lapjv.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    with pytest.raises(RuntimeError, match="native build failed"):
        native.build()
