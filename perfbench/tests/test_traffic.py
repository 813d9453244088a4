"""The copied traffic generator against the program's, and the pool."""
import numpy as np
import pytest
import torch

from perfbench.traffic import generator


@pytest.mark.parametrize("seed", [0, 2 ** 31 + 5])
def test_bit_equal_to_the_programs_generator(seed):
    from fpmatch_tpu_torch.core.config import Config, ShapeConfig
    from fpmatch_tpu_torch.data.synthetic import synthetic_pair_batch

    cfg = Config(shapes=ShapeConfig(n_max=64, e_max=384))
    theirs = synthetic_pair_batch(cfg, 3, genuine_ratio=0.5,
                                  n_range=(40, 65), image_hw=(24, 32),
                                  seed=seed)
    ours = generator.synthetic_pair_batch(3, 64, 384, genuine_ratio=0.5,
                                          n_range=(40, 65),
                                          image_hw=(24, 32), seed=seed)
    for name in generator.FIELDS:
        np.testing.assert_array_equal(ours[name], getattr(theirs, name),
                                      err_msg=name)


def test_pool_is_a_function_of_the_seed():
    traffic = {"pool": 2, "n_max": 12, "e_max": 64, "n_range": [6, 12],
               "genuine_ratio": 0.5, "jitter": 1.5, "image_hw": [32, 48]}
    a = generator.make_pool(traffic, 3, 2 ** 33 + 1, "cpu")
    b = generator.make_pool(traffic, 3, 2 ** 33 + 1, "cpu")
    c = generator.make_pool(traffic, 3, 7, "cpu")
    for x, y in zip(a, b):
        for k in x:
            assert torch.equal(x[k], y[k]), k
    assert not torch.equal(a[0]["images"], c[0]["images"])
    assert not torch.equal(a[0]["images"], a[1]["images"])
    assert a[0]["images"].shape == (3, 2, 32, 48, 3)


@pytest.mark.parametrize("seed", [0, 2 ** 31 + 5])
def test_triangles_bit_equal_to_the_programs_generator(seed):
    """With `t_max`, every field, triangles included, is the program's
    with `ngm.hyperedge` on (its `t_max` large enough that it cuts none)."""
    from fpmatch_tpu_torch.core.config import Config, NGMConfig, ShapeConfig
    from fpmatch_tpu_torch.data.synthetic import synthetic_pair_batch

    cfg = Config(shapes=ShapeConfig(n_max=64, e_max=384, t_max=128),
                 ngm=NGMConfig(hyperedge=True))
    theirs = synthetic_pair_batch(cfg, 3, genuine_ratio=0.5,
                                  n_range=(40, 65), image_hw=(24, 32),
                                  seed=seed)
    ours = generator.synthetic_pair_batch(3, 64, 384, genuine_ratio=0.5,
                                          n_range=(40, 65),
                                          image_hw=(24, 32), seed=seed,
                                          t_max=128)
    assert ours["n_tris"].min() > 0
    for name in generator.FIELDS + ("tri", "n_tris"):
        np.testing.assert_array_equal(ours[name], getattr(theirs, name),
                                      err_msg=name)


def test_without_t_max_no_triangles_and_the_same_arrays():
    kw = dict(genuine_ratio=0.5, n_range=(6, 12), image_hw=(24, 32),
              seed=2 ** 33 + 3)
    plain = generator.synthetic_pair_batch(3, 12, 64, **kw)
    tri = generator.synthetic_pair_batch(3, 12, 64, t_max=24, **kw)
    assert set(plain) == set(generator.FIELDS)
    assert set(tri) == set(generator.FIELDS) | {"tri", "n_tris"}
    assert tri["tri"].shape == (3, 2, 24, 3) and tri["tri"].dtype == np.int32
    assert tri["n_tris"].shape == (3, 2) and tri["n_tris"].dtype == np.int32
    for name in generator.FIELDS:
        np.testing.assert_array_equal(plain[name], tri[name], err_msg=name)
    # padded slots are 0; the valid ones are the view's simplices
    for b in range(3):
        for v in range(2):
            t = int(tri["n_tris"][b, v])
            assert not tri["tri"][b, v, t:].any()
            P = tri["points"][b, v, :tri["n_nodes"][b, v]]
            np.testing.assert_array_equal(tri["tri"][b, v, :t],
                                          generator.delaunay_triangles(P))


def test_a_view_over_t_max_raises():
    with pytest.raises(ValueError, match="exceed t_max"):
        generator.synthetic_pair_batch(2, 12, 64, n_range=(10, 12), t_max=4,
                                       image_hw=(24, 32), seed=1)


def test_pool_brings_triangles_where_the_traffic_sets_t_max():
    traffic = {"pool": 2, "n_max": 12, "e_max": 64, "n_range": [6, 12],
               "genuine_ratio": 0.5, "jitter": 1.5, "image_hw": [32, 48]}
    plain = generator.make_pool(traffic, 3, 2 ** 33 + 1, "cpu")
    tri = generator.make_pool(dict(traffic, t_max=24), 3, 2 ** 33 + 1, "cpu")
    for x, y in zip(plain, tri):
        assert "tri" not in x and "n_tris" not in x
        assert y["tri"].shape == (3, 2, 24, 3) and y["n_tris"].shape == (3, 2)
        for k in x:
            assert torch.equal(x[k], y[k]), k
