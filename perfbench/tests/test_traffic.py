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
