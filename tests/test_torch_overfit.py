"""`python -m fpmatch_tpu_torch.cli.overfit --steps 3 --device cpu`
against the JAX package's `cli/overfit.py`: the same flags (plus
`--device`) and printed lines, and its first step: the same synthetic pair,
the same weights (a Flax init carried across), the first step's loss within
the train step's 1e-4 (test_torch_train), every loss finite. Both CLIs
build their model at test_torch_utils.tiny_jax_config's widths and sk_tau
0.05 here (the config class they read is replaced); `chip_smoke.py` runs
the port's at its defaults on the card.
"""
import dataclasses
import functools

import numpy as np

from fpmatch_tpu.cli import overfit as j_overfit
from fpmatch_tpu.core import config as j_config
from fpmatch_tpu.data.synthetic import synthetic_pair_batch as j_synth
from fpmatch_tpu.models import ngm as j_ngm
from fpmatch_tpu.models.ngm import NGMNet as JNet
from fpmatch_tpu.train import step as j_step
from fpmatch_tpu_torch.cli import overfit as t_overfit
from fpmatch_tpu_torch.convert import from_flax_variables
from fpmatch_tpu_torch.core import config as t_config
from fpmatch_tpu_torch.models import ngm as t_ngm
from test_torch_cli_match import _InitGiven
from test_torch_utils import (flax_init, np_tree, tiny_jax_config,
                              to_torch_config)


def _tiny_configs(monkeypatch):
    """Both CLIs' `Config(shapes=...)` at tiny widths and sk_tau 0.05."""
    jbase = tiny_jax_config(sk_tau=0.05)
    tbase = to_torch_config(jbase)
    monkeypatch.setattr(j_config, "Config", lambda shapes: dataclasses.replace(
        jbase, shapes=shapes))
    monkeypatch.setattr(t_config, "Config", lambda shapes: dataclasses.replace(
        tbase, shapes=shapes))


def test_cli_overfit_first_step_matches_jax_cli(monkeypatch, capsys):
    """The JAX CLI's flags and defaults (plus `--device`), its printed
    lines, and on the CPU its first step: the same pair and weights give the
    same loss within 1e-4; three steps give finite losses and an
    accuracy in [0, 1]."""
    ap = t_overfit.build_parser()
    assert vars(ap.parse_args([])) == {"steps": 100, "lr": 1e-4,
                                       "n_max": 32, "univ": 64, "seed": 0,
                                       "device": "cuda"}
    _tiny_configs(monkeypatch)
    cfg = j_config.Config(shapes=j_config.ShapeConfig(
        n_max=32, e_max=192, univ_size=64))
    batch = j_synth(cfg, batch_size=1, seed=0, n_range=(24, 30),
                    image_hw=(128, 160))
    v = np_tree(flax_init(JNet(cfg), batch, train=False))
    monkeypatch.setattr(j_ngm, "NGMNet", functools.partial(_InitGiven, v))
    j_losses = []
    real_step = j_step.make_train_step

    def recording(*a, **k):
        step = real_step(*a, **k)

        def run(state, b):
            state, metrics = step(state, b)
            j_losses.append(float(metrics["loss"]))
            return state, metrics
        return run

    monkeypatch.setattr(j_step, "make_train_step", recording)
    j_overfit.main(["--steps", "1"])
    j_out = capsys.readouterr().out

    real_build = t_ngm.build_model
    monkeypatch.setattr(t_ngm, "build_model", lambda c, **k: real_build(
        c, device=k["device"], state_dict=from_flax_variables(v, c)))
    losses, accs = [], []
    acc = t_overfit.main(["--steps", "3", "--device", "cpu"],
                         on_step=lambda i, m: (losses.append(
                             float(m["loss"])), accs.append(
                             float(m["accuracy"]))))
    t_out = capsys.readouterr().out.splitlines()
    assert len(j_losses) == 1 and len(losses) == 3
    assert abs(losses[0] - j_losses[0]) <= 1e-4 * abs(j_losses[0])
    assert np.isfinite(losses).all() and 0.0 <= acc <= 1.0
    assert acc == accs[-1]
    # the JAX CLI's lines: steps 0 and the last, then the final accuracy
    assert j_out.splitlines()[0].startswith("step 0: loss=")
    assert [ln.split(":")[0] for ln in t_out] == ["step 0", "step 2",
                                                  "final accuracy"]
