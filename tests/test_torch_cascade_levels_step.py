"""One training step of the tiny 2c model at ``cascade_levels`` (4, 4) in
the port against the JAX package's step, on the CPU from the same jittered
weights and batch (64^2).

The stages run by position: the 1/4 stage reads gt_idx_4c and the 1/2
stage gt_idx_2c, while the step supplies gt_idx_4c twice over, so the 1/2
stage trains without ground truth and adds no loss term (no loss_2c), and
the fine ground truth is read at the 1/4 grid (the last value's) with the
1/2 stage's match indices clamped to its end, as the JAX package's gather
clamps them.  fine_correct_thr is FINE_CORRECT_THR
(test_torch_cascade_levels.py): the rows that feed loss_f are then 7 of
those whose index is clamped, and loss_f is above 0 in both packages (at
the recipe's 1.0 no row of the tiny random model is correct here, loss_f
is 0 and any index rule would pass).  The same loss keys, each term within 1e-5
relative, per-leaf gradients within 1e-4 relative (test_torch_train.py's
rule, the JAX
gradients read from the step's own trace by ``step_gradients``), BatchNorm
statistics within 1e-5."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from tests.test_torch_2c import _step_overrides  # noqa: E402
from tests.test_torch_cascade_levels import FINE_CORRECT_THR  # noqa: E402
from tests.test_torch_train import (_leaves, _pair_batch,  # noqa: E402
                                    jax_step, step_variables, torch_step)
from tests.torch_parity import configs  # noqa: E402

RECIPE = "outdoor_casmtr_2c"
STEP_LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4
BN_ATOL = 1e-5
SIZE = 64


@pytest.fixture(scope="module")
def step_run():
    ov = _step_overrides()
    ov["loftr"]["cascade_levels"] = [4, 4]
    ov["loftr"]["loss"] = {"fine_correct_thr": FINE_CORRECT_THR}
    jcfg, tcfg = configs(ov, RECIPE)
    batch = _pair_batch(size=SIZE)
    jm, like, variables = step_variables(jcfg, tcfg, batch)
    jscalars, jgrads, jstats = jax_step(jm, jcfg, variables, batch)
    tscalars, tgrads, tstats = torch_step(tcfg, variables, like, batch)
    return dict(jscalars=jscalars, jgrads=jgrads, jstats=jstats,
                tscalars=tscalars, tgrads=tgrads, tstats=tstats,
                start=variables)


def test_step_loss_terms_match_jax(step_run):
    js, ts = step_run["jscalars"], step_run["tscalars"]
    assert set(ts) == set(js) == {"loss", "loss_8c", "loss_4c", "loss_f",
                                  "valid_n_4c", "valid_n_2c", "grad_norm"}
    for k in ("loss", "loss_8c", "loss_4c", "loss_f", "grad_norm"):
        np.testing.assert_allclose(float(ts[k]), float(js[k]),
                                   rtol=STEP_LOSS_RTOL, err_msg=k)
    for name in ("4c", "2c"):
        assert int(ts[f"valid_n_{name}"]) == int(js[f"valid_n_{name}"]) > 0
    assert float(ts["loss_4c"]) > 0
    assert float(js["loss_f"]) > 0 and float(ts["loss_f"]) > 0


def test_step_gradients_match_jax(step_run):
    """Per leaf, ||g_port - g_jax|| <= 1e-4 ||g_jax||, the leaf norm floored
    at 1e-3 of the whole gradient's (test_torch_train.py)."""
    want = _leaves(step_run["jgrads"])
    got = _leaves(step_run["tgrads"])
    assert got.keys() == want.keys()
    assert any("loftr_coarse_2c" in k for k in want)
    total = float(np.sqrt(sum(float((w ** 2).sum()) for w in want.values())))
    for k, w in want.items():
        assert np.isfinite(got[k]).all(), k
        scale = max(float(np.linalg.norm(w)), 1e-3 * total)
        err = float(np.linalg.norm(got[k] - w))
        assert err <= GRAD_RTOL * scale, f"{k}: relative error {err / scale}"


def test_step_batch_stats_match_jax(step_run):
    want = _leaves(step_run["jstats"])
    got = _leaves(step_run["tstats"])
    start = _leaves(step_run["start"]["batch_stats"])
    assert got.keys() == want.keys()
    assert any("up_block2" in k for k in want)
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=0, atol=BN_ATOL,
                                   err_msg=k)
        assert not np.array_equal(w, start[k]), f"{k} did not move"
