"""The port's one-process training step on a batch of two pairs against the
JAX package's step on the same batch, at tests/test_torch_train.py's
tolerances (loss terms 1e-5 relative, per-leaf gradients 1e-4 relative,
BatchNorm statistics 1e-5).

At batch 2 the samples of a step couple: BatchNorm takes its statistics
over both, the 1/8 and 1/4 selections are one top-M over the flattened
batch (the 1/4 level's capacity of 16 shared by the two pairs), and the
losses divide by the batch's counts.  The two pairs are shifted by
different amounts, so each holds ground-truth matches and both take part
in every coupling; the picks per sample are printed.  This is the step
that the data-parallel step at world 2 (tests/test_torch_distributed.py)
equals, and so what makes that one equal the JAX step."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from tests.test_torch_train import (BN_ATOL, GRAD_RTOL,  # noqa: E402
                                    STEP_LOSS_RTOL, _leaves, _pair_batch,
                                    _step_overrides, jax_step,
                                    step_variables, torch_step)
from tests.torch_parity import configs  # noqa: E402


def pair_batch2():
    """Two shifted pairs (image1 = image0 moved 8 and 4 pixels), as one
    batch of numpy arrays."""
    a, b = _pair_batch(seed=0, shift=8), _pair_batch(seed=1, shift=4)
    return {k: np.concatenate([a[k], b[k]]) for k in a}


@pytest.fixture(scope="module")
def runs():
    from casmtr_tpu_torch.models import casmtr as model_mod
    jcfg, tcfg = configs(_step_overrides())
    batch = pair_batch2()
    jm, like, variables = step_variables(jcfg, tcfg, batch)
    picks = {}

    def recording(name, fn):
        def wrapped(*a, **kw):
            out = fn(*a, **kw)
            m = out if hasattr(out, "b_ids") else out[0]
            picks[name] = np.bincount(m.b_ids[m.valid].numpy(),
                                      minlength=2).tolist()
            return out
        return wrapped

    cm, matching = model_mod.cm, model_mod.matching
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(matching, "extract_coarse_matches", recording(
            "8c", matching.extract_coarse_matches))
        mp.setattr(cm, "extract_cascade_matches", recording(
            "4c", cm.extract_cascade_matches))
        port = torch_step(tcfg, variables, like, batch)
    print(f"picks per sample: {picks}")
    jax_run = jax_step(jm, jcfg, variables, batch, two_pass_bn=True)
    return {"jax": jax_run, "port": port, "picks": picks,
            "m_cap": tcfg.loftr.match_cascade.train_pad_num_gt_min[0]}


def test_batch2_shares_the_selection_across_samples(runs):
    """Both pairs hold 1/4 picks, and together they fill the one
    capacity: the selection couples them."""
    p4 = runs["picks"]["4c"]
    assert min(p4) > 0 and sum(p4) == runs["m_cap"], p4


def test_batch2_step_loss_matches_jax(runs):
    (js, _, _), (ts, _, _) = runs["jax"], runs["port"]
    assert set(ts) == set(js)
    for k in ("loss", "loss_8c", "loss_4c", "loss_f", "grad_norm"):
        np.testing.assert_allclose(float(ts[k]), float(js[k]),
                                   rtol=STEP_LOSS_RTOL, err_msg=k)
    assert int(ts["valid_n_4c"]) == int(js["valid_n_4c"]) == runs["m_cap"]


def test_batch2_step_gradients_match_jax(runs):
    """Per leaf, as tests/test_torch_train.test_train_step_gradients_
    match_jax: the norm floored at 1e-3 of the whole gradient's."""
    want = _leaves(runs["jax"][1])
    got = _leaves(runs["port"][1])
    assert got.keys() == want.keys()
    total = float(np.sqrt(sum(float((w ** 2).sum())
                              for w in want.values())))
    for k, w in want.items():
        scale = max(float(np.linalg.norm(w)), 1e-3 * total)
        err = float(np.linalg.norm(got[k] - w))
        assert err <= GRAD_RTOL * scale, f"{k}: relative error {err / scale}"


def test_batch2_batch_stats_match_jax(runs):
    want = _leaves(runs["jax"][2])
    got = _leaves(runs["port"][2])
    assert got.keys() == want.keys()
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=0, atol=BN_ATOL,
                                   err_msg=k)

