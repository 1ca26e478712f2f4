"""Serving over replicas: the port's ``Matcher(devices=[...])`` against the
JAX package's ``Matcher(mesh=...)`` on the CPU, with the same weights
(``torch_parity.port_variables``):

* two replicas at B = 2 and B = 4 (B/n = 1 and 2: the capacity scale of
  each replica's forward and the offset of its ``b_ids``), pair for pair
  within mkpts 1e-4 px and mconf 1e-5;
* a configuration whose small ``max_matches`` saturates, where each
  replica's own top-(B/n * M) differs from the one-device top-(B * M):
  the port's replicas equal the JAX mesh, and differ from the one-device
  results as the JAX mesh does;
* B = 3 raises ValueError; ``warmup`` rounds each size up to a multiple
  of the replicas; ``device`` and ``devices`` together raise.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
jax = pytest.importorskip("jax")

from tests.torch_parity import fast_jit, port_variables  # noqa: E402
from tests.torch_parity import tiny_4c_overrides  # noqa: E402

RECIPE = "outdoor_casmtr_4c"
BUCKET = 64
PX_ATOL = 1e-4
CONF_ATOL = 1e-5
# the coarse and cascade capacities per pair: the cascade's is small
# enough that pairs saturate their share of the selection
MAX_MATCHES = (16, 6)


def _overrides(max_matches=None):
    """The tiny 4c with every threshold at 0, no border margin and no
    cycle check at 1/4, so that its random weights give several final
    matches per pair."""
    ov = tiny_4c_overrides(BUCKET, zero_thresholds=True)
    ov["loftr"]["match_cascade"].update(border_rm=[0], double_check=[False])
    if max_matches is not None:
        ov["loftr"]["match_coarse"]["max_matches"] = max_matches[0]
        ov["loftr"]["match_cascade"]["max_matches"] = [max_matches[1]]
    return ov


def _pairs(seed, n):
    """Textured pairs of different sizes, image1 a shifted crop of a
    blend of image0's texture, so the pairs' match counts differ."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        h, w = (BUCKET, BUCKET) if i % 2 == 0 else (48, 56)
        yy, xx = np.mgrid[0:h + 8, 0:w + 8].astype(np.float32)
        f = rng.uniform(0.05, 0.4, (3, 2))
        base = np.stack([0.5 + 0.25 * np.sin(f[c, 0] * xx + c)
                         * np.cos(f[c, 1] * yy) for c in range(3)], -1)
        base += rng.normal(0, 0.05 * (i + 1), base.shape)
        base = np.clip(base, 0, 1).astype(np.float32)
        dy, dx = rng.integers(0, 8, 2)
        out.append((base[:h, :w], base[dy:dy + h, dx:dx + w]))
    return out


def _matchers(ov):
    """(port one-device, port two replicas, JAX one-device, JAX mesh of 2)
    on the same weights.  The JAX Matchers are made without their
    constructor's compiled init: the weights are carried from the port's
    seeded initialization."""
    from casmtr_tpu.models import build_model as jax_build_model
    from casmtr_tpu.parallel.mesh import make_mesh
    from casmtr_tpu.serving import Matcher as JaxMatcher
    from casmtr_tpu_torch.serving import Matcher
    from casmtr_tpu_torch.weights import load_jax_variables
    one = Matcher(RECIPE, bucket=BUCKET, df=32, thr=0.0, overrides=ov,
                  device="cpu")
    reps = Matcher(RECIPE, bucket=BUCKET, df=32, thr=0.0, overrides=ov,
                   devices=["cpu", "cpu"])
    jmodel = jax_build_model(reps.cfg.loftr)
    zeros = np.zeros((1, BUCKET, BUCKET, 3), np.float32)
    variables = port_variables(one.model, lambda: jmodel.init(
        jax.random.PRNGKey(0), {"image0": zeros, "image1": zeros},
        train=False), seed=3)
    for m in (one, reps):
        load_jax_variables(m.model, variables)
        m.replicate()
    jax_matchers = []
    for mesh in (None, make_mesh(2)):
        jm = JaxMatcher.__new__(JaxMatcher)
        jm.__dict__.update(cfg=reps.cfg, bucket=BUCKET, df=32, thr=0.0,
                           _model=jmodel, _applies={}, mesh=mesh,
                           variables=variables)
        jax_matchers.append(jm)
    return (one, reps, *jax_matchers)


def _assert_same(got, want):
    assert len(got) == len(want)
    for b, (g, w) in enumerate(zip(got, want)):
        assert len(g.mconf) == len(w.mconf), b
        og, ow = np.lexsort(g.mkpts0.T), np.lexsort(w.mkpts0.T)
        for name, atol in (("mkpts0", PX_ATOL), ("mkpts1", PX_ATOL),
                           ("mconf", CONF_ATOL)):
            np.testing.assert_allclose(getattr(g, name)[og],
                                       getattr(w, name)[ow], rtol=0,
                                       atol=atol, err_msg=f"pair {b} {name}")


def _same_sets(a, b):
    return all(len(x.mconf) == len(y.mconf) and np.array_equal(
        x.mkpts0[np.lexsort(x.mkpts0.T)], y.mkpts0[np.lexsort(y.mkpts0.T)])
        for x, y in zip(a, b))


@pytest.fixture(scope="module")
def runs():
    """Every Matcher's results on the same four pairs: the replicas and
    the JAX mesh at B = 2 and 4, the one-device Matchers at B = 4."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax, "jit", fast_jit)
        one, reps, jone, jmesh = _matchers(_overrides(MAX_MATCHES))
        pairs = _pairs(2, 4)
        out = {"matchers": (one, reps)}
        for B in (2, 4):
            out["reps", B] = reps.match_batch(pairs[:B])
            out["mesh", B] = jmesh.match_batch(pairs[:B])
        out["one"] = one.match_batch(pairs)
        out["jax one"] = jone.match_batch(pairs)
        yield out


@pytest.mark.parametrize("B", [2, 4])
def test_replicas_equal_jax_mesh(runs, B):
    got = runs["reps", B]
    assert sum(len(r.mconf) for r in got) > 0
    _assert_same(got, runs["mesh", B])


def test_saturated_selection_is_per_replica(runs):
    """At these max_matches the pairs saturate their share: the JAX
    mesh's per-replica selection differs from its one-device selection,
    the port's replicas equal the mesh (above) and differ from the port's
    one device likewise, and the two one-device Matchers agree."""
    assert not _same_sets(runs["mesh", 4], runs["jax one"])
    assert not _same_sets(runs["reps", 4], runs["one"])
    _assert_same(runs["one"], runs["jax one"])


def test_replicas_refuse_and_warm_up(runs, monkeypatch):
    from casmtr_tpu_torch.serving import Matcher
    one, reps = runs["matchers"]
    with pytest.raises(ValueError, match="not divisible"):
        reps.match_batch(_pairs(1, 3))
    sizes = []
    monkeypatch.setattr(reps, "match_batch",
                        lambda pairs: sizes.append(len(pairs)))
    reps.warmup((1, 2, 3))
    assert sizes == [2, 2, 4]
    with pytest.raises(ValueError, match="not both"):
        Matcher(RECIPE, bucket=BUCKET, df=32, overrides=_overrides(),
                device="cpu", devices=["cpu"])
    assert one.devices is None
