"""The PyTorch port's CasMTR-4c eval forward against the JAX package's, end
to end on the CPU with the same weights: the tiny 4c configuration (full
wiring, Twins backbone at its smallest preset) with match thresholds at 0,
so every stage yields matches.  Then the port's ``Matcher`` against the JAX
``Matcher`` on three requests, one of them padded (mask on the path) and
one resized and padded.

Tolerances: the match sets are equal; keypoints within 1e-3 px and
confidences within 1e-4 (float32 through a deep stack, summed in another
order by XLA-CPU and ATen)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tests.torch_parity import (configs, jitter, port_variables,  # noqa: E402
                                tiny_4c_overrides)

PX_ATOL = 1e-3
CONF_ATOL = 1e-4


def _images(rng, B, h, w):
    """A smooth texture and a shifted copy, so matches are meaningful."""
    yy, xx = np.mgrid[0:h + 8, 0:w + 8].astype(np.float32)
    base = []
    for _ in range(B):
        f = rng.uniform(0.05, 0.3, (3, 2))
        img = np.stack([0.5 + 0.5 * np.sin(f[c, 0] * yy + f[c, 1] * xx
                                           + rng.uniform(0, 6))
                        for c in range(3)], -1)
        base.append(img)
    base = np.stack(base).astype(np.float32)
    return base[:, :h, :w], base[:, 5:h + 5, 3:w + 3]


def _by_pair(m):
    v = np.asarray(m["valid"])
    keys = [(int(b), int(i), int(j)) for b, i, j in
            zip(np.asarray(m["b_ids"])[v], np.asarray(m["i_ids"])[v],
                np.asarray(m["j_ids"])[v])]
    order = sorted(range(len(keys)), key=keys.__getitem__)
    return [keys[k] for k in order], {
        name: np.asarray(m[name])[v][order]
        for name in ("mconf", "mkpts0", "mkpts1", "expec_f") if name in m}


def _assert_same_matches(got, want):
    keys_g, vals_g = _by_pair(got)
    keys_w, vals_w = _by_pair(want)
    assert len(keys_w) > 0
    assert keys_g == keys_w
    np.testing.assert_allclose(vals_g["mconf"], vals_w["mconf"], rtol=0,
                               atol=CONF_ATOL)
    for name in ("mkpts0", "mkpts1"):
        np.testing.assert_allclose(vals_g[name], vals_w[name], rtol=0,
                                   atol=PX_ATOL)
    if "expec_f" in vals_w:  # normalized sub-pixel offset and its std
        np.testing.assert_allclose(vals_g["expec_f"], vals_w["expec_f"],
                                   rtol=0, atol=CONF_ATOL)


def _fields(m):
    return {name: np.asarray(getattr(m, name)) for name in
            ("b_ids", "i_ids", "j_ids", "valid", "mconf", "mkpts0", "mkpts1")}


def test_casmtr_4c_eval_forward_matches_jax():
    from casmtr_tpu.models.casmtr import CasMTR as JaxCasMTR
    from casmtr_tpu_torch.models.casmtr import CasMTR
    from casmtr_tpu_torch.weights import load_jax_variables
    jcfg, tcfg = configs(tiny_4c_overrides(zero_thresholds=True))
    img0, img1 = _images(np.random.default_rng(0), 2, 128, 128)
    batch = {"image0": jnp.asarray(img0), "image1": jnp.asarray(img1)}
    jm = JaxCasMTR(jcfg.loftr)
    model = CasMTR(tcfg.loftr)
    variables = port_variables(model, lambda: jm.init(
        jax.random.PRNGKey(0), batch, train=False))
    out = jax.jit(lambda v, b: jm.apply(v, b, train=False))(variables, batch)

    load_jax_variables(model, variables)
    model.eval()
    with torch.inference_mode():
        got = model({"image0": torch.from_numpy(img0),
                     "image1": torch.from_numpy(img1)})

    want_c, got_c = _fields(out.coarse.matches), _fields(got.coarse.matches)
    assert got_c["valid"].sum() > 0
    _assert_same_matches(got_c, want_c)
    want_f, got_f = _fields(out.final_matches), _fields(got.final_matches)
    want_f["expec_f"] = np.asarray(out.fine.expec_f)
    got_f["expec_f"] = got.fine.expec_f.numpy()
    assert got_f["valid"].sum() > 0
    _assert_same_matches(got_f, want_f)


def test_matcher_answers_like_jax_matcher():
    """Three requests through both Matchers with the same weights: a square
    image pair, a 128x64 pair that the 128 bucket pads (masks on the path),
    and a 100x150 pair that both resize to 64x128 (the JAX Matcher with
    cv2.resize, the port with its host library) before padding.  The
    canvases each Matcher feeds its model agree within 1e-6 (masks and
    scales exactly).  At this bucket torch's bilinear resize, which the
    port took before, also comes within 1.2e-7 of cv2.resize (its error
    grows with the output's size): tests/test_torch_data.py holds the
    resize against cv2 at serving sizes."""
    from casmtr_tpu.serving import Matcher as JaxMatcher
    from casmtr_tpu_torch.serving import Matcher
    from casmtr_tpu_torch.weights import load_jax_variables
    ov = tiny_4c_overrides(zero_thresholds=True)
    jmatch = JaxMatcher("outdoor_casmtr_4c", bucket=128, df=32, thr=0.0,
                        overrides=ov)
    jmatch.variables = jitter(jmatch.variables)
    tmatch = Matcher("outdoor_casmtr_4c", bucket=128, df=32, thr=0.0,
                     overrides=ov, device="cpu")
    load_jax_variables(tmatch.model, jmatch.variables)

    rng = np.random.default_rng(1)
    a0, a1 = _images(rng, 1, 128, 128)
    b0, b1 = _images(rng, 1, 128, 64)
    c0, c1 = _images(rng, 1, 100, 150)
    for img0, img1 in ((a0[0], a1[0]), (b0[0], b1[0]), (c0[0], c1[0])):
        for img in (img0, img1):
            got_in, want_in = tmatch._preprocess(img), jmatch._preprocess(img)
            np.testing.assert_allclose(got_in[0], want_in[0], rtol=0,
                                       atol=1e-6)
            np.testing.assert_array_equal(got_in[1], want_in[1])
            np.testing.assert_array_equal(got_in[2], want_in[2])
        want = jmatch.match(img0, img1)
        got = tmatch.match(img0, img1)
        assert len(want.mconf) > 0
        assert len(got.mconf) == len(want.mconf)
        og = np.lexsort(got.mkpts0.T)
        ow = np.lexsort(want.mkpts0.T)
        np.testing.assert_allclose(got.mkpts0[og], want.mkpts0[ow], rtol=0,
                                   atol=PX_ATOL)
        np.testing.assert_allclose(got.mkpts1[og], want.mkpts1[ow], rtol=0,
                                   atol=PX_ATOL)
        np.testing.assert_allclose(got.mconf[og], want.mconf[ow], rtol=0,
                                   atol=CONF_ATOL)
