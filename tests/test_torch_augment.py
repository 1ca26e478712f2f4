"""The port's augmentations (``casmtr_tpu_torch.data.augment``) against
the JAX package's cv2-based ones on the CPU, one seed each side:

* ``DarkAug`` and ``MobileAug`` within 1e-6 (float32 images in [0, 1]; the
  blur and motion-blur branches taken on some seeds: the port's sums run
  in another order than OpenCV's, measured at most 1.8e-7);
* ``random_rotation``: ``K_new`` and the rotation matrix bit-equal, depth
  and mask (nearest) bit-equal, the image (bilinear) within 2e-5 (OpenCV
  5.0's warpAffine computes its coordinates in float32 with fused
  multiply-adds, and its row tails another way: measured at most 8.8e-6);
* the cv2 primitives alone: ``gaussian_blur`` at k 3, 5, 7 and
  ``filter2d`` at k 3-9 within 1e-6 (measured 1.2e-7);
* ``build_augmentor``'s dispatch equal.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
cv2 = pytest.importorskip("cv2")

from casmtr_tpu.data import augment as J  # noqa: E402
from casmtr_tpu_torch.data import augment as A  # noqa: E402

SEEDS = range(24)


def _image(rng, h, w):
    return rng.random((h, w, 3)).astype(np.float32)


@pytest.mark.parametrize("name", ["DarkAug", "MobileAug"])
def test_photometric_presets_equal_jax(name, monkeypatch):
    calls = []
    for prim in ("gaussian_blur", "filter2d"):
        fn = getattr(A, prim)
        monkeypatch.setattr(A, prim, lambda *a, _fn=fn, _p=prim: (
            calls.append(_p), _fn(*a))[1])
    for seed in SEEDS:
        img = _image(np.random.default_rng(seed), 29 + seed, 41)
        want = getattr(J, name)(np.random.default_rng(seed))(img)
        got = getattr(A, name)(np.random.default_rng(seed))(img)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert calls, f"{name}: no seed took the blur branch"


def test_random_rotation_equals_jax():
    for seed in SEEDS:
        rng = np.random.default_rng(seed)
        h, w = int(rng.integers(20, 90)), int(rng.integers(20, 90))
        img = _image(rng, h, w)
        depth = (rng.random((h, w)) * 10).astype(np.float32)
        mask = rng.random((h, w)) < 0.7
        K = np.array([[300.0, 0, w / 2], [0, 310.0, h / 2], [0, 0, 1]])
        want = J.random_rotation(img, depth, mask, K,
                                 rng=np.random.default_rng(seed))
        got = A.random_rotation(img, depth, mask, K,
                                rng=np.random.default_rng(seed))
        for g, x in zip(got, want):
            assert g.dtype == x.dtype and g.shape == x.shape
        np.testing.assert_allclose(got[0], want[0], rtol=0, atol=2e-5)
        for g, x in zip(got[1:], want[1:]):
            assert np.array_equal(g, x)
        deg = float(np.random.default_rng(seed).uniform(-90, 90))
        assert np.array_equal(
            A.rotation_matrix_2d((w / 2 - 0.5, h / 2 - 0.5), deg, 1.0),
            cv2.getRotationMatrix2D((w / 2 - 0.5, h / 2 - 0.5), deg, 1.0))


def test_blur_and_filter_primitives():
    rng = np.random.default_rng(7)
    for k in (3, 5, 7):
        for shape in ((1, 9, 3), (2, 2), (31, 47, 3)):
            img = rng.random(shape).astype(np.float32)
            np.testing.assert_allclose(
                A.gaussian_blur(img, k), cv2.GaussianBlur(img, (k, k), 0),
                rtol=0, atol=1e-6)
    for k in range(3, 10):
        img = _image(rng, 23, 37)
        kern = (rng.random((k, k)) * (rng.random((k, k)) < 0.4)).astype(
            np.float32)
        kern /= max(kern.sum(), 1)
        np.testing.assert_allclose(A.filter2d(img, kern),
                                   cv2.filter2D(img, -1, kern), rtol=0,
                                   atol=1e-6)


def test_build_augmentor_dispatch():
    for method in (None, "dark", "mobile"):
        want = J.build_augmentor(method)
        got = A.build_augmentor(method)
        assert (got is None and want is None) or (
            type(got).__name__ == type(want).__name__)
    for mod in (A, J):
        with pytest.raises(ValueError, match="Invalid augmentation"):
            mod.build_augmentor("fog")
