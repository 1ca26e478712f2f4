"""The port's match figures (``casmtr_tpu_torch.utils.plotting``) on the
CPU:

* ``error_colormap`` and ``dynamic_alpha`` equal the JAX module's (match
  counts 0-3000, errors around the threshold);
* the raster of ``make_matching_figure`` holds both images unchanged off
  the lines, the dots and the text, and each match's colour at its two
  ends; ``make_evaluation_figure`` writes the JAX function's text rule
  (black on bright images, white on dark ones);
* the PNG the port writes reads back bit-equal to the raster through cv2
  (a witness) and through the port's own reader, for RGBA, RGB and gray.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
cv2 = pytest.importorskip("cv2")
pytest.importorskip("matplotlib")

from casmtr_tpu_torch.data import codecs  # noqa: E402
from casmtr_tpu_torch.utils import plotting as P  # noqa: E402


def test_colormap_and_alpha_equal_jax():
    from casmtr_tpu.utils import plotting as JP
    for n in range(0, 3001):
        assert P.dynamic_alpha(n) == JP.dynamic_alpha(n), n
    err = np.linspace(0, 3e-3, 257)
    for thr, alpha in ((5e-4, 1.0), (1e-4, 0.35)):
        np.testing.assert_array_equal(P.error_colormap(err, thr, alpha),
                                      JP.error_colormap(err, thr, alpha))


def _images(seed, shapes):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, s).astype(np.uint8) / 255.0 for s in shapes]


def test_raster_keeps_images_and_colours_the_ends():
    img0, img1 = _images(0, [(40, 50, 3), (30, 44)])
    mk0 = np.array([[5.0, 6.0], [40.2, 30.7], [20.0, 35.0]])
    mk1 = np.array([[10.0, 20.0], [3.0, 4.4], [40.0, 25.0]])
    color = np.array([[1, 0, 0, 1], [0, 1, 0, 1], [0, 0, 1, 1]], float)
    fig = P.make_matching_figure(img0, img1, mk0, mk1, color)
    off = 50 + P.GAP
    assert fig.shape == (40, off + 44, 4) and fig.dtype == np.uint8
    assert (fig[..., 3] == 255).all()
    # the pixels no line or dot reaches: both images as they are
    drawn = np.zeros(fig.shape[:2], bool)
    for p0, p1 in zip(mk0, mk1 + [off, 0]):
        n = int(np.ceil(np.abs(p1 - p0).max())) + 1
        t = np.linspace(0, 1, n)[:, None]
        xy = np.rint(p0 + t * (p1 - p0)).astype(int)
        drawn[xy[:, 1], xy[:, 0]] = True
        for x, y in np.rint([p0, p1]).astype(int):
            drawn[y - 1:y + 2, x - 1:x + 2] = True
    u0 = np.rint(img0 * 255).astype(np.uint8)
    u1 = np.repeat(np.rint(img1 * 255).astype(np.uint8)[..., None], 3, 2)
    keep0, keep1 = ~drawn[:, :50], ~drawn[:30, off:]
    assert keep0.sum() > 1500 and keep1.sum() > 1000
    assert np.array_equal(fig[:, :50, :3][keep0], u0[keep0])
    assert np.array_equal(fig[:30, off:, :3][keep1], u1[keep1])
    assert (fig[:, 50:off, :3] == 255)[~drawn[:, 50:off]].all()
    assert (fig[30:, off:, :3] == 255)[~drawn[30:, off:]].all()
    for p0, p1, c in zip(mk0, mk1 + [off, 0], color):
        for x, y in np.rint([p0, p1]).astype(int):
            assert np.array_equal(fig[y, x, :3], (c[:3] * 255).astype(int))


def test_text_rule_and_evaluation_figure():
    dark, bright = np.full((120, 220), 0.1), np.full((120, 220), 0.95)
    errs = np.array([1e-4, 9e-4])
    pts = np.array([[60.0, 60.0], [100.0, 100.0]])
    for img, value in ((dark, 255), (bright, 0)):
        fig = P.make_evaluation_figure(img, img, pts, pts, errs, 5e-4)
        block = fig[P.TEXT_MARGIN:P.TEXT_MARGIN + 7 * P.TEXT_SCALE,
                    P.TEXT_MARGIN:P.TEXT_MARGIN + 200, :3]
        assert (block == value).any()
        plain = P.make_matching_figure(img, img, pts, pts,
                                       P.error_colormap(errs, 5e-4))
        # only the text differs from the same figure without it
        diff = (fig != plain).any(-1)
        assert diff.any() and (np.nonzero(diff)[0] < 2 * 9 * P.TEXT_SCALE
                               + P.TEXT_MARGIN).all()


@pytest.mark.parametrize("channels", [4, 3, 1])
def test_png_reads_back_bit_equal(tmp_path, channels):
    img0, img1 = _images(1, [(33, 21, 3), (27, 30, 3)])
    fig = P.make_evaluation_figure(
        img0, img1, np.array([[3.0, 4.0], [15.5, 20.0]]),
        np.array([[7.0, 9.0], [25.0, 2.0]]), np.array([1e-4, 2e-3]), 5e-4)
    raster = fig if channels == 4 else (
        fig[..., :3] if channels == 3 else fig[..., 0])
    path = tmp_path / "fig.png"
    P.write_png(path, raster)
    want = cv2.imread(str(path), cv2.IMREAD_UNCHANGED)
    if channels > 1:
        want = want[..., [2, 1, 0, 3][:channels]]
    assert np.array_equal(want, raster)
    assert np.array_equal(codecs.imread(path, codecs.IMREAD_UNCHANGED),
                          raster)
    out = tmp_path / "direct.png"
    assert P.make_evaluation_figure(
        img0, img1, np.zeros((0, 2)), np.zeros((0, 2)), np.zeros(0), 5e-4,
        path=str(out)) is None
    assert cv2.imread(str(out), cv2.IMREAD_UNCHANGED).shape == (33, 59, 4)
