"""Photometric and geometric augmentations (counterpart of
casmtr_tpu/data/augment.py): ``DarkAug``, ``MobileAug``,
``build_augmentor`` and ``random_rotation``, in numpy.

Each takes the same ``np.random.Generator`` draws in the same order as the
JAX package's, so one seed gives both packages the same parameters.  The
JAX module's OpenCV calls are replaced by this module's own code on
OpenCV's rules:

* ``gaussian_blur(img, k)`` is ``cv2.GaussianBlur(img, (k, k), 0)`` for
  the k 3, 5 and 7 that DarkAug draws: OpenCV's fixed binomial kernels for
  those sizes, applied separably (rows, then columns) with
  ``BORDER_REFLECT_101``;
* ``filter2d(img, kernel)`` is ``cv2.filter2D(img, -1, kernel)``:
  correlation with the anchor at the kernel's centre and
  ``BORDER_REFLECT_101``, summed over the kernel's nonzero taps;
* ``rotation_matrix_2d`` is ``cv2.getRotationMatrix2D`` and
  ``warp_affine`` is ``cv2.warpAffine``: the matrix inverted in float64,
  the source coordinates of each pixel in float32, bilinear
  (``INTER_LINEAR``) or nearest (``INTER_NEAREST``) sampling, and a zero
  border (``BORDER_CONSTANT``).

They agree with OpenCV 5.0 to float32 rounding, not bit for bit (the sums'
order and OpenCV's fused multiply-adds): ``tests/test_torch_augment.py``
states the tolerances.  No command calls these functions, in either
package.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np

INTER_LINEAR = 1
INTER_NEAREST = 0

# cv2.getGaussianKernel's fixed kernels for odd sizes 3-7 at sigma <= 0
_SMALL_GAUSSIAN = {
    3: (0.25, 0.5, 0.25),
    5: (0.0625, 0.25, 0.375, 0.25, 0.0625),
    7: (0.03125, 0.109375, 0.21875, 0.28125, 0.21875, 0.109375, 0.03125),
}


def _reflect101(n: int, r: int) -> np.ndarray:
    """Source indices of positions -r .. n + r - 1 under
    BORDER_REFLECT_101 (gfedcb|abcdefgh|gfedcba)."""
    idx = np.arange(-r, n + r)
    if n == 1:
        return np.zeros_like(idx)
    period = 2 * (n - 1)
    idx = np.abs(idx) % period
    return np.where(idx >= n, period - idx, idx)


def _symmetric_pass(img: np.ndarray, kernel, axis: int) -> np.ndarray:
    """One separable pass of a symmetric kernel along ``axis``: the centre
    tap, then each pair of taps on the sum of its two samples."""
    r = len(kernel) // 2
    n = img.shape[axis]
    src = np.take(img, _reflect101(n, r), axis=axis)
    k = [img.dtype.type(v) for v in kernel]

    def shifted(j):
        return np.take(src, np.arange(j, j + n), axis=axis)

    acc = shifted(r) * k[r]
    for j in range(1, r + 1):
        acc = acc + k[r + j] * (shifted(r - j) + shifted(r + j))
    return acc.astype(img.dtype)


def gaussian_blur(img: np.ndarray, k: int) -> np.ndarray:
    """``cv2.GaussianBlur(img, (k, k), 0)`` for k 3, 5 or 7 (the sizes with
    OpenCV's fixed kernels that DarkAug draws), on [h, w] or [h, w, c]
    float images."""
    if k not in _SMALL_GAUSSIAN:
        raise ValueError(f"gaussian_blur: k {k}; 3, 5 or 7 only")
    kernel = _SMALL_GAUSSIAN[k]
    return _symmetric_pass(_symmetric_pass(img, kernel, 1), kernel, 0)


def filter2d(img: np.ndarray, kernel: np.ndarray) -> np.ndarray:
    """``cv2.filter2D(img, -1, kernel)``: correlation of each channel with
    ``kernel`` [kh, kw], anchored at its centre, BORDER_REFLECT_101, over
    its nonzero taps in row-major order, in the image's dtype."""
    kernel = np.asarray(kernel)
    kh, kw = kernel.shape
    ay, ax = kh // 2, kw // 2
    h, w = img.shape[:2]
    rows = _reflect101(h, max(ay, kh - 1 - ay))[max(ay, kh - 1 - ay) - ay:]
    cols = _reflect101(w, max(ax, kw - 1 - ax))[max(ax, kw - 1 - ax) - ax:]
    src = img[rows][:, cols]
    acc = np.zeros_like(img)
    for y, x in zip(*np.nonzero(kernel)):
        acc = acc + img.dtype.type(kernel[y, x]) * src[y:y + h, x:x + w]
    return acc.astype(img.dtype)


def rotation_matrix_2d(center, angle: float, scale: float) -> np.ndarray:
    """``cv2.getRotationMatrix2D``: [2, 3] float64, the centre taken as
    float32 (OpenCV's Point2f), the angle in degrees."""
    cx, cy = (float(np.float32(c)) for c in center)
    a = angle * (math.pi / 180)
    alpha, beta = math.cos(a) * scale, math.sin(a) * scale
    return np.array([[alpha, beta, (1 - alpha) * cx - beta * cy],
                     [-beta, alpha, beta * cx + (1 - alpha) * cy]])


def _invert_affine(M: np.ndarray) -> np.ndarray:
    """``cv2.invertAffineTransform`` in float64."""
    d = M[0, 0] * M[1, 1] - M[0, 1] * M[1, 0]
    d = 1.0 / d if d != 0 else 0.0
    a11, a22 = M[1, 1] * d, M[0, 0] * d
    a12, a21 = -M[0, 1] * d, -M[1, 0] * d
    b1 = -a11 * M[0, 2] - a12 * M[1, 2]
    b2 = -a21 * M[0, 2] - a22 * M[1, 2]
    return np.array([[a11, a12, b1], [a21, a22, b2]])


def _fma32(a, b, c) -> np.ndarray:
    """a * b + c of float32 values with one rounding to float32."""
    return (np.asarray(a, np.float64) * np.asarray(b, np.float64)
            + np.asarray(c, np.float64)).astype(np.float32)


def warp_affine(img: np.ndarray, M: np.ndarray, dsize,
                flags: int = INTER_LINEAR) -> np.ndarray:
    """``cv2.warpAffine(img, M, dsize, flags=flags)`` with a zero border:
    each output pixel (x, y) samples the input at the inverse map of M,
    computed in float32 as OpenCV does (row term m1 y + m2, then a fused
    m0 x + row term); ``INTER_LINEAR`` blends the four neighbours
    (outside ones count as 0) by fused lerps along x, then along y, on
    float32 images; ``INTER_NEAREST`` takes the nearest one (rounded half
    to even) of any dtype."""
    w, h = dsize
    m = _invert_affine(np.asarray(M, np.float64)).astype(np.float32)
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    row_x = (m[0, 1] * ys + m[0, 2]).astype(np.float32)
    row_y = (m[1, 1] * ys + m[1, 2]).astype(np.float32)
    X = _fma32(m[0, 0], xs, row_x)
    Y = _fma32(m[1, 0], xs, row_y)
    sh, sw = img.shape[:2]

    def sample(iy, ix):
        ok = (ix >= 0) & (ix < sw) & (iy >= 0) & (iy < sh)
        v = img[np.clip(iy, 0, sh - 1), np.clip(ix, 0, sw - 1)]
        if img.ndim == 3:
            ok = ok[..., None]
        return np.where(ok, v, np.zeros((), img.dtype))

    if flags == INTER_NEAREST:
        return sample(np.rint(Y).astype(np.int64),
                      np.rint(X).astype(np.int64)).astype(img.dtype)
    if flags != INTER_LINEAR:
        raise ValueError(f"warp_affine: flags {flags}; INTER_LINEAR (1) or "
                         "INTER_NEAREST (0)")
    if img.dtype != np.float32:
        raise ValueError(f"warp_affine: INTER_LINEAR takes float32 images, "
                         f"got {img.dtype}")
    fx, fy = np.floor(X), np.floor(Y)
    a, b = (X - fx).astype(np.float32), (Y - fy).astype(np.float32)
    x0, y0 = fx.astype(np.int64), fy.astype(np.int64)
    if img.ndim == 3:
        a, b = a[..., None], b[..., None]
    p00, p01 = sample(y0, x0), sample(y0, x0 + 1)
    p10, p11 = sample(y0 + 1, x0), sample(y0 + 1, x0 + 1)
    top = _fma32(a, p01 - p00, p00)
    bottom = _fma32(a, p11 - p10, p10)
    return _fma32(b, bottom - top, top).astype(img.dtype)


class DarkAug:
    """Low-light simulation: random gamma, brightness and contrast jitter,
    and now and then a Gaussian blur."""

    def __init__(self, rng: Optional[np.random.Generator] = None):
        self.rng = rng or np.random.default_rng()

    def __call__(self, img: np.ndarray) -> np.ndarray:
        """img: [h, w, c] float32 in [0, 1]."""
        gamma = self.rng.uniform(1.2, 2.2)
        img = np.power(np.clip(img, 0, 1), gamma)
        brightness = self.rng.uniform(-0.25, 0.0)
        contrast = self.rng.uniform(0.7, 1.0)
        img = np.clip((img - 0.5) * contrast + 0.5 + brightness, 0, 1)
        if self.rng.random() < 0.3:
            k = int(self.rng.integers(3, 8)) | 1
            img = gaussian_blur(img, k)
        return img.astype(np.float32)


class MobileAug:
    """Mobile-capture simulation: motion blur, noise and a colour shift."""

    def __init__(self, rng: Optional[np.random.Generator] = None):
        self.rng = rng or np.random.default_rng()

    def __call__(self, img: np.ndarray) -> np.ndarray:
        if self.rng.random() < 0.5:
            k = int(self.rng.integers(3, 10))
            kern = np.zeros((k, k), np.float32)
            angle = self.rng.uniform(0, 180)
            c = (k - 1) / 2
            dx, dy = np.cos(np.radians(angle)), np.sin(np.radians(angle))
            for t in np.linspace(-c, c, k * 2):
                y, x = int(round(c + t * dy)), int(round(c + t * dx))
                if 0 <= y < k and 0 <= x < k:
                    kern[y, x] = 1
            kern /= max(kern.sum(), 1)
            img = filter2d(img, kern)
        if self.rng.random() < 0.5:
            img = img + self.rng.normal(0, 0.02, img.shape)
        shift = self.rng.uniform(-0.05, 0.05, (1, 1, img.shape[-1]))
        return np.clip(img + shift, 0, 1).astype(np.float32)


def build_augmentor(method: Optional[str], **kwargs):
    """None, or the preset named ``method`` ("dark", "mobile"); another
    name raises ValueError."""
    if method is None:
        return None
    if method == "dark":
        return DarkAug(**kwargs)
    if method == "mobile":
        return MobileAug(**kwargs)
    raise ValueError(f"Invalid augmentation method: {method}")


def random_rotation(img: np.ndarray, depth: np.ndarray, mask: np.ndarray,
                    K: np.ndarray, max_deg: float = 90.0,
                    rng: Optional[np.random.Generator] = None):
    """Random in-plane rotation of an image about its centre, its depth
    and mask warped alike (nearest), and the intrinsics updated as
    K <- H @ K.  Returns (img, depth, mask, K_new)."""
    rng = rng or np.random.default_rng()
    h, w = img.shape[:2]
    deg = float(rng.uniform(-max_deg, max_deg))
    M = rotation_matrix_2d((w / 2 - 0.5, h / 2 - 0.5), deg, 1.0)
    H = np.eye(3, dtype=np.float64)
    H[:2] = M
    img_r = warp_affine(img, M, (w, h), flags=INTER_LINEAR)
    depth_r = warp_affine(depth, M, (w, h), flags=INTER_NEAREST)
    mask_r = warp_affine(mask.astype(np.uint8), M, (w, h),
                         flags=INTER_NEAREST).astype(bool)
    K_new = (H @ K).astype(np.float32)
    return img_r, depth_r, mask_r, K_new
