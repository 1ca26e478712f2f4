"""Host-side image, depth and pose reading (counterpart of
casmtr_tpu/data/io.py, with its names, arguments and return values): the
longer-edge resize, divisible-by-df rounding and bottom-right padding with
masks, MegaDepth h5 depth, ScanNet 640x480 frames, 16-bit PNG depth and
pose files.  Outputs are NHWC numpy arrays in [0, 1].

The files are read by ``data/codecs`` (no cv2, PIL or h5py) and resampled
by the host library (``csrc/host/image_ops.cpp``): ``padding=True`` takes
the fused resize + pad + normalize of the JAX package's native op, and the
other resizes OpenCV's 8-bit ``INTER_LINEAR``, as the JAX package's
``cv2.resize`` calls do.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from casmtr_tpu_torch.data import codecs, host


def get_resized_wh(w: int, h: int, resize: Optional[int]):
    """Resize the LONGER edge to ``resize``."""
    if resize is None:
        return w, h
    scale = resize / max(h, w)
    return int(round(w * scale)), int(round(h * scale))


def get_divisible_wh(w: int, h: int, df: Optional[int]):
    """Round down to a multiple of df."""
    if df is None:
        return w, h
    return int(w // df * df), int(h // df * df)


def pad_bottom_right(inp: np.ndarray, pad_size: int, ret_mask: bool = False):
    """Zero-pad to (pad_size, pad_size) bottom-right.  inp: [h, w] or
    [h, w, c]."""
    assert pad_size >= max(inp.shape[:2]), (pad_size, inp.shape)
    shape = ((pad_size, pad_size) if inp.ndim == 2
             else (pad_size, pad_size, inp.shape[2]))
    padded = np.zeros(shape, dtype=inp.dtype)
    padded[:inp.shape[0], :inp.shape[1]] = inp
    mask = None
    if ret_mask:
        mask = np.zeros((pad_size, pad_size), dtype=bool)
        mask[:inp.shape[0], :inp.shape[1]] = True
    return padded, mask


def _imread(path, gray: bool) -> np.ndarray:
    """uint8 [h, w] gray or [h, w, 3] RGB."""
    return codecs.imread(path, codecs.IMREAD_GRAYSCALE if gray
                         else codecs.IMREAD_COLOR)


def _u8_image(img: np.ndarray) -> np.ndarray:
    """``img`` as a C-contiguous uint8 [h, w] or [h, w, c] array for the
    host library; anything else raises."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim not in (2, 3) or 0 in img.shape:
        raise ValueError(f"expected a uint8 [h, w] or [h, w, c] image, got "
                         f"{img.dtype} {img.shape}")
    return np.ascontiguousarray(img)


def resize_u8(img: np.ndarray, wh: Tuple[int, int]) -> np.ndarray:
    """``cv2.resize(img, wh)`` of a uint8 [h, w] or [h, w, c] image
    (INTER_LINEAR; an exact 2x reduction as OpenCV's INTER_AREA)."""
    w, h = int(wh[0]), int(wh[1])
    if w < 1 or h < 1:
        raise ValueError(f"resize to {(w, h)}")
    src = _u8_image(img)
    cn = 1 if src.ndim == 2 else src.shape[2]
    out = np.empty((h, w) if src.ndim == 2 else (h, w, cn), np.uint8)
    host.lib().casmtr_resize_linear_u8(src.ctypes.data, src.shape[0],
                                       src.shape[1], cn, out.ctypes.data,
                                       h, w)
    return out


def resize_f32(img: np.ndarray, wh: Tuple[int, int]) -> np.ndarray:
    """``cv2.resize(img, wh)`` of a float32 [h, w] or [h, w, c] image
    (INTER_LINEAR) by the host library: bit-equal to OpenCV 5.0 wherever
    the image has two or more rows and columns (a 1-pixel-high or -wide
    source takes another route in OpenCV, within 2e-6).  The rule is
    ``resize_f32_plain``'s."""
    w, h = int(wh[0]), int(wh[1])
    if w < 1 or h < 1:
        raise ValueError(f"resize to {(w, h)}")
    src = np.asarray(img)
    if src.dtype != np.float32 or src.ndim not in (2, 3) or 0 in src.shape:
        raise ValueError(f"expected a float32 [h, w] or [h, w, c] image, "
                         f"got {src.dtype} {src.shape}")
    src = np.ascontiguousarray(src)
    cn = 1 if src.ndim == 2 else src.shape[2]
    out = np.empty((h, w) if src.ndim == 2 else (h, w, cn), np.float32)
    host.lib().casmtr_resize_linear_f32(src.ctypes.data, src.shape[0],
                                        src.shape[1], cn, out.ctypes.data,
                                        h, w)
    return out


def resize_f32_plain(img: np.ndarray, wh: Tuple[int, int]) -> np.ndarray:
    """``resize_f32`` in numpy, the library's oracle: per output the source
    coordinate (d + 0.5) * (1 / (dst / src)) - 0.5 in float64, its floor
    and the next index clamped into the image, the fraction f rounded to
    float32, and a + f * (b - a) with b - a in float32 and the product and
    sum in float64 (one rounding to float32: OpenCV's fused multiply-add,
    but for rare double roundings); the horizontal pass, then the
    vertical one."""
    w, h = int(wh[0]), int(wh[1])
    src = np.asarray(img, np.float32)
    if src.shape[:2] == (h, w):
        return src.copy()

    def coefs(n_dst, n_src):
        x = (np.arange(n_dst) + 0.5) * (1.0 / (n_dst / n_src)) - 0.5
        s = np.floor(x)
        f = (x - s).astype(np.float32).astype(np.float64)
        s = s.astype(np.int64)
        return np.clip(s, 0, n_src - 1), np.clip(s + 1, 0, n_src - 1), f

    def lerp(a, b, f):
        return (a + f * (b - a).astype(np.float64)).astype(np.float32)

    x0, x1, fx = coefs(w, src.shape[1])
    y0, y1, fy = coefs(h, src.shape[0])
    fx = fx.reshape((-1,) + (1,) * (src.ndim - 2))
    fy = fy.reshape((-1, 1) + (1,) * (src.ndim - 2))
    rows = lerp(src[:, x0], src[:, x1], fx)
    return lerp(rows[y0], rows[y1], fy)


def resize_pad_normalize(img: np.ndarray, out_h: int, out_w: int,
                         pad_size: int):
    """The fused bilinear resize of a uint8 [h, w] or [h, w, c] image to
    (out_h, out_w), scaled to [0, 1] and padded bottom-right into a zeroed
    float32 [pad_size, pad_size, 3] canvas (gray broadcast to 3 channels),
    with its bool mask."""
    if out_h < 1 or out_w < 1 or pad_size < out_h or pad_size < out_w:
        raise ValueError(f"pad_size {pad_size}, output size "
                         f"{(out_h, out_w)}")
    src = _u8_image(img)
    cn = 1 if src.ndim == 2 else src.shape[2]
    canvas = np.zeros((pad_size, pad_size, 3), np.float32)
    mask = np.zeros((pad_size, pad_size), bool)
    host.lib().casmtr_resize_pad_normalize(
        src.ctypes.data, src.shape[0], src.shape[1], cn, out_h, out_w,
        pad_size, canvas.ctypes.data, mask.ctypes.data)
    return canvas, mask


def read_megadepth_image(path, resize: Optional[int] = None,
                         df: Optional[int] = None, padding: bool = False,
                         gray: bool = False, pad_size: Optional[int] = None):
    """Returns (image [h, w, 3] float32 in [0,1], mask [h, w] bool|None,
    scale [2] float32 = [w/w_new, h/h_new]).  ``pad_size`` pads to a fixed
    square canvas instead of max(h_new, w_new) (the padded region is
    masked)."""
    img = _imread(path, gray)
    h, w = img.shape[:2]
    w_new, h_new = get_divisible_wh(*get_resized_wh(w, h, resize), df)
    scale = np.array([w / w_new, h / h_new], np.float32)
    if padding:
        canvas, mask = resize_pad_normalize(img, h_new, w_new,
                                            pad_size or max(h_new, w_new))
        return canvas, mask, scale
    img = resize_u8(img, (w_new, h_new)).astype(np.float32) / 255.0
    if gray:
        img = np.repeat(img[..., None], 3, axis=-1)
    return img, None, scale


def read_megadepth_depth(path, pad_to: Optional[int] = None) -> np.ndarray:
    """MegaDepth h5 depth.  [h, w] float32."""
    depth = codecs.read_h5_dataset(path, "depth")
    if pad_to is not None:
        depth, _ = pad_bottom_right(depth, pad_to, ret_mask=False)
    return depth.astype(np.float32)


def read_scannet_image(path, resize: Tuple[int, int] = (640, 480),
                       gray: bool = False) -> np.ndarray:
    """ScanNet image resized to (w, h) = (640, 480).  [h, w, 3] float32 in
    [0, 1]."""
    img = resize_u8(_imread(path, gray), resize)
    img = img.astype(np.float32) / 255.0
    if gray:
        img = np.repeat(img[..., None], 3, axis=-1)
    return img


def read_scannet_depth(path) -> np.ndarray:
    """PNG depth in millimetres -> metres."""
    depth = codecs.imread(path, codecs.IMREAD_UNCHANGED)
    return (depth / 1000.0).astype(np.float32)


def read_scannet_pose(path) -> np.ndarray:
    """Camera2World txt -> World2Camera."""
    cam2world = np.loadtxt(path, delimiter=" ")
    return np.linalg.inv(cam2world)


def load_im_padding(path0, path1, resize: int = 1024, df: int = 32):
    """Single-pair loading: resize so the SHORTER side is ``resize``,
    divisible-by-df, pad both to a common canvas + masks.  Returns (img0,
    img1, mask0, mask1, scale0, scale1) with images [1, H, W, 3]."""
    imgs, sizes, scales = [], [], []
    for p in (path0, path1):
        img = _imread(p, gray=False)
        h, w = img.shape[:2]
        s = resize / min(h, w)
        w_new, h_new = get_divisible_wh(int(round(w * s)), int(round(h * s)),
                                        df)
        imgs.append(resize_u8(img, (w_new, h_new)))
        sizes.append((h_new, w_new))
        scales.append(np.array([w / w_new, h / h_new], np.float32))
    H = max(s[0] for s in sizes)
    W = max(s[1] for s in sizes)
    outs, masks = [], []
    for img in imgs:
        canvas = np.zeros((H, W, 3), np.float32)
        canvas[:img.shape[0], :img.shape[1]] = img.astype(np.float32) / 255.0
        mask = np.zeros((H, W), bool)
        mask[:img.shape[0], :img.shape[1]] = True
        outs.append(canvas[None])
        masks.append(mask[None])
    return outs[0], outs[1], masks[0], masks[1], scales[0], scales[1]
