"""Match figures without matplotlib (counterpart of
casmtr_tpu/utils/plotting.py): the pair side by side with one line per
match, coloured by epipolar error or confidence, and a text overlay.

``error_colormap`` and ``dynamic_alpha`` are the JAX module's numpy code.
``make_matching_figure`` and ``make_evaluation_figure`` draw an RGBA uint8
raster [H, W, 4] instead of a matplotlib figure, and ``write_png`` writes
one with ``zlib`` and ``struct`` alone.

Deviation from the JAX module: the layout is this module's own, not
matplotlib's.  The images keep their pixel size (no figure size, dpi or
margins): image0 at the left, image1 ``GAP`` white columns to its right,
both at the top of a white canvas as tall as the taller one.  A match is a
one-pixel line from ``mkpts0`` to ``mkpts1`` shifted by image1's offset,
alpha-blended in its colour (the lines in order, then the dots), with a
3x3 dot at each end; the text is drawn in the 5x7 bitmap font held below
(printable ASCII, scaled by ``TEXT_SCALE``) at image0's top-left corner,
black or white on the JAX module's rule.  A point outside its image draws
no dot; a line is clipped to the canvas.
"""

from __future__ import annotations

import struct
import zlib
from typing import Optional, Sequence

import numpy as np

GAP = 8          # white columns between the two images
TEXT_SCALE = 2   # each font pixel drawn as a TEXT_SCALE x TEXT_SCALE block
TEXT_MARGIN = 4  # the text's distance from image0's top-left corner

# The classic 5x7 LCD font for ASCII 32-126: five column bytes a glyph,
# bit 0 the top row.
_FONT = bytes.fromhex(
    "0000000000" "00005f0000" "0007000700" "147f147f14" "242a7f2a12"
    "2313086462" "3649552250" "0005030000" "001c224100" "0041221c00"
    "082a1c2a08" "08083e0808" "0050300000" "0808080808" "0060600000"
    "2010080402" "3e5149453e" "00427f4000" "4261514946" "2141454b31"
    "1814127f10" "2745454539" "3c4a494930" "0171090503" "3649494936"
    "064949291e" "0036360000" "0056360000" "0008142241" "1414141414"
    "4122140800" "0201510906" "324979413e" "7e1111117e" "7f49494936"
    "3e41414122" "7f4141221c" "7f49494941" "7f09090101" "3e41415132"
    "7f0808087f" "00417f4100" "2040413f01" "7f08142241" "7f40404040"
    "7f0204027f" "7f0408107f" "3e4141413e" "7f09090906" "3e4151215e"
    "7f09192946" "4649494931" "01017f0101" "3f4040403f" "1f2040201f"
    "7f2018207f" "6314081463" "0304780403" "6151494543" "00007f4141"
    "0204081020" "41417f0000" "0402010204" "4040404040" "0001020400"
    "2054545478" "7f48444438" "3844444420" "384444487f" "3854545418"
    "087e090102" "081454543c" "7f08040478" "00447d4000" "2040443d00"
    "007f102844" "00417f4000" "7c04180478" "7c08040478" "3844444438"
    "7c14141408" "081414187c" "7c08040408" "4854545420" "043f444020"
    "3c4040207c" "1c2040201c" "3c4030403c" "4428102844" "0c5050503c"
    "4464544c44" "0008364100" "00007f0000" "0041360800" "08082a1c08")


def error_colormap(err: np.ndarray, thr: float, alpha: float = 1.0):
    """Green (correct) -> red (wrong) per-match colors."""
    x = 1 - np.clip(err / (thr * 2), 0, 1)
    return np.clip(np.stack([2 - x * 2, x * 2, np.zeros_like(x),
                             np.ones_like(x) * alpha], -1), 0, 1)


def dynamic_alpha(n_matches: int,
                  milestones=(0, 300, 1000, 2000),
                  alphas=(1.0, 0.8, 0.4, 0.2)) -> float:
    """Fade lines as the match count grows."""
    if n_matches == 0:
        return 1.0
    ranges = list(zip(alphas, alphas[1:] + (alphas[-1],)))
    for (m0, m1), (a0, a1) in zip(zip(milestones, milestones[1:] + (None,)),
                                  ranges):
        if m1 is None or n_matches < m1:
            if m1 is None:
                return a0
            t = (n_matches - m0) / (m1 - m0)
            return a0 + t * (a1 - a0)
    return alphas[-1]


def _rgb(img: np.ndarray) -> np.ndarray:
    """[H, W] or [H, W, 3] in [0, 1] -> float32 [H, W, 3]."""
    img = np.asarray(img, np.float32)
    if img.ndim == 2:
        img = np.repeat(img[:, :, None], 3, axis=2)
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"expected an [H, W] or [H, W, 3] image, got "
                         f"{img.shape}")
    return img


def _colors(color, n: int) -> np.ndarray:
    """Per-match RGBA [n, 4] float32 from [n, 3] or [n, 4] (alpha 1 when
    absent)."""
    c = np.asarray(color, np.float32).reshape(n, -1)
    if c.shape[1] == 3:
        c = np.concatenate([c, np.ones((n, 1), np.float32)], 1)
    return np.clip(c, 0, 1)


def _blend(canvas, ys, xs, rgba) -> None:
    """Alpha-blend one colour over the canvas's pixels (ys, xs)."""
    a = rgba[3]
    canvas[ys, xs] = canvas[ys, xs] * (1 - a) + rgba[:3] * a


def _line(canvas, p0, p1, rgba) -> None:
    """A one-pixel line from p0 to p1 (x, y), one sample per pixel of the
    longer axis, clipped to the canvas."""
    d = np.subtract(p1, p0)
    n = int(np.ceil(np.abs(d).max())) + 1
    t = np.linspace(0.0, 1.0, n)
    xs = np.rint(p0[0] + t * d[0]).astype(np.int64)
    ys = np.rint(p0[1] + t * d[1]).astype(np.int64)
    h, w = canvas.shape[:2]
    ok = (xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)
    _blend(canvas, ys[ok], xs[ok], rgba)


def _dot(canvas, p, box, rgba) -> None:
    """A 3x3 dot at p (x, y) inside ``box`` (x0, y0, x1, y1), skipped when
    p lies outside it."""
    x, y = int(np.rint(p[0])), int(np.rint(p[1]))
    x0, y0, x1, y1 = box
    if not (x0 <= x < x1 and y0 <= y < y1):
        return
    ys, xs = np.mgrid[max(y - 1, y0):min(y + 2, y1),
                      max(x - 1, x0):min(x + 2, x1)]
    _blend(canvas, ys.ravel(), xs.ravel(), rgba)


def _text(canvas, lines: Sequence[str], x: int, y: int, value: float,
          scale: int = TEXT_SCALE) -> None:
    """The text lines in the bitmap font, each glyph 5 x 7 font pixels plus
    one of spacing, drawn opaque in the gray ``value``; characters outside
    printable ASCII draw as '?'.  Clipped to the canvas."""
    h, w = canvas.shape[:2]
    for row, line in enumerate(lines):
        top = y + row * 9 * scale
        for col, ch in enumerate(line):
            code = ord(ch) if 32 <= ord(ch) <= 126 else ord("?")
            glyph = _FONT[(code - 32) * 5:(code - 31) * 5]
            left = x + col * 6 * scale
            for gx, bits in enumerate(glyph):
                for gy in range(7):
                    if bits >> gy & 1:
                        y0, x0 = top + gy * scale, left + gx * scale
                        canvas[max(y0, 0):min(y0 + scale, h),
                               max(x0, 0):min(x0 + scale, w)] = value


def make_matching_figure(img0: np.ndarray, img1: np.ndarray,
                         mkpts0: np.ndarray, mkpts1: np.ndarray,
                         color: np.ndarray, text=(),
                         path: Optional[str] = None):
    """The side-by-side match figure as an RGBA uint8 raster [H, W, 4]
    (the module docstring gives the layout).  img: [H, W] or [H, W, 3] in
    [0, 1]; mkpts [N, 2] (x, y) in each image's pixels; color [N, 3] or
    [N, 4] in [0, 1].  With ``path`` the raster is written there as a PNG
    and None is returned, as the JAX function returns no figure then."""
    im0, im1 = _rgb(img0), _rgb(img1)
    (h0, w0), (h1, w1) = im0.shape[:2], im1.shape[:2]
    off = w0 + GAP
    canvas = np.ones((max(h0, h1), off + w1, 3), np.float32)
    canvas[:h0, :w0] = im0
    canvas[:h1, off:] = im1
    mkpts0 = np.asarray(mkpts0, np.float64).reshape(-1, 2)
    mkpts1 = np.asarray(mkpts1, np.float64).reshape(-1, 2)
    n = len(mkpts0)
    if n:
        rgba = _colors(color, n)
        shifted = mkpts1 + np.array([off, 0.0])
        for i in range(n):
            _line(canvas, mkpts0[i], shifted[i], rgba[i])
        for i in range(n):
            _dot(canvas, mkpts0[i], (0, 0, w0, h0), rgba[i])
            _dot(canvas, shifted[i], (off, 0, off + w1, h1), rgba[i])
    # white text on dark images (the JAX function's rule: image0's top-left
    # 100 x 200 block brighter than 200/255 takes black)
    dark = not np.asarray(img0)[:100, :200].mean() > 200 / 255
    _text(canvas, list(text), TEXT_MARGIN, TEXT_MARGIN, 1.0 if dark else 0.0)
    raster = np.empty(canvas.shape[:2] + (4,), np.uint8)
    raster[..., :3] = np.rint(np.clip(canvas, 0, 1) * 255)
    raster[..., 3] = 255
    if path:
        write_png(path, raster)
        return None
    return raster


def make_evaluation_figure(img0, img1, mkpts0, mkpts1, epi_errs, epi_err_thr,
                           path: Optional[str] = None):
    """The evaluation figure: lines coloured by epipolar error, faded by
    the match count, with the count and the precision as text."""
    alpha = dynamic_alpha(len(mkpts0))
    correct = epi_errs < epi_err_thr
    precision = float(np.mean(correct)) if len(correct) else 0.0
    color = error_colormap(epi_errs, epi_err_thr, alpha)
    text = [f"#Matches {len(mkpts0)}",
            f"Precision({epi_err_thr:.2e}) ({100 * precision:.1f}%): "
            f"{int(correct.sum())}/{len(mkpts0)}"]
    return make_matching_figure(img0, img1, mkpts0, mkpts1, color, text,
                                path=path)


def png_bytes(raster: np.ndarray) -> bytes:
    """An 8-bit PNG of ``raster`` ([H, W] gray, [H, W, 3] RGB or [H, W, 4]
    RGBA uint8): one IDAT of unfiltered rows, deflated by ``zlib``."""
    raster = np.ascontiguousarray(raster)
    if raster.dtype != np.uint8 or raster.ndim not in (2, 3):
        raise ValueError(f"expected a uint8 [H, W(, C)] raster, got "
                         f"{raster.dtype} {raster.shape}")
    h, w = raster.shape[:2]
    channels = 1 if raster.ndim == 2 else raster.shape[2]
    ctype = {1: 0, 3: 2, 4: 6}.get(channels)
    if ctype is None:
        raise ValueError(f"expected 1, 3 or 4 channels, got {channels}")
    rows = raster.reshape(h, w * channels)
    data = np.concatenate([np.zeros((h, 1), np.uint8), rows], 1).tobytes()

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(data, 6))
            + chunk(b"IEND", b""))


def write_png(path, raster: np.ndarray) -> None:
    """Write ``raster`` to ``path`` as a PNG (``png_bytes``)."""
    with open(path, "wb") as f:
        f.write(png_bytes(raster))
