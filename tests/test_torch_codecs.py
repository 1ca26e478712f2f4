"""The port's file readers (``casmtr_tpu_torch.data.codecs`` over the host
library) against cv2.imread and h5py, bit for bit, on the CPU:

* JPEG written at test time: 4:4:4, 4:2:2, 4:2:0 and 4:4:0 at 1x1, 17x9,
  67x45 and 45x67, qualities 50 and 95, gray files, restart intervals 1, 3
  and 17, EXIF orientations 1-8 (colour and gray), an Adobe RGB file, 16-bit
  quantization tables (SOF1), progressive files (SOF2) from PIL and cv2 in
  every subsampling, with and without restart intervals; read in colour,
  gray and unchanged mode;
* PNG of every colour type and bit depth the readers take (gray 8/16, RGB
  8/16, gray+alpha 8/16, RGBA 8/16, palette 1/2/4/8, with and without
  tRNS), rows filtered with every filter type, in the three modes;
* HDF5 from h5py: the default format and ``libver="latest"`` contiguous,
  chunked with gzip and with shuffle + gzip (default format), big- and
  little-endian floats and integers, nested groups;
* the refusals: arithmetic (sequential and progressive), lossless and
  12-bit JPEG, CMYK,
  interlaced PNG, 4-bit gray PNG, an unknown format (ValueError naming the
  file and what was met), chunked layout version 4 and the LZF filter
  (NotImplementedError);
* the committed fixtures against their manifest (tests/data/port_io,
  scripts/make_port_io_fixtures.py).

cv2's colour results are compared in RGB(A) order: the port reads RGB.
"""

import hashlib
import io
import json
import os
import struct
import zlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
cv2 = pytest.importorskip("cv2")
h5py = pytest.importorskip("h5py")
Image = pytest.importorskip("PIL.Image")

from casmtr_tpu_torch.data import codecs  # noqa: E402

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                        "port_io")
MODES = {"color": cv2.IMREAD_COLOR, "gray": cv2.IMREAD_GRAYSCALE,
         "unchanged": cv2.IMREAD_UNCHANGED}


def rgb_order(img):
    if img.ndim == 3:
        img = img[..., [2, 1, 0, 3][:img.shape[2]]]
    return np.ascontiguousarray(img)


def textured(seed, h, w, c=3):
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    img = np.stack([128 + 100 * np.sin(x / 7.0 + k) * np.cos(y / 11.0 + 2 * k)
                    for k in range(c)], -1) + rng.normal(0, 20, (h, w, c))
    img = np.clip(img, 0, 255).astype(np.uint8)
    return img if c > 1 else img[..., 0]


def assert_same(path, modes=MODES):
    for name, flag in modes.items():
        want = rgb_order(cv2.imread(str(path), flag))
        got = codecs.imread(path, flag)
        assert got.dtype == want.dtype and got.shape == want.shape, name
        assert np.array_equal(got, want), (name, np.abs(
            got.astype(int) - want.astype(int)).max())


def pil_jpeg(path, img, **kw):
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "JPEG", **kw)
    path.write_bytes(buf.getvalue())
    return path


JPEG_CASES = [(sub, q, hw) for sub in ("4:4:4", "4:2:2", "4:2:0")
              for q in (50, 95)
              for hw in ((1, 1), (9, 17), (45, 67), (67, 45))]


@pytest.mark.parametrize("sub,q,hw", JPEG_CASES,
                         ids=[f"{s}-q{q}-{h}x{w}" for s, q, (h, w)
                              in JPEG_CASES])
def test_jpeg_subsampling_sizes_qualities(tmp_path, sub, q, hw):
    path = pil_jpeg(tmp_path / "a.jpg", textured(q, *hw), quality=q,
                    subsampling=sub)
    assert_same(path)


@pytest.mark.parametrize("hw", [(1, 1), (9, 17), (45, 67)])
def test_jpeg_440_and_gray(tmp_path, hw):
    path = tmp_path / "a.jpg"
    ok, enc = cv2.imencode(".jpg", textured(1, *hw), [
        cv2.IMWRITE_JPEG_QUALITY, 80, cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
        cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440])
    path.write_bytes(enc.tobytes())
    assert_same(path)
    assert_same(pil_jpeg(tmp_path / "g.jpg", textured(2, *hw, c=1),
                         quality=75))


@pytest.mark.parametrize("interval", [1, 3, 17])
def test_jpeg_restart_intervals(tmp_path, interval):
    path = tmp_path / "a.jpg"
    ok, enc = cv2.imencode(".jpg", textured(3, 67, 45), [
        cv2.IMWRITE_JPEG_QUALITY, 85, cv2.IMWRITE_JPEG_RST_INTERVAL,
        interval])
    path.write_bytes(enc.tobytes())
    assert b"\xff\xdd" in enc.tobytes()
    assert_same(path)


@pytest.mark.parametrize("orientation", range(1, 9))
def test_jpeg_exif_orientation(tmp_path, orientation):
    exif = Image.Exif()
    exif[0x0112] = orientation
    for c in (3, 1):
        path = pil_jpeg(tmp_path / f"{c}.jpg", textured(4, 17, 9, c=c),
                        quality=90, exif=exif.tobytes())
        assert_same(path)


def test_jpeg_adobe_rgb_and_16bit_tables(tmp_path):
    path = pil_jpeg(tmp_path / "rgb.jpg", textured(5, 33, 21), quality=90,
                    keep_rgb=True)
    assert b"Adobe" in path.read_bytes()
    assert_same(path)
    path = pil_jpeg(tmp_path / "q16.jpg", textured(6, 40, 56),
                    qtables=[list(range(300, 364)), list(range(2, 66))])
    data = path.read_bytes()
    assert b"\xff\xc1" in data and data[data.find(b"\xff\xdb") + 4] >> 4
    assert_same(path)


def _baseline(tmp_path):
    return pil_jpeg(tmp_path / "b.jpg", textured(7, 17, 9), quality=90)


PROGRESSIVE_CASES = [(enc, sub, hw) for enc in ("pil", "cv2")
                     for sub in ("4:4:4", "4:2:2", "4:2:0", "4:4:0")
                     for hw in ((1, 1), (13, 23), (67, 45))
                     if not (enc == "pil" and sub == "4:4:0")]
CV2_SAMPLING = {"4:4:4": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
                "4:2:2": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
                "4:2:0": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420,
                "4:4:0": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440}


@pytest.mark.parametrize("enc,sub,hw", PROGRESSIVE_CASES,
                         ids=[f"{e}-{s}-{h}x{w}" for e, s, (h, w)
                              in PROGRESSIVE_CASES])
def test_jpeg_progressive(tmp_path, enc, sub, hw):
    """Progressive files: PIL's scan script (spectral selection and
    successive approximation) and libjpeg's through cv2, the latter with
    a restart interval on the larger size."""
    if enc == "pil":
        path = pil_jpeg(tmp_path / "p.jpg", textured(11, *hw), quality=90,
                        subsampling=sub, progressive=True)
    else:
        path = tmp_path / "p.jpg"
        ok, data = cv2.imencode(".jpg", textured(12, *hw), [
            cv2.IMWRITE_JPEG_PROGRESSIVE, 1, cv2.IMWRITE_JPEG_QUALITY, 85,
            cv2.IMWRITE_JPEG_SAMPLING_FACTOR, CV2_SAMPLING[sub],
            cv2.IMWRITE_JPEG_RST_INTERVAL, 2 if hw[0] > 13 else 0])
        path.write_bytes(data.tobytes())
    assert b"\xff\xc2" in path.read_bytes()
    assert_same(path)
    gray = pil_jpeg(tmp_path / "g.jpg", textured(13, *hw, c=1), quality=70,
                    progressive=True)
    assert_same(gray)


@pytest.mark.parametrize("patch,words", [
    ("sof10", "arithmetic coding (SOF10)"),
    ((b"\xff\xc0", b"\xff\xc9"), "arithmetic coding (SOF9)"),
    ((b"\xff\xc0", b"\xff\xc3"), "lossless JPEG (SOF3)"),
    ("precision", "12-bit samples"),
    ("cmyk", "CMYK/YCCK (4 components)"),
])
def test_jpeg_refusals(tmp_path, patch, words):
    if patch == "sof10":   # progressive with arithmetic coding
        data = pil_jpeg(tmp_path / "p.jpg", textured(8, 17, 9), quality=90,
                        progressive=True).read_bytes()
        path = tmp_path / "x.jpg"
        path.write_bytes(data.replace(b"\xff\xc2", b"\xff\xca", 1))
    elif patch == "cmyk":
        path = tmp_path / "c.jpg"
        Image.fromarray(np.concatenate([textured(9, 17, 9), textured(
            10, 17, 9, c=1)[..., None]], -1), "CMYK").save(path, "JPEG")
    else:
        data = _baseline(tmp_path).read_bytes()
        if patch == "precision":
            i = data.find(b"\xff\xc0") + 4
            data = data[:i] + b"\x0c" + data[i + 1:]
        else:
            data = data.replace(*patch, 1)
        path = tmp_path / "x.jpg"
        path.write_bytes(data)
    with pytest.raises(ValueError, match=str(path)) as e:
        codecs.imread(path)
    assert words in str(e.value)


def test_unknown_format_and_missing_file(tmp_path):
    path = tmp_path / "x.bmp"
    path.write_bytes(b"BM" + bytes(62))
    with pytest.raises(ValueError, match="not a JPEG or PNG"):
        codecs.imread(path)
    with pytest.raises(FileNotFoundError):
        codecs.imread(tmp_path / "missing.jpg")


# ---------------------------------------------------------------- PNG


def _chunk(kind, data):
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def write_png(path, samples, ctype, depth, plte=None, trns=None,
              interlace=0):
    """A PNG whose rows cycle through filter types 0-4."""
    h, w = samples.shape[:2]
    if depth == 16:
        rows = samples.astype(">u2").reshape(h, -1).view(np.uint8)
    elif depth == 8:
        rows = samples.reshape(h, -1).astype(np.uint8)
    else:
        bits = np.unpackbits(samples.reshape(h, w, 1).astype(np.uint8),
                             axis=2)[:, :, 8 - depth:]
        rows = np.packbits(bits.reshape(h, -1), axis=1)
    ch = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[ctype]
    bpp = max(1, ch * depth // 8)
    raw, prev = bytearray(), np.zeros(rows.shape[1], np.int64)
    for y in range(h):
        f = y % 5
        r = rows[y].astype(np.int64)
        a = np.concatenate([np.zeros(bpp, np.int64), r[:-bpp]])
        b = prev
        c = np.concatenate([np.zeros(bpp, np.int64), prev[:-bpp]])
        if f == 0:
            e = r
        elif f == 1:
            e = r - a
        elif f == 2:
            e = r - b
        elif f == 3:
            e = r - ((a + b) >> 1)
        else:
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            e = r - np.where((pa <= pb) & (pa <= pc), a,
                             np.where(pb <= pc, b, c))
        raw.append(f)
        raw += bytes((e % 256).astype(np.uint8))
        prev = r
    data = b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", struct.pack(
        ">IIBBBBB", w, h, depth, ctype, 0, 0, interlace))
    if plte is not None:
        data += _chunk(b"PLTE", plte.tobytes())
    if trns is not None:
        data += _chunk(b"tRNS", trns)
    data += _chunk(b"IDAT", zlib.compress(bytes(raw))) + _chunk(b"IEND", b"")
    path.write_bytes(data)
    return path


PNG_CASES = [(t, d, tr) for d in (8, 16) for t in (0, 2, 4, 6)
             for tr in ((False, True) if t in (0, 2) else (False,))]


@pytest.mark.parametrize("ctype,depth,with_trns", PNG_CASES,
                         ids=[f"type{t}-{d}bit{'-trns' if tr else ''}"
                              for t, d, tr in PNG_CASES])
def test_png_colour_types(tmp_path, ctype, depth, with_trns):
    rng = np.random.default_rng(ctype * 100 + depth)
    ch = {0: 1, 2: 3, 4: 2, 6: 4}[ctype]
    s = rng.integers(0, 2 ** depth, (13, 11, ch))
    s[0, :4] = s[0, :1]      # gray-looking pixels (the RGB->gray shortcut)
    trns = None
    if with_trns:
        s[2, 2] = 5
        trns = struct.pack(">" + "H" * ch, *([5] * ch))
    assert_same(write_png(tmp_path / "a.png", s, ctype, depth, trns=trns))


@pytest.mark.parametrize("depth", [1, 2, 4, 8])
@pytest.mark.parametrize("with_trns", [False, True])
def test_png_palette(tmp_path, depth, with_trns):
    rng = np.random.default_rng(depth)
    n = 1 << depth
    plte = rng.integers(0, 256, (n, 3)).astype(np.uint8)
    trns = (bytes(rng.integers(0, 256, n // 2 + 1).astype(np.uint8))
            if with_trns else None)
    assert_same(write_png(tmp_path / "p.png", rng.integers(0, n, (13, 11, 1)),
                          3, depth, plte=plte, trns=trns))


def test_png_written_by_cv2_and_pil(tmp_path):
    rng = np.random.default_rng(11)
    cv2.imwrite(str(tmp_path / "d.png"),
                rng.integers(0, 65536, (48, 64)).astype(np.uint16))
    assert_same(tmp_path / "d.png")
    Image.fromarray(textured(12, 30, 40)).save(tmp_path / "c.png")
    assert_same(tmp_path / "c.png")
    Image.fromarray(textured(13, 30, 40)).quantize(37).save(tmp_path /
                                                            "q.png")
    assert_same(tmp_path / "q.png")


def test_png_refusals(tmp_path):
    rng = np.random.default_rng(14)
    path = write_png(tmp_path / "i.png", rng.integers(0, 256, (8, 8, 3)), 2,
                     8, interlace=1)
    with pytest.raises(ValueError, match="interlaced \\(Adam7\\)"):
        codecs.imread(path)
    path = write_png(tmp_path / "g4.png", rng.integers(0, 16, (8, 8, 1)), 0,
                     4)
    with pytest.raises(ValueError, match="bit depth 4 \\(colour type 0\\)"):
        codecs.imread(path)


# ---------------------------------------------------------------- HDF5


def h5_read(path, name):
    with h5py.File(path, "r") as f:
        return np.asarray(f[name])


H5_CASES = [(lib, kw) for lib, kw in (
    (None, {}), ("latest", {}), (None, {"chunks": (16, 16),
                                        "compression": "gzip"}),
    (None, {"chunks": (7, 5), "compression": "gzip", "shuffle": True}))]


@pytest.mark.parametrize("libver,kw", H5_CASES,
                         ids=["default-contiguous", "latest-contiguous",
                              "chunked-gzip", "chunked-shuffle-gzip"])
@pytest.mark.parametrize("dtype", ["<f4", ">f4", "<f8", "<u2", ">i4"])
def test_h5_layouts_and_types(tmp_path, libver, kw, dtype):
    rng = np.random.default_rng(15)
    data = (rng.random((37, 29)) * 100).astype(dtype)
    path = tmp_path / "d.h5"
    with h5py.File(path, "w", libver=libver) as f:
        f.create_dataset("depth", data=data, **kw)
    got = codecs.read_h5_dataset(path, "depth")
    want = h5_read(path, "depth")
    assert got.dtype == want.dtype.newbyteorder("=")
    assert np.array_equal(got, want)


def test_h5_groups(tmp_path):
    rng = np.random.default_rng(16)
    path = tmp_path / "g.h5"
    with h5py.File(path, "w") as f:
        for i in range(30):
            f[f"x{i}"] = np.arange(i + 1)
        f.create_group("a/b")["depth"] = rng.random((5, 6)).astype("f4")
    for name in ("x17", "a/b/depth"):
        assert np.array_equal(codecs.read_h5_dataset(path, name),
                              h5_read(path, name))
    with pytest.raises(KeyError, match="nothing"):
        codecs.read_h5_dataset(path, "a/nothing")


def test_h5_refusals(tmp_path):
    data = np.ones((10, 10), np.float32)
    path = tmp_path / "v4.h5"
    with h5py.File(path, "w", libver="latest") as f:
        f.create_dataset("depth", data=data, chunks=(5, 5))
    with pytest.raises(NotImplementedError, match="layout message version 4"):
        codecs.read_h5_dataset(path, "depth")
    path = tmp_path / "lzf.h5"
    with h5py.File(path, "w") as f:
        f.create_dataset("depth", data=data, chunks=(5, 5),
                         compression="lzf")
    with pytest.raises(NotImplementedError, match="filter 32000"):
        codecs.read_h5_dataset(path, "depth")


# ---------------------------------------------------------------- fixtures


def _digest(arr):
    arr = np.ascontiguousarray(arr)
    arr = arr.astype(arr.dtype.newbyteorder("="))
    return {"shape": list(arr.shape), "dtype": str(arr.dtype),
            "sha256": hashlib.sha256(arr.tobytes()).hexdigest()}


def test_committed_fixtures_match_their_manifest():
    with open(os.path.join(FIXTURES, "manifest.json")) as f:
        manifest = json.load(f)
    assert len(manifest) >= 35
    for rel, want in manifest.items():
        path = os.path.join(FIXTURES, rel)
        if "refused" in want:
            with pytest.raises(ValueError, match=want["refused"].replace(
                    "(", "\\(").replace(")", "\\)")):
                codecs.imread(path)
            continue
        for mode, entry in want.items():
            got = (codecs.read_h5_dataset(path, mode) if rel.endswith(".h5")
                   else codecs.imread(path, MODES[mode]))
            assert _digest(got) == entry, (rel, mode)


def test_grown_contiguous_h5_reads_in_h5py(tmp_path):
    """chip_smoke.contiguous_h5 (a full-size depth file in h5py's default
    layout, grown from the committed small one) writes a file h5py reads
    back as the array, contiguous, and so does the port."""
    from chip_smoke import contiguous_h5
    rng = np.random.default_rng(17)
    data = (rng.random((123, 97)) * 50).astype(np.float32)
    path = tmp_path / "grown.h5"
    contiguous_h5(os.path.join(FIXTURES, "decode", "h5_contiguous.h5"),
                  "depth", data, path)
    with h5py.File(path, "r") as f:
        assert f["depth"].chunks is None
        assert np.array_equal(f["depth"][()], data)
    assert np.array_equal(codecs.read_h5_dataset(path, "depth"), data)
