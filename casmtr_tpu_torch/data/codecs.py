"""Image and HDF5 reading without cv2, PIL or h5py.

``imread(path, mode)`` gives what ``cv2.imread`` gives in its three modes,
except that colour comes as RGB(A), not BGR(A): ``IMREAD_COLOR`` [H, W, 3]
uint8, ``IMREAD_GRAYSCALE`` [H, W] uint8 and ``IMREAD_UNCHANGED`` (the
file's own channels and depth: [H, W], [H, W, 3] or [H, W, 4], uint8 or
uint16).  The format is sniffed from the magic bytes, as cv2 does: JPEG
``FF D8`` (decoded by the host library, ``csrc/host/jpeg_decode.cpp``, to
libjpeg-turbo's default output, the EXIF orientation applied) and PNG
``89 50 4E 47`` (chunks parsed here, the joined IDAT inflated by ``zlib``,
the rows unfiltered by ``csrc/host/png_unfilter.cpp``, and libpng's
conversions as OpenCV asks for them).  Anything else raises ValueError
naming the file; so do the refused variants: arithmetic-coded (SOF9,
SOF10), lossless, hierarchical and 12-bit JPEG, CMYK/YCCK, interlaced
(Adam7) PNG and PNG bit depths below 8 other than palette.  Baseline,
extended-sequential and progressive (SOF2) Huffman JPEG are read.

``read_h5_dataset(path, name)`` reads one dataset of an HDF5 file in pure
Python (``struct``, numpy, ``zlib``): superblock versions 0-3, object
header versions 1 and 2, symbol-table groups (v1 B-tree and local heap)
and link messages, IEEE float and integer datatypes in either byte order,
compact and contiguous layouts, and chunked layout (message version 3)
with a v1 B-tree index and the deflate and shuffle filters.  Anything else
raises NotImplementedError naming what was met.
"""

from __future__ import annotations

import ctypes
import os
import struct
import zlib
from typing import Dict, List, Tuple

import numpy as np

from casmtr_tpu_torch.data import host

IMREAD_UNCHANGED = -1
IMREAD_GRAYSCALE = 0
IMREAD_COLOR = 1
_ERRLEN = 512
_PNG_MAGIC = b"\x89PNG\r\n\x1a\n"


def imread(path, mode: int = IMREAD_COLOR) -> np.ndarray:
    """The image at ``path`` as ``cv2.imread(path, mode)`` reads it, colour
    channels in RGB(A) order.  Raises FileNotFoundError for a missing file
    and ValueError for a format or variant that is not read."""
    path = os.fspath(path)
    if mode not in (IMREAD_UNCHANGED, IMREAD_GRAYSCALE, IMREAD_COLOR):
        raise ValueError(f"unknown imread mode {mode}")
    with open(path, "rb") as f:
        data = f.read()
    if data[:2] == b"\xff\xd8":
        return _jpeg(path, data, mode)
    if data[:8] == _PNG_MAGIC:
        return _png(path, data, mode)
    raise ValueError(f"{path}: not a JPEG or PNG file (magic bytes "
                     f"{data[:8].hex()})")


# ---------------------------------------------------------------- JPEG


def _orient(img: np.ndarray, orientation: int) -> np.ndarray:
    """cv2's ApplyExifOrientation for EXIF values 1-8."""
    if orientation >= 5:
        img = img.swapaxes(0, 1)
    flip = {2: (1,), 3: (0, 1), 4: (0,), 6: (1,), 7: (0, 1), 8: (0,)}
    for axis in flip.get(orientation, ()):
        img = np.flip(img, axis)
    return np.ascontiguousarray(img)


def _jpeg(path: str, data: bytes, mode: int) -> np.ndarray:
    lib = host.lib()
    err = ctypes.create_string_buffer(_ERRLEN)
    info = (ctypes.c_int * 4)()
    if lib.casmtr_jpeg_header(data, len(data), info, err, _ERRLEN):
        raise ValueError(f"{path}: {err.value.decode()}")
    w, h, ncomp, orientation = info
    # cv2: UNCHANGED keeps a gray JPEG gray and reads any other as colour
    gray = mode == IMREAD_GRAYSCALE or (mode == IMREAD_UNCHANGED
                                        and ncomp == 1)
    out = np.empty((h, w) if gray else (h, w, 3), np.uint8)
    if lib.casmtr_jpeg_decode(data, len(data), int(gray),
                              out.ctypes.data, err, _ERRLEN):
        raise ValueError(f"{path}: {err.value.decode()}")
    # cv2 applies the EXIF orientation except in IMREAD_UNCHANGED
    if orientation == 1 or mode == IMREAD_UNCHANGED:
        return out
    return _orient(out, orientation)


# ---------------------------------------------------------------- PNG

_PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _png_chunks(path: str, data: bytes):
    pos, chunks = 8, []
    while pos + 8 <= len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        chunks.append((kind, data[pos + 8:pos + 8 + n]))
        pos += 12 + n
        if kind == b"IEND":
            break
    if not chunks or chunks[0][0] != b"IHDR":
        raise ValueError(f"{path}: PNG without an IHDR chunk")
    return chunks


def _png_samples(path: str, data: bytes):
    """(samples [H, W, C] uint8 or uint16, colour type, bit depth, palette
    [N, 3] or None, tRNS bytes or None)."""
    chunks = _png_chunks(path, data)
    w, h, depth, ctype, _, _, interlace = struct.unpack(">IIBBBBB",
                                                        chunks[0][1])
    if ctype not in _PNG_CHANNELS:
        raise ValueError(f"{path}: PNG colour type {ctype}")
    if interlace:
        raise ValueError(f"{path}: interlaced (Adam7) PNG is not supported")
    if depth < 8 and ctype != 3:
        raise ValueError(f"{path}: PNG bit depth {depth} (colour type "
                         f"{ctype}) is not supported; palette images "
                         "may have 1, 2 or 4 bits")
    plte = b"".join(c for k, c in chunks if k == b"PLTE") or None
    trns = b"".join(c for k, c in chunks if k == b"tRNS") or None
    raw = zlib.decompress(b"".join(c for k, c in chunks if k == b"IDAT"))
    ch = _PNG_CHANNELS[ctype]
    rowbytes = (w * ch * depth + 7) // 8
    if len(raw) < h * (rowbytes + 1):
        raise ValueError(f"{path}: PNG image data is truncated")
    rows = np.empty((h, rowbytes), np.uint8)
    err = ctypes.create_string_buffer(_ERRLEN)
    if host.lib().casmtr_png_unfilter(raw, h, rowbytes,
                                      max(1, ch * depth // 8),
                                      rows.ctypes.data, err, _ERRLEN):
        raise ValueError(f"{path}: {err.value.decode()}")
    if depth == 16:
        samples = rows.view(">u2").astype(np.uint16).reshape(h, w, ch)
    elif depth == 8:
        samples = rows.reshape(h, w, ch)
    else:  # palette indices packed MSB first
        bits = np.unpackbits(rows, axis=1).reshape(h, -1, depth)
        weights = 1 << np.arange(depth - 1, -1, -1, dtype=np.uint8)
        samples = (bits[:, :w] * weights).sum(-1, dtype=np.uint8)[..., None]
    palette = None
    if ctype == 3:
        if plte is None:
            raise ValueError(f"{path}: palette PNG without a PLTE chunk")
        palette = np.frombuffer(plte, np.uint8).reshape(-1, 3)
    return samples, ctype, depth, palette, trns


def _png(path: str, data: bytes, mode: int) -> np.ndarray:
    s, ctype, depth, palette, trns = _png_samples(path, data)
    # OpenCV's channel count for the file: colour types with alpha, and
    # RGB or palette with a tRNS chunk, read as 4 channels; gray as 1
    four = ctype in (4, 6) or (ctype in (2, 3) and trns is not None)
    if mode == IMREAD_UNCHANGED:
        out_ch = 4 if four else (1 if ctype == 0 else 3)
    else:
        out_ch = 3 if mode == IMREAD_COLOR else 1
    wide = np.uint16 if depth == 16 else np.uint8
    maxval = 65535 if depth == 16 else 255
    # libpng: palette (and its tRNS) expanded, tRNS to alpha if 4 channels
    if ctype == 3:
        idx = s[..., 0]
        rgb = palette[np.minimum(idx, len(palette) - 1)]
        if out_ch == 4:
            alpha = np.full(256, 255, np.uint8)
            alpha[:len(trns)] = np.frombuffer(trns, np.uint8)
            rgb = np.concatenate([rgb, alpha[idx][..., None]], -1)
        s, ctype = rgb, (6 if out_ch == 4 else 2)
    elif ctype == 2 and out_ch == 4:
        key = np.array(struct.unpack(">HHH", trns[:6]), wide)
        alpha = np.where((s == key).all(-1), 0, maxval).astype(wide)
        s, ctype = np.concatenate([s, alpha[..., None]], -1), 6
    # strip alpha below 4 channels
    if out_ch < 4 and ctype in (4, 6):
        s, ctype = s[..., :-1], (0 if ctype == 4 else 2)
    if out_ch == 1 and ctype == 2:
        s = _rgb_to_gray(s, depth)
    elif out_ch >= 3 and ctype in (0, 4):
        s = np.concatenate([s[..., :1]] * 3 + [s[..., 1:]], -1)
    if depth == 16 and mode != IMREAD_UNCHANGED:
        s = (s >> 8).astype(np.uint8)
    s = np.ascontiguousarray(s)
    return s[..., 0] if s.shape[-1] == 1 else s


def _rgb_to_gray(s: np.ndarray, depth: int) -> np.ndarray:
    """libpng's png_do_rgb_to_gray with OpenCV's weights (0.299, 0.587)
    and no gamma: 15-bit fixed point, truncated in 8 bits and rounded in
    16; a pixel whose three samples agree keeps its value."""
    rc = 29900 * 32768 // 100000
    gc = 58700 * 32768 // 100000
    bc = 32768 - rc - gc
    c = s.astype(np.int64)
    r, g, b = c[..., 0], c[..., 1], c[..., 2]
    if depth == 16:
        y = (rc * r + gc * g + bc * b + 16384) >> 15
    else:
        y = np.where((r == g) & (r == b), r, (rc * r + gc * g + bc * b) >> 15)
    return y.astype(s.dtype)[..., None]


# ---------------------------------------------------------------- HDF5

_UNDEF = 0xFFFFFFFFFFFFFFFF
_HDF5_MAGIC = b"\x89HDF\r\n\x1a\n"


class _H5:
    """An HDF5 file's bytes and the sizes its superblock declares."""

    def __init__(self, path: str):
        self.path = path
        with open(path, "rb") as f:
            self.b = f.read()
        at = 0
        while self.b[at:at + 8] != _HDF5_MAGIC:
            at = 512 if at == 0 else at * 2
            if at >= len(self.b):
                raise ValueError(f"{path}: not an HDF5 file")
        v = self.b[at + 8]
        if v in (0, 1):
            self.so, self.sl = self.b[at + 13], self.b[at + 14]
            p = at + 24 + (4 if v == 1 else 0)
            self.base = self.uint(p, self.so)
            # root group symbol table entry: link name offset, header
            self.root = self.uint(p + 4 * self.so + self.so, self.so)
        elif v in (2, 3):
            self.so, self.sl = self.b[at + 9], self.b[at + 10]
            p = at + 12
            self.base = self.uint(p, self.so)
            self.root = self.uint(p + 3 * self.so, self.so)
        else:
            raise NotImplementedError(f"{path}: HDF5 superblock version {v}")

    def uint(self, pos: int, n: int) -> int:
        return int.from_bytes(self.b[pos:pos + n], "little")

    def addr(self, a: int) -> int:
        return a + self.base

    def undefined(self, a: int) -> bool:
        return a == (1 << (8 * self.so)) - 1

    # -- object headers: [(type, flags, body bytes)]
    def messages(self, addr: int) -> List[Tuple[int, int, bytes]]:
        p = self.addr(addr)
        out: List[Tuple[int, int, bytes]] = []
        if self.b[p:p + 4] == b"OHDR":
            flags = self.b[p + 5]
            q = p + 6 + (16 if flags & 0x20 else 0) + (4 if flags & 0x10
                                                       else 0)
            width = 1 << (flags & 3)
            size = self.uint(q, width)
            blocks = [(q + width, q + width + size)]
            while blocks:
                start, end = blocks.pop(0)
                q = start
                while q + 4 + (2 if flags & 0x04 else 0) <= end:
                    mtype, msize, mflags = (self.b[q],
                                            self.uint(q + 1, 2),
                                            self.b[q + 3])
                    q += 4 + (2 if flags & 0x04 else 0)
                    body = self.b[q:q + msize]
                    q += msize
                    if mtype == 0x10:
                        c = self.addr(int.from_bytes(body[:self.so],
                                                     "little"))
                        n = int.from_bytes(body[self.so:self.so + self.sl],
                                           "little")
                        # OCHK signature, messages, checksum
                        blocks.append((c + 4, c + n - 4))
                    else:
                        out.append((mtype, mflags, body))
            return out
        if self.b[p] != 1:
            raise NotImplementedError(f"{self.path}: object header version "
                                      f"{self.b[p]}")
        n_msgs = self.uint(p + 2, 2)
        blocks = [(p + 16, p + 16 + self.uint(p + 8, 4))]
        while blocks and len(out) < n_msgs:
            start, end = blocks.pop(0)
            q = start
            while q + 8 <= end and len(out) < n_msgs:
                mtype, msize, mflags = (self.uint(q, 2), self.uint(q + 2, 2),
                                        self.b[q + 4])
                body = self.b[q + 8:q + 8 + msize]
                q += 8 + msize
                if mtype == 0x10:
                    c = self.addr(int.from_bytes(body[:self.so], "little"))
                    n = int.from_bytes(body[self.so:self.so + self.sl],
                                       "little")
                    blocks.append((c, c + n))
                    n_msgs -= 1
                else:
                    out.append((mtype, mflags, body))
        return out

    # -- groups
    def links(self, addr: int) -> Dict[str, int]:
        """name -> object header address of a group's hard links."""
        out: Dict[str, int] = {}
        for mtype, _, body in self.messages(addr):
            if mtype == 0x11:  # symbol table: v1 B-tree + local heap
                btree = int.from_bytes(body[:self.so], "little")
                heap = int.from_bytes(body[self.so:2 * self.so], "little")
                self._symbol_nodes(btree, heap, out)
            elif mtype == 0x06:
                name, target = self._link(body)
                if target is not None:
                    out[name] = target
            elif mtype == 0x02:  # link info: dense storage in a fractal heap
                flags = body[1]
                p = 2 + (8 if flags & 1 else 0)
                if not self.undefined(int.from_bytes(body[p:p + self.so],
                                                     "little")):
                    raise NotImplementedError(
                        f"{self.path}: a group with dense link storage "
                        "(fractal heap)")
        return out

    def _link(self, body: bytes):
        flags = body[1]
        p = 2
        ltype = 0
        if flags & 0x08:
            ltype = body[p]
            p += 1
        if flags & 0x04:
            p += 8
        if flags & 0x10:
            p += 1
        width = 1 << (flags & 3)
        n = int.from_bytes(body[p:p + width], "little")
        p += width
        name = body[p:p + n].decode()
        if ltype != 0:   # soft and external links are not followed
            return name, None
        return name, int.from_bytes(body[p + n:p + n + self.so], "little")

    def _symbol_nodes(self, btree: int, heap: int, out: Dict[str, int]):
        h = self.addr(heap)
        if self.b[h:h + 4] != b"HEAP":
            raise NotImplementedError(f"{self.path}: a local heap without "
                                      "its signature")
        data = self.addr(self.uint(h + 8 + 2 * self.sl, self.so))
        for child in self._btree_children(btree, 0):
            s = self.addr(child)
            if self.b[s:s + 4] != b"SNOD":
                raise NotImplementedError(f"{self.path}: a symbol table "
                                          "node without its signature")
            entry = 2 * self.so + 24
            for i in range(self.uint(s + 6, 2)):
                e = s + 8 + i * entry
                off = self.uint(e, self.so)
                end = self.b.index(b"\0", data + off)
                out[self.b[data + off:end].decode()] = self.uint(
                    e + self.so, self.so)

    def _btree_children(self, addr: int, node_type: int, key_size=None):
        """The level-0 children of a v1 B-tree (with the key before each
        child when ``key_size`` is given)."""
        p = self.addr(addr)
        if self.b[p:p + 4] != b"TREE" or self.b[p + 4] != node_type:
            raise NotImplementedError(f"{self.path}: a v1 B-tree node of "
                                      f"another type at {addr}")
        level, used = self.b[p + 5], self.uint(p + 6, 2)
        ksize = self.sl if node_type == 0 else key_size
        q = p + 8 + 2 * self.so
        for _ in range(used):
            key = self.b[q:q + ksize]
            child = self.uint(q + ksize, self.so)
            q += ksize + self.so
            if level > 0:
                yield from self._btree_children(child, node_type, key_size)
            elif key_size is None:
                yield child
            else:
                yield key, child

    # -- datasets
    def dataset(self, addr: int) -> np.ndarray:
        shape = dtype = layout = None
        filters: List[Tuple[int, Tuple[int, ...]]] = []
        for mtype, mflags, body in self.messages(addr):
            if mflags & 0x02 and mtype in (0x01, 0x03, 0x08, 0x0B):
                raise NotImplementedError(f"{self.path}: a shared message "
                                          f"of type {mtype:#x}")
            if mtype == 0x01:
                shape = self._dataspace(body)
            elif mtype == 0x03:
                dtype = self._datatype(body)
            elif mtype == 0x08:
                layout = body
            elif mtype == 0x0B:
                filters = self._filters(body)
        if shape is None or dtype is None or layout is None:
            raise NotImplementedError(f"{self.path}: object at {addr} is "
                                      "not a dataset")
        return self._read(layout, shape, dtype, filters)

    def _dataspace(self, body: bytes) -> Tuple[int, ...]:
        v, rank = body[0], body[1]
        if v == 1:
            p = 8
        elif v == 2:
            if body[3] == 2:
                raise NotImplementedError(f"{self.path}: a null dataspace")
            p = 4
        else:
            raise NotImplementedError(f"{self.path}: dataspace message "
                                      f"version {v}")
        return tuple(int.from_bytes(body[p + i * self.sl:p + (i + 1)
                                         * self.sl], "little")
                     for i in range(rank))

    def _datatype(self, body: bytes) -> np.dtype:
        cls, bits = body[0] & 15, body[1]
        size = struct.unpack("<I", body[4:8])[0]
        order = ">" if bits & 1 else "<"
        if cls == 0 and size in (1, 2, 4, 8):
            return np.dtype(f"{order}{'i' if bits & 8 else 'u'}{size}")
        if cls == 1 and size in (2, 4, 8) and not bits & 0x40:
            return np.dtype(f"{order}f{size}")
        raise NotImplementedError(f"{self.path}: datatype class {cls} of "
                                  f"{size} bytes")

    def _filters(self, body: bytes) -> List[Tuple[int, Tuple[int, ...]]]:
        v, n = body[0], body[1]
        p = 8 if v == 1 else 2
        out = []
        for _ in range(n):
            fid, = struct.unpack("<H", body[p:p + 2])
            if v == 1 or fid >= 256:
                name_len, = struct.unpack("<H", body[p + 2:p + 4])
                p += 2
            else:
                name_len = 0
            n_vals, = struct.unpack("<H", body[p + 4:p + 6])
            p += 6
            p += ((name_len + 7) // 8 * 8) if v == 1 else name_len
            vals = struct.unpack(f"<{n_vals}I", body[p:p + 4 * n_vals])
            p += 4 * n_vals + (4 if v == 1 and n_vals % 2 else 0)
            if fid not in (1, 2):
                raise NotImplementedError(f"{self.path}: HDF5 filter {fid} "
                                          "(only deflate 1 and shuffle 2)")
            out.append((fid, vals))
        return out

    def _read(self, layout: bytes, shape, dtype: np.dtype, filters):
        v, cls = layout[0], layout[1]
        count = int(np.prod(shape, dtype=np.int64))
        if v not in (3, 4) or (cls == 2 and v != 3):
            raise NotImplementedError(
                f"{self.path}: data layout message version {v} (class "
                f"{cls}); chunked data is read from version 3 only")
        if cls == 0:
            n, = struct.unpack("<H", layout[2:4])
            raw = layout[4:4 + n]
        elif cls == 1:
            a = int.from_bytes(layout[2:2 + self.so], "little")
            if self.undefined(a):
                return np.zeros(shape, dtype.newbyteorder("="))
            p = self.addr(a)
            raw = self.b[p:p + count * dtype.itemsize]
        elif cls == 2:
            return self._chunked(layout, shape, dtype, filters)
        else:
            raise NotImplementedError(f"{self.path}: layout class {cls}")
        arr = np.frombuffer(raw, dtype, count).reshape(shape)
        return arr.astype(dtype.newbyteorder("="))

    def _chunked(self, layout: bytes, shape, dtype: np.dtype, filters):
        ndims = layout[2]
        btree = int.from_bytes(layout[3:3 + self.so], "little")
        p = 3 + self.so
        dims = struct.unpack(f"<{ndims}I", layout[p:p + 4 * ndims])
        chunk, rank = dims[:-1], ndims - 1
        out = np.zeros(shape, dtype)
        if self.undefined(btree):
            return out.astype(dtype.newbyteorder("="))
        csize = int(np.prod(chunk)) * dtype.itemsize
        for key, child in self._btree_children(btree, 1, 8 + 8 * ndims):
            nbytes, mask = struct.unpack("<II", key[:8])
            offs = struct.unpack(f"<{ndims}Q", key[8:])[:rank]
            q = self.addr(child)
            raw = self.b[q:q + nbytes]
            for i, (fid, vals) in reversed(list(enumerate(filters))):
                if mask & (1 << i):
                    continue
                if fid == 1:
                    raw = zlib.decompress(raw)
                else:
                    size = vals[0] if vals else dtype.itemsize
                    a = np.frombuffer(raw, np.uint8)
                    n = len(a) // size
                    raw = (a[:n * size].reshape(size, n).T.tobytes()
                           + a[n * size:].tobytes())
            if len(raw) != csize:
                raise ValueError(f"{self.path}: a chunk of {len(raw)} bytes"
                                 f", expected {csize}")
            block = np.frombuffer(raw, dtype).reshape(chunk)
            sl = tuple(slice(o, min(o + c, s))
                       for o, c, s in zip(offs, chunk, shape))
            out[sl] = block[tuple(slice(0, x.stop - x.start) for x in sl)]
        return out.astype(dtype.newbyteorder("="))


def read_h5_dataset(path, name: str) -> np.ndarray:
    """The dataset ``name`` (a path of groups, such as "depth" or
    "a/b/depth") of the HDF5 file at ``path``, in native byte order."""
    path = os.fspath(path)
    f = _H5(path)
    addr = f.root
    for part in [p for p in name.split("/") if p]:
        links = f.links(addr)
        if part not in links:
            raise KeyError(f"{path}: no object {part!r} in {name!r}")
        addr = links[part]
    return f.dataset(addr)
