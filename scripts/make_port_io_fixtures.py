#!/usr/bin/env python3
"""Write the file fixtures of the PyTorch port's readers into
tests/data/port_io/ (seeded; needs numpy, cv2, PIL and h5py, which the
port itself never imports):

* ``decode/``: small JPEG, PNG and HDF5 files, one per case the readers
  must take (4:4:4, 4:2:2, 4:2:0, 4:4:0 and gray JPEG at odd sizes, two
  qualities, a restart interval, EXIF orientations 3, 6 and 8, an Adobe
  RGB file, 16-bit quantization tables; 8-bit gray, RGB, RGBA and palette
  PNG and 16-bit gray PNG; contiguous and deflate+shuffle chunked HDF5),
  and progressive JPEG: 4:2:0 from PIL (67x45), 4:4:4, gray, 4:2:0 with a
  restart interval and an odd 23x13 from cv2, and the MegaDepth scene's
  first view (1200x800) re-encoded progressive by PIL;
* ``megadepth/``: a scene in MegaDepth's layout (index/scene_info/0000.npz
  with image_paths, depth_paths, intrinsics, poses and pair_infos, and the
  list file index/list.txt): 4 views, 1200x800 JPEG 4:2:0, of a textured
  piecewise-planar scene (a ground plane and two facades) with known K and
  world-to-camera poses, and their ``depth`` h5 files (metres, quantized to
  1/256 m, chunked with shuffle and deflate);
* ``scannet/``: a scene in ScanNet's layout (scans/scene0000_00/color/*.jpg
  at 1296x968, depth/*.png 16-bit millimetres at 640x480, pose/*.txt
  camera-to-world; index/scene0000_00.npz, index/intrinsics.npz,
  index/list.txt) of a textured room: 3 frames;
* ``manifest.json``: for each file and each read mode, the shape, dtype
  and sha256 of what cv2.imread (channels reordered to RGB(A)) or h5py
  gives.

Run from the root of the repository:

    python scripts/make_port_io_fixtures.py

The output is the same bit for bit on every run, apart from what another
version of the JPEG encoder writes.
"""

import hashlib
import io
import json
import os
import shutil
import sys

import cv2
import h5py
import numpy as np
from PIL import Image

OUT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "tests", "data", "port_io")
MODES = {"color": cv2.IMREAD_COLOR, "gray": cv2.IMREAD_GRAYSCALE,
         "unchanged": cv2.IMREAD_UNCHANGED}


def rgb_order(img):
    """cv2's BGR(A) result in RGB(A) order."""
    if img.ndim == 3:
        img = img[..., [2, 1, 0, 3][:img.shape[2]]]
    return np.ascontiguousarray(img)


def entry(arr):
    arr = np.ascontiguousarray(arr)
    arr = arr.astype(arr.dtype.newbyteorder("="))
    return {"shape": list(arr.shape), "dtype": str(arr.dtype),
            "sha256": hashlib.sha256(arr.tobytes()).hexdigest()}


def smooth_noise(rng, h, w, c=3):
    y, x = np.mgrid[0:h, 0:w]
    img = np.stack([128 + 100 * np.sin(x / 7.0 + k) * np.cos(y / 11.0 + 2 * k)
                    for k in range(c)], -1)
    img += rng.normal(0, 20, img.shape)
    img = np.clip(img, 0, 255).astype(np.uint8)
    return img if c > 1 else img[..., 0]


def save_pil(path, img, **kw):
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "JPEG", **kw)
    with open(path, "wb") as f:
        f.write(buf.getvalue())


def save_cv2(path, img, params):
    ok, enc = cv2.imencode(os.path.splitext(path)[1], img, params)
    assert ok
    with open(path, "wb") as f:
        f.write(enc.tobytes())


def latest_h5(path):
    """h5py's ``libver="latest"`` file (superblock 3, object header 2)
    with no timestamps in its root group, so that it is the same on every
    run."""
    fapl = h5py.h5p.create(h5py.h5p.FILE_ACCESS)
    fapl.set_libver_bounds(h5py.h5f.LIBVER_LATEST, h5py.h5f.LIBVER_LATEST)
    fcpl = h5py.h5p.create(h5py.h5p.FILE_CREATE)
    fcpl.set_obj_track_times(False)
    return h5py.File(h5py.h5f.create(path.encode(), h5py.h5f.ACC_TRUNC,
                                     fcpl=fcpl, fapl=fapl))


def decode_cases(rng, d):
    os.makedirs(d)
    big, small, tiny = (45, 67), (9, 17), (1, 1)
    for sub, name in (("4:4:4", "444"), ("4:2:2", "422"), ("4:2:0", "420")):
        for q in (50, 95):
            save_pil(f"{d}/jpeg_{name}_q{q}_67x45.jpg",
                     smooth_noise(rng, *big), quality=q, subsampling=sub)
    save_pil(f"{d}/jpeg_420_q90_17x9.jpg", smooth_noise(rng, *small),
             quality=90, subsampling="4:2:0")
    save_pil(f"{d}/jpeg_420_q90_1x1.jpg", smooth_noise(rng, *tiny),
             quality=90, subsampling="4:2:0")
    save_cv2(f"{d}/jpeg_440_q80_67x45.jpg", smooth_noise(rng, *big),
             [cv2.IMWRITE_JPEG_QUALITY, 80,
              cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
              cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440])
    save_pil(f"{d}/jpeg_gray_q75_67x45.jpg", smooth_noise(rng, *big, c=1),
             quality=75)
    save_cv2(f"{d}/jpeg_420_restart2_67x45.jpg", smooth_noise(rng, *big),
             [cv2.IMWRITE_JPEG_QUALITY, 85, cv2.IMWRITE_JPEG_RST_INTERVAL, 2])
    for o in (3, 6, 8):
        exif = Image.Exif()
        exif[0x0112] = o
        save_pil(f"{d}/jpeg_420_exif{o}_67x45.jpg", smooth_noise(rng, *big),
                 quality=90, exif=exif.tobytes())
    save_pil(f"{d}/jpeg_adobe_rgb_67x45.jpg", smooth_noise(rng, *big),
             quality=90, keep_rgb=True)
    save_pil(f"{d}/jpeg_dqt16_67x45.jpg", smooth_noise(rng, *big),
             qtables=[list(range(300, 364)), list(range(2, 66))])
    save_pil(f"{d}/jpeg_progressive_67x45.jpg", smooth_noise(rng, *big),
             quality=90, progressive=True)

    Image.fromarray(smooth_noise(rng, *big, c=1)).save(f"{d}/png_gray8.png")
    Image.fromarray(smooth_noise(rng, *big)).save(f"{d}/png_rgb8.png")
    rgba = np.concatenate([smooth_noise(rng, *big),
                           smooth_noise(rng, *big, c=1)[..., None]], -1)
    Image.fromarray(rgba).save(f"{d}/png_rgba8.png")
    Image.fromarray(smooth_noise(rng, *big)).quantize(37).save(
        f"{d}/png_palette8.png")
    cv2.imwrite(f"{d}/png_gray16.png",
                rng.integers(0, 65536, big).astype(np.uint16))

    depth = (rng.random((37, 29)) * 50).astype(np.float32)
    with h5py.File(f"{d}/h5_contiguous.h5", "w") as f:
        f.create_dataset("depth", data=depth, track_times=False)
    with latest_h5(f"{d}/h5_latest_contiguous.h5") as f:
        f.create_dataset("depth", data=depth[::-1], track_times=False)
    with h5py.File(f"{d}/h5_chunked_shuffle_gzip.h5", "w") as f:
        f.create_dataset("depth", data=depth.T, chunks=(8, 16),
                         compression="gzip", shuffle=True, track_times=False)


def progressive_cases(rng, d, megadepth_root):
    """Progressive JPEG from cv2 and PIL, drawn from their own ``rng`` so
    that the other fixtures stay as they were."""
    big, odd = (45, 67), (13, 23)
    prog = [cv2.IMWRITE_JPEG_PROGRESSIVE, 1]
    save_cv2(f"{d}/jpeg_progressive_444_q85_67x45.jpg",
             smooth_noise(rng, *big), prog + [
                 cv2.IMWRITE_JPEG_QUALITY, 85,
                 cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                 cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444])
    save_pil(f"{d}/jpeg_progressive_gray_q75_67x45.jpg",
             smooth_noise(rng, *big, c=1), quality=75, progressive=True)
    save_cv2(f"{d}/jpeg_progressive_420_restart3_67x45.jpg",
             smooth_noise(rng, *big), prog + [
                 cv2.IMWRITE_JPEG_QUALITY, 90,
                 cv2.IMWRITE_JPEG_RST_INTERVAL, 3])
    save_cv2(f"{d}/jpeg_progressive_420_q90_23x13.jpg",
             smooth_noise(rng, *odd), prog + [cv2.IMWRITE_JPEG_QUALITY, 90])
    view = cv2.imread(os.path.join(
        megadepth_root, "Undistorted_SfM/0000/images/0000.jpg"))
    save_pil(f"{d}/jpeg_progressive_420_1200x800.jpg",
             np.ascontiguousarray(view[..., ::-1]), quality=90,
             progressive=True, subsampling="4:2:0")


# ---- rendering of piecewise-planar scenes


def look_at(center, target, down=(0.0, 1.0, 0.0)):
    """World-to-camera [4, 4] of a camera at ``center`` looking at
    ``target`` (x right, y down, z forward; the world's y points down)."""
    z = np.asarray(target, float) - center
    z /= np.linalg.norm(z)
    x = np.cross(down, z)
    x /= np.linalg.norm(x)
    y = np.cross(z, x)
    R = np.stack([x, y, z])
    T = np.eye(4)
    T[:3, :3], T[:3, 3] = R, -R @ center
    return T


def texture(rng, n_planes):
    """A texture function per plane: sums of sinusoids and soft blobs of
    the plane's 2D coordinates (metres), RGB in [0, 1]."""
    params = []
    for _ in range(n_planes):
        params.append((rng.uniform(2, 12, (3, 4, 2)) * rng.choice([-1, 1],
                                                                   (3, 4, 2)),
                       rng.uniform(0, 6, (3, 4)),
                       rng.uniform(-4, 4, (24, 2)), rng.uniform(0.05, 0.3, 24),
                       rng.uniform(0, 1, (24, 3))))

    def tex(k, u, v):
        freq, phase, centers, radii, colors = params[k]
        out = np.zeros(u.shape + (3,))
        for c in range(3):
            out[..., c] = sum(np.sin(freq[c, i, 0] * u + freq[c, i, 1] * v
                                     + phase[c, i]) for i in range(4)) / 8
        for (cu, cv), r, col in zip(centers, radii, colors):
            wgt = np.exp(-((u - cu) ** 2 + (v - cv) ** 2) / (2 * r * r))
            out += wgt[..., None] * (col - 0.5)
        return np.clip(out + 0.5, 0, 1)

    return tex


def render(planes, tex, K, T, h, w):
    """(RGB uint8 [h, w, 3], depth [h, w] metres, 0 where nothing is hit)
    of the planes (point, normal, u axis) seen by K and world-to-camera
    T."""
    R, t = T[:3, :3], T[:3, 3]
    center = -R.T @ t
    yy, xx = np.mgrid[0:h, 0:w].astype(float)
    rays_c = np.stack([xx + 0.5, yy + 0.5, np.ones_like(xx)], -1) @ \
        np.linalg.inv(K).T
    rays_w = rays_c @ R   # R^T applied to each ray
    best = np.full((h, w), np.inf)
    img = np.zeros((h, w, 3))
    for k, (p0, n, uax) in enumerate(planes):
        p0, n, uax = (np.asarray(a, float) for a in (p0, n, uax))
        denom = rays_w @ n
        with np.errstate(divide="ignore", invalid="ignore"):
            s = ((p0 - center) @ n) / denom
        hit = (s > 1e-6) & (s < best)
        pts = center + rays_w * s[..., None]
        vax = np.cross(n, uax)
        rel = pts - p0
        u, v = rel @ uax, rel @ vax
        hit &= (np.abs(u) < 12) & (np.abs(v) < 12)
        col = tex(k, u, v)
        img[hit] = col[hit]
        best[hit] = s[hit]
    depth = np.where(np.isfinite(best), best * rays_c[..., 2], 0.0)
    return (img * 255 + 0.5).astype(np.uint8), depth


def megadepth_scene(rng, root):
    """4 views of a ground plane and two facades, 1200x800."""
    h, w = 800, 1200
    K = np.array([[1000.0, 0, w / 2], [0, 1000.0, h / 2], [0, 0, 1]])
    planes = [((0, 2.0, 0), (0, -1, 0), (1, 0, 0)),            # ground
              ((0, 0, 8.0), (0, 0, -1), (1, 0, 0)),            # facade
              ((-4.0, 0, 6.0), (0.8, 0, -0.6), (0.6, 0, 0.8))]  # side wall
    tex = texture(rng, len(planes))
    img_dir = "Undistorted_SfM/0000/images"
    dep_dir = "phoenix/S6/zl548/MegaDepth_v1/0000/dense0/depths"
    os.makedirs(os.path.join(root, img_dir))
    os.makedirs(os.path.join(root, dep_dir))
    os.makedirs(os.path.join(root, "index", "scene_info"))
    image_paths, depth_paths, intrinsics, poses = [], [], [], []
    for i in range(4):
        center = np.array([-0.6 + 0.4 * i, -0.2 + 0.1 * (i % 2), -1.0 + 0.2 * i])
        T = look_at(center, (0.3 * i - 0.4, 0.3, 7.0))
        img, depth = render(planes, tex, K, T, h, w)
        ip, dp = f"{img_dir}/{i:04d}.jpg", f"{dep_dir}/{i:04d}.h5"
        save_pil(os.path.join(root, ip), img, quality=80, subsampling="4:2:0")
        depth = (np.round(depth * 256) / 256).astype(np.float32)
        with h5py.File(os.path.join(root, dp), "w") as f:
            f.create_dataset("depth", data=depth, chunks=(100, 100),
                             compression="gzip", compression_opts=9,
                             shuffle=True, track_times=False)
        image_paths.append(ip)
        depth_paths.append(dp)
        intrinsics.append(K)
        poses.append(T)
    pairs = [(i, j) for i in range(4) for j in range(i + 1, 4)]
    pair_infos = np.array([((i, j), 0.6 - 0.1 * (j - i), None)
                           for i, j in pairs], dtype=object)
    np.savez(os.path.join(root, "index", "scene_info", "0000.npz"),
             image_paths=np.array(image_paths),
             depth_paths=np.array(depth_paths),
             intrinsics=np.array(intrinsics), poses=np.array(poses),
             pair_infos=pair_infos)
    with open(os.path.join(root, "index", "list.txt"), "w") as f:
        f.write("0000\n")
    return [*image_paths], [*depth_paths]


def scannet_scene(rng, root):
    """3 frames of a textured room: colour 1296x968, depth 640x480 mm."""
    scene = "scene0000_00"
    K = np.array([[577.6, 0, 318.9], [0, 578.7, 242.7], [0, 0, 1]])
    Kc = K * np.array([[1296 / 640], [968 / 480], [1]])
    planes = [((0, 1.4, 0), (0, -1, 0), (1, 0, 0)),      # floor
              ((0, 0, 3.5), (0, 0, -1), (1, 0, 0)),      # back wall
              ((-2.0, 0, 0), (1, 0, 0), (0, 0, 1)),      # left wall
              ((2.2, 0, 0), (-1, 0, 0), (0, 0, 1))]      # right wall
    tex = texture(rng, len(planes))
    sdir = os.path.join(root, "scans", scene)
    for sub in ("color", "depth", "pose"):
        os.makedirs(os.path.join(sdir, sub))
    os.makedirs(os.path.join(root, "index"))
    stems = []
    for i in range(3):
        center = np.array([-0.3 + 0.25 * i, 0.0, -0.5 + 0.1 * i])
        T = look_at(center, (0.2 * i - 0.2, 0.4, 3.5))
        img, _ = render(planes, tex, Kc, T, 968, 1296)
        _, depth = render(planes, tex, K, T, 480, 640)
        save_pil(os.path.join(sdir, "color", f"{i}.jpg"), img, quality=80)
        cv2.imwrite(os.path.join(sdir, "depth", f"{i}.png"),
                    np.round(depth * 1000).astype(np.uint16))
        np.savetxt(os.path.join(sdir, "pose", f"{i}.txt"), np.linalg.inv(T),
                   delimiter=" ")
        stems.append(i)
    names = np.array([(0, 0, 0, 1), (0, 0, 1, 2), (0, 0, 0, 2)])
    np.savez(os.path.join(root, "index", f"{scene}.npz"), name=names,
             score=np.array([0.6, 0.6, 0.5]))
    np.savez(os.path.join(root, "index", "intrinsics.npz"), **{scene: K})
    with open(os.path.join(root, "index", "list.txt"), "w") as f:
        f.write(f"{scene}\n")
    return ([f"scans/{scene}/color/{i}.jpg" for i in stems],
            [f"scans/{scene}/depth/{i}.png" for i in stems])


def manifest_entries(path, kind):
    if kind == "h5":
        with h5py.File(path, "r") as f:
            return {"depth": entry(np.asarray(f["depth"]))}
    modes = MODES if kind == "png" else {k: MODES[k] for k in ("color",
                                                               "gray")}
    return {m: entry(rgb_order(cv2.imread(path, flag)))
            for m, flag in modes.items()}


def main():
    if os.path.exists(OUT):
        shutil.rmtree(OUT)
    rng = np.random.default_rng(20261018)
    decode_cases(rng, os.path.join(OUT, "decode"))
    md_images, md_depths = megadepth_scene(rng, os.path.join(OUT,
                                                             "megadepth"))
    sn_images, sn_depths = scannet_scene(rng, os.path.join(OUT, "scannet"))
    progressive_cases(np.random.default_rng(20261019),
                      os.path.join(OUT, "decode"),
                      os.path.join(OUT, "megadepth"))
    files = sorted(os.path.join("decode", f)
                   for f in os.listdir(os.path.join(OUT, "decode")))
    files += [os.path.join("megadepth", p) for p in md_images + md_depths]
    files += [os.path.join("scannet", p) for p in sn_images + sn_depths]
    manifest = {}
    for rel in files:
        path = os.path.join(OUT, rel)
        kind = os.path.splitext(rel)[1][1:].replace("jpg", "jpeg")
        manifest[rel] = manifest_entries(path, kind)
    with open(os.path.join(OUT, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
    total = sum(os.path.getsize(os.path.join(r, f))
                for r, _, fs in os.walk(OUT) for f in fs)
    print(f"wrote {len(files)} files to {OUT}: {total / 2 ** 20:.2f} MiB")
    return 0


if __name__ == "__main__":
    sys.exit(main())
