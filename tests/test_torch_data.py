"""The port's data layer against the JAX package's, on the CPU, on the same
files (``tests/test_data_layer.make_fake_scene`` and ``make_fake_scannet``,
and the committed fixtures of scripts/make_port_io_fixtures.py):

* ``data/io``: the padding path (the port's host resize against the JAX
  package's native op, both built here with g++) within 1e-6 (bit-equal
  here: the port spells out the multiply-adds GCC fuses in the JAX build
  under -march=native on a CPU with FMA); the uint8
  resize paths (``cv2.resize`` in the JAX package) within 1/255 + 1e-6 on
  every pixel with the share of differing pixels at most RESIZE_SHARE (0:
  the port's resize reproduces OpenCV's 8-bit INTER_LINEAR bit for bit on
  every size tried); depth, pose, scale and K bit-equal;
* ``MegaDepthDataset`` and ``ScanNetDataset``: every key of every sample,
  images as above, the rest bit-equal, in train and test mode;
* ``RandomConcatSampler`` and ``get_local_split``: identical index
  streams over several epochs and settings;
* ``MultiSceneDataModule``: the same splits, the same batches from the
  training loader (its sampler) and the evaluation loader, and the same
  warnings for missing and empty scenes;
* the float32 resize of the serving Matcher (``resize_f32``, the host
  library, and its numpy oracle ``resize_f32_plain``) against
  ``cv2.resize`` within 1e-6 (bit-equal here);
* the resizes refuse what the host library cannot take (not uint8 or not
  float32, not [h, w] or [h, w, c], empty, a canvas smaller than the
  output).
"""

import os
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
cv2 = pytest.importorskip("cv2")
h5py = pytest.importorskip("h5py")

from casmtr_tpu.config import override as jax_override  # noqa: E402
from casmtr_tpu.configs import build_config as jax_build_config  # noqa: E402
from casmtr_tpu.data import io as jio  # noqa: E402
from casmtr_tpu.data import loader as jloader  # noqa: E402
from casmtr_tpu.data.megadepth import MegaDepthDataset as JMega  # noqa: E402
from casmtr_tpu.data.module import \
    MultiSceneDataModule as JModule  # noqa: E402
from casmtr_tpu.data.scannet import ScanNetDataset as JScan  # noqa: E402

from casmtr_tpu_torch.config import override as port_override  # noqa: E402
from casmtr_tpu_torch.configs import build_config  # noqa: E402
from casmtr_tpu_torch.data import io as tio  # noqa: E402
from casmtr_tpu_torch.data import loader as tloader  # noqa: E402
from casmtr_tpu_torch.data.megadepth import MegaDepthDataset  # noqa: E402
from casmtr_tpu_torch.data.module import MultiSceneDataModule  # noqa: E402
from casmtr_tpu_torch.data.scannet import ScanNetDataset  # noqa: E402
from tests.test_data_layer import (make_fake_scannet,  # noqa: E402
                                   make_fake_scene)

PAD_ATOL = 1e-6
U8_ATOL = 1 / 255 + 1e-6
RESIZE_SHARE = 0.0
FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                        "port_io")
IMAGE_KEYS = ("image0", "image1")


def assert_samples_equal(got, want, image_atol, share=None):
    assert set(got) == set(want)
    for k, w in want.items():
        g = got[k]
        if k in IMAGE_KEYS:
            assert g.shape == w.shape and g.dtype == w.dtype, k
            diff = np.abs(g.astype(np.float64) - w)
            assert diff.max() <= image_atol, (k, diff.max())
            if share is not None:
                assert (diff > 0).mean() <= share, (k, (diff > 0).mean())
        elif isinstance(w, np.ndarray):
            assert g.dtype == w.dtype and np.array_equal(g, w), k
        else:
            assert g == w, k


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    d = tmp_path_factory.mktemp("mega")
    return str(d), make_fake_scene(d, "0000", n_images=4, n_pairs=5,
                                   hw=(97, 131))


def test_sizes_and_padding():
    for w, h, r, df in ((800, 600, 400, 64), (1296, 968, 832, 8),
                        (131, 97, None, 32), (97, 131, 64, None)):
        assert tio.get_resized_wh(w, h, r) == jio.get_resized_wh(w, h, r)
        assert tio.get_divisible_wh(w, h, df) == jio.get_divisible_wh(w, h,
                                                                      df)
    x = np.arange(15, dtype=np.float32).reshape(3, 5)
    for a, b in zip(tio.pad_bottom_right(x, 8, True),
                    jio.pad_bottom_right(x, 8, True)):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("gray", [False, True])
@pytest.mark.parametrize("resize,df,pad", [(64, 32, None), (96, 8, 128),
                                           (None, None, None)])
def test_read_megadepth_image_padding(scene, gray, resize, df, pad):
    root, _ = scene
    path = os.path.join(root, "imgs", "0000_1.jpg")
    got = tio.read_megadepth_image(path, resize, df, True, gray, pad)
    want = jio.read_megadepth_image(path, resize, df, True, gray, pad)
    assert np.abs(got[0] - want[0]).max() <= PAD_ATOL
    assert np.array_equal(got[1], want[1]) and np.array_equal(got[2],
                                                              want[2])


@pytest.mark.parametrize("gray", [False, True])
@pytest.mark.parametrize("resize,df", [(64, 32), (100, 8), (None, None),
                                       (262, None)])
def test_read_megadepth_image_resize(scene, gray, resize, df):
    root, _ = scene
    path = os.path.join(root, "imgs", "0000_2.jpg")
    got = tio.read_megadepth_image(path, resize, df, False, gray)
    want = jio.read_megadepth_image(path, resize, df, False, gray)
    assert got[1] is None and want[1] is None
    assert np.array_equal(got[2], want[2])
    diff = np.abs(got[0] - want[0])
    assert diff.max() <= U8_ATOL and (diff > 0).mean() <= RESIZE_SHARE


def test_resize_u8_against_cv2_on_the_fixtures():
    """The uint8 resize at the dataset sizes of the committed scenes and at
    odd sizes, against cv2.resize."""
    img = cv2.imread(os.path.join(
        FIXTURES, "scannet/scans/scene0000_00/color/0.jpg"))
    for wh in ((640, 480), (648, 484), (333, 251), (1296, 968), (7, 5)):
        for src in (img, img[..., 0]):
            diff = np.abs(tio.resize_u8(src, wh).astype(int)
                          - cv2.resize(src, wh).astype(int))
            assert diff.max() <= 1 and (diff > 0).mean() <= RESIZE_SHARE


def test_depth_pose_and_pair_loading(scene, tmp_path):
    root, _ = scene
    d = os.path.join(root, "depths", "0000_0.h5")
    for pad in (None, 200):
        a, b = tio.read_megadepth_depth(d, pad), jio.read_megadepth_depth(
            d, pad)
        assert a.dtype == b.dtype and np.array_equal(a, b)
    sroot, _, _ = make_fake_scannet(tmp_path)
    base = os.path.join(sroot, "scene0000_00")
    for f, fn in (("depth/1.png", "read_scannet_depth"),
                  ("pose/2.txt", "read_scannet_pose")):
        a = getattr(tio, fn)(os.path.join(base, f))
        b = getattr(jio, fn)(os.path.join(base, f))
        assert a.dtype == b.dtype and np.array_equal(a, b)
    for gray in (False, True):
        p = os.path.join(base, "color", "0.jpg")
        diff = np.abs(tio.read_scannet_image(p, gray=gray)
                      - jio.read_scannet_image(p, gray=gray))
        assert diff.max() <= U8_ATOL and (diff > 0).mean() <= RESIZE_SHARE
    p0 = os.path.join(root, "imgs", "0000_0.jpg")
    p1 = os.path.join(base, "color", "1.jpg")
    for resize, df in ((64, 32), (100, 8)):
        got = tio.load_im_padding(p0, p1, resize, df)
        want = jio.load_im_padding(p0, p1, resize, df)
        for g, w in zip(got, want):
            assert g.shape == w.shape and g.dtype == w.dtype
            assert np.abs(g.astype(np.float64) - w).max() <= U8_ATOL


@pytest.mark.parametrize("mode", ["train", "test"])
@pytest.mark.parametrize("padding", [True, False])
def test_megadepth_dataset(scene, mode, padding):
    root, npz = scene
    kw = dict(mode=mode, min_overlap_score=0.0, img_resize=64, df=32,
              img_padding=padding, depth_padding=padding, is_rgb=padding)
    got, want = MegaDepthDataset(root, npz, **kw), JMega(root, npz, **kw)
    assert len(got) == len(want) == 5
    for i in range(len(want)):
        assert_samples_equal(got[i], want[i],
                             PAD_ATOL if padding else U8_ATOL,
                             None if padding else RESIZE_SHARE)


@pytest.mark.parametrize("mode", ["train", "test"])
@pytest.mark.parametrize("is_rgb", [True, False])
def test_scannet_dataset(tmp_path, mode, is_rgb):
    root, npz, intr = make_fake_scannet(tmp_path, n_pairs=4)
    got = ScanNetDataset(root, npz, intr, mode=mode, is_rgb=is_rgb)
    want = JScan(root, npz, intr, mode=mode, is_rgb=is_rgb)
    assert len(got) == len(want) == (2 if mode == "train" else 4)
    for i in range(len(want)):
        assert_samples_equal(got[i], want[i], U8_ATOL, RESIZE_SHARE)


class _Sized:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return i


@pytest.mark.parametrize("replacement,shuffle,repeat,n_per", [
    (True, True, 1, 5), (False, True, 2, 5), (False, False, 1, 20),
    (True, False, 3, 7), (False, True, 1, 3)])
def test_random_concat_sampler_streams(replacement, shuffle, repeat, n_per):
    sizes = (10, 4, 17)
    got = tloader.RandomConcatSampler(
        tloader.ConcatDataset([_Sized(n) for n in sizes]), n_per,
        replacement, shuffle, repeat, seed=66)
    want = jloader.RandomConcatSampler(
        jloader.ConcatDataset([_Sized(n) for n in sizes]), n_per,
        replacement, shuffle, repeat, seed=66)
    assert len(got) == len(want)
    for _ in range(3):   # the generator carries over from epoch to epoch
        assert list(got) == list(want)


@pytest.mark.parametrize("n,world", [(10, 4), (8, 4), (3, 5), (1, 1),
                                     (7, 2)])
def test_get_local_split(n, world):
    items = [f"s{i}" for i in range(n)]
    for rank in range(world):
        for seed in (0, 66):
            assert (tloader.get_local_split(items, world, rank, seed)
                    == jloader.get_local_split(items, world, rank, seed))


def _module_overrides(root, n_samples=3):
    d = {f"{s}_{k}": v for s in ("train", "val", "test") for k, v in (
        ("data_root", root), ("npz_root", root),
        ("list_path", os.path.join(root, f"{s}_list.txt")))}
    d.update(trainval_data_source="MegaDepth", test_data_source="MegaDepth",
             min_overlap_score_train=0.0, min_overlap_score_test=0.0,
             mgdpt_img_resize=64, mgdpt_df=32)
    return {"dataset": d, "trainer": {"n_samples_per_subset": n_samples},
            "loftr": {"is_rgb": True}}


def _batches_equal(got, want):
    got, want = list(got), list(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            if k in IMAGE_KEYS:
                assert np.abs(g[k] - w[k]).max() <= PAD_ATOL
            elif isinstance(w[k], np.ndarray):
                assert np.array_equal(g[k], w[k]), k
            else:
                assert g[k] == w[k], k


def test_multi_scene_data_module(tmp_path):
    root = str(tmp_path)
    make_fake_scene(tmp_path, "0000", n_images=4, n_pairs=4, hw=(70, 90))
    make_fake_scene(tmp_path, "0001", n_images=4, n_pairs=3, hw=(70, 90))
    (tmp_path / "train_list.txt").write_text("0000\n0001\n")
    (tmp_path / "val_list.txt").write_text("0001\n")
    (tmp_path / "test_list.txt").write_text("0000 extra\n")
    ov = _module_overrides(root)
    tm = MultiSceneDataModule(port_override(build_config(
        "outdoor_casmtr_4c"), ov), build_workers=2)
    jm = JModule(jax_override(jax_build_config("outdoor_casmtr_4c"), ov),
                 build_workers=2)
    for split in ("train_dataset", "val_dataset", "test_dataset"):
        a, b = getattr(tm, split)(), getattr(jm, split)()
        assert a.cumulative_sizes == b.cumulative_sizes
    _batches_equal(tm.train_loader(2, num_workers=2),
                   jm.train_loader(2, num_workers=2))
    _batches_equal(tm.eval_loader(tm.val_dataset(), 1, 2),
                   jm.eval_loader(jm.val_dataset(), 1, 2))


def test_multi_scene_data_module_warnings(tmp_path):
    root = str(tmp_path)
    make_fake_scene(tmp_path, "0000", n_images=4, n_pairs=2, hw=(40, 50))
    make_fake_scene(tmp_path, "0002", n_images=4, n_pairs=0, hw=(40, 50))
    (tmp_path / "train_list.txt").write_text("0000\n0001\n0002\n")
    ov = _module_overrides(root)
    caught = []
    for module, cfg in (
            (MultiSceneDataModule, port_override(build_config(
                "outdoor_casmtr_4c"), ov)),
            (JModule, jax_override(jax_build_config("outdoor_casmtr_4c"),
                                   ov))):
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            ds = module(cfg, build_workers=1).train_dataset()
        caught.append(([str(x.message) for x in w], ds.cumulative_sizes))
    assert caught[0] == caught[1]
    assert len(caught[0][0]) == 2 and caught[0][1] == [2]
    (tmp_path / "train_list.txt").write_text("0009\n")
    with pytest.raises(FileNotFoundError, match="no scene npz"):
        MultiSceneDataModule(port_override(build_config(
            "outdoor_casmtr_4c"), ov)).train_dataset()


# (source h, w) -> (h, w): the serving Matcher's downscales into bucket 832,
# two upscales and an exact 2x reduction
F32_RESIZES = {"800x1200 -> 512x832": ((800, 1200), (512, 832)),
               "1000x1500 -> 512x832": ((1000, 1500), (512, 832)),
               "480x640 -> 704x928": ((480, 640), (704, 928)),
               "333x517 -> 512x800": ((333, 517), (512, 800)),
               "256x384 -> 128x192": ((256, 384), (128, 192))}
F32_RESIZE_ATOL = 1e-6


@pytest.mark.parametrize("case", list(F32_RESIZES))
def test_resize_f32_against_cv2(case):
    """The float32 resize of the serving Matcher (the host library) and its
    numpy oracle against ``cv2.resize`` (INTER_LINEAR), as the JAX Matcher
    calls it on float32 RGB images, within 1e-6 (bit-equal here); gray
    images too."""
    (h, w), (h_new, w_new) = F32_RESIZES[case]
    rng = np.random.default_rng(h + w)
    img = rng.random((h, w, 3), dtype=np.float32)
    for src in (img, np.ascontiguousarray(img[..., 1])):
        want = cv2.resize(src, (w_new, h_new))
        for fn in (tio.resize_f32, tio.resize_f32_plain):
            got = fn(src, (w_new, h_new))
            assert got.dtype == np.float32 and got.shape == want.shape
            np.testing.assert_allclose(got, want, rtol=0,
                                       atol=F32_RESIZE_ATOL,
                                       err_msg=fn.__name__)


def test_resize_f32_refuses_what_the_host_library_cannot_take():
    for bad in (np.zeros((8, 8, 3), np.uint8), np.zeros((1, 1, 8, 8),
                                                        np.float32),
                np.zeros((0, 8), np.float32)):
        with pytest.raises(ValueError, match="float32"):
            tio.resize_f32(bad, (4, 4))
    with pytest.raises(ValueError, match="resize to"):
        tio.resize_f32(np.zeros((8, 8), np.float32), (4, 0))
    # a non-contiguous view is read as the array it shows; the same size
    # is a copy
    src = np.arange(192, dtype=np.float32).reshape(8, 8, 3)
    assert np.array_equal(tio.resize_f32(src[:, ::-1], (8, 8)), src[:, ::-1])
    np.testing.assert_allclose(tio.resize_f32(src[:, ::-1], (4, 4)),
                               cv2.resize(src[:, ::-1].copy(), (4, 4)),
                               rtol=0, atol=F32_RESIZE_ATOL)


def test_resizes_refuse_what_the_host_library_cannot_take():
    img = np.zeros((8, 8, 3), np.uint8)
    for bad in (img.astype(np.float32), img[..., 0][None, None],
                np.zeros((0, 8), np.uint8)):
        with pytest.raises(ValueError, match="uint8"):
            tio.resize_u8(bad, (4, 4))
        with pytest.raises(ValueError, match="uint8"):
            tio.resize_pad_normalize(bad, 4, 4, 8)
    with pytest.raises(ValueError, match="pad_size"):
        tio.resize_pad_normalize(img, 8, 9, 8)
    with pytest.raises(ValueError, match="resize to"):
        tio.resize_u8(img, (0, 4))
    # a non-contiguous view is read as the array it shows
    src = np.arange(192, dtype=np.uint8).reshape(8, 8, 3)
    assert np.array_equal(tio.resize_u8(src[:, ::-1], (8, 8)), src[:, ::-1])
