"""The port's TensorBoard writer (``casmtr_tpu_torch.utils.logging.
TensorBoardWriter``, stdlib only) on the CPU:

* CRC32C against RFC 3720's check value, and the masked CRC32C of
  TFRecord against tensorboard's own;
* the port's writer and the JAX package's (``tf.summary``) log the same
  scalars; both directories read back with tensorboard's event
  accumulator give the same tags, steps and float32 values;
* a figure's image summary decodes to the raster it was given;
* a tiny ``cli.train`` run on the CPU writes ``train/*`` (``lr`` too),
  ``val/*`` and ``val_match/pair-*`` into ``run-dir/tb``.
"""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
cv2 = pytest.importorskip("cv2")
pytest.importorskip("tensorflow")
pea = pytest.importorskip(
    "tensorboard.backend.event_processing.plugin_event_accumulator")
from tensorboard.util import tensor_util  # noqa: E402

from casmtr_tpu_torch.utils import logging as L  # noqa: E402


def read_back(log_dir):
    """{tag: [(step, value)]} of every tensor event in ``log_dir``, and
    each tag's plugin."""
    acc = pea.EventAccumulator(str(log_dir), size_guidance={"tensors": 0})
    acc.Reload()
    out, plugins = {}, {}
    for tag in acc.Tags()["tensors"]:
        out[tag] = [(e.step, tensor_util.make_ndarray(e.tensor_proto))
                    for e in acc.Tensors(tag)]
        plugins[tag] = acc.SummaryMetadata(tag).plugin_data.plugin_name
    return out, plugins


def test_crc32c_and_record_framing():
    from tensorboard.compat.tensorflow_stub.pywrap_tensorflow import \
        masked_crc32c
    assert L.crc32c(b"123456789") == 0xE3069283
    assert L.crc32c(b"") == 0
    rng = np.random.default_rng(0)
    for n in (1, 8, 255, 4097):
        data = rng.integers(0, 256, n).astype(np.uint8).tobytes()
        assert L.masked_crc32c(data) == masked_crc32c(data)
    rec = L.tfrecord(b"abc")
    assert rec[:8] == (3).to_bytes(8, "little") and rec[12:15] == b"abc"


def test_scalars_read_back_as_the_jax_writer_s(tmp_path):
    from casmtr_tpu.utils.logging import TensorBoardWriter as JaxWriter
    logs = [({"train/loss": 0.731, "train/loss_c": 1e-7, "lr": 3.2e-4}, 0),
            ({"train/loss": float(np.float32(0.1) / 3), "lr": 1e-3}, 50),
            ({"val/auc@5": 0.0, "val/prec@5e-04": 0.25}, 51)]
    dirs = {"port": tmp_path / "port", "jax": tmp_path / "jax"}
    for name, cls in (("port", L.TensorBoardWriter), ("jax", JaxWriter)):
        w = cls(str(dirs[name]))
        for values, step in logs:
            w.scalars(values, step)
        w.flush()
    got, plugins = read_back(dirs["port"])
    want, jax_plugins = read_back(dirs["jax"])
    assert sorted(got) == sorted(want) == sorted(
        {k for values, _ in logs for k in values})
    assert plugins == jax_plugins == {k: "scalars" for k in got}
    for tag in got:
        assert [s for s, _ in got[tag]] == [s for s, _ in want[tag]]
        for (_, a), (_, b) in zip(got[tag], want[tag]):
            assert a.dtype == b.dtype == np.float32 and a == b, tag
    name = os.listdir(dirs["port"])[0]
    assert name.startswith("events.out.tfevents.")


def test_figure_summary_decodes(tmp_path):
    from casmtr_tpu_torch.utils.plotting import make_matching_figure
    rng = np.random.default_rng(1)
    fig = make_matching_figure(rng.random((20, 30)), rng.random((25, 18, 3)),
                               [[3.0, 4.0]], [[10.0, 11.0]],
                               [[0.0, 1.0, 0.0, 0.5]], text=["x"])
    w = L.TensorBoardWriter(str(tmp_path))
    w.figure("val_match/pair-0", fig, 7)
    w.close()
    got, plugins = read_back(tmp_path)
    assert plugins == {"val_match/pair-0": "images"}
    [(step, value)] = got["val_match/pair-0"]
    width, height, png = value
    assert step == 7 and (int(width), int(height)) == (fig.shape[1],
                                                       fig.shape[0])
    img = cv2.imdecode(np.frombuffer(png, np.uint8), cv2.IMREAD_UNCHANGED)
    assert np.array_equal(img[..., [2, 1, 0, 3]], fig)


def test_train_command_writes_tensorboard(tmp_path):
    from casmtr_tpu_torch.cli import train as T
    from tests.test_data_layer import make_fake_scene
    from tests.test_torch_commands import _overrides
    make_fake_scene(tmp_path, scene_id="0000", n_images=4, n_pairs=2)
    for split in ("train", "val", "test"):
        (tmp_path / f"{split}_list.txt").write_text("0000\n")
    run = tmp_path / "run"
    T.main(["--model", "outdoor_casmtr_4c", "--epochs", "1",
            "--num-workers", "1", "--log-every", "1", "--max-val-pairs", "2",
            "--sanity-val-steps", "0", "--plot-every", "1", "--device", "cpu",
            "--run-dir", str(run),
            "--overrides-json", json.dumps(_overrides(str(tmp_path), 2))])
    got, plugins = read_back(run / "tb")
    steps = [s for s, _ in got["train/loss"]]
    assert steps == [1, 2] and [s for s, _ in got["train/lr"]] == steps
    assert {"val/auc@5", "val/auc@10", "val/auc@20"} <= set(got)
    assert [s for s, _ in got["val/auc@5"]] == [2]
    figs = sorted(t for t in got if t.startswith("val_match/"))
    assert figs == ["val_match/pair-0", "val_match/pair-1"]
    assert {plugins[t] for t in figs} == {"images"}
