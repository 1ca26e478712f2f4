"""Serving API of the port: a fixed-bucket image matcher (counterpart of
casmtr_tpu/serving.py).

Every image is resized so its long side fits a square ``bucket`` canvas
(df-divisible), padded bottom-right and masked; keypoints come back in the
original image's pixel coordinates.  The weights come from ``ckpt`` (a
reference ``.ckpt``/``.pth`` or a port checkpoint directory,
``train.checkpoints.load_checkpoint_variables``), else random from a seed;
the JAX package's variables load afterwards with
``casmtr_tpu_torch.weights.load_jax_variables(matcher.model, ...)``.  Inputs
are arrays or image paths (JPEG or PNG, read by ``data/codecs`` as
``cv2.imread`` reads them, without cv2).

``Matcher(devices=[...])`` serves over replicas, the counterpart of the
JAX ``Matcher(mesh=...)``: one copy of the weights per distinct device, a
batch of B pairs split into n equal chunks, and each replica's forward
selecting its own top-(B/n * M) matches, as the JAX package's ``shard_map``
forward does (not the one-device global top-(B * M)).  On cards the
replicas run at once, each in a host thread and on a CUDA stream of its
own that live as long as the Matcher.
"""

from __future__ import annotations

import contextlib
import copy
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from casmtr_tpu_torch.config import Config, override
from casmtr_tpu_torch.configs import build_config
from casmtr_tpu_torch.data.io import resize_f32
from casmtr_tpu_torch.models import build_model
from casmtr_tpu_torch.weights import init_random_

ImageLike = Union[str, os.PathLike, np.ndarray]


class MatchResult(NamedTuple):
    """Matches for one pair, in original image pixel coordinates."""
    mkpts0: np.ndarray  # [N, 2] (x, y) in image0
    mkpts1: np.ndarray  # [N, 2] (x, y) in image1
    mconf: np.ndarray   # [N]


def resolve_device(device: Union[None, str, torch.device]) -> torch.device:
    """``None`` means the card ("cuda"); a CUDA device without CUDA raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: the port runs on the "
                           "card; pass device='cpu' to run on the CPU")
    return dev


def configure_card() -> None:
    """The process-wide PyTorch flags of the port's eval on the card: no
    TF32 in matrix products and cuDNN convolutions (float32 work is full
    float32), bf16 products summed in float32, and cuDNN's autotuner on
    (see Matcher)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.benchmark = True


def _to_rgb_array(img: ImageLike) -> np.ndarray:
    """A path (``data/io._imread`` in colour, / 255) or an array: [H, W]
    gray, [H, W, 3] RGB or [H, W, 4] RGBA (alpha dropped); uint8 in
    [0, 255] or float (rescaled if it looks like a 0-255 range)."""
    if isinstance(img, (str, os.PathLike)):
        from casmtr_tpu_torch.data.io import _imread
        return _imread(img, gray=False).astype(np.float32) / 255.0
    arr = np.asarray(img)
    if arr.ndim == 2:
        arr = np.repeat(arr[:, :, None], 3, axis=2)
    elif arr.ndim == 3 and arr.shape[2] == 4:
        arr = arr[:, :, :3]
    if arr.ndim != 3 or arr.shape[2] != 3:
        raise ValueError(f"expected [H,W], [H,W,3] or [H,W,4], got {arr.shape}")
    if arr.dtype == np.uint8:
        return arr.astype(np.float32) / 255.0
    arr = arr.astype(np.float32)
    if arr.max(initial=0.0) > 1.5:
        arr = arr / 255.0
    return arr


class Matcher:
    """Image matcher at a fixed canvas size.

    model: recipe name (casmtr_tpu_torch.configs.MODEL_RECIPES) or a Config.
    ckpt: a reference .ckpt/.pth (strict: every key of the model) or a port
        checkpoint directory (``train.checkpoints.CheckpointManager``; its
        newest step's parameters and BatchNorm statistics), loaded over the
        seeded initialization before the model moves to ``device``.
    bucket: square canvas side; every input is resized (long side) and
        padded to it.
    df: size divisor of the resized image (backbone stride alignment).
    thr: confidence threshold applied to the returned matches.
    overrides: optional config override dict (applied last).
    device: where the model runs; None means "cuda", which raises when CUDA
        is absent.  Pass "cpu" to run on the CPU.
    devices: a sequence of n devices instead of ``device`` (the two are
        mutually exclusive): replica r serves pairs [r B/n, (r+1) B/n) of a
        batch of B pairs, B a multiple of n, with its own selection of the
        top-(B/n * M) matches (the JAX ``Matcher(mesh=...)``).  Replicas on
        one device share its copy of the weights; ``replicate()`` copies
        ``model``'s weights (the first device's copy) to the others after
        they change.
    seed / generator: the random weights are drawn from ``generator`` or, if
        none is given, from a CPU generator seeded with ``seed``.

    On the card the forward computes the backbone and the transformer
    stacks in bfloat16 (the JAX package's eval policy; models/casmtr.py),
    the rest in float32; on the CPU, or on the card with
    ``CASMTR_BACKBONE_BF16=0 CASMTR_TRANSFORMER_BF16=0``, all in float32.
    On the card this class turns TF32 off for matrix products and cuDNN
    convolutions, so float32 work is full float32, keeps bf16 matrix
    products' sums in float32 (no reduced-precision reductions), and turns
    cuDNN's autotuner on: every request has the bucket's shapes, so the
    first one pays the tuning and the rest reuse its choices.  Without it,
    cuDNN's heuristic gave the Twins FPN's 3x3 256->128 conv at 208^2 an
    FFT algorithm that took about 320 ms on an H100, against under 2 ms
    autotuned (chip_smoke.py, profile phase).  All four are process-wide
    PyTorch flags.
    """

    def __init__(self, model: Union[str, Config] = "outdoor_casmtr_4c",
                 ckpt: Optional[str] = None, bucket: int = 832, df: int = 64,
                 thr: float = 0.2,
                 overrides: Optional[Dict] = None, device=None, seed: int = 0,
                 generator: Optional[torch.Generator] = None,
                 devices: Optional[Sequence] = None):
        cfg = build_config(model) if isinstance(model, str) else model
        if overrides:
            cfg = override(cfg, overrides)
        self.cfg = cfg
        self.bucket = int(bucket)
        self.df = int(df)
        if self.bucket < self.df or self.bucket % self.df != 0:
            raise ValueError(f"bucket {bucket} must be a multiple of df {df}")
        self.thr = float(thr)
        if devices is not None:
            if device is not None:
                raise ValueError("Matcher: pass device or devices, not both")
            if not devices:
                raise ValueError("Matcher: devices is empty")
            self.devices = [resolve_device(d) for d in devices]
        else:
            self.devices = None
        self.device = (self.devices[0] if self.devices
                       else resolve_device(device))
        if any(d.type == "cuda" for d in self.devices or [self.device]):
            configure_card()
        self.model = build_model(cfg.loftr)
        if generator is None:
            generator = torch.Generator().manual_seed(seed)
        init_random_(self.model, generator)
        if ckpt:
            from casmtr_tpu_torch.train.checkpoints import \
                load_checkpoint_variables
            load_checkpoint_variables(ckpt, self.model)
        self.model.to(self.device).eval()
        self._models: Dict[torch.device, torch.nn.Module] = {
            self.device: self.model}
        self._workers: List[ThreadPoolExecutor] = []   # one per replica
        self._streams: List[Optional["torch.cuda.Stream"]] = []
        self.replicate()

    def replicate(self) -> None:
        """Copy ``model``'s parameters and buffers to the weights of every
        other device of ``devices`` (one copy per distinct device)."""
        for dev in dict.fromkeys(self.devices or ()):
            if dev == self.device:
                continue
            if dev in self._models:
                self._models[dev].load_state_dict(self.model.state_dict())
            else:
                self._models[dev] = copy.deepcopy(self.model).to(dev).eval()

    def _preprocess(self, img: ImageLike):
        """Resize the long side into the bucket (df-divisible), pad
        bottom-right.  Returns (canvas [S, S, 3], mask [S, S] bool, scale [2]
        original px per model px).  The resize, when one is needed, is the
        host library's ``cv2.resize`` (INTER_LINEAR) of the float32 image,
        as the JAX package's Matcher calls it (``data/io.resize_f32``)."""
        arr = _to_rgb_array(img)
        h, w = arr.shape[:2]
        s = self.bucket / max(h, w)
        w_new = max(self.df, int(round(w * s)) // self.df * self.df)
        h_new = max(self.df, int(round(h * s)) // self.df * self.df)
        if (h_new, w_new) != (h, w):
            arr = resize_f32(arr, (w_new, h_new))
        S = self.bucket
        canvas = np.zeros((S, S, 3), np.float32)
        canvas[:h_new, :w_new] = arr
        mask = np.zeros((S, S), bool)
        mask[:h_new, :w_new] = True
        return canvas, mask, np.array([w / w_new, h / h_new], np.float32)

    def _pack(self, pairs: Sequence[Tuple[ImageLike, ImageLike]],
              device=None):
        cols: Dict[str, List[np.ndarray]] = {
            k: [] for k in ("image0", "image1", "mask0", "mask1", "scale0",
                            "scale1")}
        for img0, img1 in pairs:
            for i, img in ((0, img0), (1, img1)):
                canvas, mask, scale = self._preprocess(img)
                cols[f"image{i}"].append(canvas)
                cols[f"mask{i}"].append(mask)
                cols[f"scale{i}"].append(scale)
        return {k: torch.from_numpy(np.stack(v)).to(device or self.device)
                for k, v in cols.items()}

    def match(self, img0: ImageLike, img1: ImageLike) -> MatchResult:
        """Match one pair of any sizes (arrays or image paths)."""
        return self.match_batch([(img0, img1)])[0]

    def match_batch(self, pairs: Sequence[Tuple[ImageLike, ImageLike]]
                    ) -> List[MatchResult]:
        """Match B pairs in one forward.  Selection is one top-(B*M) by
        confidence across the batch (every capacity scaled by B), so per-pair
        results equal the single-pair ones while no pair saturates the
        config's ``max_matches``.  Over n ``devices`` B must be a multiple
        of n (ValueError otherwise), and each replica selects over its own
        B/n pairs."""
        if not pairs:
            return []
        if self.devices is None:
            with torch.inference_mode():
                out = self._forward(self.model, self._pack(pairs), len(pairs))
        else:
            out = self._replica_forward(pairs)
        out = {k: v.cpu().numpy() for k, v in out.items()}
        keep = out["valid"] & (out["mconf"] >= self.thr)
        results = []
        for b in range(len(pairs)):
            sel = keep & (out["b_ids"] == b)
            results.append(MatchResult(out["mkpts0"][sel], out["mkpts1"][sel],
                                       out["mconf"][sel]))
        return results

    @staticmethod
    def _forward(model, batch, capacity_scale: int,
                 offset: int = 0) -> Dict[str, torch.Tensor]:
        fm = model(batch, capacity_scale=capacity_scale).final_matches
        out = {k: getattr(fm, k)
               for k in ("b_ids", "mkpts0", "mkpts1", "mconf", "valid")}
        out["b_ids"] = out["b_ids"] + offset
        return out

    def _replica_forward(self, pairs) -> Dict[str, torch.Tensor]:
        """The forwards of the n replicas on their chunks of ``pairs``,
        joined: on cards at once, each in its own host thread on its own
        stream (synchronized before the results are read); on the CPU in
        turn.  The threads live as long as the Matcher: cuDNN keeps the
        algorithms its autotuner picks per host thread, so a fresh thread
        per request would autotune every convolution again."""
        n = len(self.devices)
        if len(pairs) % n:
            raise ValueError(f"batch {len(pairs)} not divisible by the "
                             f"{n} replicas")
        Bl = len(pairs) // n

        def run(r: int) -> Dict[str, torch.Tensor]:
            dev = self.devices[r]
            chunk = pairs[r * Bl:(r + 1) * Bl]
            with contextlib.ExitStack() as stack:
                stack.enter_context(torch.inference_mode())
                if dev.type == "cuda":
                    stack.enter_context(torch.cuda.device(dev))
                    stack.enter_context(torch.cuda.stream(self._streams[r]))
                out = self._forward(self._models[dev], self._pack(chunk, dev),
                                    Bl, r * Bl)
                if dev.type == "cuda":
                    self._streams[r].synchronize()
            return out

        if any(d.type == "cuda" for d in self.devices):
            if not self._workers:
                self._workers = [ThreadPoolExecutor(1) for _ in range(n)]
                self._streams = [torch.cuda.Stream(device=d)
                                 if d.type == "cuda" else None
                                 for d in self.devices]
            futures = [w.submit(run, r) for r, w in enumerate(self._workers)]
            outs = [f.result() for f in futures]
        else:
            outs = [run(r) for r in range(n)]
        return {k: torch.cat([o[k].cpu() for o in outs]) for k in outs[0]}

    def warmup(self, batch_sizes: Sequence[int] = (1,)) -> None:
        """Pay the first request's costs up front (on the card cuDNN's
        autotuning and the kernels' build; the host library's build, since
        the dummy is resized): one dummy batch of a blank
        half-bucket image pair per batch size, each size rounded up to a
        multiple of the replicas (the only sizes that can run)."""
        dummy = np.zeros((self.bucket // 2, self.bucket // 2, 3), np.float32)
        n = len(self.devices) if self.devices else 1
        for bs in batch_sizes:
            self.match_batch([(dummy, dummy)] * (-(-bs // n) * n))
