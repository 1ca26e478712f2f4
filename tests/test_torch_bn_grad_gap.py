"""How far float32 alone puts the ResNetFPN backbone's gradients from their
float64 values, on the CPU.

chip_smoke.py's training reference holds the flagship's ResNetFPN variant's
backbone in train mode, card float32 against CPU float32, under a seeded
cotangent of its maps at 256^2 (``backbone_stage``), and reports the worst
per-leaf relative error (leaf norms floored at 1e-3 of the whole
gradient's); on the card that is ``layer3.0.bn1.bias`` at about 7e-3.  This
test takes the same backbone, batch and cotangent on the CPU in float32
(``backbone_stage`` itself) and in float64 (the same network with its
compute dtype, weights and statistics widened) and finds the same leaf
about 7e-3 apart: a BatchNorm bias's gradient under a random cotangent is a
sum that largely cancels, so its float32 error follows the summation order,
and the gap is float32 rounding, not the card."""

import copy

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import chip_smoke  # noqa: E402

LEAF = "layer3.0.bn1.bias"
SIZE = 256


def _float64_stage(base, monkeypatch):
    """``chip_smoke.backbone_stage`` on the CPU in float64: gradients by
    parameter."""
    from casmtr_tpu_torch.models.backbone import resnet_fpn
    monkeypatch.setattr(resnet_fpn, "backbone_dtype",
                        lambda device, train: torch.float64)
    monkeypatch.setattr(resnet_fpn, "run", lambda m, t, dt: m(t.to(dt)))
    batch = chip_smoke.train_batch(SIZE, 1)
    x = torch.from_numpy(np.concatenate([batch["image0"], batch["image1"]])
                         ).permute(0, 3, 1, 2).double()
    rng = np.random.default_rng(2)
    bb = copy.deepcopy(base.backbone).double().train()
    maps = [m.double() for m in bb(x)]
    dot = sum((m * torch.from_numpy(rng.standard_normal(
        tuple(m.shape)).astype(np.float32)).double()).sum() for m in maps)
    params = dict(bb.named_parameters())
    grads = torch.autograd.grad(dot, list(params.values()))
    return dict(zip(params, (g.detach() for g in grads)))


def test_resnet_fpn_bn_bias_gradient_gap_is_float32_rounding(monkeypatch):
    torch.manual_seed(0)
    base, _, _ = chip_smoke.build_trainer(torch, chip_smoke.RESNET, SIZE,
                                          device="cpu")
    with chip_smoke.precision("f32"):
        _, _, _, g32 = chip_smoke.backbone_stage(torch, base, SIZE, "cpu",
                                                 "f32")
    g64 = _float64_stage(base, monkeypatch)
    floor = 1e-3 * float(torch.cat([g.flatten() for g in g64.values()]
                                   ).norm())
    rel = float((g32[LEAF] - g64[LEAF]).norm()) / max(
        float(g64[LEAF].norm()), floor)
    cos, (worst, worst_name) = chip_smoke.leaf_errors(torch, g32, g64)
    print(f"{LEAF}: float32 against float64 {rel:.4g}; gradient cosine "
          f"{cos:.10f}, worst leaf {worst_name} {worst:.4g}")
    assert 3.5e-3 < rel < 1.4e-2
    assert cos > 0.9999
