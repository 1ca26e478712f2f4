"""Backbone registry (counterpart of casmtr_tpu/models/backbone/__init__.py)."""

from casmtr_tpu_torch.models.backbone.resnet_fpn import (ResNetFPN_8_2,
                                                         ResNetFPN_8_4_2)
from casmtr_tpu_torch.models.backbone.twins import TwinsFPN_8_4_2


def build_backbone(config):
    """config: LoftrConfig.  Returns the module producing the NCHW pyramid
    [1/8, (1/4,), 1/2], finest last; the caller names it ``backbone`` so
    state-dict keys line up with the reference's ``backbone.*``."""
    bb = config.backbone
    res = tuple(config.resolution)
    if bb.backbone_type == "ResNetFPN" and res in ((8, 4, 2), (8, 2)):
        cls = ResNetFPN_8_4_2 if res == (8, 4, 2) else ResNetFPN_8_2
        return cls(initial_dim=bb.initial_dim,
                   block_dims=tuple(bb.block_dims), is_rgb=config.is_rgb)
    if bb.backbone_type == "Twins" and res == (8, 4, 2):
        return TwinsFPN_8_4_2(initial_dim=bb.initial_dim,
                              block_dims=tuple(bb.block_dims),
                              model_type=bb.model_type or "large")
    raise NotImplementedError(
        f"backbone {bb.backbone_type} at resolution {res} is not ported: "
        "ResNetFPN_16_4 and TwinsFPN_16_8_4_2 serve no recipe (ROADMAP, "
        "\"Not ported on purpose\")")
