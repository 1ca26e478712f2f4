"""Backbone registry (counterpart of casmtr_tpu/models/backbone/__init__.py)."""

from casmtr_tpu_torch.models.backbone.resnet_fpn import (ResNetFPN_8_2,
                                                         ResNetFPN_8_4_2,
                                                         ResNetFPN_16_4)
from casmtr_tpu_torch.models.backbone.twins import (TwinsFPN_8_4_2,
                                                    TwinsFPN_16_8_4_2)

_RESNET = {(8, 2): ResNetFPN_8_2, (8, 4, 2): ResNetFPN_8_4_2,
           (16, 4): ResNetFPN_16_4}


def build_backbone(config):
    """config: LoftrConfig.  Returns the module producing the NCHW pyramid,
    coarsest first and finest last ([1/8, (1/4,), 1/2], [1/16, 1/4] or
    [1/16, 1/8, 1/4, 1/2]); the caller names it ``backbone`` so state-dict
    keys line up with the reference's ``backbone.*``.  Routed as the JAX
    registry routes: ResNetFPN at any other resolution raises ValueError,
    Twins at any resolution but (16, 8, 4, 2) is ``TwinsFPN_8_4_2``."""
    bb = config.backbone
    res = tuple(config.resolution)
    if bb.backbone_type == "ResNetFPN":
        if res not in _RESNET:
            raise ValueError(f"unsupported resolution {res} for ResNetFPN")
        return _RESNET[res](initial_dim=bb.initial_dim,
                            block_dims=tuple(bb.block_dims),
                            is_rgb=config.is_rgb)
    if bb.backbone_type == "Twins":
        cls = TwinsFPN_16_8_4_2 if res == (16, 8, 4, 2) else TwinsFPN_8_4_2
        return cls(initial_dim=bb.initial_dim,
                   block_dims=tuple(bb.block_dims),
                   model_type=bb.model_type or "large")
    raise ValueError(f"unknown backbone {bb.backbone_type}")
