"""Model registry: string name -> PoseModel.

Replaces the reference's get_model() string dispatch
(openpose_plus/models/__init__.py :: get_model [HIGH; empty mount —
SURVEY.md §2 "Model registry"]).
"""

from __future__ import annotations

from openpose_plus.config import ModelConfig
from openpose_plus.models import hao28, mobilenet_thin, vgg19, vggtiny
from openpose_plus.models.common import PoseModel

_REGISTRY = {
    "vgg19": vgg19.forward,
    "vgg": vgg19.forward,            # reference alias --model=vgg
    "vggtiny": vggtiny.forward,
    "mobilenet_thin": mobilenet_thin.forward,
    "mobilenet": mobilenet_thin.forward,
    "hao28_experimental": hao28.forward,
    "hao28": hao28.forward,
}


def get_model(cfg: ModelConfig) -> PoseModel:
    """Build the model named by cfg.name."""
    try:
        body = _REGISTRY[cfg.name]
    except KeyError:
        raise ValueError(
            f"unknown model {cfg.name!r}; have {sorted(set(_REGISTRY))}"
        ) from None
    return PoseModel(cfg, body)


def model_names() -> list[str]:
    return sorted(set(_REGISTRY))
