"""openpose_plus — multi-person 2D pose estimation framework in JAX.

A from-scratch JAX/XLA/Pallas rebuild of the capabilities of
Aki57/openpose-plus (see SURVEY.md): swappable CNN backbones producing
stage-wise heatmaps + part-affinity fields, fully on-device vectorized
grouping into skeletons, data-parallel training and distributed COCO
evaluation over a named device mesh.

Public API:

    from openpose_plus import Engine, default_config
    engine = Engine(default_config("mobilenet_thin"))
    humans = engine.infer(images_uint8)
"""

__version__ = "0.1.0"


def __getattr__(name):
    # Lazy exports: keep `import openpose_plus` cheap (no jax import).
    if name == "Engine":
        from openpose_plus.engine import Engine
        return Engine
    if name in ("Config", "default_config"):
        from openpose_plus import config as _c
        return getattr(_c, name)
    if name == "get_model":
        from openpose_plus.models import get_model
        return get_model
    if name == "HumanBatch":
        from openpose_plus.postproc import HumanBatch
        return HumanBatch
    raise AttributeError(name)


__all__ = ["Engine", "Config", "default_config", "get_model", "HumanBatch",
           "__version__"]
