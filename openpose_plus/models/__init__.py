from openpose_plus.models.registry import get_model, model_names

__all__ = ["get_model", "model_names"]
