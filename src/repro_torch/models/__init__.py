from repro_torch.models.registry import ModelApi, make_model

__all__ = ["ModelApi", "make_model"]
