from hvt_torch.models.factory import build_model

__all__ = ["build_model"]
