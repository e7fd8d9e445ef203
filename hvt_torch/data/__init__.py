from hvt_torch.data.device import DevicePrep
from hvt_torch.data.loader import build_loader

__all__ = ["DevicePrep", "build_loader"]
