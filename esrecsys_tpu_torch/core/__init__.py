from esrecsys_tpu_torch.core.device import pad_to_multiple, resolve_device

__all__ = ["pad_to_multiple", "resolve_device"]
