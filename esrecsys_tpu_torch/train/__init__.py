from esrecsys_tpu_torch.train.export import (export_model, latest_artifact,
                                             load_model)

__all__ = ["export_model", "latest_artifact", "load_model"]
