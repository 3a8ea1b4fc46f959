from esrecsys_tpu_torch.train.export import (export_model, latest_artifact,
                                             load_model)
from esrecsys_tpu_torch.train.loop import FitResult, fit
from esrecsys_tpu_torch.train.state import TrainState

__all__ = ["FitResult", "TrainState", "export_model", "fit",
           "latest_artifact", "load_model"]
