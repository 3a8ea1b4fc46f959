"""Training runtime: one harness shared by every workload."""

from esrecsys_tpu_torch.train.checkpoint import Checkpointer
from esrecsys_tpu_torch.train.export import (export_model, latest_artifact,
                                             load_model)
from esrecsys_tpu_torch.train.loop import FitResult, fit
from esrecsys_tpu_torch.train.preemption import PreemptionGuard
from esrecsys_tpu_torch.train.state import TrainState

__all__ = ["Checkpointer", "FitResult", "PreemptionGuard", "TrainState",
           "export_model", "fit", "latest_artifact", "load_model"]
