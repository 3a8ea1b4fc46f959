"""Train state (counterpart of ``esrecsys_tpu/train/state.py``).

The reference's state is an immutable pytree that each step replaces; the
port's steps update the model and optimizer state in place and return the
same object with ``step`` advanced.
"""

from __future__ import annotations

import dataclasses
from typing import Any

from torch import nn


@dataclasses.dataclass
class TrainState:
    step: int
    params: nn.Module
    # the row-sparse step: {"album": {"momentum": t}, "artist": {...}} for
    # the dense momentum carrier, with an int32 "last_step" per table for
    # the lazy one, None at momentum 0; the dense step: a torch.optim.SGD
    # over params
    opt_state: Any = None
