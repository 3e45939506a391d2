from parallax_tpu_torch.models.base import BatchInputs, StageModel
from parallax_tpu_torch.models.registry import (
    create_stage_model,
    params_from_numpy,
)

__all__ = ["BatchInputs", "StageModel", "create_stage_model",
           "params_from_numpy"]
