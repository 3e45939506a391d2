from parallax_tpu_torch.models.base import BatchInputs, StageModel
from parallax_tpu_torch.models.registry import (
    create_stage_model,
    params_from_numpy,
)
# Importing a model family registers its architectures.
from parallax_tpu_torch.models.qwen3_moe import MoEStageModel
from parallax_tpu_torch.models.deepseek_v3 import DeepseekStageModel
from parallax_tpu_torch.models.deepseek_v32 import DeepseekV32StageModel
from parallax_tpu_torch.models.gpt_oss import GptOssStageModel
from parallax_tpu_torch.models.minimax_m2 import MiniMaxM2StageModel
from parallax_tpu_torch.models.minimax_m3 import MiniMaxM3StageModel

__all__ = ["BatchInputs", "DeepseekStageModel", "DeepseekV32StageModel",
           "GptOssStageModel", "MiniMaxM2StageModel", "MiniMaxM3StageModel",
           "MoEStageModel", "StageModel", "create_stage_model",
           "params_from_numpy"]
