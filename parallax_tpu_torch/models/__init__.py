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
from parallax_tpu_torch.models.glm4 import Glm4MoeStageModel, Glm4StageModel
from parallax_tpu_torch.models.step3p5 import Step3p5StageModel
from parallax_tpu_torch.models.qwen3_next import Qwen3NextStageModel

__all__ = ["BatchInputs", "DeepseekStageModel", "DeepseekV32StageModel",
           "Glm4MoeStageModel", "Glm4StageModel", "GptOssStageModel",
           "MiniMaxM2StageModel", "MiniMaxM3StageModel", "MoEStageModel",
           "Qwen3NextStageModel", "StageModel", "Step3p5StageModel",
           "create_stage_model", "params_from_numpy"]
