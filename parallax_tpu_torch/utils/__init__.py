from parallax_tpu_torch.utils.logging import get_logger, set_log_level

__all__ = ["get_logger", "set_log_level"]
