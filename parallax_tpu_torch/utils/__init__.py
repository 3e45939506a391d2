from parallax_tpu_torch.utils.logging import get_logger, set_log_level

__all__ = ["get_logger", "set_log_level", "unported"]


def unported(what: str, item) -> NotImplementedError:
    """The error that refuses a feature of the JAX package the port does
    not run yet, naming the ROADMAP queue 1 item that ports it."""
    return NotImplementedError(
        f"{what}: not ported yet to parallax_tpu_torch (ROADMAP queue 1 "
        f"item {item})")
