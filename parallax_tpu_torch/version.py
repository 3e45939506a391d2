"""The port's own version (``parallax_tpu_torch.__version__`` reads it)."""

__version__ = "0.1.0"
