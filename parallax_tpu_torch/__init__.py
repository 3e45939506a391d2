"""parallax_tpu_torch: the PyTorch + CUDA port of parallax_tpu for NVIDIA Hopper.

A second package beside the JAX reference (``parallax_tpu``). It imports
``torch`` and never ``jax`` or anything of ``parallax_tpu``; module layout and
names mirror the JAX package so each module's counterpart is easy to find.
The hot attention and sampling kernels are hand-written CUDA C++ for
``sm_90a`` (``csrc/``), built with ``nvcc`` at first use; every kernel keeps a
plain PyTorch version beside it, which is what runs on CPU tensors.

Entry points run on ``cuda:0`` unless the caller passes ``device="cpu"``.
"""

from parallax_tpu_torch.version import __version__  # noqa: F401
