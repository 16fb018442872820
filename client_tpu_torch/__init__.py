"""PyTorch / CUDA port of ``client_tpu`` for NVIDIA Hopper.

A second package beside the JAX one: module paths mirror ``client_tpu``,
the code is PyTorch, and each TPU kernel on a ported path is a kernel
written by hand for ``sm_90a`` (``csrc/``, built by :mod:`.kernels`). The
port imports nothing of JAX or of ``client_tpu``. Entry points run on
``cuda`` unless the caller passes ``device="cpu"``.
"""

from client_tpu_torch.utils import InferenceServerException, resolve_device

__all__ = ["InferenceServerException", "resolve_device"]
