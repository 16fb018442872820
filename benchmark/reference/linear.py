"""The linear layers of the plain references, at full precision and, for
the control, one precision below the configurations' bfloat16.

``exact`` multiplies in float32 with TF32 off. ``fp8`` is the control:
both inputs of every linear layer rounded to float8 (e4m3) with the
usual scales, one for each row of the activations and one for each
output column of the weights, then multiplied in float32. It stands for
the step that would tempt a later change: serving the bfloat16 model's
matrix products in fp8.
"""

import torch

FP8_MAX = 448.0  # largest finite float8 e4m3fn


def full_precision() -> None:
    """Float32 products without TF32 on this process's card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def exact(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x [..., k] @ w [k, n]`` in float32."""
    return x.float() @ w.float()


def _round_fp8(t: torch.Tensor, dim: int) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 with one scale along ``dim``'s slices."""
    scale = t.abs().amax(dim=dim, keepdim=True).clamp(min=1e-12) / FP8_MAX
    return (t / scale).to(torch.float8_e4m3fn).float() * scale


def fp8(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` with both inputs rounded to float8 e4m3: rows of ``x``
    and columns of ``w`` scaled each on its own."""
    return _round_fp8(x.float(), -1) @ _round_fp8(w.float(), 0)
