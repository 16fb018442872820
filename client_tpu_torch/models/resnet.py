"""ResNet-v1.5 image classifier (bottleneck blocks) in PyTorch.

The port of ``client_tpu/models/resnet.py``: the network behind the
``image_classifier`` model
(:class:`client_tpu_torch.models.serving.ImageClassifierModel`). Images
arrive NHWC; the network runs NCHW-shaped tensors laid out
``torch.channels_last``, so the NHWC input is a view, not a copy.
Parameters are a plain dict (:func:`init_params`, :func:`params_from_jax`):

- ``conv_init [F, 3, 7, 7]`` and ``bn_init``; ``head_kernel [C, classes]``
  and ``head_bias`` (fp32);
- ``blocks``, one dict a bottleneck block: ``conv0``/``conv1``/``conv2``
  and ``norm0``/``norm1``/``norm2``, and ``conv_proj``/``norm_proj``
  where the shortcut is projected;
- a convolution kernel is OIHW in ``config.dtype``; a norm is a dict of
  fp32 ``scale``, ``bias``, ``mean`` and ``var [C]``.

Numerics follow the reference (flax):

- ``SAME`` padding is flax's, not torch's symmetric padding: a dim of
  size n under kernel k and stride s pads ``max((ceil(n/s) - 1)·s + k - n,
  0)`` in all, half of it (rounded down) before. A stride-2 3x3
  convolution or the 3x3/2 max pool on an even size pads (0, 1), the
  pool with -inf; the stem convolution pads an explicit (3, 3).
- Batch norm (running statistics) computes in fp32,
  ``(x - mean) · (rsqrt(var + 1e-5) · scale) + bias``, then casts to the
  model dtype; it is not folded into the convolutions.
- The pooled mean over H and W accumulates in fp32 and returns the model
  dtype; the dense head and the logits are fp32.

The convolutions are ``F.conv2d`` (cuDNN on the card): the JAX package
computes them outside any Pallas kernel, so this path has no kernel of
its own.
"""

import dataclasses
import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from client_tpu_torch.utils import numpy_to_tensor, resolve_device

NORM_EPS = 1e-5


@dataclasses.dataclass(frozen=True)
class ResNetConfig:
    """ResNet-50 by default: stage_sizes (3, 4, 6, 3), 64 filters."""

    stage_sizes: Tuple[int, ...] = (3, 4, 6, 3)
    num_classes: int = 1000
    num_filters: int = 64
    dtype: torch.dtype = torch.bfloat16

    def blocks(self) -> List[Tuple[int, int, int]]:
        """(input channels, filters, stride) of every bottleneck block, in
        order."""
        out, channels = [], self.num_filters
        for i, count in enumerate(self.stage_sizes):
            filters = self.num_filters * 2 ** i
            for j in range(count):
                out.append((channels, filters, 2 if i > 0 and j == 0 else 1))
                channels = filters * 4
        return out


def resnet50(num_classes: int = 1000, dtype: torch.dtype = torch.bfloat16) -> ResNetConfig:
    return ResNetConfig((3, 4, 6, 3), num_classes, 64, dtype)


def resnet18_thin(num_classes: int = 1000,
                  dtype: torch.dtype = torch.bfloat16) -> ResNetConfig:
    """The reference's small variant for tests (one block a stage, 16
    filters)."""
    return ResNetConfig((1, 1, 1, 1), num_classes, 16, dtype)


def _has_projection(in_channels: int, filters: int, stride: int) -> bool:
    # the reference projects where the shapes differ
    return in_channels != filters * 4 or stride != 1


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------


def init_params(generator: torch.Generator, config: ResNetConfig,
                device=None) -> Dict[str, Any]:
    """Random parameters drawn from ``generator`` (which must live on
    ``device``) with the reference's initializers: convolution and dense
    kernels LeCun-normal (truncated at two deviations), biases zero, norm
    scales one, running means zero and variances one — and each block's
    last norm scale zero."""
    device = resolve_device(device)

    def lecun(shape, fan_in):
        std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
        out = torch.empty(shape, device=device, dtype=torch.float32)
        return torch.nn.init.trunc_normal_(out, 0.0, std, -2 * std, 2 * std,
                                           generator=generator)

    def conv(out_c, in_c, k):
        w = lecun((out_c, in_c, k, k), in_c * k * k)
        return w.to(config.dtype).contiguous(memory_format=torch.channels_last)

    def norm(channels, scale=1.0):
        return {"scale": torch.full((channels,), scale, device=device),
                "bias": torch.zeros(channels, device=device),
                "mean": torch.zeros(channels, device=device),
                "var": torch.ones(channels, device=device)}

    f = config.num_filters
    params: Dict[str, Any] = {"conv_init": conv(f, 3, 7), "bn_init": norm(f), "blocks": []}
    for in_c, filters, stride in config.blocks():
        block = {"conv0": conv(filters, in_c, 1), "norm0": norm(filters),
                 "conv1": conv(filters, filters, 3), "norm1": norm(filters),
                 "conv2": conv(filters * 4, filters, 1), "norm2": norm(filters * 4, 0.0)}
        if _has_projection(in_c, filters, stride):
            block["conv_proj"] = conv(filters * 4, in_c, 1)
            block["norm_proj"] = norm(filters * 4)
        params["blocks"].append(block)
    width = config.blocks()[-1][1] * 4
    params["head_kernel"] = lecun((width, config.num_classes), width)
    params["head_bias"] = torch.zeros(config.num_classes, device=device)
    return params


def _conv_from_jax(tree, in_c: int, out_c: int, k: int, dtype, device) -> torch.Tensor:
    w = np.asarray(tree["kernel"], dtype=np.float32)
    if w.shape != (k, k, in_c, out_c):
        raise ValueError(f"kernel of shape {w.shape}, the config asks for {(k, k, in_c, out_c)}")
    w = numpy_to_tensor(w.transpose(3, 2, 0, 1), device)  # HWIO -> OIHW
    return w.to(dtype).contiguous(memory_format=torch.channels_last)


def _norm_from_jax(tree, stat, channels: int, device) -> Dict[str, torch.Tensor]:
    out = {"scale": tree["scale"], "bias": tree["bias"], "mean": stat["mean"],
           "var": stat["var"]}
    for name, value in out.items():
        if np.shape(value) != (channels,):
            raise ValueError(f"norm {name} of shape {np.shape(value)}, the config asks for "
                             f"{(channels,)}")
        out[name] = numpy_to_tensor(np.asarray(value, dtype=np.float32), device)
    return out


def block_from_jax(weights, stats, in_channels: int, filters: int, stride: int,
                   dtype: torch.dtype, device) -> Dict[str, Any]:
    """One ``ResNetBlock``'s variables (its ``params`` and ``batch_stats``
    subtrees, numpy) as the port's block params on ``device``."""
    block = {}
    shapes = ((in_channels, filters, 1), (filters, filters, 3), (filters, filters * 4, 1))
    for i, (cin, cout, k) in enumerate(shapes):
        block[f"conv{i}"] = _conv_from_jax(weights[f"Conv_{i}"], cin, cout, k, dtype, device)
        block[f"norm{i}"] = _norm_from_jax(weights[f"BatchNorm_{i}"], stats[f"BatchNorm_{i}"],
                                           cout, device)
    if _has_projection(in_channels, filters, stride):
        block["conv_proj"] = _conv_from_jax(weights["conv_proj"], in_channels, filters * 4, 1,
                                            dtype, device)
        block["norm_proj"] = _norm_from_jax(weights["norm_proj"], stats["norm_proj"],
                                            filters * 4, device)
    return block


def params_from_jax(variables: Dict[str, Any], config: ResNetConfig,
                    device=None) -> Dict[str, Any]:
    """The reference's ``{'params', 'batch_stats'}`` variables, given as
    numpy arrays (e.g. ``jax.tree.map(np.asarray, variables)``), as the
    port's parameters on ``device``: kernels HWIO -> OIHW in
    ``config.dtype``, norms and the head fp32. Raises when the variables
    do not have ``config``'s shapes."""
    device = resolve_device(device)
    weights, stats = variables["params"], variables["batch_stats"]
    f = config.num_filters
    params: Dict[str, Any] = {
        "conv_init": _conv_from_jax(weights["conv_init"], 3, f, 7, config.dtype, device),
        "bn_init": _norm_from_jax(weights["bn_init"], stats["bn_init"], f, device),
        "blocks": [],
    }
    names = sorted((k for k in weights if k.startswith("ResNetBlock_")),
                   key=lambda k: int(k.rsplit("_", 1)[1]))
    if len(names) != len(config.blocks()):
        raise ValueError(f"{len(names)} blocks, the config asks for {len(config.blocks())}")
    for name, (in_c, filters, stride) in zip(names, config.blocks()):
        params["blocks"].append(block_from_jax(weights[name], stats[name], in_c, filters,
                                               stride, config.dtype, device))
    kernel = np.asarray(weights["Dense_0"]["kernel"], dtype=np.float32)
    width = config.blocks()[-1][1] * 4
    if kernel.shape != (width, config.num_classes):
        raise ValueError(f"head kernel of shape {kernel.shape}, the config asks for "
                         f"{(width, config.num_classes)}")
    params["head_kernel"] = numpy_to_tensor(kernel, device)
    params["head_bias"] = numpy_to_tensor(
        np.asarray(weights["Dense_0"]["bias"], dtype=np.float32), device)
    return params


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


def same_padding(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    """flax/XLA ``SAME`` padding of one dim: (before, after)."""
    total = max((-(-size // stride) - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def _pad(x: torch.Tensor, kernel: int, stride: int,
         pads: Optional[Sequence[Tuple[int, int]]], value: float = 0.0):
    """``x`` [B, C, H, W] padded for a window of ``kernel``/``stride``:
    ``pads`` ((top, bottom), (left, right)), else SAME. Returns the
    tensor and the symmetric padding left for the op to apply itself
    (F.pad runs only where the two sides differ)."""
    if pads is None:
        pads = (same_padding(x.shape[2], kernel, stride),
                same_padding(x.shape[3], kernel, stride))
    (top, bottom), (left, right) = pads
    if top == bottom and left == right:
        return x, (top, left)
    return F.pad(x, (left, right, top, bottom), value=value), (0, 0)


def conv(x: torch.Tensor, weight: torch.Tensor, stride: int = 1,
         pads: Optional[Sequence[Tuple[int, int]]] = None) -> torch.Tensor:
    """A bias-free convolution with SAME (or explicit) padding."""
    x, padding = _pad(x, weight.shape[-1], stride, pads)
    return F.conv2d(x, weight, stride=stride, padding=padding)


def max_pool(x: torch.Tensor, kernel: int = 3, stride: int = 2) -> torch.Tensor:
    """Max pool with SAME padding by -inf."""
    x, padding = _pad(x, kernel, stride, None, value=-math.inf)
    return F.max_pool2d(x, kernel, stride, padding=padding)


def batch_norm(x: torch.Tensor, norm: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Inference batch norm in fp32, cast back to ``x``'s dtype."""
    shape = (1, -1, 1, 1)
    mul = torch.rsqrt(norm["var"] + NORM_EPS) * norm["scale"]
    y = (x - norm["mean"].view(shape)) * mul.view(shape) + norm["bias"].view(shape)
    return y.to(x.dtype)


def block(x: torch.Tensor, p: Dict[str, Any], stride: int) -> torch.Tensor:
    """One bottleneck block (1x1 -> 3x3 with the stride -> 1x1), the
    shortcut projected where ``p`` has ``conv_proj``."""
    y = torch.relu_(batch_norm(conv(x, p["conv0"]), p["norm0"]))
    y = torch.relu_(batch_norm(conv(y, p["conv1"], stride), p["norm1"]))
    y = batch_norm(conv(y, p["conv2"]), p["norm2"])
    if "conv_proj" in p:
        x = batch_norm(conv(x, p["conv_proj"], stride), p["norm_proj"])
    return torch.relu_(x + y)


def stem(params: Dict[str, Any], images_nhwc: torch.Tensor,
         config: ResNetConfig) -> torch.Tensor:
    """The cast to the model dtype, the 7x7/2 convolution, its norm and the
    3x3/2 max pool, NCHW-shaped in ``channels_last``."""
    x = images_nhwc.to(config.dtype).permute(0, 3, 1, 2)  # a view, channels_last
    x = conv(x, params["conv_init"], 2, pads=((3, 3), (3, 3)))
    return max_pool(torch.relu_(batch_norm(x, params["bn_init"])))


def forward(params: Dict[str, Any], images_nhwc: torch.Tensor,
            config: ResNetConfig) -> torch.Tensor:
    """Classify ``images_nhwc`` [B, H, W, 3] -> fp32 logits [B, classes]."""
    x = stem(params, images_nhwc, config)
    for p, (_, _, stride) in zip(params["blocks"], config.blocks()):
        x = block(x, p, stride)
    pooled = x.mean(dim=(2, 3), dtype=torch.float32).to(config.dtype)
    return pooled.float() @ params["head_kernel"] + params["head_bias"]
