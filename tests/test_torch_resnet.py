"""The port's ResNet (``client_tpu_torch/models/resnet.py``) against the
JAX package's (``client_tpu/models/resnet.py``) on the CPU.

The same seeded numpy inputs and variables go through both: the flax
variables' shapes come from ``jax.eval_shape`` of the reference's init and
are filled with random values, every norm perturbed (scale, bias,
running mean and variance), so that no residual branch is a no-op, as the
reference's default init (each block's last norm scale zero) would make
it. The port takes the variables through ``resnet.params_from_jax``.

- flax ``SAME`` padding, kernels 1, 3 and 7, strides 1 and 2, even and
  odd sizes: convolutions against ``jax.lax.conv_general_dilated`` and
  the 3x3/2 max pool against ``flax.linen.max_pool`` on all-negative
  inputs (the pool pads with -inf, not 0), within 1e-5;
- batch norm in fp32 (and in bf16, where the reference still computes in
  fp32), one block with a projected and one with an identity shortcut,
  within 1e-5 (fp32);
- the whole forward of ``ResNet(stage_sizes=(2, 1, 1, 1), num_filters=8)``
  at 32 x 32: logits within 1e-4 (fp32), and within 2 % of the largest
  |logit| in bf16.
"""

import dataclasses

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from client_tpu.models import resnet as jax_resnet
from client_tpu_torch.models import resnet
from client_tpu_torch.models.serving import ImageClassifierModel

torch.set_num_threads(1)

LAYER_TOL = 1e-5
LOGIT_TOL = 1e-4
STAGES, FILTERS, CLASSES, SIZE = (2, 1, 1, 1), 8, 10, 32
CONFIG = resnet.ResNetConfig(STAGES, CLASSES, FILTERS, torch.float32)


def _fill(shapes, seed):
    """Random variables of the reference's tree of shapes: kernels
    LeCun-scaled normals, every norm perturbed, the head's bias too."""
    rng = np.random.default_rng(seed)

    def leaf(path, shape):
        name = path[-1].key
        if name == "kernel":
            fan_in = int(np.prod(shape.shape[:-1]))
            return (rng.normal(size=shape.shape) / np.sqrt(fan_in)).astype(np.float32)
        if name in ("scale", "var"):
            return rng.uniform(0.5, 1.5, shape.shape).astype(np.float32)
        return rng.normal(0.0, 0.1, shape.shape).astype(np.float32)  # bias, mean

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _nhwc(x: torch.Tensor) -> np.ndarray:
    return x.permute(0, 2, 3, 1).float().numpy()


def _nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(x).permute(0, 3, 1, 2)


@pytest.fixture(scope="module")
def network():
    """The reference network at (2, 1, 1, 1)/8 in fp32 and bf16 (jitted
    once for the module), its random variables and the port's params."""
    model = jax_resnet.ResNet(stage_sizes=STAGES, num_classes=CLASSES,
                              num_filters=FILTERS, dtype=jnp.float32)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, SIZE, SIZE, 3), jnp.float32))
    variables = _fill(shapes, 0)
    return {
        "apply": jax.jit(model.apply),
        "apply_bf16": jax.jit(dataclasses.replace(model, dtype=jnp.bfloat16).apply),
        "shapes": shapes,
        "variables": variables,
        "params": resnet.params_from_jax(variables, CONFIG, "cpu"),
        "images": np.random.default_rng(1).normal(size=[2, SIZE, SIZE, 3]).astype(np.float32),
    }


# ---------------------------------------------------------------------------
# SAME padding
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("size", [8, 9], ids=["even", "odd"])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("kernel", [1, 3, 7])
def test_same_convolution_matches_lax(kernel, stride, size):
    rng = np.random.default_rng(kernel * 100 + stride * 10 + size)
    x = rng.normal(size=[2, size, size, 4]).astype(np.float32)
    w = rng.normal(size=[kernel, kernel, 4, 5]).astype(np.float32)
    want = np.asarray(jax.lax.conv_general_dilated(
        x, w, (stride, stride), "SAME", dimension_numbers=("NHWC", "HWIO", "NHWC")))
    pads = jax.lax.padtype_to_pads((size, size), (kernel, kernel), (stride, stride), "SAME")
    assert [resnet.same_padding(size, kernel, stride)] * 2 == [tuple(p) for p in pads]
    got = resnet.conv(_nchw(x), torch.from_numpy(w.transpose(3, 2, 0, 1)), stride)
    assert got.shape == (2, 5) + want.shape[1:3]
    np.testing.assert_allclose(_nhwc(got), want, rtol=0, atol=LAYER_TOL)


def test_stride_2_on_an_even_size_pads_nothing_before():
    """The trap: flax pads (0, 1) where torch's padding=1 pads (1, 1)."""
    assert resnet.same_padding(112, 3, 2) == (0, 1)
    assert resnet.same_padding(113, 3, 2) == (1, 1)
    assert resnet.same_padding(56, 3, 1) == (1, 1)
    assert resnet.same_padding(56, 1, 2) == (0, 0)


@pytest.mark.parametrize("size", [8, 9, 112], ids=["even", "odd", "stem"])
def test_max_pool_pads_with_minus_infinity_as_flax(size):
    rng = np.random.default_rng(size)
    x = (-np.abs(rng.normal(size=[2, size, size, 3])) - 1.0).astype(np.float32)
    want = np.asarray(nn.max_pool(jnp.asarray(x), (3, 3), strides=(2, 2), padding="SAME"))
    got = resnet.max_pool(_nchw(x))
    assert got.shape == (2, 3) + want.shape[1:3]
    np.testing.assert_array_equal(_nhwc(got), want)


# ---------------------------------------------------------------------------
# norms and blocks
# ---------------------------------------------------------------------------


def _jax_norm(dtype):
    return nn.BatchNorm(use_running_average=True, momentum=0.9, epsilon=1e-5, dtype=dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_batch_norm_computes_in_fp32(dtype):
    """fp32 within 1e-5; bf16 input: the reference still normalizes in
    fp32 and rounds once, and the port's output equals it bit for bit
    (bf16 arithmetic, or ``F.batch_norm`` on bf16 tensors, is off by up to
    a bf16 ulp of the largest output here)."""
    rng = np.random.default_rng(7)
    x = rng.normal(2.0, 3.0, size=[2, 5, 5, 6]).astype(np.float32)
    stats = {"mean": rng.normal(size=6).astype(np.float32),
             "var": rng.uniform(0.5, 4.0, 6).astype(np.float32)}
    weights = {"scale": rng.uniform(0.5, 1.5, 6).astype(np.float32),
               "bias": rng.normal(size=6).astype(np.float32)}
    jdtype = getattr(jnp, dtype)
    want = _jax_norm(jdtype).apply({"params": weights, "batch_stats": stats},
                                   jnp.asarray(x, jdtype))
    assert want.dtype == jdtype
    norm = {k: torch.from_numpy(v) for k, v in {**weights, **stats}.items()}
    got = resnet.batch_norm(_nchw(x).to(getattr(torch, dtype)), norm)
    assert got.dtype == getattr(torch, dtype)
    want = np.asarray(want, np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(_nhwc(got), want, rtol=0, atol=LAYER_TOL)
    else:
        np.testing.assert_array_equal(_nhwc(got), want)


@pytest.mark.parametrize("in_channels,filters,stride", [(8, 4, 2), (16, 4, 1)],
                         ids=["projection", "identity"])
def test_block_matches_flax(in_channels, filters, stride):
    block = jax_resnet.ResNetBlock(filters, (stride, stride), dtype=jnp.float32)
    x = np.random.default_rng(9).normal(size=[2, 9, 9, in_channels]).astype(np.float32)
    shapes = jax.eval_shape(block.init, jax.random.PRNGKey(0), jnp.asarray(x))
    variables = _fill(shapes, 3)
    assert ("conv_proj" in variables["params"]) == (in_channels != 4 * filters or stride != 1)
    want = np.asarray(jax.jit(block.apply)(variables, x))
    params = resnet.block_from_jax(variables["params"], variables["batch_stats"],
                                   in_channels, filters, stride, torch.float32, "cpu")
    got = resnet.block(_nchw(x), params, stride)
    np.testing.assert_allclose(_nhwc(got), want, rtol=0, atol=LAYER_TOL)


# ---------------------------------------------------------------------------
# the whole network
# ---------------------------------------------------------------------------


def test_forward_matches_the_reference_fp32(network):
    want = np.asarray(network["apply"](network["variables"], network["images"]))
    got = resnet.forward(network["params"], torch.from_numpy(network["images"]), CONFIG)
    assert got.dtype == torch.float32 and got.shape == (2, CLASSES)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=LOGIT_TOL)
    # the stem (7x7/2 with explicit (3, 3) padding, norm, -inf max pool)
    # is one layer of the comparison too
    stem = resnet.stem(network["params"], torch.from_numpy(network["images"]), CONFIG)
    assert stem.shape == (2, FILTERS, 8, 8)


def test_forward_bf16_within_2_percent(network):
    want = np.asarray(network["apply_bf16"](network["variables"], network["images"]))
    assert want.dtype == np.float32
    config = dataclasses.replace(CONFIG, dtype=torch.bfloat16)
    params = resnet.params_from_jax(network["variables"], config, "cpu")
    assert params["conv_init"].dtype == torch.bfloat16
    assert params["bn_init"]["scale"].dtype == torch.float32
    got = resnet.forward(params, torch.from_numpy(network["images"]), config).numpy()
    assert np.isfinite(got).all()
    assert np.abs(got - want).max() <= 2e-2 * np.abs(want).max()


def test_init_params_mirrors_the_reference_layout(network):
    """Same structure and shapes as the reference's variables through
    ``params_from_jax``; each block's last norm scale is zero, the other
    scales one, kernels truncated LeCun normals."""
    params = resnet.init_params(torch.Generator().manual_seed(0), CONFIG, "cpu")
    ported = network["params"]

    def shapes(tree):
        if isinstance(tree, dict):
            return {k: shapes(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [shapes(v) for v in tree]
        return tuple(tree.shape)

    assert shapes(params) == shapes(ported)
    for block in params["blocks"]:
        assert torch.count_nonzero(block["norm2"]["scale"]) == 0
        assert torch.all(block["norm0"]["scale"] == 1) and torch.all(block["norm0"]["var"] == 1)
    kernel = params["blocks"][0]["conv1"].float()
    std = (1.0 / (FILTERS * 9)) ** 0.5 / 0.87962566103423978
    assert kernel.abs().max() <= 2 * std
    assert abs(kernel.std().item() - 0.88 * std) < 0.2 * std
    assert params["conv_init"].is_contiguous(memory_format=torch.channels_last)


def test_params_from_jax_refuses_other_shapes(network):
    with pytest.raises(ValueError, match="blocks"):
        resnet.params_from_jax(network["variables"],
                               dataclasses.replace(CONFIG, stage_sizes=(1, 1, 1, 1)), "cpu")
    with pytest.raises(ValueError, match="kernel"):
        resnet.params_from_jax(network["variables"],
                               dataclasses.replace(CONFIG, num_filters=16), "cpu")
    with pytest.raises(ValueError, match="head"):
        resnet.params_from_jax(network["variables"],
                               dataclasses.replace(CONFIG, num_classes=11), "cpu")


def test_classifier_model_pads_batches_and_keeps_the_true_rows(network):
    model = ImageClassifierModel(image_size=SIZE, config=CONFIG, params=network["params"],
                                 class_labels=[f"c{i}" for i in range(CLASSES)], device="cpu")
    model.warmup()
    images = np.random.default_rng(2).normal(size=[3, SIZE, SIZE, 3]).astype(np.float32)
    out = model.execute({"INPUT": images}, {})["OUTPUT"]
    want = resnet.forward(network["params"], torch.from_numpy(images), CONFIG).numpy()
    assert out.shape == (3, CLASSES) and out.dtype == np.float32
    np.testing.assert_allclose(out, want, rtol=0, atol=LAYER_TOL)
    single = model.execute({"INPUT": images[0]}, {})["OUTPUT"]
    np.testing.assert_allclose(single[0], want[0], rtol=0, atol=LAYER_TOL)
    assert model.labels("OUTPUT")[3] == "c3"
    assert model.outputs == [{"name": "OUTPUT", "datatype": "FP32", "shape": [CLASSES]}]
    assert model.inputs == [{"name": "INPUT", "datatype": "FP32", "shape": [SIZE, SIZE, 3]}]
