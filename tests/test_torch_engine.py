"""The port's continuous-batching engine model against the JAX package.

``LlmEngineModel(device="cpu")`` on the tiny fp32 Llama, with the JAX
weights carried across by ``params_from_jax``, runs 8 concurrent greedy
generations — with and without a shared prompt prefix — and every stream
must equal JAX ``llama.generate`` on the same weights token for token
(fp32 keeps greedy decode stable across the engine's batch buckets).
Afterwards no KV block is left in use.
"""

import asyncio

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from client_tpu.models import llama as jax_llama
from client_tpu_torch.llm.engine import EngineConfig
from client_tpu_torch.llm.serving import LlmEngineModel
from client_tpu_torch.models import llama, paged_attention
from client_tpu_torch.scheduling import PriorityQueue
from client_tpu_torch.server.model_repository import ModelRepository, ModelUnavailableError
from client_tpu_torch.utils import InferenceServerException

torch.set_num_threads(1)

MAX_TOKENS = 10
JAX_CONFIG = jax_llama.LlamaConfig.tiny(max_seq_len=64, dtype=jnp.float32)


@pytest.fixture(scope="module")
def weights():
    init = jax.jit(lambda key: jax_llama.init_params(key, JAX_CONFIG))
    jax_params = init(jax.random.PRNGKey(0))
    params = llama.params_from_jax(jax.tree.map(np.asarray, jax_params), device="cpu")
    return jax_params, params


def _tiny_model(params, name="llm_engine", **kwargs):
    return LlmEngineModel(
        name=name,
        config=llama.LlamaConfig.tiny(max_seq_len=64, dtype=torch.float32),
        params=params,
        engine_config=EngineConfig(
            block_size=8, num_blocks=1 + 8 * 8, max_active=8, max_queue=32,
            max_seq_len=64,
        ),
        device="cpu",
        **kwargs,
    )


@pytest.fixture(scope="module")
def model(weights):
    _, params = weights
    model = _tiny_model(params)
    model.warmup()
    yield model
    model.shutdown()


def _jax_generate(jax_params, prompts):
    """JAX ``llama.generate`` over equal-length prompts, batched."""
    generate = jax.jit(lambda p, t: jax_llama.generate(p, t, JAX_CONFIG, MAX_TOKENS))
    return np.asarray(generate(jax_params, np.array(prompts, dtype=np.int32))).tolist()


async def _generate(model, prompt):
    out = []
    async for item in model.execute_decoupled(
        {"INPUT_IDS": np.array(prompt, dtype=np.int32)}, {"max_tokens": MAX_TOKENS}
    ):
        out.append(int(item["OUTPUT_IDS"][0]))
        if item["__final__"]:
            break
    return out


def _run_concurrently(model, prompts):
    async def run():
        return await asyncio.gather(*(_generate(model, p) for p in prompts))

    return asyncio.run(run())


@pytest.mark.parametrize("shared_prefix", [False, True], ids=["distinct", "shared-prefix"])
def test_eight_concurrent_generations_equal_jax_generate(weights, model, shared_prefix):
    jax_params, _ = weights
    rng = np.random.default_rng(4 if shared_prefix else 5)
    if shared_prefix:
        # 16 shared tokens = 2 full blocks, then a distinct tail
        prefix = rng.integers(2, 256, size=16).tolist()
        prompts = [prefix + rng.integers(2, 256, size=3).tolist() for _ in range(8)]
    else:
        prompts = [rng.integers(2, 256, size=11).tolist() for _ in range(8)]
    engine = model.engine
    hits_before = engine.allocator.prefix_hits
    streams = _run_concurrently(model, prompts)
    assert streams == _jax_generate(jax_params, prompts)
    if shared_prefix:
        assert engine.allocator.prefix_hits - hits_before >= 2 * 7
    assert engine.allocator.blocks_in_use == 0
    assert engine.stats()["active_sequences"] == 0


def test_config_reports_the_kernel_and_sharing(model):
    params = model.config()["parameters"]
    assert params["decode_kernel"]["string_value"] == "fused"
    assert params["tp"]["string_value"] == "1"
    assert params["prefix_sharing"]["string_value"] == "cow"
    assert model.config()["model_transaction_policy"] == {"decoupled": True}


def test_out_of_vocabulary_ids_are_refused(model):
    with pytest.raises(InferenceServerException, match="INPUT_IDS"):
        _run_concurrently(model, [[1, 2, 256]])
    assert model.engine.allocator.blocks_in_use == 0


@pytest.mark.parametrize(
    "kwargs,match",
    [({"tp": 2}, "tp > 1"), ({"speculation": {"mode": "bogus"}}, "speculative")],
)
def test_unported_options_raise(weights, kwargs, match):
    """``tp > 1`` is refused when the model is made. Speculation is
    ported; a declaration it cannot build (an unknown mode) fails the
    load: the repository entry is UNAVAILABLE with the reason."""
    if "tp" in kwargs:
        with pytest.raises(InferenceServerException, match=match):
            LlmEngineModel(device="cpu", **kwargs)
        return
    repository = ModelRepository()
    repository.add_model(_tiny_model(weights[1], name="bad_spec", **kwargs))
    (entry,) = repository.index()
    assert entry["state"] == "UNAVAILABLE"
    assert match in entry["reason"] and "unknown speculation mode 'bogus'" in entry["reason"]
    assert not repository.is_ready("bad_spec")


def test_a_failing_warmup_probe_fails_the_load(weights, monkeypatch):
    """Warmup picks one kernel; when its probe fails the model does not
    fall back to another — it registers UNAVAILABLE with the error."""
    def refused(*args):
        raise RuntimeError("kernel launch refused")

    monkeypatch.setattr(paged_attention, "resolve_decode_attention",
                        lambda device: ("cuda", refused))
    repository = ModelRepository()
    repository.add_model(_tiny_model(weights[1], name="broken"))
    (entry,) = repository.index()
    assert entry["state"] == "UNAVAILABLE"
    assert "kernel launch refused" in entry["reason"]
    assert not repository.is_ready("broken")
    with pytest.raises(ModelUnavailableError):
        repository.get("broken")


def test_priority_queue_orders_by_level_then_arrival_and_expires():
    queue = PriorityQueue(levels=3)
    a = queue.push("a", level=3)
    b = queue.push("b", level=1, deadline_ns=100)
    c = queue.push("c", level=1)
    d = queue.push("d", level=9)  # clamps to the lowest lane
    assert [item.value for item in queue.scan()] == ["b", "c", "a", "d"]
    assert queue.expire(100) == []
    assert [item.value for item in queue.expire(101)] == ["b"]
    queue.remove([a, d])
    assert [item.value for item in queue.scan()] == ["c"]
    assert len(queue) == 1 and c.level == 1
