"""The port's training half and ``graft_entry`` against the JAX package's.

- ``loss_fn`` within 1e-5 of the reference's on the same fp32 tiny
  weights (the JAX pytree through ``params_from_jax``) and tokens;
- gradients within 1e-5 (max abs) of ``jax.grad(loss_fn)``, unsharded and
  under each ``[cpu] * n`` plan: dp2, tp2, dp1 x sp4 x tp2 (the
  reference's own mesh in ``test_llama_forward_with_sp_mesh``) and
  dp2 x sp2 x tp2;
- ``forward`` under each plan within 1e-4 of the reference's
  ``forward(mesh=None)``;
- three ``make_train_step`` steps against the reference's
  ``make_train_step(config, None)`` (optax AdamW): losses within 1e-5,
  parameters within 1e-4, unsharded and under each plan;
- the counterpart of ``test_llama_sharded_train_step``: bf16 tiny at
  dp2 x sp2 x tp2 learns one batch over 3 steps;
- ``graft_entry``: ``_factor_mesh`` equal to ``__graft_entry__``'s, the
  tiny forward, both factorizations of ``dryrun_multichip(8)`` on the
  CPU, and no silent CPU without a card;
- a plan that spans processes is refused.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as jax_graft_entry
from client_tpu.models import llama as jax_llama
from client_tpu_torch import graft_entry
from client_tpu_torch.models import llama
from client_tpu_torch.parallel import sharding

torch.set_num_threads(1)

CPU = torch.device("cpu")
STEPS = 3
PLANS = {
    "dp2": {"dp": 2},
    "tp2": {"tp": 2},
    "dp1xsp4xtp2": {"dp": 1, "sp": 4, "tp": 2},
    "dp2xsp2xtp2": {"dp": 2, "sp": 2, "tp": 2},
}


def _plan(name):
    if name is None:
        return None
    axes = PLANS[name]
    spec = sharding.MeshSpec.parse({"axes": axes})
    return sharding.resolve(spec, [CPU] * spec.device_count)


def _as_numpy(tree):
    return jax.tree.map(np.asarray, tree)


def _max_diff(ours, theirs):
    """The largest |difference| over two parameter trees (torch, numpy)."""
    return max(float(np.abs(a.detach().numpy() - b).max())
               for a, b in zip(llama._leaves(ours), jax.tree.leaves(theirs)))


@pytest.fixture(scope="module")
def reference():
    """fp32 tiny weights, tokens [4, 16] from a numpy seed, and the
    reference's loss, gradients, logits and three AdamW steps on them."""
    config = jax_llama.LlamaConfig.tiny(dtype=jnp.float32)
    params = jax_llama.init_params(jax.random.PRNGKey(7), config)
    tokens = np.random.default_rng(7).integers(0, config.vocab_size, [4, 16]).astype(np.int32)
    loss, grads = jax.value_and_grad(jax_llama.loss_fn)(params, tokens, config, None)
    logits = jax_llama.forward(params, tokens, config, mesh=None)
    train_step, optimizer = jax_llama.make_train_step(config, None)
    state, opt_state, losses = params, optimizer.init(params), []
    for _ in range(STEPS):
        state, opt_state, step_loss = train_step(state, opt_state, tokens)
        losses.append(float(step_loss))
    return {"params": _as_numpy(params), "tokens": tokens, "loss": float(loss),
            "grads": _as_numpy(grads), "logits": np.asarray(logits), "losses": losses,
            "trained": _as_numpy(state)}


def _ours(reference):
    return llama.params_from_jax(reference["params"], device="cpu")


CONFIG = llama.LlamaConfig.tiny(dtype=torch.float32)


def test_loss_fn_matches_the_reference(reference):
    loss = llama.loss_fn(_ours(reference), torch.from_numpy(reference["tokens"]), CONFIG)
    assert loss.shape == () and loss.dtype == torch.float32
    assert abs(float(loss) - reference["loss"]) <= 1e-5


@pytest.mark.parametrize("plan", [None, *PLANS], ids=["unsharded", *PLANS])
def test_gradients_match_jax_grad(reference, plan):
    params = _ours(reference)
    leaves = [leaf.requires_grad_() for leaf in llama._leaves(params)]
    loss = llama.loss_fn(params, torch.from_numpy(reference["tokens"]), CONFIG, _plan(plan))
    grads = torch.autograd.grad(loss, leaves)
    assert abs(float(loss.detach()) - reference["loss"]) <= 1e-5
    for ours, theirs in zip(grads, jax.tree.leaves(reference["grads"])):
        assert ours.shape == theirs.shape
        assert float(np.abs(ours.numpy() - theirs).max()) <= 1e-5


@pytest.mark.parametrize("plan", list(PLANS))
def test_forward_under_a_plan_matches_the_reference(reference, plan):
    with torch.no_grad():
        logits = llama.forward(_ours(reference), torch.from_numpy(reference["tokens"]),
                               CONFIG, mesh=_plan(plan))
    assert logits.shape == reference["logits"].shape
    assert logits.dtype == torch.float32
    assert float(np.abs(logits.numpy() - reference["logits"]).max()) <= 1e-4


@pytest.mark.parametrize("plan", [None, *PLANS], ids=["unsharded", *PLANS])
def test_three_train_steps_match_the_reference(reference, plan):
    train_step, optimizer = llama.make_train_step(CONFIG, _plan(plan))
    params = _ours(reference)
    opt_state = optimizer.init(params)
    tokens = torch.from_numpy(reference["tokens"])
    losses = []
    for _ in range(STEPS):
        params, opt_state, loss = train_step(params, opt_state, tokens)
        losses.append(float(loss))
    assert opt_state.count == STEPS
    assert np.abs(np.array(losses) - reference["losses"]).max() <= 1e-5
    assert _max_diff(params, reference["trained"]) <= 1e-4


def test_adamw_has_optax_defaults():
    optimizer = llama.make_train_step(CONFIG, None)[1]
    assert (optimizer.learning_rate, optimizer.b1, optimizer.b2, optimizer.eps,
            optimizer.weight_decay) == (1e-3, 0.9, 0.999, 1e-8, 1e-4)
    params = {"w": torch.ones(3, dtype=torch.bfloat16)}
    state = optimizer.init(params)
    assert [m.dtype for m in state.mu + state.nu] == [torch.bfloat16] * 2


def test_sharded_bf16_train_step_learns():
    """The port's ``test_llama_sharded_train_step``: bf16 tiny weights,
    dp2 x sp2 x tp2, one batch memorised over three steps."""
    config = llama.LlamaConfig.tiny()
    params = llama.init_params(torch.Generator().manual_seed(0), config, device="cpu")
    train_step, optimizer = llama.make_train_step(config, _plan("dp2xsp2xtp2"))
    opt_state = optimizer.init(params)
    tokens = torch.from_numpy(np.random.default_rng(1).integers(0, 255, [4, 16]))
    losses = []
    for _ in range(STEPS):
        params, opt_state, loss = train_step(params, opt_state, tokens)
        losses.append(float(loss))
    assert params["embed"].dtype == torch.bfloat16
    assert np.isfinite(losses).all() and losses[-1] < losses[0]


def test_a_plan_that_spans_processes_is_refused(reference):
    spec = sharding.MeshSpec.parse({"axes": {"tp": 2}})
    pod_plan = sharding.MeshPlan(spec=spec, devices=(CPU, CPU), process_count=2,
                                 local_device_count=1, owners=(0, 1))
    tokens = torch.from_numpy(reference["tokens"])
    with pytest.raises(ValueError, match="one process only"):
        llama.forward(_ours(reference), tokens, CONFIG, mesh=pod_plan)
    with pytest.raises(ValueError, match="one process only"):
        llama.make_train_step(CONFIG, pod_plan)


@pytest.mark.parametrize("n", range(1, 17))
def test_factor_mesh_matches_the_reference(n):
    assert graft_entry._factor_mesh(n) == jax_graft_entry._factor_mesh(n)


def test_entry_gives_the_tiny_forward():
    fn, (params, tokens) = graft_entry.entry(device="cpu")
    assert tokens.shape == (2, 16) and not tokens.any()
    logits = fn(params, tokens)
    assert logits.shape == (2, 16, llama.LlamaConfig.tiny().vocab_size)
    assert logits.dtype == torch.float32 and bool(torch.isfinite(logits).all())


def test_dryrun_multichip_runs_both_factorizations(capsys):
    losses = graft_entry.dryrun_multichip(8, devices=["cpu"] * 8)
    assert [mesh for mesh, _ in losses] == [(2, 2, 2), (1, 2, 4)]
    values = [loss for _, loss in losses]
    assert np.isfinite(values).all() and abs(values[0] - values[1]) <= 1e-3
    out = capsys.readouterr().out
    assert "dryrun_multichip ok: mesh dp=2 sp=2 tp=2" in out
    assert "dryrun_multichip ok: mesh dp=1 sp=2 tp=4" in out


def test_training_entry_points_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda: graft_entry.entry(), lambda: graft_entry.entry(device="cuda"),
                 lambda: graft_entry.dryrun_multichip(8),
                 lambda: graft_entry.dryrun_multichip(8, devices=["cuda:0"] * 8)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    with pytest.raises(RuntimeError, match="need 8 devices, have 2"):
        graft_entry.dryrun_multichip(8, devices=["cpu"] * 2)
