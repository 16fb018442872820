"""A grouped-query decoder served by the port's LLM engine
(``LlmEngineModel`` over ``models/llama.py``): the engine's admission,
paged cache and decode batch behind the OpenAI chat route. Judged by the
widest gap below the float32 reference's best logit of a served token
(``check.served_logit_gap``, ``reference/decoder.py``)."""

from harness import check
from harness import weights as drawn

# the model's KServe tensors; the chat route streams text instead
INFER_TENSORS = ("INPUT_IDS", "OUTPUT_IDS")


def weights(sizes, seed, device):
    return drawn.decoder(sizes, seed, device)


def build(config, sizes, weights, device, spans):
    import torch

    from client_tpu_torch.llm.engine import EngineConfig
    from client_tpu_torch.llm.serving import LlmEngineModel
    from client_tpu_torch.models import llama

    serve = config["serve"]
    model_config = llama.LlamaConfig(
        vocab_size=sizes["vocab_size"], d_model=sizes["hidden_size"],
        n_layers=sizes["num_hidden_layers"], n_heads=sizes["num_attention_heads"],
        n_kv_heads=sizes["num_key_value_heads"], d_ff=sizes["intermediate_size"],
        max_seq_len=serve["max_seq_len"], rope_theta=float(sizes["rope_theta"]),
        norm_eps=float(sizes["rms_norm_eps"]), dtype=getattr(torch, serve["dtype"]))
    engine_config = EngineConfig(max_seq_len=serve["max_seq_len"], **serve["engine"])
    model = LlmEngineModel(name=serve["system"], config=model_config, params=weights,
                           engine_config=engine_config, device=device)
    if spans is not None:
        model.device_fn_wrapper = spans.wrap_engine
    return model


def warm(config, model, mix):
    """Nothing: the engine's warm-up probes and the ramp cover its
    shapes."""


def counters(model, server):
    return dict(model.engine.stats())


def compare(run, weights, control=False):
    limits = run.config["serve"]["check_limits"]
    sample = check.decoder_sample(run)
    served = sum(len(s) for _, s in sample)
    value = check.served_logit_gap(weights, run.sizes, sample, control) if sample else None
    return {"served_logit_gap": {"value": value, "limit": limits["served_logit_gap"]},
            "checked_tokens": {"value": served, "limit": limits["min_checked_tokens"]}}


def tiny(config, mix):
    """In float32 the program computes what the reference does: its gap
    reads 0.0 there, the fp8 control's 0.148, and the limit is 0.02."""
    config.update(vocab_size=512, hidden_size=64, intermediate_size=128,
                  num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2)
    config["serve"]["max_seq_len"] = 256
    config["serve"]["engine"].update(max_active=8, num_blocks=1 + 8 * 16)
    config["serve"]["check_limits"].update(min_checked_tokens=20, served_logit_gap=0.02)
    mix.update(concurrency=4, ramp_s=1)
    # outputs as long as the prompts, so that the decode steps' own keys
    # and values weigh in every answer
    mix["prompt_tokens"].update(median=16, min=8, max=32)
    mix["output_tokens"].update(min=16, max=48)
