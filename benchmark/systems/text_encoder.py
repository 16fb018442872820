"""A BERT-family encoder served by the port's ``TextEncoderModel``
(``models/bert.py``) behind the dynamic batcher with ragged padding, on
the ``/infer`` route. Judged by the widest relative error of a served
answer against the float32 reference's for the request alone, unpadded
(``check.answer_error``, ``reference/encoder.py``)."""

import numpy as np

from harness import check
from harness import weights as drawn

INFER_TENSORS = ("INPUT_IDS", "EMBEDDING")


def weights(sizes, seed, device):
    return drawn.encoder(sizes, seed, device)


def build(config, sizes, weights, device, spans):
    import torch

    from client_tpu_torch.models import bert
    from client_tpu_torch.models.serving import TextEncoderModel

    serve = config["serve"]
    model_config = bert.BertConfig(
        vocab_size=sizes["vocab_size"], d_model=sizes["hidden_size"],
        n_layers=sizes["num_hidden_layers"], n_heads=sizes["num_attention_heads"],
        d_ff=sizes["intermediate_size"], max_seq_len=sizes["max_position_embeddings"],
        pad_token_id=sizes["pad_token_id"], norm_eps=float(sizes["layer_norm_eps"]),
        dtype=getattr(torch, serve["dtype"]))
    model = TextEncoderModel(name=serve["system"], config=model_config,
                             params=weights, device=device)
    model.max_batch_size = int(serve["max_batch_size"])
    if spans is not None:
        spans.wrap_execute(model)
    return model


def warm(config, model, mix):
    """Every row bucket up to the batch limit by every length bucket of
    the mix's lengths."""
    spec = mix["input_tokens"]
    rows, lengths = [], []
    r = 1
    while r <= model.max_batch_size:
        rows.append(r)
        r *= 2
    n = 8
    while n < spec["max"]:
        n *= 2
        if n >= spec["min"]:
            lengths.append(n)
    for r in rows:
        for n in lengths:
            model.execute({INFER_TENSORS[0]: np.ones([r, n], dtype=np.int32)}, {})


def counters(model, server):
    return server.statistics()


def compare(run, weights, control=False):
    limits = run.config["serve"]["check_limits"]
    sample = check.encoder_sample(run)
    value = check.answer_error(weights, run.sizes, sample, control) if sample else None
    return {"answer_error": {"value": value, "limit": limits["answer_error"]},
            "checked_answers": {"value": len(sample), "limit": limits["min_checked_answers"]}}


def tiny(config, mix):
    """In float32 the program computes what the reference does: its error
    reads 2.4e-7 there, the fp8 control's 0.059, and the limit is 0.01."""
    config.update(vocab_size=1024, hidden_size=64, intermediate_size=128,
                  num_hidden_layers=2, num_attention_heads=4, max_position_embeddings=128)
    config["serve"]["check_limits"].update(min_checked_answers=8, answer_error=0.01)
    mix.update(concurrency=4, ramp_s=1, check_requests=16)
    mix["input_tokens"].update(median=32, min=8, max=128)
