"""attn_kernel_share.bert: the share of the window's BERT layers whose
attention ran the hand-written kernel, in percent: the model's kernel
launches (``kernel_launches.encoder_attention`` of its statistics entry,
a running count) over the executions (``execution_count``) times the
configuration's layers, each the difference between the window's
closing and its opening. None where the program books no such count."""


def read(run):
    if run.system != "text_encoder" or "close" not in run.counters:
        return None
    opened, closed = run.counters["open"], run.counters["close"]
    counts = [doc.get("kernel_launches", {}).get("encoder_attention") for doc in (opened, closed)]
    if None in counts:
        return None
    executions = closed["execution_count"] - opened["execution_count"]
    if not executions:
        return None
    return 100.0 * (counts[1] - counts[0]) / (executions * run.sizes["num_hidden_layers"])
