"""How ``correct`` is decided: the served answers against the plain
reference, once the window has closed and the program is gone.

A served decoder (``served_logit_gap``): a sample drawn from the seed of
the streams the window served to the end, the longest among them. The
reference runs once over each prompt and its served tokens, and the
number is the widest gap by which a served token's logit lies below the
reference's best at that position. Greedy streams on sound bf16
arithmetic part from the float32 reference only at near-ties.

A served encoder (``answer_error``): the answers of a sample drawn from
the seed of the requests sent in the window, each against the
reference's answer for the request alone, unpadded; the number is the
largest ``max |answer - reference| / max |reference|``.

A model type (``systems/<system>.py``) picks its comparison in its
``compare(run, weights, control)``. The control of each number
(``control=True``) puts the reference, computed in fp8
(``reference/linear.py``), in the program's place and judges it alike;
the benchmark's own runs do not compute it.
"""

import base64
from typing import Any, Dict, List, Sequence, Tuple

import numpy as np

from harness import traffic
from reference import decoder, encoder, linear, tokenizer


def _draw(seed: int, population: int, count: int, salt: int) -> List[int]:
    rng = np.random.default_rng(np.random.SeedSequence([int(seed), salt]))
    return sorted(rng.choice(population, size=min(count, population), replace=False).tolist())


def decoder_sample(run) -> List[Tuple[List[int], List[int]]]:
    """(prompt ids, served tokens) of the streams the check compares:
    the longest stream served to the end after the window opened, and
    ``check_requests - 1`` more drawn from the seed."""
    plan = traffic.Plan(run.mix, run.seed)
    finished = [r for r in run.records
                if r.get("done") and "error" not in r and r.get("t_first", 0) >= run.open_ns
                and len(r["tokens"]) == plan.request(r["slot"], r["k"])["max_tokens"]]
    finished.sort(key=lambda r: (r["slot"], r["k"]))
    if not finished:
        return []
    longest = max(range(len(finished)), key=lambda i: (
        len(plan.request(finished[i]["slot"], finished[i]["k"])["prompt"].split())
        + len(finished[i]["tokens"])))
    rest = [i for i in range(len(finished)) if i != longest]
    chosen = [longest] + [rest[i] for i in _draw(run.seed, len(rest),
                                                 int(run.mix["check_requests"]) - 1, 0x6A)]
    vocab = int(run.sizes["vocab_size"])
    out = []
    for i in chosen:
        record = finished[i]
        prompt = plan.request(record["slot"], record["k"])["prompt"]
        out.append((tokenizer.encode(prompt, vocab), list(record["tokens"])))
    return out


def _decoder_logits(weights, sizes, sample, linear_fn):
    sequences = [ids + served[:-1] for ids, served in sample]
    rows = [range(len(ids) - 1, len(ids) - 1 + len(served)) for ids, served in sample]
    return decoder.logits(weights, sizes, sequences, rows, linear=linear_fn)


def served_logit_gap(weights, sizes, sample, control: bool = False) -> float:
    """The widest gap below the reference's best logit of any served
    token of the sample. For the ``control``, the token judged at each
    served position is the one the fp8 reference puts first there, along
    the same prompts and served tokens (a control need not decode)."""
    import torch

    exact = _decoder_logits(weights, sizes, sample, linear.exact)
    if control:
        picks = [low.argmax(1) for low in _decoder_logits(weights, sizes, sample, linear.fp8)]
    else:
        picks = [torch.as_tensor(served) for _, served in sample]
    widest = 0.0
    for ref, pick in zip(exact, picks):
        picked = ref.gather(1, pick.to(ref.device)[:, None])[:, 0]
        widest = max(widest, float((ref.max(1).values - picked).max()))
    return widest


def encoder_sample(run) -> List[Tuple[Sequence[int], np.ndarray]]:
    """(token ids, served answer) of ``check_requests`` requests sent in
    the window and answered, drawn from the seed among those whose
    answers the client kept (its own draw from the seed)."""
    plan = traffic.Plan(run.mix, run.seed, run.sizes["vocab_size"])
    kept = sorted((r for r in run.records
                   if "answer" in r and run.open_ns <= r["t_send"] < run.close_ns),
                  key=lambda r: (r["slot"], r["k"]))
    out = []
    for i in _draw(run.seed, len(kept), int(run.mix["check_requests"]), 0x6B):
        r = kept[i]
        answer = np.frombuffer(base64.b64decode(r["answer"]), dtype="<f4")
        out.append((plan.request(r["slot"], r["k"])["ids"].tolist(), answer))
    return out


def _relative_errors(answers, references) -> float:
    widest = 0.0
    for answer, ref in zip(answers, references):
        ref = ref.float().cpu().numpy()
        widest = max(widest, float(np.abs(np.asarray(answer) - ref).max() / np.abs(ref).max()))
    return widest


def answer_error(weights, sizes, sample, control: bool = False) -> float:
    """The widest relative error of a served answer of the sample; for
    the ``control``, of the fp8 reference's answer in its place."""
    ids = [i for i, _ in sample]
    refs = encoder.embeddings(weights, sizes, ids, linear=linear.exact)
    if control:
        answers = [t.float().cpu().numpy() for t in
                   encoder.embeddings(weights, sizes, ids, linear=linear.fp8)]
    else:
        answers = [a for _, a in sample]
    return _relative_errors(answers, refs)


def passed(name: str, check: Dict[str, Any]) -> bool:
    """A count (``checked_*``) has a least value, every other number a
    greatest; a number that could not be read fails."""
    if check["value"] is None:
        return False
    if name.startswith("checked_"):
        return check["value"] >= check["limit"]
    return check["value"] <= check["limit"]
