"""Draft proposers for speculative decoding.

Speculative decoding splits a decode step in two: a cheap proposer
guesses up to K candidate tokens per running sequence, and the target
model verifies all K+1 positions in one multi-query paged-attention call
(``models/llama.py`` ``decode_step_paged_multi``). The engine walks the
verified logits with the same seeded per-token sampling it uses for plain
decoding and accepts a draft token only when it equals the token the
target would have sampled, so the emitted stream is token-for-token that
of plain decoding (greedy and seeded sampling); speculation only changes
how many tokens one device call yields.

Two proposers, selected per model through the ``speculation`` attrs
(``{"mode": "draft" | "ngram", "k": N, ...}``):

- :class:`NgramProposer`: prompt-lookup decoding. Find the most recent
  earlier occurrence of the context's trailing n-gram and propose the
  tokens that followed it. No extra compute and no second model.
- :class:`DraftModelProposer`: a small draft Llama sharing the target's
  vocabulary rolls K greedy tokens over a dense cache of the full
  context.

Proposers are pure functions of the context and keep no state across
steps, so preemption and resume replay identically and a rejected
proposal leaves nothing to roll back on the proposer side.
"""

import dataclasses
from typing import Any, List, Optional, Sequence

import numpy as np
import torch

from client_tpu_torch.models import llama
from client_tpu_torch.server.models import pad_batch_bucket
from client_tpu_torch.utils import resolve_device


class NgramProposer:
    """Prompt-lookup proposer: match the trailing n-gram, copy what
    followed its most recent earlier occurrence.

    ``ngram`` is the longest suffix tried first; shorter suffixes (down
    to ``min_ngram``) are tried only when the longer one has no earlier
    occurrence, since a longer match is better evidence that the
    continuation repeats. Pure host-side list scanning.
    """

    name = "ngram"

    def __init__(self, k: int, ngram: int = 3, min_ngram: int = 1):
        if k < 1:
            raise ValueError(f"speculation k must be >= 1, got {k}")
        if ngram < 1 or min_ngram < 1 or min_ngram > ngram:
            raise ValueError(
                f"need 1 <= min_ngram <= ngram, got {min_ngram}..{ngram}"
            )
        self.k = int(k)
        self.ngram = int(ngram)
        self.min_ngram = int(min_ngram)

    def propose(self, context: Sequence[int], k: int) -> List[int]:
        """Up to ``k`` candidate continuations of ``context`` (possibly
        fewer, possibly none: the engine treats a short proposal as a
        smaller speculative step, never an error)."""
        k = min(int(k), self.k)
        context = list(context)
        n_ctx = len(context)
        if k < 1 or n_ctx < self.min_ngram + 1:
            return []
        for n in range(min(self.ngram, n_ctx - 1), self.min_ngram - 1, -1):
            suffix = context[n_ctx - n:]
            # rightmost earlier occurrence: recent repetition predicts the
            # immediate continuation better than distant repetition
            for start in range(n_ctx - n - 1, -1, -1):
                if context[start:start + n] == suffix:
                    follow = context[start + n:start + n + k]
                    if follow:
                        return [int(t) for t in follow]
        return []


class DraftModelProposer:
    """Greedy K-token rollout of a draft Llama over the full context.

    The draft shares the target's vocabulary (its proposals are token ids
    the target can verify directly) and runs dense: a scratch KV cache of
    its own per call, never the paged pool, so a rejected proposal has no
    draft-side state to unwind. The context is padded to a power-of-two
    bucket (at least 8) before the prefill, as the JAX package's jitted
    rollout pads it, so both compute the same thing; the rollout itself is
    a Python loop over :func:`llama.decode_step` on the parameters'
    device.
    """

    name = "draft"

    def __init__(self, params: Any, config: llama.LlamaConfig, k: int):
        if k < 1:
            raise ValueError(f"speculation k must be >= 1, got {k}")
        self.k = int(k)
        self._params = params
        self._config = config

    def propose(self, context: Sequence[int], k: int) -> List[int]:
        """Up to ``k`` greedy draft tokens after ``context``. Enters
        inference mode itself: the engine calls it from executor
        threads, and the mode is per thread."""
        k = min(int(k), self.k)
        context = list(context)
        if k < 1 or not context:
            return []
        config = self._config
        # the dense rollout covers the whole context (absolute positions
        # are cache indices); a context close to the draft's limit
        # shrinks the proposal rather than overflowing the scratch cache
        k = min(k, config.max_seq_len - len(context))
        if k < 1:
            return []
        bucket = min(pad_batch_bucket(len(context), minimum=8), config.max_seq_len)
        padded = np.zeros([1, bucket], dtype=np.int32)
        padded[0, :len(context)] = context
        device = self._params["embed"].device
        with torch.inference_mode():
            tokens = torch.from_numpy(padded).to(device)
            cache = llama.init_kv_cache(config, 1, bucket + k, device=device)
            logits, cache = llama.prefill_with_cache(
                self._params, tokens, cache, config, last_index=len(context) - 1
            )
            token = logits.argmax(dim=-1).to(torch.int32)  # [1]
            drafts = [token]
            for position in range(len(context), len(context) + k - 1):
                logits, cache = llama.decode_step(
                    self._params, token, position, cache, config
                )
                token = logits.argmax(dim=-1).to(torch.int32)
                drafts.append(token)
            # one device-to-host copy for the whole rollout
            return [int(t) for t in torch.cat(drafts).tolist()]


def build_proposer(
    speculation: dict,
    target_config: Optional[llama.LlamaConfig] = None,
    draft_params: Any = None,
    draft_config: Optional[llama.LlamaConfig] = None,
    device=None,
) -> Any:
    """The proposer a model's ``speculation`` attrs describe.

    ``{"mode": "ngram", "k": N, "ngram": M}`` needs nothing else;
    ``{"mode": "draft", "k": N}`` uses ``draft_params``/``draft_config``
    when given, else a fresh half-depth twin of the target config (same
    vocabulary) with weights drawn on ``device`` (``cuda`` unless the
    caller passes ``"cpu"``) from a ``torch.Generator`` seeded with 1.
    The JAX package draws its twin from ``PRNGKey(1)``: the seeds match,
    the bits do not, so the two twins propose different tokens. Raises
    ``ValueError`` on an unknown mode or a malformed k, so a mistyped
    model declaration fails at warmup, not at request time.
    """
    mode = str(speculation.get("mode", "ngram"))
    k = int(speculation.get("k", 4))
    if mode == "ngram":
        return NgramProposer(
            k,
            ngram=int(speculation.get("ngram", 3)),
            min_ngram=int(speculation.get("min_ngram", 1)),
        )
    if mode == "draft":
        if draft_params is None:
            if draft_config is None:
                draft_config = dataclasses.replace(
                    target_config, n_layers=max(1, target_config.n_layers // 2)
                )
            if draft_config.vocab_size != target_config.vocab_size:
                raise ValueError(
                    "draft model must share the target vocabulary "
                    f"({draft_config.vocab_size} != {target_config.vocab_size})"
                )
            device = resolve_device(device)
            generator = torch.Generator(device=device).manual_seed(1)
            draft_params = llama.init_params(generator, draft_config, device)
        elif draft_config is None:
            raise ValueError("draft_params given without draft_config")
        return DraftModelProposer(draft_params, draft_config, k)
    raise ValueError(
        f"unknown speculation mode {mode!r} (choose 'draft' or 'ngram')"
    )
