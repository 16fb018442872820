"""LLM input-corpus generation.

The port's own copy of ``client_tpu/genai_perf/inputs.py``. The
reference's llm_inputs (reference genai-perf llm_inputs/llm_inputs.py:
29-360 + synthetic_prompt_generator.py): synthetic prompts with a target
token-count distribution, emitted as a perf-harness --input-data JSON file.
Output formats:

- ``kserve-ids``: token-id tensors (INPUT_IDS int32) for KServe decode
  models, no tokenizer round trip on the server;
- ``kserve-text``: BYTES prompt tensors for text-input models;
- ``openai-chat`` / ``openai-completions``: OpenAI request bodies in a
  BYTES ``payload`` input.

Nothing here touches the network unless :func:`fetch_hub_prompts` is
called, and that refuses in offline mode.
"""

import json
import random
from typing import Dict, List, Optional

from client_tpu_torch.genai_perf.tokenizer import SyntheticTokenizer

# A small word bank for synthetic prose (stand-in for the reference's
# Shakespeare-derived corpus).
_WORDS = (
    "the quick brown fox jumps over lazy dog while measuring inference "
    "latency throughput tokens streaming benchmark context parallel mesh "
    "tensor shard pipeline decode prefill attention cache memory bandwidth "
    "systolic array compiler fusion kernel schedule window stability"
).split()


def synthesize_prompt(
    rng: random.Random, mean_tokens: int, stddev_tokens: float
) -> str:
    count = max(1, int(rng.gauss(mean_tokens, stddev_tokens)))
    return " ".join(rng.choice(_WORDS) for _ in range(count))


def load_dataset_prompts(
    path: str, dataset_format: str = "auto", limit: int = 0
) -> List[str]:
    """Read prompts from a local dataset export (offline twin of the
    reference's hosted-dataset fetchers, reference genai-perf
    llm_inputs/llm_inputs.py:149-360).

    Supported record schemas (JSON list or JSONL of objects):

    - ``openorca``: ``system_prompt`` + ``question`` concatenated
      (reference OPEN_ORCA handling);
    - ``cnn_dailymail``: ``article`` (reference CNN_DAILY_MAIL handling);
    - ``plain``: ``prompt`` or ``text`` field;
    - ``auto`` (default): pick per record from the fields present.
    """
    records: List[Dict] = []
    with open(path, encoding="utf-8-sig") as f:  # tolerate a UTF-8 BOM
        text = f.read()
    body = text.lstrip()
    if body.startswith("["):
        records = json.loads(body)
    else:  # JSONL
        for line in body.splitlines():
            line = line.strip()
            if line:
                records.append(json.loads(line))
    prompts: List[str] = []
    for rec in records:
        if not isinstance(rec, dict):
            continue
        prompt = None
        if dataset_format in ("openorca", "auto") and "question" in rec:
            system = rec.get("system_prompt", "")
            prompt = (system + " " + rec["question"]).strip()
        elif dataset_format in ("cnn_dailymail", "auto") and "article" in rec:
            prompt = rec["article"]
        elif dataset_format in ("plain", "auto"):
            prompt = rec.get("prompt") or rec.get("text")
        if prompt:
            prompts.append(prompt)
        if limit and len(prompts) >= limit:
            break
    if not prompts:
        raise ValueError(
            f"dataset file '{path}' yielded no prompts for format "
            f"'{dataset_format}' (expected question/article/prompt/text "
            "fields)"
        )
    return prompts


# Hosted-dataset endpoints (the reference's dataset_url_map, reference
# genai-perf llm_inputs/llm_inputs.py:48-49,70 — same HF datasets-server
# rows API).
HUB_DATASET_URLS = {
    "openorca": (
        "https://datasets-server.huggingface.co/rows?"
        "dataset=Open-Orca%2FOpenOrca&config=default&split=train"
    ),
    "cnn_dailymail": (
        "https://datasets-server.huggingface.co/rows?"
        "dataset=cnn_dailymail&config=1.0.0&split=train"
    ),
}


def fetch_hub_prompts(
    dataset_name: str, starting_index: int = 0, length: int = 100
) -> List[str]:
    """Fetch prompts from a hosted dataset (reference
    _get_input_dataset_from_url, llm_inputs.py:209-360).

    Honors offline mode: HF_HUB_OFFLINE / HF_DATASETS_OFFLINE raise a
    clear error instead of attempting network IO, so air-gapped runs use
    --input-dataset files instead.
    """
    import os
    import urllib.request

    if dataset_name not in HUB_DATASET_URLS:
        raise ValueError(
            f"unknown hosted dataset '{dataset_name}' (supported: "
            f"{', '.join(sorted(HUB_DATASET_URLS))})"
        )
    for flag in ("HF_HUB_OFFLINE", "HF_DATASETS_OFFLINE"):
        if os.environ.get(flag, "") not in ("", "0"):
            raise RuntimeError(
                f"offline mode ({flag}={os.environ[flag]}): hosted-dataset "
                f"fetch disabled; pass --input-dataset <file> instead"
            )
    url = (
        f"{HUB_DATASET_URLS[dataset_name]}"
        f"&offset={starting_index}&length={length}"
    )
    with urllib.request.urlopen(url, timeout=60) as response:
        payload = json.loads(response.read().decode("utf-8"))
    prompts: List[str] = []
    for entry in payload.get("rows", []):
        row = entry.get("row", {})
        if dataset_name == "openorca":
            system = row.get("system_prompt", "")
            question = row.get("question", "")
            prompt = (system + " " + question).strip()
        else:  # cnn_dailymail
            prompt = row.get("article", "")
        if prompt:
            prompts.append(prompt)
    if not prompts:
        raise ValueError(
            f"hosted dataset '{dataset_name}' returned no usable rows"
        )
    return prompts


def create_llm_inputs(
    path: str,
    num_prompts: int = 100,
    input_tokens_mean: int = 128,
    input_tokens_stddev: float = 0.0,
    output_tokens_mean: int = 32,
    output_tokens_stddev: float = 0.0,
    output_format: str = "kserve-ids",
    input_name: str = "INPUT_IDS",
    tokenizer=None,
    seed: int = 0,
    model: str = "",
    streaming: bool = False,
    dataset_path: Optional[str] = None,
    dataset_format: str = "auto",
    prompts: Optional[List[str]] = None,
    shared_prefix_tokens: int = 0,
    speculation: Optional[str] = None,
) -> Dict:
    """Write a perf-harness input-data JSON of LLM requests.

    Prompts are synthetic by default; with ``dataset_path`` they come from
    a local dataset export instead (OpenOrca/CNN_DailyMail/plain schemas,
    cycled when shorter than ``num_prompts``). ``shared_prefix_tokens``
    prepends ONE fixed synthetic prefix of that many tokens to every
    prompt (a shared system prompt), and stamps each request with a
    ``routing_key`` parameter derived from the prefix content — the key
    ``--routing-policy consistent_hash`` pins on, so a fleet routes every
    sharer to the replica whose KV-block index already holds the prefix.
    ``speculation`` ("on"/"off") stamps the engine's per-request
    speculative-decoding switch on every entry — the A/B lever that runs
    the SAME workload against one speculation-enabled model with and
    without drafting. Returns the generated document (also written to
    ``path``).
    """
    import hashlib

    rng = random.Random(seed)
    tokenizer = tokenizer or SyntheticTokenizer()
    dataset = prompts
    if dataset is None and dataset_path:
        dataset = load_dataset_prompts(dataset_path, dataset_format)
    prefix_ids: List[int] = []
    prefix_text = ""
    routing_key = None
    if shared_prefix_tokens > 0:
        # a dedicated rng: the prefix is identical across runs of equal
        # (seed, shared_prefix_tokens) regardless of num_prompts
        prefix_text = synthesize_prompt(
            random.Random(f"{seed}-shared-prefix"), shared_prefix_tokens, 0.0
        )
        prefix_ids = tokenizer.encode(prefix_text)[:shared_prefix_tokens]
        routing_key = "prefix-" + hashlib.md5(
            ",".join(map(str, prefix_ids)).encode(),
            usedforsecurity=False,
        ).hexdigest()[:16]
    entries: List[Dict] = []
    for i in range(num_prompts):
        if dataset is not None:
            prompt = dataset[i % len(dataset)]
        else:
            prompt = synthesize_prompt(
                rng, input_tokens_mean, input_tokens_stddev
            )
        if prefix_text and output_format != "kserve-ids":
            prompt = prefix_text + " " + prompt
        if output_format == "kserve-ids":
            # length follows the sampled distribution — no clipping to the
            # mean, or above-mean prefill lengths would never occur
            ids = tokenizer.encode(prompt)
            if not ids:
                ids = [1]
            if prefix_ids:
                # token-exact shared prefix: every request's leading
                # blocks chain-hash identically in the engine's index
                ids = prefix_ids + ids
            entry = {input_name: {"content": ids, "shape": [len(ids)]}}
        elif output_format == "kserve-text":
            entry = {input_name: {"content": [prompt], "shape": [1]}}
        elif output_format in ("openai-chat", "openai-completions"):
            # OpenAI request bodies ride in a BYTES "payload" input
            # (reference OPENAI_CHAT_COMPLETIONS / OPENAI_COMPLETIONS
            # formats, genai-perf llm_inputs.py); max_tokens is part of the
            # body per OpenAI semantics, and "stream" is baked in here so
            # the benchmark hot path never re-parses the payload.
            if output_format == "openai-chat":
                body = {
                    "model": model,
                    "messages": [{"role": "user", "content": prompt}],
                    "stream": streaming,
                }
            else:
                body = {
                    "model": model,
                    "prompt": prompt,
                    "stream": streaming,
                }
            if output_tokens_mean is not None:
                body["max_tokens"] = max(
                    1,
                    int(rng.gauss(output_tokens_mean, output_tokens_stddev)),
                )
            entry = {"payload": {"content": [json.dumps(body)], "shape": [1]}}
            if speculation is not None:
                entry.setdefault("parameters", {})["speculation"] = speculation
            if routing_key is not None:
                # stamped on every format for a uniform input document;
                # note the harness only accepts --routing-policy on the
                # kserve http/grpc clients today, so the affinity
                # pairing is live on kserve-* and inert (forward-compat
                # data) on openai payloads
                entry.setdefault("parameters", {})["routing_key"] = routing_key
            entries.append(entry)
            continue
        else:
            raise ValueError(f"unknown output format '{output_format}'")
        if routing_key is not None:
            entry["parameters"] = {"routing_key": routing_key}
        if speculation is not None:
            entry.setdefault("parameters", {})["speculation"] = speculation
        if output_tokens_mean is not None:
            # per-request sampled output length, carried as a request
            # parameter via the input-data "parameters" key (role of the
            # reference's per-request max_tokens embedding,
            # reference genai-perf llm_inputs/llm_inputs.py)
            max_tokens = max(
                1, int(rng.gauss(output_tokens_mean, output_tokens_stddev))
            )
            entry.setdefault("parameters", {})["max_tokens"] = max_tokens
        entries.append(entry)
    doc = {"data": entries}
    if path:
        with open(path, "w") as f:
            json.dump(doc, f)
    return doc
