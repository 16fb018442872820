"""The port's genai-perf: the LLM benchmark front-end over its perf harness.

An own copy of ``client_tpu/genai_perf``: synthesizes LLM input corpora,
drives the port's perf harness in streaming mode against an
OpenAI-compatible endpoint, and reduces the profile export to LLM
metrics (time to first token, inter-token latency, output-token and
request throughput) with console, CSV and JSON reports
(``python -m client_tpu_torch.genai_perf``). Its tokenizer module is also
the OpenAI front-end's.
"""

from client_tpu_torch.genai_perf.metrics import (  # noqa: F401
    LLMMetrics,
    LLMProfileDataParser,
    Statistics,
)
