"""Tiny versions of the benchmark's cells, for runs on the CPU: the
cells' own files with the widths, depth, vocabulary and traffic cut down
and float32 arithmetic, so that a run takes seconds. The program then
computes what the float32 reference does, so the tiny cells hold it to
limits near nought, between its readings (0.0 and 2.4e-7) and the fp8
control's at these sizes (0.148 and 0.059)."""

import time
from pathlib import Path

from harness import main

ROOT = Path(__file__).resolve().parents[2]
SEED = 2**31 + 1234


def cell(name: str):
    cell = main.load_cell(ROOT, name)
    config, mix = cell["config_doc"], cell["mix"]
    if config["serve"]["system"] == "llm_engine":
        config.update(vocab_size=512, hidden_size=64, intermediate_size=128,
                      num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2)
        config["serve"]["max_seq_len"] = 256
        config["serve"]["engine"].update(max_active=8, num_blocks=1 + 8 * 16)
        config["serve"]["check_limits"].update(min_checked_tokens=20, served_logit_gap=0.02)
        mix.update(concurrency=4, ramp_s=1)
        # outputs as long as the prompts, so that the decode steps' own
        # keys and values weigh in every answer
        mix["prompt_tokens"].update(median=16, min=8, max=32)
        mix["output_tokens"].update(min=16, max=48)
    else:
        config.update(vocab_size=1024, hidden_size=64, intermediate_size=128,
                      num_hidden_layers=2, num_attention_heads=4, max_position_embeddings=128)
        config["serve"]["check_limits"].update(min_checked_answers=8, answer_error=0.01)
        mix.update(concurrency=4, ramp_s=1, check_requests=16)
        mix["input_tokens"].update(median=32, min=8, max=128)
    config["serve"]["dtype"] = "float32"
    return cell


def run(name: str, seconds: float = 3.0, trace: bool = False, seed: int = SEED):
    """One run of the tiny cell on the CPU: (run, its result line)."""
    run, _, checks = main.run_cell(cell(name), seed, seconds, trace, time.monotonic_ns(),
                                   device="cpu")
    return run, main.result_line(run, checks)
