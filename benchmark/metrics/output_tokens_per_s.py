"""output_tokens_per_s: every output token whose event reached the
client inside the window, over the window's seconds."""


def read(run):
    if run.route != "openai_chat_stream":
        return None
    tokens = sum(1 for r in run.records for t in r["stamps"] if run.in_window(t))
    return tokens / run.window_s
