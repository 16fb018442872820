"""``python -m client_tpu_torch.genai_perf``: the port's genai-perf CLI."""

from client_tpu_torch.genai_perf.main import main

if __name__ == "__main__":
    raise SystemExit(main())
