"""``python -m client_tpu_torch.perf``: the port's perf-analyzer CLI."""

from client_tpu_torch.perf.cli import main

if __name__ == "__main__":
    raise SystemExit(main())
