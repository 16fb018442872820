"""CLI entry point: ``python -m client_tpu_torch.server``.

Starts the HTTP front-end over a model repository holding the built-in
models (``simple``, ``identity_fp32``, ``identity_bf16``,
``identity_bytes``, ``repeat_int32``, ``sequence_accumulate``,
``add_sub_chain``; ``--no-builtin-models`` leaves them out);
``--zoo-models`` adds ``image_classifier`` (64 x 64 images, the thin
ResNet-18), ``llm_decode`` and ``llm_engine`` (the tiny Llama) and
``text_encoder`` (the tiny BERT), random weights from seed 0. Every model
runs on ``--device`` (default ``cuda``), which is also the device
``/metrics`` reports the memory of.
"""

import argparse
import asyncio
import signal


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="client_tpu_torch.server",
        description="KServe v2 / OpenAI inference server (PyTorch backend)",
    )
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--http-port", type=int, default=8000)
    parser.add_argument(
        "--no-builtin-models",
        action="store_true",
        help="skip the built-in models (simple, identity_*, repeat_int32, "
        "sequence_accumulate, add_sub_chain)",
    )
    parser.add_argument(
        "--zoo-models",
        action="store_true",
        help="also register the model-zoo adapters (image_classifier, llm_decode, "
        "llm_engine, text_encoder)",
    )
    parser.add_argument(
        "--device",
        choices=["cuda", "cpu"],
        default="cuda",
        help="device the models run on; cuda raises when there is no card",
    )
    args = parser.parse_args(argv)

    from client_tpu_torch.server.core import ServerCore
    from client_tpu_torch.server.http_server import serve_http
    from client_tpu_torch.server.model_repository import ModelRepository

    repository = ModelRepository()
    if not args.no_builtin_models:
        from client_tpu_torch.server.models import register_builtin_models

        register_builtin_models(repository, device=args.device)
    if args.zoo_models:
        from client_tpu_torch.models.serving import register_zoo_models

        register_zoo_models(repository, device=args.device)
    for entry in repository.index():
        print(f"model {entry['name']}: {entry['state']} {entry['reason']}".rstrip(),
              flush=True)
    core = ServerCore(repository, device=args.device)

    async def serve() -> None:
        server = await serve_http(core, args.host, args.http_port)
        print(f"serving HTTP on {args.host}:{server.port}", flush=True)
        stop = asyncio.Event()
        loop = asyncio.get_running_loop()
        for sig in (signal.SIGTERM, signal.SIGINT):
            loop.add_signal_handler(sig, stop.set)
        try:
            await stop.wait()
        finally:
            await server.close()
            core.close()

    asyncio.run(serve())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
