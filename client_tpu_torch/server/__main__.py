"""CLI entry point: ``python -m client_tpu_torch.server``.

Starts the HTTP front-end over a model repository holding the built-in
models (``simple``, ``identity_fp32``, ``identity_bf16``,
``identity_bytes``, ``repeat_int32``, ``sequence_accumulate``,
``add_sub_chain``; ``--no-builtin-models`` leaves them out);
``--zoo-models`` adds ``image_classifier`` (64 x 64 images, the thin
ResNet-18), ``llm_decode`` and ``llm_engine`` (the tiny Llama) and
``text_encoder`` (the tiny BERT), random weights from seed 0; and
``--model-repository`` loads every ``<name>/model.py`` of a directory
(its ``create_model`` gets the server's device through a ``device``
keyword when it declares one). Every model runs on ``--device`` (default
``cuda``), which is also the device ``/metrics`` reports the memory of.

``--grpc-port`` adds the KServe v2 gRPC service on the native front-end
(``server/native_frontend.py``; ``--grpc-frontend native`` or ``auto``,
built with ``g++`` at first use). Unlike the reference, which always
serves gRPC on 8001, the port serves it only when asked.
``--grpc-tls-cert`` with ``--grpc-tls-key`` makes that port speak TLS
(ALPN ``h2``), terminated in C++ through ``libssl.so.3``; when the
library cannot be loaded or a PEM cannot be read the server exits 1 and
its log names the cause: it never serves plaintext instead.
``--grpc-frontend aio`` exits 2: the grpc.aio server stands on grpcio,
which the port does not import.

Startup is announced, as the reference announces it, only through the
structured log (JSON lines on stderr): one ``model_state`` record a model,
then ``server_started`` with ``host``, ``http_port``, ``grpc_port`` and
``grpc_frontend``.

On SIGTERM or SIGINT the server drains first: ``/v2/health/ready``
answers 503 while ``/v2/health/live`` stays 200, new inferences get 503 +
``Retry-After``, and in-flight and queued work gets ``--drain-timeout``
seconds to finish; the structured log (JSON lines on stderr) records
``drain_started`` and ``drain_completed``, and only then do the
front-end and the core close.
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
        "--grpc-port", type=int, default=None,
        help="serve the KServe v2 gRPC service on this port (0 picks a free "
        "one); off unless given",
    )
    parser.add_argument(
        "--grpc-frontend", choices=["native", "aio", "auto"], default="auto",
        help="gRPC front-end: 'native' (the C++ h2 server), 'auto' = native; "
        "'aio' (grpc.aio) is not ported",
    )
    parser.add_argument("--grpc-tls-cert", default=None,
                        help="PEM certificate chain: the native gRPC front-end "
                        "terminates TLS itself (grpcs, ALPN h2); requires "
                        "--grpc-tls-key")
    parser.add_argument("--grpc-tls-key", default=None,
                        help="PEM private key for --grpc-tls-cert")
    parser.add_argument(
        "--model-repository",
        default=None,
        help="directory of <name>/model.py models (python_backend analogue)",
    )
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
        "--max-workers", type=int, default=32, help="model execution threads"
    )
    parser.add_argument(
        "--drain-timeout",
        type=float,
        default=30.0,
        help="graceful-shutdown budget in seconds: on SIGTERM/SIGINT the "
        "server flips /v2/health/ready to 503 (liveness stays up), "
        "rejects new inferences with 503, and waits this long for "
        "in-flight and queued work before closing",
    )
    parser.add_argument(
        "--device",
        choices=["cuda", "cpu"],
        default="cuda",
        help="device the models run on; cuda raises when there is no card",
    )
    args = parser.parse_args(argv)
    if args.grpc_frontend == "aio":
        parser.error("--grpc-frontend aio: the grpc.aio server "
                     "(client_tpu/server/grpc_server.py) stands on grpcio, which the "
                     "port does not import, and is not ported (ROADMAP, "
                     "\"Not to port\"); use native")
    if bool(args.grpc_tls_cert) != bool(args.grpc_tls_key):
        parser.error("--grpc-tls-cert and --grpc-tls-key go together")
    if args.grpc_tls_cert and args.grpc_port is None:
        parser.error("--grpc-tls-cert needs --grpc-port")

    from client_tpu_torch.server.core import ServerCore
    from client_tpu_torch.server.http_server import serve_http
    from client_tpu_torch.server.model_repository import build_repository

    repository = build_repository(args.model_repository, builtin=not args.no_builtin_models,
                                  zoo=args.zoo_models, device=args.device)
    core = ServerCore(repository, max_workers=args.max_workers, device=args.device)
    for entry in repository.index():
        core.logger.info("model_state", model=entry["name"], state=entry["state"],
                         reason=entry["reason"])

    async def serve() -> int:
        server = await serve_http(core, args.host, args.http_port)
        grpc_frontend, grpc_port = None, None
        if args.grpc_port is not None:
            from client_tpu_torch.server.native_frontend import serve_grpc_native

            try:
                grpc_frontend, grpc_port = await serve_grpc_native(
                    core, args.host, args.grpc_port, tls_cert=args.grpc_tls_cert,
                    tls_key=args.grpc_tls_key)
            except OSError as e:
                # a TLS listener that cannot load libssl or its PEM never
                # falls back to plaintext: the server does not start
                core.logger.error("server_failed", error=str(e))
                await server.close()
                core.close()
                return 1
        core.logger.info("server_started", host=args.host, http_port=server.port,
                         grpc_port=grpc_port,
                         grpc_frontend="native" if grpc_frontend else None)
        stop = asyncio.Event()
        loop = asyncio.get_running_loop()
        for sig in (signal.SIGTERM, signal.SIGINT):
            loop.add_signal_handler(sig, stop.set)
        try:
            await stop.wait()
        finally:
            # the graceful half first: readiness false and new work
            # refused while in-flight and queued requests finish; drain()
            # logs drain_started / drain_completed itself
            drained = await core.drain(args.drain_timeout)
            core.logger.info("server_stopping", drained=drained)
            if grpc_frontend is not None:
                grpc_frontend.stop()
            await server.close()
            core.close()
        return 0

    return asyncio.run(serve())


if __name__ == "__main__":
    raise SystemExit(main())
