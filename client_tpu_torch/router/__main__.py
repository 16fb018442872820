"""``python -m client_tpu_torch.router --serve``: one router as a subprocess.

The process form of :class:`client_tpu_torch.router.RouterServer`, with
the reference's flags: bench drivers spawn it in front of fleet replicas
(router-vs-direct proxy tax), and the chaos tests SIGKILL it mid-run to
prove clients with ``urls=[router_a, router_b]`` fail over with zero
visible errors.

Backends come from ``--backends`` (``grpc[=http]`` comma list) and/or
``--replica-ports-file`` (repeatable; each is the JSON a ``python -m
client_tpu_torch.perf.fleet_runner --serve --grpc-port 0 --ports-file``
replica wrote: the same file handoff, chained). The router's own bound
ports go to ``--ports-file`` (atomic) and stdout.
"""

import argparse
import json
import signal
import threading
import time
from typing import Dict, List, Optional

from client_tpu_torch.perf.fleet_runner import read_ports_file, write_ports_file
from client_tpu_torch.router.server import RouterServer


def _parse_backends(spec: str) -> Dict[str, Optional[str]]:
    """``grpc_addr[=http_addr],...`` → {grpc: http_or_None}."""
    backends: Dict[str, Optional[str]] = {}
    for item in spec.split(","):
        item = item.strip()
        if not item:
            continue
        grpc_addr, _, http_addr = item.partition("=")
        backends[grpc_addr] = http_addr or None
    return backends


def _backends_from_ports_files(
    paths: List[str], host: str, wait_s: float
) -> Dict[str, Optional[str]]:
    backends: Dict[str, Optional[str]] = {}
    poll_s = 0.05
    for path in paths:
        ports = read_ports_file(path)
        attempts = max(1, int(wait_s / poll_s))
        while ports is None and attempts > 0:
            time.sleep(poll_s)
            attempts -= 1
            ports = read_ports_file(path)
        if ports is None:
            raise SystemExit(f"no ports file at {path} after {wait_s:g}s")
        grpc_port = ports.get("grpc_port")
        http_port = ports.get("http_port")
        if not grpc_port:
            raise SystemExit(f"{path}: replica exposes no gRPC port")
        backends[f"{host}:{grpc_port}"] = (
            f"{host}:{http_port}" if http_port else None
        )
    return backends


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m client_tpu_torch.router",
        description="serve one router over a set of fleet replicas "
        "(prints a JSON ports line, stops on SIGTERM)",
    )
    parser.add_argument("--serve", action="store_true", required=True)
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--http-port", type=int, default=0)
    parser.add_argument("--grpc-port", type=int, default=0)
    parser.add_argument(
        "--backends",
        default="",
        help="comma list of backend addresses, each 'grpc[=http]'",
    )
    parser.add_argument(
        "--replica-ports-file",
        action="append",
        default=[],
        metavar="PATH",
        help="read one backend's ports from a fleet_runner --ports-file "
        "JSON (repeatable)",
    )
    parser.add_argument(
        "--backend-host",
        default="127.0.0.1",
        help="host the --replica-ports-file ports bind on",
    )
    parser.add_argument("--ports-file", default=None, metavar="PATH")
    parser.add_argument(
        "--policy",
        default="least_outstanding",
        help="routing policy (round_robin / least_outstanding / p2c / "
        "consistent_hash)",
    )
    parser.add_argument(
        "--max-inflight",
        type=int,
        default=0,
        help="shed default-priority requests past this many in flight "
        "(0 = no shedding)",
    )
    parser.add_argument("--probe-interval", type=float, default=0.25)
    parser.add_argument("--backend-wait", type=float, default=15.0)
    args = parser.parse_args(argv)

    backends: Dict[str, Optional[str]] = {}
    if args.backends:
        backends.update(_parse_backends(args.backends))
    if args.replica_ports_file:
        backends.update(
            _backends_from_ports_files(
                args.replica_ports_file, args.backend_host, args.backend_wait
            )
        )
    if not backends:
        parser.error("need --backends and/or --replica-ports-file")

    server = RouterServer(
        backends,
        host=args.host,
        http_port=args.http_port,
        grpc_port=args.grpc_port,
        routing_policy=args.policy,
        max_inflight=args.max_inflight,
        probe_interval_s=args.probe_interval,
    )
    server.start()
    ports = {"http_port": server.http_port, "grpc_port": server.grpc_port}
    if args.ports_file:
        write_ports_file(args.ports_file, ports)
    print(json.dumps(ports), flush=True)
    stop = threading.Event()
    for signum in (signal.SIGTERM, signal.SIGINT):
        signal.signal(signum, lambda *_: stop.set())
    stop.wait()
    server.stop()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
