"""The port's perf-analyzer CLI (``python -m client_tpu_torch.perf``).

The port's own copy of ``client_tpu/perf/cli.py``. Flag names follow the
reference's perf_analyzer CLI (reference src/c++/perf_analyzer/
command_line_parser.cc option table) for drop-in familiarity: -m, -u, -i,
-b, --concurrency-range, --request-rate-range, --request-intervals,
--periodic-concurrency-range, --request-period, --request-distribution,
--measurement-interval, --stability-percentage, --max-trials,
--latency-threshold, --percentile, --input-data, --shape, --streaming,
--sequence-length, --num-of-sequences, -f (csv), --profile-export-file,
--verbose.

Every flag of the JAX package's CLI is parsed. Those whose piece the port
does not have yet are refused with exit code 2 and a one-line error that
names the missing piece and its ROADMAP item (:func:`refusal`); none is
silently ignored. The CSV columns, the profile export and the
``--json-summary`` keys are the reference's, so either package's readers
parse the other's output.
"""

import argparse
import asyncio
import json
import os
import sys
from typing import List, Optional, Tuple


def _parse_range(value: str, kind=int) -> Tuple:
    """start[:end[:step]]"""
    parts = value.split(":")
    start = kind(parts[0])
    end = kind(parts[1]) if len(parts) > 1 else start
    step = kind(parts[2]) if len(parts) > 2 else kind(1)
    return start, end, step


def _topology_from_env():
    """(world_size, rank, coordinator) from the CTPU_* env vars, the
    defaults of --world-size, --rank and --coordinator."""
    return (
        int(os.environ.get("CTPU_WORLD_SIZE", "1")),
        int(os.environ.get("CTPU_RANK", "0")),
        os.environ.get("CTPU_COORDINATOR", "127.0.0.1:29500"),
    )


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="perf-analyzer-tpu-torch",
        description="Measure inference serving performance (KServe v2).",
    )
    parser.add_argument("-m", "--model-name", required=True)
    parser.add_argument("-x", "--model-version", default="")
    parser.add_argument(
        "-u",
        "--url",
        default="localhost:8000",
        help="server host:port; a comma list (host1:p1,host2:p2) names "
        "replica endpoints — the kserve client then health-checks and "
        "fails over between them (client_tpu_torch.lifecycle.EndpointPool)",
    )
    parser.add_argument(
        "-i",
        "--protocol",
        default="http",
        choices=["http", "grpc"],
        help="service protocol (grpc is refused: not ported yet)",
    )
    parser.add_argument(
        "--service-kind",
        default="kserve",
        choices=["kserve", "openai", "tfserving", "torchserve"],
        help="kserve (default) or an OpenAI-compatible endpoint "
        "(tfserving and torchserve are refused: not ported yet)",
    )
    parser.add_argument(
        "--endpoint",
        default="v1/chat/completions",
        help="openai: endpoint path",
    )
    parser.add_argument("-b", "--batch-size", type=int, default=1)
    parser.add_argument(
        "--concurrency-range",
        default=None,
        help="start:end:step concurrency sweep",
    )
    parser.add_argument(
        "--request-rate-range",
        default=None,
        help="start:end:step request-rate sweep (infer/sec)",
    )
    parser.add_argument(
        "--request-distribution",
        default="constant",
        choices=["constant", "poisson"],
    )
    parser.add_argument(
        "--request-intervals",
        default=None,
        help="file of inter-request intervals in microseconds (one per line)",
    )
    parser.add_argument(
        "--periodic-concurrency-range",
        default=None,
        help="start:end:step periodic concurrency ramp (LLM profiling)",
    )
    parser.add_argument(
        "--request-period",
        type=int,
        default=10,
        help="requests per periodic-concurrency period",
    )
    parser.add_argument(
        "--measurement-interval",
        "-p",
        type=int,
        default=5000,
        help="measurement window in msec",
    )
    parser.add_argument(
        "--stability-percentage", "-s", type=float, default=10.0
    )
    parser.add_argument(
        "--measurement-mode",
        choices=("time_windows", "count_windows"),
        default="time_windows",
        help="window boundary: elapsed interval, or request count with "
        "the interval as a hard cap",
    )
    parser.add_argument(
        "--measurement-request-count",
        type=int,
        default=50,
        help="window size in requests (count_windows)",
    )
    parser.add_argument(
        "--binary-search",
        action="store_true",
        help="bisect --concurrency-range for the highest value meeting "
        "--latency-threshold",
    )
    parser.add_argument("--max-trials", "-r", type=int, default=10)
    parser.add_argument(
        "--latency-threshold",
        "-l",
        type=int,
        default=0,
        help="latency budget in msec (0 = none)",
    )
    parser.add_argument(
        "--percentile",
        type=int,
        default=None,
        help="use this latency percentile for stability (default: avg)",
    )
    parser.add_argument(
        "--input-data",
        default=None,
        help="JSON data file, or a directory of per-input raw files",
    )
    parser.add_argument(
        "--shared-memory",
        choices=("none", "system", "tpu"),
        default="none",
        help="stage inputs into registered shared-memory regions "
        "(system or tpu extension) instead of inline tensors",
    )
    parser.add_argument(
        "--shape",
        action="append",
        default=[],
        help="name:d1,d2,... override for dynamic input shapes",
    )
    parser.add_argument("--streaming", action="store_true")
    parser.add_argument(
        "--stream-mode",
        action="store_true",
        help="gRPC only; refused: not ported yet",
    )
    parser.add_argument("--sequence-length", type=int, default=0)
    parser.add_argument("--num-of-sequences", type=int, default=4)
    parser.add_argument("-f", "--filename", default=None, help="CSV output")
    parser.add_argument("--profile-export-file", default=None)
    parser.add_argument("-v", "--verbose", action="store_true")
    parser.add_argument(
        "--warmup-request-count", type=int, default=0,
        help="requests to discard before measuring",
    )
    parser.add_argument(
        "--request-parameter",
        action="append",
        default=[],
        help="name:value:type custom request parameter "
        "(type: int|float|bool|string)",
    )
    parser.add_argument(
        "--json-summary",
        action="store_true",
        help="print a one-line JSON summary (bench integration)",
    )
    def _error_rate(value: str) -> float:
        rate = float(value)
        if not 0.0 <= rate <= 1.0:
            raise argparse.ArgumentTypeError(
                f"--max-error-rate must be a fraction in [0, 1], got {rate}"
            )
        return rate

    parser.add_argument(
        "--max-error-rate",
        type=_error_rate,
        default=None,
        help="abort the run when the cumulative request error rate "
        "exceeds this fraction in [0, 1] (default: tolerate errors; "
        "they are recorded and reported)",
    )
    parser.add_argument(
        "--request-priority",
        default=None,
        help="scheduling priority parameter for every request (1 = "
        "highest), or a comma list cycled across requests (e.g. '1,2') "
        "for a mixed-priority overload run — the report then carries a "
        "per-priority latency split",
    )
    parser.add_argument(
        "--queue-timeout-us",
        type=int,
        default=None,
        help="per-request server queue timeout in microseconds (the "
        "KServe 'timeout' parameter); timed-out requests fail with a "
        "deadline error before execution",
    )
    def _positive_period(value: str) -> float:
        period = float(value)
        if period <= 0:
            raise argparse.ArgumentTypeError(
                f"--rolling-restart must be > 0 seconds, got {period}"
            )
        return period

    parser.add_argument(
        "--rolling-restart",
        type=_positive_period,
        default=None,
        metavar="PERIOD_S",
        help="refused: needs repository control, not ported yet",
    )
    parser.add_argument(
        "--routing-policy",
        default=None,
        choices=[
            "sticky",
            "round-robin",
            "round_robin",
            "least-outstanding",
            "least_outstanding",
            "p2c",
            "consistent-hash",
            "consistent_hash",
        ],
        help="endpoint-selection policy for multi-endpoint runs "
        "(-u comma list): sticky primary (default), round-robin, "
        "least-outstanding, p2c (power of two choices on the live "
        "outstanding/EWMA signals), or consistent-hash (affinity on the "
        "'routing_key' request parameter — pair with "
        "--request-parameter routing_key:<key>:string)",
    )
    parser.add_argument(
        "--hedge-after-s",
        type=float,
        default=None,
        metavar="S",
        help="arm request hedging: an idempotent request that outlives "
        "S seconds launches one duplicate on another endpoint; first "
        "response wins, the loser is cancelled. 0 derives the trigger "
        "from the observed p95 instead of a fixed delay. Incompatible "
        "with --shared-memory (single-writer regions must not race)",
    )
    def _positive_fleet(value: str) -> int:
        count = int(value)
        if count < 1:
            raise argparse.ArgumentTypeError(
                f"--fleet must be >= 1 replicas, got {count}"
            )
        return count

    parser.add_argument(
        "--fleet",
        type=_positive_fleet,
        default=None,
        metavar="N",
        help="refused: in-process replica fleets are not ported yet",
    )
    parser.add_argument(
        "--stage-breakdown",
        action="store_true",
        help="trace every request client-side (observability spans) and "
        "report a serialize/transport/deserialize stage breakdown next "
        "to the server queue/compute stats (kserve http only)",
    )
    parser.add_argument(
        "--trace-export-file",
        default=None,
        help="write the client-side spans as JSONL to this file "
        "(implies --stage-breakdown)",
    )
    parser.add_argument(
        "--collect-metrics",
        action="store_true",
        help="scrape the server's Prometheus /metrics during the run and "
        "report a 'Server metrics' section (TPU duty cycle, memory, "
        "queue/compute, batch sizes)",
    )
    def _positive_interval(value: str) -> float:
        interval = float(value)
        if interval <= 0:
            raise argparse.ArgumentTypeError(
                f"--metrics-interval must be > 0 seconds, got {interval}"
            )
        return interval

    parser.add_argument(
        "--metrics-interval",
        type=_positive_interval,
        default=1.0,
        help="seconds between /metrics scrapes (with --collect-metrics)",
    )
    parser.add_argument(
        "--metrics-url",
        default=None,
        help="metrics endpoint (host:port[/metrics]); implies "
        "--collect-metrics. Default: the -u "
        "host/port for HTTP runs, port 8000 on the -u host otherwise. "
        "A comma list of several replicas (the fleet view) is refused: "
        "not ported yet",
    )
    parser.add_argument(
        "--profile-server",
        action="store_true",
        help="enable the server's per-stage CPU accounting for this run "
        "(POST /v2/debug/profiling on the metrics host; restored after) "
        "and print a 'Wire-gap attribution' table decomposing server "
        "CPU us/req by stage; implies --collect-metrics and "
        "--stage-breakdown",
    )
    parser.add_argument(
        "--flamegraph-out",
        default=None,
        metavar="PATH",
        help="capture a wall-stack sample of the server during the "
        "measurement (GET /v2/debug/profile) and write collapsed stacks "
        "(flamegraph.pl / speedscope 'import' format) to PATH; implies "
        "--profile-server",
    )
    parser.add_argument(
        "--profile-hz",
        type=float,
        default=99.0,
        help="sampling rate for --flamegraph-out (the server's overhead "
        "guard may lower the effective rate)",
    )
    parser.add_argument(
        "--dump-slow-requests",
        type=int,
        default=0,
        metavar="N",
        help="after the run, fetch the server's flight recorder "
        "(GET /v2/debug/requests on the metrics host) and print the N "
        "slowest requests stage-decomposed (queue/compute/package us, "
        "trace id, error text); kserve http only",
    )
    parser.add_argument(
        "--log-file",
        default=None,
        metavar="PATH",
        help="write the harness's structured JSON event log to PATH "
        "(run lifecycle, client endpoint failover and circuit-breaker "
        "transitions, slow-request dump) — the client-side face of the "
        "server's /v2/logging stream",
    )
    env_world_size, env_rank, env_coordinator = _topology_from_env()
    parser.add_argument(
        "--world-size", type=int, default=env_world_size,
        help="multi-process run: process count (refused above 1: not "
        "ported yet)",
    )
    parser.add_argument(
        "--rank", type=int, default=env_rank,
        help="multi-process run: this process's rank",
    )
    parser.add_argument(
        "--coordinator", default=env_coordinator,
        help="rank-0 rendezvous address",
    )
    return parser


def refusal(args) -> Optional[str]:
    """The one-line error for a flag whose piece the port lacks, naming
    that piece and its ROADMAP item; None when every flag is served."""
    refused = [
        (args.protocol == "grpc",
         "-i grpc: the port has no gRPC front-end or client yet "
         "(ROADMAP Queue 1 item 4)"),
        (args.stream_mode,
         "--stream-mode: gRPC streams are not ported yet "
         "(ROADMAP Queue 1 item 4)"),
        (args.service_kind in ("tfserving", "torchserve"),
         f"--service-kind {args.service_kind}: the port has no "
         "compat_frontends yet (ROADMAP Queue 1 item 3d)"),
        (args.metrics_url is not None and "," in args.metrics_url,
         "--metrics-url with several replicas: the fleet view "
         "(observability/fleet.py) is not ported yet (ROADMAP Queue 1 "
         "item 7)"),
        (args.fleet is not None,
         "--fleet: perf/fleet_runner.py and repository control are not "
         "ported yet (ROADMAP Queue 1 items 3c and 7)"),
        (args.rolling_restart is not None,
         "--rolling-restart: the port's server has no repository control "
         "yet (ROADMAP Queue 1 items 3c and 7)"),
        (args.world_size > 1,
         f"--world-size {args.world_size}: perf/distributed.py is not "
         "ported yet (ROADMAP Queue 1 item 7)"),
    ]
    for refused_now, message in refused:
        if refused_now:
            return f"error: {message}"
    return None


def _cast_bool(value: str) -> bool:
    lowered = value.lower()
    if lowered in ("1", "true", "yes"):
        return True
    if lowered in ("0", "false", "no"):
        return False
    raise ValueError(f"not a boolean: '{value}'")


_PARAM_CASTS = {
    "int": int,
    "float": float,
    "bool": _cast_bool,
    "string": str,
}


def _server_http_url(args) -> str:
    """The server's HTTP base for metrics and debug endpoints:
    ``--metrics-url`` when given, else the -u primary endpoint for HTTP
    kserve runs, else the conventional HTTP port on the -u host."""
    if args.metrics_url:
        return args.metrics_url.strip()
    primary_url = args.url.split(",")[0].strip()
    if args.protocol == "http" and args.service_kind == "kserve":
        return primary_url
    host = primary_url.rsplit(":", 1)[0] or "localhost"
    return f"{host}:8000"


def parse_request_parameters(specs):
    parameters = {}
    for spec in specs:
        # name:value:type — the value may itself contain colons (URLs,
        # timestamps), so peel name from the front and type from the back
        name, _, rest = spec.partition(":")
        value, _, kind = rest.rpartition(":")
        if not name or not kind or kind not in _PARAM_CASTS:
            raise ValueError(
                f"bad --request-parameter '{spec}' (want name:value:type, "
                "type in int|float|bool|string)"
            )
        try:
            parameters[name] = _PARAM_CASTS[kind](value)
        except ValueError as e:
            raise ValueError(
                f"bad --request-parameter '{spec}': {e}"
            ) from None
    return parameters


async def run(args) -> int:
    from client_tpu_torch.perf.backend import create_backend
    from client_tpu_torch.perf.data import DataLoader
    from client_tpu_torch.perf.load_manager import (
        ConcurrencyManager,
        PeriodicConcurrencyManager,
        RequestRateManager,
    )
    from client_tpu_torch.perf.profiler import InferenceProfiler
    from client_tpu_torch.perf.report import (
        console_report,
        detailed_report,
        export_profile,
        format_client_metrics,
        format_server_metrics,
        write_csv,
    )
    from client_tpu_torch.perf.sequence import SequenceManager
    from client_tpu_torch.utils import InferenceServerException

    if args.flamegraph_out:
        args.profile_server = True
    if args.profile_server:
        if args.service_kind != "kserve":
            print(
                "error: --profile-server/--flamegraph-out need the "
                "kserve http client (server debug endpoints + client-side "
                "spans)",
                file=sys.stderr,
            )
            return 2
        # the attribution table reads against the client stage table and
        # arrives through the /metrics scrape: imply both
        args.stage_breakdown = True
        args.collect_metrics = True
    if args.metrics_url and not args.collect_metrics:
        args.collect_metrics = True
    want_tracing = args.stage_breakdown or args.trace_export_file
    if want_tracing and args.service_kind != "kserve":
        print(
            "error: --stage-breakdown/--trace-export-file need the kserve "
            "http client (client-side spans)",
            file=sys.stderr,
        )
        return 2

    if args.hedge_after_s is not None and args.shared_memory != "none":
        print(
            "error: --hedge-after-s is incompatible with --shared-memory "
            "(shared regions are single-writer; a hedged duplicate would "
            "race the winner's output)",
            file=sys.stderr,
        )
        return 2
    if (
        args.routing_policy or args.hedge_after_s is not None
    ) and args.service_kind != "kserve":
        print(
            "error: --routing-policy/--hedge-after-s need the kserve "
            "http client (EndpointPool routing)",
            file=sys.stderr,
        )
        return 2
    if args.dump_slow_requests and args.service_kind != "kserve":
        print(
            "error: --dump-slow-requests needs the kserve http client "
            "(server flight-recorder debug endpoint)",
            file=sys.stderr,
        )
        return 2
    trace_exporter = None
    tracer = None
    collector = None
    prev_profiling = None
    profiling_clock_mode = ""
    flamegraph_task = None
    run_logger = None
    if args.log_file:
        # the harness's own structured event log, also handed to the
        # kserve client so endpoint failover lands in the same stream
        from client_tpu_torch.observability.logging import StructuredLogger

        run_logger = StructuredLogger(name="perf")
        run_logger.update({"log_file": args.log_file, "log_verbose_level": 1})
        run_logger.info(
            "run_started",
            model=args.model_name,
            url=args.url,
            protocol=args.protocol,
            service_kind=args.service_kind,
        )
    if args.service_kind == "openai":
        backend = create_backend("openai", args.url, endpoint=args.endpoint)
    else:
        backend_kwargs = {}
        if want_tracing:
            from client_tpu_torch.observability import JsonlExporter, Tracer

            if args.trace_export_file:
                trace_exporter = JsonlExporter(args.trace_export_file)
            tracer = Tracer(exporter=trace_exporter)
            backend_kwargs["tracer"] = tracer
        if run_logger is not None:
            backend_kwargs["logger"] = run_logger
        if args.routing_policy:
            backend_kwargs["routing_policy"] = args.routing_policy
        if args.hedge_after_s is not None:
            backend_kwargs["hedge_policy"] = args.hedge_after_s
        backend = create_backend(args.protocol, args.url, **backend_kwargs)
    if args.streaming and not backend.supports_streaming:
        print(
            f"error: --streaming is not supported by the '{args.protocol}' "
            "protocol (gRPC streams are not ported yet: ROADMAP Queue 1 "
            "item 4)",
            file=sys.stderr,
        )
        await backend.close()
        return 2
    try:
        await backend.connect()
    except InferenceServerException as e:
        print(f"error: backend connect: {e}", file=sys.stderr)
        await backend.close()
        return 1
    shm_plane = None
    try:
        if args.collect_metrics:
            # scrape the server's Prometheus endpoint alongside the run
            # (reference --collect-metrics / MetricsManager)
            from client_tpu_torch.perf.metrics_collector import MetricsCollector

            collector = MetricsCollector(
                _server_http_url(args),
                interval_s=args.metrics_interval,
                model_name=args.model_name,
            )
            await collector.start()
            if args.verbose:
                print(f"collecting server metrics from {collector.url}")
        if args.profile_server:
            # the server's stage CPU accounting on for this run (restored
            # in the finally); its config names the calibrated clock
            from client_tpu_torch.perf.metrics_collector import set_stage_cpu

            toggled = await set_stage_cpu(collector.url, True)
            if toggled is None:
                print(
                    "warning: could not enable server stage-CPU "
                    f"accounting via {collector.url} (is the HTTP "
                    "front-end reachable?); the attribution table will "
                    "be empty",
                    file=sys.stderr,
                )
            else:
                prev_profiling = toggled["previous"]
                profiling_clock_mode = toggled["current"].get("clock", "")
                if args.verbose:
                    print(
                        "server stage-CPU accounting enabled "
                        f"(clock: {profiling_clock_mode}, was "
                        f"{prev_profiling.get('stage_cpu')})"
                    )
        metadata = await backend.get_model_metadata(
            args.model_name, args.model_version
        )
        async def _is_sequence(config, depth=0) -> bool:
            """Scheduler auto-detection incl. the ensemble composing-model
            walk (reference model_parser.cc WalkEnsemble): a sequence
            composing model makes the whole ensemble sequence-controlled."""
            if "sequence_batching" in config:
                return True
            steps = config.get("ensemble_scheduling", {}).get("step", [])
            if depth >= 8 or not steps:
                return False
            for step in steps:
                try:
                    sub = await backend.get_model_config(
                        step.get("model_name", ""), ""
                    )
                except Exception:  # noqa: BLE001 - composing unreadable
                    continue
                if await _is_sequence(sub, depth + 1):
                    return True
            return False

        sequence_model = False
        try:
            config = await backend.get_model_config(
                args.model_name, args.model_version
            )
            batched = int(config.get("max_batch_size", 0) or 0) > 0
            sequence_model = await _is_sequence(config)
        except Exception:  # noqa: BLE001 - config extension is optional
            batched = False
        shape_overrides = {}
        for override in args.shape:
            name, _, dims = override.partition(":")
            shape_overrides[name] = [int(d) for d in dims.split(",")]
        loader = DataLoader(
            metadata,
            batch_size=args.batch_size,
            shape_overrides=shape_overrides,
            batched=batched,
        )
        if args.input_data and os.path.isdir(args.input_data):
            loader.read_from_dir(args.input_data)
        elif args.input_data:
            loader.read_from_json(args.input_data)
        else:
            loader.generate_synthetic()

        if args.shared_memory != "none":
            from client_tpu_torch.perf.data import ShmDataPlane

            shm_plane = ShmDataPlane(loader, backend, kind=args.shared_memory)
            await shm_plane.setup()
            loader = shm_plane

        sequence_manager = None
        if args.sequence_length > 0 or sequence_model:
            sequence_manager = SequenceManager(
                length_mean=args.sequence_length or 20
            )
            common_seq = {"num_sequence_slots": args.num_of_sequences}
        else:
            common_seq = {}

        percentiles = (50, 90, 95, 99)
        if args.percentile and args.percentile not in percentiles:
            percentiles = tuple(sorted(set(percentiles) | {args.percentile}))

        try:
            request_parameters = parse_request_parameters(
                args.request_parameter
            )
        except ValueError as e:
            print(f"error: {e}", file=sys.stderr)
            return 2

        priorities = None
        if args.request_priority:
            try:
                priorities = [
                    int(p) for p in str(args.request_priority).split(",")
                ]
            except ValueError:
                print(
                    f"error: bad --request-priority "
                    f"'{args.request_priority}' (want an int or a comma "
                    "list of ints)",
                    file=sys.stderr,
                )
                return 2

        common = dict(
            model_name=args.model_name,
            model_version=args.model_version,
            data_loader=loader,
            streaming=args.streaming,
            sequence_manager=sequence_manager,
            parameters=request_parameters or None,
            max_error_rate=args.max_error_rate,
            priorities=priorities,
            queue_timeout_us=args.queue_timeout_us,
        )

        latency_threshold_us = (
            args.latency_threshold * 1000 if args.latency_threshold else None
        )

        if args.flamegraph_out:
            # sample the server mid-measurement: started here, after the
            # setup, right before the load managers launch
            from client_tpu_torch.perf.metrics_collector import fetch_profile

            profile_duration_s = min(
                5.0, max(0.25, args.measurement_interval / 1000.0)
            )

            async def _capture_flamegraph():
                await asyncio.sleep(0.5)
                return await fetch_profile(
                    collector.url,
                    duration_s=profile_duration_s,
                    hz=args.profile_hz,
                )

            flamegraph_task = asyncio.get_running_loop().create_task(
                _capture_flamegraph()
            )

        def make_profiler(manager):
            return InferenceProfiler(
                manager,
                metrics_collector=collector,
                measurement_interval_s=args.measurement_interval / 1000.0,
                stability_pct=args.stability_percentage,
                max_trials=args.max_trials,
                latency_threshold_us=latency_threshold_us,
                count_windows=args.measurement_mode == "count_windows",
                measurement_request_count=args.measurement_request_count,
                percentiles=percentiles,
                stability_percentile=args.percentile,
                warmup_requests=args.warmup_request_count,
                verbose=args.verbose,
            )

        profiler = None
        if args.periodic_concurrency_range:
            start, end, step = _parse_range(args.periodic_concurrency_range)
            manager = PeriodicConcurrencyManager(
                backend,
                start=start,
                end=end,
                step=step,
                request_period=args.request_period,
                **common,
            )
            import time as _time

            t0 = _time.monotonic_ns()
            await manager.run()
            t1 = _time.monotonic_ns()
            from client_tpu_torch.perf.profiler import ProfileExperiment
            from client_tpu_torch.perf.records import compute_window_status

            status = compute_window_status(manager.records, t0, t1, percentiles)
            experiments = [
                ProfileExperiment(
                    mode="periodic_concurrency",
                    value=end,
                    status=status,
                    records=manager.records,
                )
            ]
        elif args.request_intervals:
            with open(args.request_intervals) as f:
                intervals_us = [float(line) for line in f if line.strip()]
            manager = RequestRateManager(
                backend,
                distribution=args.request_distribution,
                **common_seq,
                **common,
            )
            profiler = make_profiler(manager)
            experiments = await profiler.profile_custom_intervals(
                [us / 1e6 for us in intervals_us]
            )
        elif args.request_rate_range:
            start, end, step = _parse_range(args.request_rate_range, float)
            manager = RequestRateManager(
                backend,
                distribution=args.request_distribution,
                **common_seq,
                **common,
            )
            profiler = make_profiler(manager)
            if args.binary_search:
                experiments = await profiler.profile_request_rate_binary(
                    int(start), int(end)
                )
            else:
                experiments = await profiler.profile_request_rate_range(
                    start, end, step
                )
        else:
            start, end, step = _parse_range(args.concurrency_range or "1")
            manager = ConcurrencyManager(backend, **common)
            profiler = make_profiler(manager)
            if args.binary_search:
                experiments = await profiler.profile_concurrency_binary(
                    start, end
                )
            else:
                experiments = await profiler.profile_concurrency_range(
                    start, end, step
                )

        for experiment in experiments:
            label = f"{experiment.mode} = {experiment.value:g}"
            print(f"* {label}")
            print(detailed_report(experiment))
        print()
        print(console_report(experiments))

        server_summary = None
        if collector is not None:
            await collector.stop()
            server_summary = collector.summary()
            print()
            print(format_server_metrics(server_summary))
            if collector.scrape_errors and collector.last_error:
                print(f"  last scrape error: {collector.last_error}")
        if args.profile_server and server_summary is not None:
            from client_tpu_torch.perf.report import format_wire_gap

            print()
            print(format_wire_gap(server_summary, clock_mode=profiling_clock_mode))
        if flamegraph_task is not None:
            collapsed = await flamegraph_task
            flamegraph_task = None
            if collapsed:
                with open(args.flamegraph_out, "w") as f:
                    f.write(collapsed)
                print(
                    f"wrote server flamegraph collapsed stacks to "
                    f"{args.flamegraph_out} (flamegraph.pl or "
                    "speedscope.app can open it)"
                )
            else:
                print(
                    "warning: server profile capture failed; no "
                    "flamegraph written",
                    file=sys.stderr,
                )
        if args.dump_slow_requests:
            # end the run with evidence: the server's worst requests,
            # stage-decomposed
            from client_tpu_torch.perf.metrics_collector import fetch_debug_requests
            from client_tpu_torch.perf.report import format_slow_requests

            debug_url = (collector.url if collector is not None
                         else _server_http_url(args))
            recorder_snapshot = await fetch_debug_requests(
                debug_url, model=args.model_name, limit=args.dump_slow_requests)
            print()
            if recorder_snapshot is None:
                print(
                    "warning: could not fetch /v2/debug/requests from "
                    f"{debug_url}; no slow-request dump",
                    file=sys.stderr,
                )
            else:
                print(format_slow_requests(recorder_snapshot, args.dump_slow_requests))
                if run_logger is not None:
                    for exemplar in recorder_snapshot.get("slowest", []):
                        run_logger.info("slow_request", **exemplar)

        try:
            pool_snapshot = backend.endpoint_snapshot()
        except Exception:  # noqa: BLE001 - telemetry must not fail the run
            pool_snapshot = None
        # "Client metrics": whenever client telemetry is live (a tracer,
        # or the endpoint pool's stats under --collect-metrics)
        if tracer is not None or (args.collect_metrics and pool_snapshot is not None):
            print()
            print(format_client_metrics(
                tracer.metrics.snapshot() if tracer is not None else None,
                endpoints=pool_snapshot,
            ))

        if args.filename:
            write_csv(experiments, args.filename)
        if args.profile_export_file:
            export_profile(
                experiments,
                args.profile_export_file,
                endpoint=args.url,
            )
        if args.json_summary and experiments:
            best = max(experiments, key=lambda e: e.status.throughput)
            if (
                args.binary_search
                and profiler is not None
                and profiler.binary_search_answer()
            ):
                best = profiler.binary_search_answer()
            summary_doc = {
                "throughput": best.status.throughput,
                "p50_us": best.status.latency_percentiles_us.get(50, 0),
                "p99_us": best.status.latency_percentiles_us.get(99, 0),
                "count": best.status.request_count,
                "errors": best.status.error_count,
                "mode": best.mode,
                "value": best.value,
                # overload/scheduling: admission sheds, deadline errors,
                # shed fraction, and successes/sec excluding rejects
                "rejected": best.status.rejected_count,
                "timeouts": best.status.timeout_count,
                "shed_rate": best.status.shed_rate,
                "goodput": best.status.goodput,
                # lifecycle: dropped vs rerouted across drains/restarts
                "dropped_unavailable": best.status.unavailable_count,
                "rerouted": best.status.rerouted_count,
            }
            if pool_snapshot is not None:
                # routing/hedging/ejection outcome of the run (the
                # client-side fleet counters)
                summary_doc["routing_policy"] = pool_snapshot.get("policy")
                summary_doc["hedges"] = pool_snapshot.get("hedges", 0)
                summary_doc["hedge_wins"] = pool_snapshot.get(
                    "hedge_wins", 0
                )
                summary_doc["ejections"] = pool_snapshot.get("ejections", 0)
            if best.status.per_priority_latency_us:
                summary_doc["per_priority_p99_us"] = {
                    str(p): entry.get(99, 0)
                    for p, entry in
                    best.status.per_priority_latency_us.items()
                }
            if server_summary is not None:
                summary_doc["server_duty_avg"] = server_summary.duty_avg
                summary_doc["server_duty_max"] = server_summary.duty_max
                summary_doc["server_batch_avg"] = server_summary.batch_avg
                stage_us = server_summary.stage_cpu_us()
                if stage_us:
                    summary_doc["server_stage_cpu_us"] = {
                        stage: round(us, 2)
                        for stage, us in sorted(stage_us.items())
                    }
            print(json.dumps(summary_doc))
        return 0
    except InferenceServerException as e:
        # Setup/transport failures (unreachable endpoint, bad metadata,
        # unsupported model) end the run with a message, not a traceback —
        # per-request errors during measurement are recorded in the
        # experiment records instead and never raise to here.
        print(f"error: {e}", file=sys.stderr)
        return 1
    finally:
        if flamegraph_task is not None:
            flamegraph_task.cancel()
        if prev_profiling is not None and not prev_profiling.get("stage_cpu"):
            # restore the server's pre-run profiling setting (default off)
            from client_tpu_torch.perf.metrics_collector import set_stage_cpu

            await set_stage_cpu(collector.url, False)
        if collector is not None:
            await collector.stop()  # no-op when already stopped above
        if shm_plane is not None:
            await shm_plane.cleanup()
        await backend.close()
        if trace_exporter is not None:
            trace_exporter.close()
        if run_logger is not None:
            run_logger.info("run_finished")
            run_logger.close()


def main(argv: Optional[List[str]] = None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    refused = refusal(args)
    if refused is not None:
        print(refused, file=sys.stderr)
        return 2
    if args.binary_search:
        if not args.latency_threshold:
            parser.error("--binary-search requires --latency-threshold")
        if args.periodic_concurrency_range or args.request_intervals:
            parser.error(
                "--binary-search requires --concurrency-range or "
                "--request-rate-range"
            )
    if (
        sum(
            bool(x)
            for x in (
                args.concurrency_range,
                args.request_rate_range,
                args.request_intervals,
                args.periodic_concurrency_range,
            )
        )
        > 1
    ):
        print(
            "error: pick one of --concurrency-range, --request-rate-range, "
            "--request-intervals, --periodic-concurrency-range",
            file=sys.stderr,
        )
        return 2
    return asyncio.run(run(args))


if __name__ == "__main__":
    raise SystemExit(main())
