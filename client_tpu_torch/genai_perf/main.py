"""The port's genai-perf CLI (``python -m client_tpu_torch.genai_perf``).

The port's own copy of ``client_tpu/genai_perf/main.py``. Reference
parity: the ``profile`` flow of genai-perf
(reference genai-perf main.py + parser.py + wrapper.py) — synthesize LLM
inputs, drive the perf harness in streaming mode, parse the profile export
into LLM metrics, and report. Runs the harness in-process rather than
subprocess-forking a binary (the wrapper builds the same CLI argument list
the reference would, reference wrapper.py:53-121).

``--service-kind triton`` (the default) with ``--endpoint-type kserve-ids``
or ``kserve-text`` drives the model over KServe v2 gRPC (``-i grpc``,
``ModelStreamInfer`` with ``--streaming``) through the port's own gRPC
client, and reads the engine's speculation counters from its model config
before and after the run; ``--service-kind openai`` drives the OpenAI
routes over HTTP.
"""

import argparse
import os
import sys
import tempfile
from typing import List, Optional


def build_compare_parser() -> argparse.ArgumentParser:
    """`compare` subcommand: side-by-side metrics + plots across runs
    (reference genai-perf compare subcommand + plots/)."""
    parser = argparse.ArgumentParser(
        prog="genai-perf-tpu-torch compare",
        description="Compare profile-export files from multiple runs.",
    )
    parser.add_argument(
        "--files", nargs="+", required=True,
        help="profile_export.json files to compare",
    )
    parser.add_argument(
        "--names", nargs="*", default=None,
        help="labels for the runs (default: file stems)",
    )
    parser.add_argument("--artifact-dir", default=None)
    parser.add_argument(
        "--generate-plots", action="store_true",
        help="write comparison plots (matplotlib if available)",
    )
    return parser


def compare_main(argv: List[str]) -> int:
    import csv
    import json

    from client_tpu_torch.genai_perf.metrics import LLMProfileDataParser

    args = build_compare_parser().parse_args(argv)
    artifact_dir = args.artifact_dir or tempfile.mkdtemp(
        prefix="genai_perf_compare_"
    )
    os.makedirs(artifact_dir, exist_ok=True)
    names = args.names if args.names is not None else [
        os.path.splitext(os.path.basename(f))[0] for f in args.files
    ]
    if len(names) != len(args.files):
        print("error: --names must match --files", file=sys.stderr)
        return 1

    runs = []
    for name, path in zip(names, args.files):
        try:
            metrics = LLMProfileDataParser(path).parse()
        except Exception as e:  # noqa: BLE001 - surface per-file errors
            print(f"error: cannot parse '{path}': {e}", file=sys.stderr)
            return 1
        runs.append((name, metrics))

    # statistics() sorts every metric's samples — compute once per run.
    run_stats = [(name, metrics, metrics.statistics())
                 for name, metrics in runs]
    rows = [
        ("time to first token avg (ms)",
         lambda m, s: s["time_to_first_token"].avg / 1e6),
        ("time to first token p99 (ms)",
         lambda m, s: s["time_to_first_token"].p99 / 1e6),
        ("inter-token latency avg (ms)",
         lambda m, s: s["inter_token_latency"].avg / 1e6),
        ("request latency avg (ms)",
         lambda m, s: s["request_latency"].avg / 1e6),
        ("output token throughput (tok/s)",
         lambda m, s: m.output_token_throughput),
        ("request throughput (req/s)", lambda m, s: m.request_throughput),
    ]
    width = max(len(r[0]) for r in rows) + 2
    header = " " * width + "".join(f"{n:>18}" for n, _ in runs)
    print(header)
    table = []
    for label, fn in rows:
        values = []
        for _, metrics, stats in run_stats:
            try:
                values.append(fn(metrics, stats))
            except Exception:  # noqa: BLE001 - metric absent for this run
                values.append(float("nan"))
        print(f"{label:<{width}}" + "".join(f"{v:>18.2f}" for v in values))
        table.append((label, values))

    csv_path = os.path.join(artifact_dir, "compare.csv")
    with open(csv_path, "w", newline="") as f:
        writer = csv.writer(f)
        writer.writerow(["metric"] + [n for n, _ in runs])
        for label, values in table:
            writer.writerow([label] + values)
    json_path = os.path.join(artifact_dir, "compare.json")
    with open(json_path, "w") as f:
        json.dump(
            {
                "runs": [n for n, _ in runs],
                # null (not NaN) for absent metrics — bare NaN is not JSON.
                "metrics": {
                    label: [None if v != v else v for v in values]
                    for label, values in table
                },
            },
            f,
            indent=2,
        )
    print(f"\nartifacts: {artifact_dir}")
    if args.generate_plots:
        try:
            from client_tpu_torch.genai_perf.plots import generate_comparison_plots

            generate_comparison_plots(
                list(zip(names, args.files)), artifact_dir
            )
        except Exception as e:  # noqa: BLE001 - plots are optional
            print(f"plot generation skipped: {e}", file=sys.stderr)
    return 0


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="genai-perf-tpu-torch", description="Benchmark LLM serving (KServe v2)."
    )
    parser.add_argument("-m", "--model", required=True)
    parser.add_argument("-u", "--url", default="localhost:8001")
    parser.add_argument(
        "--service-kind",
        default="triton",
        choices=["triton", "openai"],
        help="backend service flavor",
    )
    parser.add_argument(
        "--endpoint-type",
        default="kserve-ids",
        choices=[
            "kserve-ids",
            "kserve-text",
            "openai-chat",
            "openai-completions",
        ],
        help="input flavor: KServe token-id/text tensors, or OpenAI "
        "chat/completions payloads",
    )
    parser.add_argument(
        "--endpoint",
        default=None,
        help="openai: endpoint path (default derives from endpoint type:"
        " v1/chat/completions or v1/completions)",
    )
    parser.add_argument("--input-name", default="INPUT_IDS")
    parser.add_argument(
        "--input-dataset",
        default=None,
        help="local dataset export (JSON/JSONL) to draw prompts from "
        "instead of synthesizing (OpenOrca/CNN_DailyMail/plain schemas)",
    )
    parser.add_argument(
        "--dataset-format",
        default="auto",
        choices=["auto", "openorca", "cnn_dailymail", "plain"],
        help="record schema of --input-dataset",
    )
    parser.add_argument("--num-prompts", type=int, default=50)
    parser.add_argument(
        "--shared-prefix-tokens", type=int, default=0,
        help="prepend ONE fixed synthetic prefix of N tokens to every "
        "prompt (a shared system prompt) and stamp each request with a "
        "prefix-derived 'routing_key' parameter — the copy-on-write "
        "prefix-sharing workload; pair with --routing-policy "
        "consistent_hash so a fleet pins sharers to one replica's KV "
        "index",
    )
    parser.add_argument(
        "--speculation", default=None, choices=["on", "off"],
        help="stamp the engine's per-request speculative-decoding "
        "switch on every generated request — A/B the same workload "
        "against one speculation-enabled model (kserve endpoints; the "
        "server default is 'on' for models that declare speculation)",
    )
    parser.add_argument(
        "--routing-policy", default=None,
        help="perf-harness passthrough: endpoint-pool routing policy "
        "(round_robin/least_outstanding/p2c/consistent_hash) for "
        "multi-replica -u host1,host2 runs; kserve endpoint types only "
        "(the harness rejects it for the openai client)",
    )
    parser.add_argument("--synthetic-input-tokens-mean", type=int, default=64)
    parser.add_argument(
        "--synthetic-input-tokens-stddev", type=float, default=0.0
    )
    parser.add_argument("--output-tokens-mean", type=int, default=16)
    parser.add_argument("--output-tokens-stddev", type=float, default=0.0)
    parser.add_argument(
        "--tokenizer",
        default="bpe",
        help="'bpe' (bundled real subword tokenizer, default), "
        "'synthetic' (word-hash), or a local HF tokenizer name",
    )
    parser.add_argument("--concurrency", type=int, default=1)
    parser.add_argument("--request-rate", type=float, default=None)
    parser.add_argument("--measurement-interval", "-p", type=int, default=4000)
    parser.add_argument("--stability-percentage", type=float, default=50.0)
    parser.add_argument("--max-trials", type=int, default=6)
    parser.add_argument(
        "--streaming",
        action=argparse.BooleanOptionalAction,
        default=True,
        help="use decoupled streaming (--no-streaming for unary models)",
    )
    parser.add_argument(
        "--artifact-dir", default=None, help="output directory"
    )
    parser.add_argument(
        "--profile-export-file", default="profile_export.json"
    )
    parser.add_argument(
        "--dataset",
        choices=["openorca", "cnn_dailymail"],
        default=None,
        help="fetch prompts from this hosted dataset (HF datasets-server; "
        "honors HF_HUB_OFFLINE/HF_DATASETS_OFFLINE; the offline twin is "
        "--input-dataset <file>)",
    )
    parser.add_argument(
        "--generate-plots", action="store_true",
        help="write latency/throughput plots (matplotlib if available)",
    )
    parser.add_argument(
        "--json-summary", action="store_true",
        help="print ONE machine-readable JSON line with the headline LLM "
        "metrics (TTFT/ITL in ms, tokens/sec) — the bench.py/CI "
        "counterpart of the perf harness's --json-summary",
    )
    parser.add_argument("-v", "--verbose", action="store_true")
    return parser


def json_summary_line(metrics, spec_delta: Optional[dict] = None) -> dict:
    """The --json-summary document: headline LLM metrics in stable units
    (times in ms; ns internals never leak into the machine output).

    ``spec_delta`` (the engine's speculation-counter delta over this
    run, from :func:`fetch_spec_stats` before/after) adds the
    speculative-decoding headlines: ``tokens_per_step`` (decode-step
    emissions per lane-step; 1.0 when speculation is off/absent) and
    ``spec_acceptance_rate`` (accepted / verified drafts)."""
    stats = metrics.statistics()
    ttft = stats["time_to_first_token"]
    itl = stats["inter_token_latency"]
    doc = {
        "ttft_avg_ms": round(ttft.avg / 1e6, 3),
        "ttft_p99_ms": round(ttft.p99 / 1e6, 3),
        "itl_avg_ms": round(itl.avg / 1e6, 3),
        "itl_p99_ms": round(itl.p99 / 1e6, 3),
        "tokens_per_sec": round(metrics.output_token_throughput, 2),
        "requests_per_sec": round(metrics.request_throughput, 3),
        "request_count": metrics.request_count,
        "output_tokens_avg": round(
            stats["num_output_tokens"].avg, 2
        ),
    }
    if spec_delta is not None:
        doc["tokens_per_step"] = round(
            spec_delta["step_tokens"] / max(1, spec_delta["lane_steps"]), 3
        )
        doc["spec_acceptance_rate"] = round(
            spec_delta["spec_accepted"] / max(1, spec_delta["spec_proposed"]),
            3,
        )
    return doc


def fetch_spec_stats(url: str, model: str) -> Optional[dict]:
    """The engine's live speculation counters, via the model config's
    ``speculation_stats`` parameter over gRPC (the one schemaless wire
    channel — the proto statistics schema is frozen), read through the
    port's own gRPC client. None when the server/model does not expose
    them (non-engine model, speculation off, unreachable), so callers
    degrade to the plain summary."""
    import json

    try:
        from client_tpu_torch.grpc import InferenceServerClient

        client = InferenceServerClient(url)
        try:
            config = client.get_model_config(
                model, as_json=True, client_timeout=10
            )
        finally:
            client.close()
        raw = config["config"]["parameters"]["speculation_stats"][
            "string_value"
        ]
        return json.loads(raw)
    except Exception:  # noqa: BLE001 - the summary must never fail on this
        return None


def spec_stats_delta(
    before: Optional[dict], after: Optional[dict]
) -> Optional[dict]:
    """Counter deltas over one measured run (both snapshots required —
    a mid-flight model reload resets counters, surfacing as negative
    deltas, which also degrade to None)."""
    if before is None or after is None:
        return None
    delta = {key: after[key] - before[key] for key in after if key in before}
    if any(value < 0 for value in delta.values()):
        return None
    return delta


def main(argv: Optional[List[str]] = None) -> int:
    if argv is None:
        argv = sys.argv[1:]
    # Subcommand dispatch (reference genai-perf profile/compare); a bare
    # flag list keeps working as `profile` for compatibility.
    if argv and argv[0] == "compare":
        return compare_main(argv[1:])
    if argv and argv[0] == "profile":
        argv = argv[1:]
    from client_tpu_torch.genai_perf.inputs import create_llm_inputs
    from client_tpu_torch.genai_perf.metrics import (
        LLMProfileDataParser,
        console_table,
        export_csv,
        export_json,
    )
    from client_tpu_torch.genai_perf.tokenizer import get_tokenizer
    from client_tpu_torch.perf import cli as perf_cli

    args = build_parser().parse_args(argv)
    from client_tpu_torch.genai_perf.logging import getLogger, init_logging

    init_logging(verbose=args.verbose)
    log = getLogger("main")
    artifact_dir = args.artifact_dir or tempfile.mkdtemp(prefix="genai_perf_")
    os.makedirs(artifact_dir, exist_ok=True)
    log.info("artifact dir: %s", artifact_dir)
    inputs_path = os.path.join(artifact_dir, "llm_inputs.json")
    export_path = os.path.join(artifact_dir, args.profile_export_file)

    openai = (
        args.service_kind == "openai"
        or args.endpoint_type.startswith("openai")
    )
    if openai and args.endpoint_type.startswith("kserve"):
        if args.endpoint_type != "kserve-ids":
            # The default endpoint-type silently upgrades; an explicit
            # kserve choice conflicts with the openai service kind.
            print(
                "error: --service-kind openai is incompatible with "
                f"--endpoint-type {args.endpoint_type}",
                file=sys.stderr,
            )
            return 1
        args.endpoint_type = "openai-chat"
    if args.endpoint is None:
        args.endpoint = (
            "v1/completions"
            if args.endpoint_type == "openai-completions"
            else "v1/chat/completions"
        )

    tokenizer = get_tokenizer(args.tokenizer)
    hub_prompts = None
    if args.dataset:
        from client_tpu_torch.genai_perf.inputs import fetch_hub_prompts

        try:
            # the rows API caps length at 100; create_llm_inputs cycles
            # a shorter prompt list up to num_prompts
            hub_prompts = fetch_hub_prompts(
                args.dataset, length=min(100, args.num_prompts)
            )
        except Exception as e:  # noqa: BLE001 - offline/unreachable hub
            print(f"genai-perf: dataset fetch failed: {e}", file=sys.stderr)
            return 1
    log.info(
        "generating %d prompts (%s) with tokenizer %s",
        args.num_prompts,
        args.dataset or args.input_dataset or "synthetic",
        type(tokenizer).__name__,
    )
    create_llm_inputs(
        inputs_path,
        num_prompts=args.num_prompts,
        input_tokens_mean=args.synthetic_input_tokens_mean,
        input_tokens_stddev=args.synthetic_input_tokens_stddev,
        output_tokens_mean=args.output_tokens_mean,
        output_tokens_stddev=args.output_tokens_stddev,
        output_format=args.endpoint_type,
        input_name=args.input_name,
        tokenizer=tokenizer,
        model=args.model,
        streaming=openai and args.streaming,
        dataset_path=args.input_dataset,
        dataset_format=args.dataset_format,
        prompts=hub_prompts,
        shared_prefix_tokens=args.shared_prefix_tokens,
        speculation=args.speculation,
    )
    log.info("profiling model %s at %s", args.model, args.url)
    # Speculation A/B bookkeeping: snapshot the engine's speculation
    # counters around the run so the summary reports tokens-per-step and
    # acceptance over EXACTLY this workload (kserve/gRPC only — the
    # openai client has no model-config surface to read them from).
    spec_before = None if openai else fetch_spec_stats(args.url, args.model)

    # Build the perf-harness invocation (reference wrapper.Profiler role).
    perf_args = [
        "-m", args.model,
        "-u", args.url,
        "--input-data", inputs_path,
        "--measurement-interval", str(args.measurement_interval),
        "--stability-percentage", str(args.stability_percentage),
        "--max-trials", str(args.max_trials),
        "--profile-export-file", export_path,
    ]
    if openai:
        perf_args += ["--service-kind", "openai", "--endpoint", args.endpoint]
    else:
        perf_args += ["-i", "grpc"]
    if args.streaming:
        perf_args.append("--streaming")
    # output lengths are embedded per request in the generated input data
    # ("parameters" key), so no global max_tokens request parameter here
    if args.routing_policy:
        perf_args += ["--routing-policy", args.routing_policy]
    if args.request_rate is not None:
        perf_args += ["--request-rate-range", str(args.request_rate)]
    else:
        perf_args += ["--concurrency-range", str(args.concurrency)]
    if args.verbose:
        perf_args.append("--verbose")

    code = perf_cli.main(perf_args)
    if code != 0:
        return code

    spec_delta = (
        None
        if openai
        else spec_stats_delta(
            spec_before, fetch_spec_stats(args.url, args.model)
        )
    )
    metrics = LLMProfileDataParser(export_path).parse()
    print()
    print(console_table(metrics))
    if args.json_summary:
        import json as _json

        print(_json.dumps(json_summary_line(metrics, spec_delta)))
    from client_tpu_torch.genai_perf.tokenizer import tokenizer_provenance

    export_csv(metrics, os.path.join(artifact_dir, "llm_metrics.csv"))
    export_json(
        metrics,
        os.path.join(artifact_dir, "llm_metrics.json"),
        tokenizer=tokenizer_provenance(tokenizer),
    )
    print(f"\nartifacts: {artifact_dir}")
    if args.generate_plots:
        try:
            from client_tpu_torch.genai_perf.plots import generate_plots

            generate_plots(export_path, artifact_dir)
        except Exception as e:  # noqa: BLE001 - plots are optional
            print(f"plot generation skipped: {e}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
