"""Optional plots for genai-perf runs (the port's own copy of
``client_tpu/genai_perf/plots.py``; reference genai-perf plots/).

Uses matplotlib when available; writes TTFT distribution and per-request
token-timeline scatter to the artifact directory.
"""

import json
import os


def generate_plots(profile_export_path: str, artifact_dir: str) -> None:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    with open(profile_export_path) as f:
        doc = json.load(f)
    experiments = doc.get("experiments", [])
    if not experiments:
        return
    requests = experiments[0].get("requests", [])
    ttfts = [
        (r["response_timestamps"][0] - r["timestamp"]) / 1e6
        for r in requests
        if r.get("response_timestamps")
    ]
    if ttfts:
        fig, ax = plt.subplots(figsize=(6, 4))
        ax.hist(ttfts, bins=30)
        ax.set_xlabel("time to first token (ms)")
        ax.set_ylabel("requests")
        ax.set_title("TTFT distribution")
        fig.tight_layout()
        fig.savefig(os.path.join(artifact_dir, "ttft_distribution.png"))
        plt.close(fig)

    timeline = [r for r in requests if r.get("response_timestamps")]
    if timeline:
        shown = timeline[:100]
        fig, ax = plt.subplots(figsize=(8, 4))
        base = min(r["timestamp"] for r in timeline)
        for i, r in enumerate(shown):
            xs = [(t - base) / 1e9 for t in r["response_timestamps"]]
            ax.scatter(xs, [i] * len(xs), s=2)
        ax.set_xlabel("time (s)")
        ax.set_ylabel("request #")
        title = "token arrival timeline"
        if len(timeline) > len(shown):
            title += f" (first {len(shown)} of {len(timeline)} requests)"
        ax.set_title(title)
        fig.tight_layout()
        fig.savefig(os.path.join(artifact_dir, "token_timeline.png"))
        plt.close(fig)

    # Inter-token latency distribution (reference token-to-token plot).
    itls = []
    by_position = {}  # token index -> [itl_ms]
    for r in timeline:
        stamps = r["response_timestamps"]
        for k in range(1, len(stamps)):
            itl_ms = (stamps[k] - stamps[k - 1]) / 1e6
            itls.append(itl_ms)
            by_position.setdefault(k, []).append(itl_ms)
    if itls:
        fig, ax = plt.subplots(figsize=(6, 4))
        ax.hist(itls, bins=40)
        ax.set_xlabel("inter-token latency (ms)")
        ax.set_ylabel("token transitions")
        ax.set_title("ITL distribution")
        fig.tight_layout()
        fig.savefig(os.path.join(artifact_dir, "itl_distribution.png"))
        plt.close(fig)

    # ITL by token position: exposes warm-up / cache-growth trends the
    # aggregate histogram hides (reference per-position token plot).
    if by_position:
        all_positions = sorted(by_position)
        positions = all_positions[:256]
        means = [sum(by_position[p]) / len(by_position[p])
                 for p in positions]
        p95s = [sorted(by_position[p])[int(0.95 * (len(by_position[p]) - 1))]
                for p in positions]
        fig, ax = plt.subplots(figsize=(7, 4))
        ax.plot(positions, means, label="mean")
        ax.plot(positions, p95s, label="p95", linestyle="--")
        ax.set_xlabel("output token position")
        ax.set_ylabel("inter-token latency (ms)")
        title = "ITL by token position"
        if len(all_positions) > len(positions):
            title += (f" (first {len(positions)} of "
                      f"{len(all_positions)} positions)")
        ax.set_title(title)
        ax.legend()
        fig.tight_layout()
        fig.savefig(os.path.join(artifact_dir, "itl_by_position.png"))
        plt.close(fig)

    # Output-token count distribution.
    counts = [len(r["response_timestamps"]) for r in timeline]
    if counts:
        fig, ax = plt.subplots(figsize=(6, 4))
        ax.hist(counts, bins=min(30, max(counts) - min(counts) + 1 or 1))
        ax.set_xlabel("output tokens per request")
        ax.set_ylabel("requests")
        ax.set_title("Output token counts")
        fig.tight_layout()
        fig.savefig(os.path.join(artifact_dir, "output_tokens.png"))
        plt.close(fig)

    # Rolling token throughput over the run (1s buckets). Empty seconds
    # plot as zero — a stall must read as a stall, not as interpolated
    # sustained throughput.
    arrivals = [t for r in timeline for t in r["response_timestamps"]]
    if arrivals:
        base = min(arrivals)
        buckets = {}
        for t in arrivals:
            b = int((t - base) / 1e9)
            buckets[b] = buckets.get(b, 0) + 1
        xs = list(range(0, max(buckets) + 1))
        fig, ax = plt.subplots(figsize=(7, 4))
        ax.plot(xs, [buckets.get(x, 0) for x in xs])
        ax.set_xlabel("time (s)")
        ax.set_ylabel("tokens / s")
        ax.set_title("Token throughput over the run")
        fig.tight_layout()
        fig.savefig(os.path.join(artifact_dir, "throughput_over_time.png"))
        plt.close(fig)


def _extract_times_ms(profile_export_path: str):
    """(ttfts_ms, latencies_ms) from a profile export's first experiment."""
    with open(profile_export_path) as f:
        doc = json.load(f)
    experiments = doc.get("experiments", [])
    requests = experiments[0].get("requests", []) if experiments else []
    timed = [r for r in requests if r.get("response_timestamps")]
    ttfts = [(r["response_timestamps"][0] - r["timestamp"]) / 1e6 for r in timed]
    latencies = [
        (r["response_timestamps"][-1] - r["timestamp"]) / 1e6 for r in timed
    ]
    return ttfts, latencies


def _comparison_boxplot(plt, data, labels, ylabel, title, path):
    fig, ax = plt.subplots(figsize=(max(6, 2 * len(labels)), 4))
    ax.boxplot(data, showfliers=False)
    # set_xticklabels works on all matplotlib versions (the boxplot
    # tick_labels kwarg needs >= 3.9).
    ax.set_xticks(range(1, len(labels) + 1))
    ax.set_xticklabels(labels)
    ax.set_ylabel(ylabel)
    ax.set_title(title)
    fig.tight_layout()
    fig.savefig(path)
    plt.close(fig)


def generate_comparison_plots(named_paths, artifact_dir: str) -> None:
    """Cross-run comparison plots for the `compare` subcommand
    (reference genai-perf plots/: scatter/box across runs).

    named_paths: list of (label, profile_export_path).
    """
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    runs = []
    for label, path in named_paths:
        ttfts, latencies = _extract_times_ms(path)
        if ttfts:
            runs.append((label, ttfts, latencies))
    if not runs:
        return
    labels = [label for label, _, _ in runs]
    _comparison_boxplot(
        plt, [t for _, t, _ in runs], labels, "time to first token (ms)",
        "TTFT by run", os.path.join(artifact_dir, "compare_ttft_box.png"))
    _comparison_boxplot(
        plt, [l for _, _, l in runs], labels, "request latency (ms)",
        "Request latency by run",
        os.path.join(artifact_dir, "compare_latency_box.png"))
