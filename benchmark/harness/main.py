"""One run of one cell: ``run.py --workload <cell> --seed <n> --seconds
<s> --trace <0|1>``.

The cell (``BENCHMARK.json``'s ``workloads`` entry) names a
configuration (``configs/<config>.json``) and a traffic mix
(``traffic/<mix>.json``); the configuration's ``serve.system`` names its
model type (``systems/<system>.py``, ``harness/systems.py``); each metric
the cell reports is read by ``metrics/<metric>.py``. So a cell, a
configuration, a model type, a mix or a metric is added as files, and
this code finds them by name.

A run: weights from the seed on the card; the port's model and server in
this process; one client process (``client.py``) driving the mix's
closed loop; a ramp, counted in the set-up; the measured window; then,
with the program's state freed, the check against the plain reference,
and one JSON line on standard output. With ``--trace 1`` the same run
reads the per-layer metrics instead: the harness's spans around the
model's device calls, the program's counters, NVML's utilisation and
``torch.profiler`` windows inside the measured one.
"""

import argparse
import gc
import importlib.util
import json
import os
import subprocess
import sys
import time
from pathlib import Path
from typing import Any, Dict, List, Optional

BENCH = Path(__file__).resolve().parents[1]
FOREIGN = ("jax", "jaxlib", "flax", "client_tpu")
WINDOW_S, WINDOW_GAP_S = 2.0, 2.0
# the share of a traced run's window that the counters, spans and NVML
# read before the profiler windows start
QUIET_SHARE = 0.6
CLIENT_GRACE_S = 90.0
# in a traced run the client keeps the load on this long past the window,
# so that device calls go on to close the last profiler window in their
# own thread; a window longer than the first's hold is not begun
TRACE_TAIL_S = 30.0
FIRST_HOLD_S = 12.0
# the share of unary answers the client keeps for the check to draw from
CHECK_SHARE = 0.1


def foreign_modules() -> List[str]:
    """Top-level names in ``sys.modules`` that belong to JAX or to the
    JAX package, compared whole (``client_tpu_torch`` is not
    ``client_tpu``)."""
    return sorted({name.split(".")[0] for name in sys.modules} & set(FOREIGN))


def load_cell(root: Path, name: str) -> Dict[str, Any]:
    """The cell ``name`` of ``root/BENCHMARK.json``, or else of
    ``parked.json`` (cells kept out of the benchmark, which tests, the
    control's readings and trials still run), with its configuration and
    mix read, and the metrics it reports in each mode as (name, unit)
    pairs."""
    from harness import traffic

    doc = json.loads((root / "BENCHMARK.json").read_text())
    if name not in {w["name"] for w in doc["workloads"]}:
        parked = json.loads((BENCH / "parked.json").read_text())
        for key in ("configs", "workloads", "end_to_end", "per_layer"):
            doc[key] = parked[key] + doc[key]
    cells = {w["name"]: w for w in doc["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json or parked.json")
    cell = dict(cells[name])
    configs = {c["name"]: c for c in doc["configs"]}
    cell["config_doc"] = json.loads((root / configs[cell["config"]]["file"]).read_text())
    cell["mix"] = traffic.load_mix(BENCH, cell["traffic"])

    def mine(metrics):
        return [(m["name"], m["unit"]) for m in metrics
                if "workloads" not in m or name in m["workloads"]]

    cell["end_to_end"] = mine(doc["end_to_end"])
    cell["per_layer"] = mine(doc["per_layer"])
    return cell


def reader(name: str):
    """The module ``metrics/<name>.py``: its ``read(run)``, and a
    ``KERNEL`` (a substring of a kernel's name) where the metric reads
    that kernel from the profiler windows."""
    path = BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"bench_metric_{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def set_environment(root: Path) -> None:
    """Caches at fixed places inside the checkout; no JAX for libraries
    that would load it by themselves."""
    os.environ["TRITON_CACHE_DIR"] = str(root / "build" / "triton-cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(root / "build" / "torch-extensions")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_TF"] = "0"


class Run:
    """What one run saw; the metric readers take it."""

    def __init__(self, cell, seed, seconds, trace, cuda):
        self.cell, self.seed, self.seconds, self.trace, self.cuda = cell, seed, seconds, trace, cuda
        self.config = cell["config_doc"]
        self.mix = cell["mix"]
        from harness import systems

        self.sizes = systems.sizes_of(self.config)
        self.system = self.config["serve"]["system"]
        # before any weights are drawn: an unknown system fails here
        self.model_type = systems.load(self.system)
        self.route = self.mix["route"]
        # the window is [open_ns, end_ns); the metrics read [open_ns,
        # close_ns), which a traced run ends early (QUIET_SHARE)
        self.open_ns = self.close_ns = self.end_ns = 0
        self.setup_s = 0.0
        self.records: List[Dict[str, Any]] = []
        self.counters: Dict[str, Any] = {}
        self.spans = None
        self.profile: Optional[Dict[str, Any]] = None
        self.profiler_busy: List[tuple] = []
        self.nvml_samples: Optional[List[tuple]] = None
        self.memory_peak_bytes = 0
        self.setup_phases: Dict[str, float] = {}

    @property
    def window_s(self) -> float:
        return (self.close_ns - self.open_ns) / 1e9

    def in_window(self, t: int) -> bool:
        return self.open_ns <= t < self.close_ns

    def clear_of_profiler(self, a: int, b: int) -> bool:
        """Whether [a, b] lies inside the window and outside every
        profiler window (opening and reading out included)."""
        return (self.open_ns <= a and b <= self.close_ns
                and all(b < p0 or a > p1 for p0, p1 in self.profiler_busy))


def _start_client(run: Run, model: str) -> subprocess.Popen:
    """The client process; it starts (imports) while the model loads,
    and learns the server's port with its ``go``."""
    spec = {"mix": run.mix, "seed": run.seed, "host": "127.0.0.1",
            "model": model, "slots": list(range(int(run.mix["concurrency"]))),
            "vocab_size": run.sizes["vocab_size"], "check_share": CHECK_SHARE,
            "tensors": list(run.model_type.INFER_TENSORS)}
    env = dict(os.environ, PYTHONUNBUFFERED="1")
    return subprocess.Popen([sys.executable, str(BENCH / "harness" / "client.py"), json.dumps(spec)],
                            stdin=subprocess.PIPE, stdout=subprocess.PIPE, env=env, text=True)


def _sleep_until(t_ns: int) -> None:
    while True:
        left = (t_ns - time.monotonic_ns()) / 1e9
        if left <= 0:
            return
        time.sleep(min(left, 0.5))


class Phases:
    """Seconds of each part of the set-up, from the process's start."""

    def __init__(self, t0_ns: int):
        self.last = t0_ns
        self.seconds: Dict[str, float] = {}

    def mark(self, name: str) -> None:
        now = time.monotonic_ns()
        self.seconds[name] = (now - self.last) / 1e9
        self.last = now


def _call_windows(run: Run, cuda: bool) -> List[Dict[str, Any]]:
    """Profiler windows from the quiet part's end to the window's, each
    opened and closed by the thread of the model's device calls
    (:class:`devtrace.CallWindows`)."""
    from harness import devtrace

    control = devtrace.CallWindows(WINDOW_S, cuda)
    run.spans.windows = control

    def hold_ns():
        held = [w["busy_to"] - w["busy_from"] for w in control.windows]
        return max(held) if held else int(FIRST_HOLD_S * 1e9)

    while time.monotonic_ns() + int((WINDOW_S + 1.5) * 1e9) + hold_ns() < run.end_ns:
        control.request()
        while control.busy and time.monotonic_ns() < run.end_ns:
            time.sleep(0.05)
        time.sleep(WINDOW_GAP_S)
    while control.busy and time.monotonic_ns() < run.end_ns + int(TRACE_TAIL_S * 1e9):
        time.sleep(0.05)
    run.spans.windows = None
    control.after_call(force=True)
    return control.windows


def run_cell(cell, seed: int, seconds: float, trace: bool, t0_ns: int, device: str = "cuda",
             after=None):
    """Run the cell once; returns the :class:`Run`, the program's
    weights and the checks. ``after(run, weights)``, where given, runs
    once the program is gone (the control's readings)."""
    import torch

    from harness import devtrace, systems

    cuda = device == "cuda"
    run = Run(cell, seed, seconds, trace, cuda)
    system = run.model_type
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    phases = Phases(t0_ns)
    phases.mark("start and imports")
    w = system.weights(run.sizes, seed, device)
    if cuda:
        torch.cuda.synchronize()
    phases.mark("weights")
    run.spans = systems.Spans() if trace else None
    model = system.build(run.config, run.sizes, w, device, run.spans)
    client = _start_client(run, model.name)
    server = None
    sampler = None
    windows = []
    try:
        server = systems.Server(model, device)
        phases.mark("load and server")
        phases.seconds.update({"of which load": server.load_s, "of which core": server.core_s})
        system.warm(run.config, model, run.mix)
        if cuda:
            torch.cuda.synchronize()
        phases.mark("warm shapes")
        if client.stdout.readline().strip() != "ready":
            raise RuntimeError("the client process did not start")
        phases.mark("client")
        go = time.monotonic_ns()
        run.open_ns = go + int(float(run.mix["ramp_s"]) * 1e9)
        run.close_ns = run.end_ns = run.open_ns + int(seconds * 1e9)
        load_end = run.end_ns + (int(TRACE_TAIL_S * 1e9) if trace else 0)
        client.stdin.write(f"go {server.port} {run.open_ns} {load_end}\n")
        client.stdin.flush()
        _sleep_until(run.open_ns)
        run.setup_s = (time.monotonic_ns() - t0_ns) / 1e9
        phases.mark("ramp")
        run.setup_phases = phases.seconds
        run.counters["open"] = system.counters(model, server)
        if trace and cuda:
            try:
                sampler = devtrace.Sampler(devtrace.Nvml(devtrace.nvml_index()))
                sampler.start()
            except OSError as e:
                print(f"nvml: not readable ({e})", file=sys.stderr)
        if trace:
            # the counters, spans and NVML read the quiet part of the
            # window; the profiler windows fill the rest
            run.close_ns = run.open_ns + int(QUIET_SHARE * (run.end_ns - run.open_ns))
        _sleep_until(run.close_ns)
        run.counters["close"] = system.counters(model, server)
        if sampler is not None:
            sampler.stop()
            run.nvml_samples = sampler.samples
            if sampler.error:
                print(f"nvml: {sampler.error}", file=sys.stderr)
        if trace:
            windows = _call_windows(run, cuda)
            _sleep_until(run.end_ns)
        out, _ = client.communicate(timeout=seconds + CLIENT_GRACE_S)
        reply = json.loads(out.strip().splitlines()[-1])
        run.records = reply["records"]
        if reply["foreign_modules"]:
            raise RuntimeError(f"the client loaded {reply['foreign_modules']}")
        if cuda:
            torch.cuda.synchronize()
            run.memory_peak_bytes = int(torch.cuda.max_memory_allocated())
    finally:
        if client.poll() is None:
            client.kill()
            client.wait(30)
        if server is not None:
            server.stop()
    del model, server
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    for window in windows:
        run.profiler_busy.append((window["busy_from"], window["busy_to"]))
    if trace:
        kernels = [k for k in (getattr(reader(name), "KERNEL", None)
                               for name, _ in cell["per_layer"]) if k]
        run.profile = devtrace.reduce_windows(windows, kernels, run.spans)
    windows.clear()
    from reference import linear

    linear.full_precision()
    checks = system.compare(run, w)
    if after is not None:
        after(run, w)
    return run, w, checks


def verdict(run: Run, checks: Dict[str, Any]):
    """``correct``: every number compared within its limit, no request
    sent in the window failed. Returns (correct, the checks with the
    failed requests' count, attempted, failed)."""
    from harness import check

    attempted = [r for r in run.records if run.open_ns <= r["t_send"] < run.end_ns]
    failed = [r for r in attempted if "error" in r]
    checks = dict(checks, failed_requests={"value": len(failed), "limit": 0})
    correct = all(c["value"] is not None and check.passed(n, c) for n, c in checks.items())
    return correct, checks, len(attempted), len(failed)


def result_line(run: Run, checks: Dict[str, Any]) -> Dict[str, Any]:
    """The contract's JSON object; ``checks`` comes last."""
    import torch

    correct, checks, attempted, failed = verdict(run, checks)
    metrics = {}
    for name, unit in (run.cell["per_layer"] if run.trace else run.cell["end_to_end"]):
        value = reader(name).read(run)
        if value is not None:
            metrics[name] = {"value": value, "unit": unit}
    device = {"platform": "gpu" if run.cuda else "cpu",
              "kind": torch.cuda.get_device_name(0) if run.cuda else "cpu",
              "count": 1, "memory_peak_bytes": run.memory_peak_bytes}
    line: Dict[str, Any] = {"correct": correct, "attempted": attempted, "failed": failed,
                            "metrics": metrics, "device": device}
    if run.trace and run.profile is not None:
        p = run.profile
        device["busy_s"] = p["busy_ns"] / 1e9
        device["window_s"] = p["window_ns"] / 1e9
        ops = sorted(p["ops"].items(), key=lambda kv: -kv[1])[:10]
        gaps = sorted(p["gaps"].items(), key=lambda kv: -kv[1])[:10]
        line["breakdown"] = {"device_ops": [[n[:200], ns / 1e9] for n, ns in ops],
                             "idle_gaps": [[n[:200], ns / 1e9] for n, ns in gaps]}
    line["checks"] = checks
    return line


def main(argv: List[str], t0_ns: int) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    root = BENCH.parent
    set_environment(root)
    cell = load_cell(root, args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        print(f"no card for {args.workload}: it needs {cell['chips']} CUDA device(s), "
              f"torch sees {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(root))
    run, _, checks = run_cell(cell, args.seed, args.seconds, bool(args.trace), t0_ns)
    line = result_line(run, checks)
    from harness import devtrace

    try:
        nvml = devtrace.Nvml(devtrace.nvml_index())
        print(f"card: {line['device']['kind']}, power limit {nvml.power_limit_w()} W",
              file=sys.stderr)
        nvml.close()
    except OSError as e:
        print(f"card: {line['device']['kind']}, power limit not readable ({e})", file=sys.stderr)
    if run.profile is not None:
        p = run.profile
        print(f"profiler: kept {p['kept']} of {p['windows']} windows (empty {p['empty']}, "
              f"no device record {p['no_device']}, without the kernel {p['missing_kernel']}); "
              f"cudnn kernels {p['cudnn_kernels']}", file=sys.stderr)
        for i, seen in enumerate(p["seen"]):
            print(f"profiler window {i}: {json.dumps(seen)}", file=sys.stderr)
        for a, b in run.profiler_busy:
            print(f"profiler window held the device calls {(b - a) / 1e9:.3f} s", file=sys.stderr)
    print("set-up: " + ", ".join(f"{k} {v:.3f} s" for k, v in run.setup_phases.items()),
          file=sys.stderr)
    if run.nvml_samples is not None:
        print(f"nvml: {len(run.nvml_samples)} utilisation samples", file=sys.stderr)
    pool = [run.counters.get(k, {}) for k in ("open", "close")]
    if all("kv_blocks_in_use" in c for c in pool):
        print("kv cache: blocks in use {} at the window's opening, {} at its close, of {}".format(
            pool[0]["kv_blocks_in_use"], pool[1]["kv_blocks_in_use"],
            pool[0]["kv_blocks_total"]), file=sys.stderr)
    foreign = foreign_modules()
    if foreign:
        print(f"refusing to report: this process loaded {', '.join(foreign)}", file=sys.stderr)
        return 3
    for name, c in line["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    sys.stdout.write(json.dumps(line) + "\n")
    sys.stdout.flush()
    return 0
