"""What the device did: NVML's utilisation and ``torch.profiler`` windows.

:class:`Nvml` reads ``libnvidia-ml`` through ``ctypes`` (no CUPTI): the
card's name, its power limit, and its utilisation, the share of each
sample period in which a kernel ran. :class:`Sampler` polls it through
the measured window.

:class:`CallWindows` opens ``torch.profiler`` (CPU and CUDA activity)
for a few short windows, each opened and closed by the thread that runs
the model's device calls, between two calls; nothing is read out of them
until the run's window has closed. Opened from another thread while the
model launches, a window on this card sometimes holds the host's kernel
launches and no kernel record, and every later window of the process
too. :func:`reduce_windows` counts and drops such windows, and any
window that lacks a kernel the cell must show, and reduces the rest to
busy time, a kernel's time and launches, the top device operations and
the idle gaps by what the host was doing then.
"""

import bisect
import ctypes
import os
import re
import threading
import time
from typing import Any, Dict, List, Optional, Sequence

_LAUNCH = re.compile(r"cu(da)?Launch\w*Kernel")
# device records that are copies and fills, not kernels
_NOT_KERNELS = ("Memcpy", "Memset")


class _Utilization(ctypes.Structure):
    _fields_ = [("gpu", ctypes.c_uint), ("memory", ctypes.c_uint)]


class Nvml:
    """One card through NVML. Raises ``OSError`` where the library or
    the card cannot be read."""

    def __init__(self, index: int = 0):
        self.lib = ctypes.CDLL("libnvidia-ml.so.1")
        self.lib.nvmlInit_v2.restype = ctypes.c_int
        self.lib.nvmlShutdown.restype = ctypes.c_int
        self.lib.nvmlDeviceGetHandleByIndex_v2.argtypes = [ctypes.c_uint,
                                                           ctypes.POINTER(ctypes.c_void_p)]
        self.lib.nvmlDeviceGetHandleByIndex_v2.restype = ctypes.c_int
        self.lib.nvmlDeviceGetUtilizationRates.argtypes = [ctypes.c_void_p,
                                                           ctypes.POINTER(_Utilization)]
        self.lib.nvmlDeviceGetUtilizationRates.restype = ctypes.c_int
        self.lib.nvmlDeviceGetPowerManagementLimit.argtypes = [ctypes.c_void_p,
                                                               ctypes.POINTER(ctypes.c_uint)]
        self.lib.nvmlDeviceGetPowerManagementLimit.restype = ctypes.c_int
        self._check(self.lib.nvmlInit_v2(), "nvmlInit_v2")
        self.handle = ctypes.c_void_p()
        self._check(self.lib.nvmlDeviceGetHandleByIndex_v2(index, ctypes.byref(self.handle)),
                    "nvmlDeviceGetHandleByIndex_v2")

    @staticmethod
    def _check(code: int, what: str) -> None:
        if code != 0:
            raise OSError(f"{what} returned NVML error {code}")

    def utilization(self) -> int:
        value = _Utilization()
        self._check(self.lib.nvmlDeviceGetUtilizationRates(self.handle, ctypes.byref(value)),
                    "nvmlDeviceGetUtilizationRates")
        return int(value.gpu)

    def power_limit_w(self) -> float:
        value = ctypes.c_uint()
        self._check(self.lib.nvmlDeviceGetPowerManagementLimit(self.handle, ctypes.byref(value)),
                    "nvmlDeviceGetPowerManagementLimit")
        return value.value / 1000.0

    def close(self) -> None:
        self.lib.nvmlShutdown()


def nvml_index() -> int:
    """NVML's index of the process's first card: the first entry of
    ``CUDA_VISIBLE_DEVICES`` where it is a number, else 0."""
    visible = os.environ.get("CUDA_VISIBLE_DEVICES", "").split(",")[0].strip()
    return int(visible) if visible.isdigit() else 0


class Sampler:
    """Polls NVML's utilisation every ``period_s`` between start() and
    stop(); ``samples`` holds (monotonic ns, percent)."""

    def __init__(self, nvml: Nvml, period_s: float = 0.1):
        self.nvml, self.period_s = nvml, period_s
        self.samples: List[tuple] = []
        self.error: Optional[str] = None
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, name="bench-nvml", daemon=True)

    def _run(self):
        while not self._stop.wait(self.period_s):
            try:
                self.samples.append((time.monotonic_ns(), self.nvml.utilization()))
            except OSError as e:
                self.error = str(e)
                return

    def start(self):
        self._thread.start()

    def stop(self):
        self._stop.set()
        self._thread.join(5)


class CallWindows:
    """Profiler windows opened and closed by the thread that runs the
    model's device calls, between two calls, so that no kernel launch of
    the program runs while the profiler starts or stops. The harness's
    thread asks for a window (:meth:`request`); the first device call
    after that opens it, and the first call to end ``length_s`` later
    closes it. ``windows`` collects each raw: its monotonic bounds, the
    offset of the profiler's clock, its result, and ``busy_from`` /
    ``busy_to``, the span in which it held the device calls up."""

    def __init__(self, length_s: float, cuda: bool):
        self.length_ns = int(length_s * 1e9)
        self.cuda = cuda
        self.windows: List[Dict[str, Any]] = []
        self._wanted = threading.Event()
        self._open = None
        self._lock = threading.Lock()

    def request(self) -> None:
        self._wanted.set()

    @property
    def busy(self) -> bool:
        return self._wanted.is_set() or self._open is not None

    def before_call(self) -> None:
        if not self._wanted.is_set():
            return
        from torch.profiler import ProfilerActivity, profile

        with self._lock:
            if self._open is not None or not self._wanted.is_set():
                return
            activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if self.cuda else [])
            busy_from = time.monotonic_ns()
            prof = profile(activities=activities)
            prof.start()
            start = time.monotonic_ns()
            self._open = {"prof": prof, "start": start, "busy_from": busy_from,
                          "offset": time.time_ns() - time.monotonic_ns()}
            self._wanted.clear()

    def after_call(self, force: bool = False) -> None:
        """Close the open window once it is ``length_s`` old (at once with
        ``force``: the harness's last word, where no call came)."""
        window = self._open
        if window is None or (not force and time.monotonic_ns() - window["start"] < self.length_ns):
            return
        with self._lock:
            if self._open is not window:
                return
            end = time.monotonic_ns()
            window["prof"].stop()
            self.windows.append({"start": window["start"], "end": end,
                                 "offset": window["offset"], "busy_from": window["busy_from"],
                                 "busy_to": time.monotonic_ns(),
                                 "result": window["prof"].profiler.kineto_results})
            self._open = None


def _union(intervals: List[tuple]) -> List[tuple]:
    merged: List[list] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [tuple(m) for m in merged]


class _Cover:
    """Which of some nested (start, end, name) ranges covers a time: the
    one that started last among those still open then, found from the
    sorted starts (a bounded look back; "None" past it)."""

    def __init__(self, ranges: List[tuple]):
        self.ranges = sorted(ranges)
        self.starts = [r[0] for r in self.ranges]

    def at(self, t: int, look_back: int = 256) -> Optional[str]:
        i = bisect.bisect_right(self.starts, t) - 1
        for j in range(i, max(-1, i - look_back), -1):
            if self.ranges[j][1] >= t:
                return self.ranges[j][2]
        return None


def reduce_windows(windows: Sequence[Dict[str, Any]], kernels: Sequence[str],
                   spans: Optional[Any]) -> Dict[str, Any]:
    """Reduce the raw windows. A window is thrown away when it holds the
    host's kernel launches and no kernel record ("empty"; copies may be
    there), when it holds no kernel record at all, or when it lacks one
    of ``kernels`` (substrings of kernel names; the cell's metrics read
    them). For the kept ones: busy ns (the union of device records inside
    the window), the window's ns, each of ``kernels``' device ns and the
    host time of each of its launches, device time by operation name, and
    idle ns by what the host was doing (the harness's span around the
    device call then, and the innermost host operation of a thread that
    launched kernels)."""
    from torch.autograd import DeviceType

    out: Dict[str, Any] = {"windows": len(windows), "kept": 0, "empty": 0, "no_device": 0,
                           "missing_kernel": 0, "busy_ns": 0, "window_ns": 0,
                           "kernels": {k: {"ns": 0, "launches_at": []} for k in kernels},
                           "ops": {},
                           "gaps": {}, "cudnn_kernels": 0, "seen": []}
    span_ranges = []
    if spans is not None:
        span_ranges = ([(a, b, "prefill call") for a, b, *_ in spans.prefill]
                       + [(a, b, "decode call") for a, b, *_ in spans.decode]
                       + [(a, b, "execute call") for a, b in spans.execute])
    calls = _Cover(span_ranges)
    for window in windows:
        start, end, offset = window["start"], window["end"], window["offset"]
        device, launches, host = [], {}, {}
        launch_threads: Dict[int, int] = {}
        for event in window["result"].events():
            if event.is_user_annotation():
                continue  # the harness's own ranges, on either side
            name = event.name()
            a = event.start_ns() - offset
            b = a + event.duration_ns()
            if event.device_type() == DeviceType.CUDA:
                device.append((a, b, name, event.correlation_id()))
            elif _LAUNCH.match(name):
                launches[event.correlation_id()] = a
                tid = event.start_thread_id()
                launch_threads[tid] = launch_threads.get(tid, 0) + 1
            else:
                host.setdefault(event.start_thread_id(), []).append((a, b, name))
        kernel_records = [d for d in device if not d[2].startswith(_NOT_KERNELS)]
        names: Dict[str, int] = {}
        for d in device:
            names[d[2][:60]] = names.get(d[2][:60], 0) + 1
        out["seen"].append({"device_records": len(device), "kernels": len(kernel_records),
                            "launches": len(launches),
                            "top": sorted(names.items(), key=lambda kv: -kv[1])[:3]})
        if not kernel_records:
            out["empty" if launches else "no_device"] += 1
            continue
        if not all(any(k in d[2] for d in kernel_records) for k in kernels):
            out["missing_kernel"] += 1
            continue
        out["kept"] += 1
        out["window_ns"] += end - start
        inside = [(max(a, start), min(b, end), name, corr)
                  for a, b, name, corr in device if b > start and a < end]
        busy = _union([(a, b) for a, b, _, _ in inside])
        out["busy_ns"] += sum(b - a for a, b in busy)
        for a, b, name, corr in inside:
            out["ops"][name] = out["ops"].get(name, 0) + (b - a)
            if "cudnn" in name.lower():
                out["cudnn_kernels"] += 1
        for a, b, name, corr in device:
            for k in kernels:
                if k in name and start <= a < end:
                    out["kernels"][k]["ns"] += b - a
                    out["kernels"][k]["launches_at"].append(launches.get(corr, a))
        # the threads that launched kernels: one of them runs the device call
        host_ops = [_Cover(host.get(tid, [])) for tid in launch_threads]
        edges = [start] + [t for ab in busy for t in ab] + [end]
        for a, b in zip(edges[0::2], edges[1::2]):
            if b <= a:
                continue
            mid = (a + b) // 2
            outer = calls.at(mid) or "between device calls"
            inner = next((op for op in (c.at(mid) for c in host_ops) if op),
                         "Python, no op recorded")
            label = f"{outer}: {inner}"
            out["gaps"][label] = out["gaps"].get(label, 0) + (b - a)
    return out
