"""The reduction of profiler windows, on windows made by hand."""

from torch.autograd import DeviceType

from harness import devtrace
from harness.systems import Spans

OFFSET = 1_000_000_000_000


class Event:
    def __init__(self, name, start, duration, device, corr=0, tid=1):
        self._v = (name, start + OFFSET, duration, device, corr, tid)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def duration_ns(self):
        return self._v[2]

    def device_type(self):
        return self._v[3]

    def correlation_id(self):
        return self._v[4]

    def is_user_annotation(self):
        return self.name().startswith("bench.")

    def start_thread_id(self):
        return self._v[5]


class Result:
    def __init__(self, events):
        self._events = events

    def events(self):
        return self._events


def window(events, start=0, end=1000):
    return {"start": start, "end": end, "offset": OFFSET, "result": Result(events)}


CPU, CUDA = DeviceType.CPU, DeviceType.CUDA


def test_empty_and_kernelless_windows_are_thrown_away():
    launches_only = window([Event("cudaLaunchKernel", 10, 5, CPU, 1)])
    copies_only = window([Event("cudaLaunchKernel", 10, 5, CPU, 1),
                          Event("Memcpy DtoH (Device -> Pageable)", 20, 5, CUDA, 2)])
    nothing = window([Event("aten::mm", 10, 5, CPU)])
    without_k1 = window([Event("cudaLaunchKernel", 10, 5, CPU, 1),
                         Event("gemm", 20, 10, CUDA, 1)])
    out = devtrace.reduce_windows([launches_only, copies_only, nothing, without_k1],
                                  ["rpa_decode_kernel"], None)
    assert (out["kept"], out["empty"], out["no_device"], out["missing_kernel"]) == (0, 2, 1, 1)


def test_a_kept_window_reduces_to_busy_time_kernels_and_gaps():
    spans = Spans()
    spans.decode.append((100, 600, [5, 5], 1))
    events = [
        Event("cudaLaunchKernel", 110, 5, CPU, 7, tid=3),
        Event("cudaLaunchKernel", 300, 5, CPU, 8, tid=3),
        Event("aten::index_put_", 350, 100, CPU, tid=3),
        Event("void rpa_decode_kernel<bf16>", 200, 100, CUDA, 7),
        Event("gemm", 250, 100, CUDA, 8),
        Event("gemm", 500, 100, CUDA, 9),
        Event("bench.decode", 100, 800, CUDA),  # a range, not device work
        Event("bench.decode", 100, 500, CPU, tid=3),  # the same range on the host
    ]
    out = devtrace.reduce_windows([window(events)], ["rpa_decode_kernel"], spans)
    assert out["kept"] == 1 and out["window_ns"] == 1000
    assert out["busy_ns"] == 150 + 100  # [200, 350) and [500, 600)
    k1 = out["kernels"]["rpa_decode_kernel"]
    assert k1 == {"ns": 100, "launches_at": [110]}
    assert out["ops"] == {"void rpa_decode_kernel<bf16>": 100, "gemm": 200}
    # idle: [0, 200) before the call, [350, 500) inside it while the host
    # runs index_put_, [600, 1000) after it
    assert out["gaps"] == {"decode call: Python, no op recorded": 200,
                           "decode call: aten::index_put_": 150,
                           "between device calls: Python, no op recorded": 400}
