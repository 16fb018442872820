"""Metric readers on runs made by hand."""

from types import SimpleNamespace

from harness import main


def _run(**fields):
    base = dict(system="llm_engine", open_ns=0, close_ns=1000, nvml_samples=None, profile=None)
    base.update(fields)
    run = SimpleNamespace(**base)
    run.in_window = lambda t: run.open_ns <= t < run.close_ns
    return run


def test_idle_share_reads_nvml_and_falls_back_to_the_profiler_windows():
    read = main.reader("idle_share.llm").read
    assert read(_run(nvml_samples=[(10, 30), (20, 50), (2000, 0)])) == 60.0
    assert read(_run(profile={"busy_ns": 250, "window_ns": 1000})) == 75.0
    assert read(_run()) is None
    assert read(_run(system="text_encoder", nvml_samples=[(10, 30)])) is None
