"""idle_share.llm: 100 less the mean of NVML's utilisation (the share of
each sample period in which any kernel ran) over the samples taken in
the window, in percent. Where NVML could not be read: 100 less the
share of the kept profiler windows in which the card was busy."""


def read(run):
    if run.system != "llm_engine":
        return None
    samples = [u for t, u in run.nvml_samples or () if run.in_window(t)]
    if samples:
        return 100.0 - sum(samples) / len(samples)
    p = run.profile
    if p and p["window_ns"]:
        return 100.0 * (1.0 - p["busy_ns"] / p["window_ns"])
    return None
