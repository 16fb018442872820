"""infer_per_s: /infer requests answered inside the window (answer
received, no error) over the window's seconds."""


def read(run):
    if run.route != "kserve_infer":
        return None
    answered = sum(1 for r in run.records
                   if r.get("done") and "error" not in r and run.in_window(r["t_first"]))
    return answered / run.window_s
