"""wire_ms.bert: what a request spent outside the server core: the
client's mean latency over the requests answered in the window, less the
statistics route's mean request time (success ns over count) over the
window. That is the client's encode and decode, the wire, and the HTTP
front-end's parse and reply."""


def read(run):
    if run.system != "text_encoder" or "close" not in run.counters:
        return None
    latencies = [(r["t_first"] - r["t_send"]) / 1e6 for r in run.records
                 if r.get("done") and "error" not in r and run.in_window(r["t_first"])]
    a = run.counters["open"]["inference_stats"]["success"]
    b = run.counters["close"]["inference_stats"]["success"]
    count = b["count"] - a["count"]
    if not latencies or not count:
        return None
    return sum(latencies) / len(latencies) - (b["ns"] - a["ns"]) / count / 1e6
