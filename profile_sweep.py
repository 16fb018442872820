"""Crash count of the profile route's device trace on a card.

``GET /v2/debug/profile?...&jax_trace_dir=`` opens a ``torch.profiler``
capture of CPU and CUDA activity for its window
(``observability/profiling.py``'s ``maybe_torch_trace``). Under load such a
capture can kill the process inside CUPTI. This script counts how often: it
takes 2 s captures in turn and restarts the process each time one dies,
until ``--captures`` captures are counted. Nothing of the port is patched.

``server`` serves phase 10d's set-up as ``chip_smoke.py`` does: ResNet-50
with seed-0 weights behind the port's HTTP front-end, under the port's
harness at ``-b 1``, concurrency 8, TPU shared memory and
``--profile-server``; each capture is a request to the route.

``bare`` has no server: one thread runs forwards while the main thread
takes the captures through ``maybe_torch_trace``.

    z2    ResNet-50 at batches 1, 2, 4, 8, the inputs resident on the card
    z3    z2 with cuDNN off
    z5    a Llama-7B decode step's bf16 MLP products (batch 8, width 4096,
          cuBLAS) with SiLU and adds, no cuDNN

Kineto's settings in the environment (``TEARDOWN_CUPTI=0``, say) reach
every process. Each process runs with a small LD_PRELOAD library (built here
with ``gcc``) that prints the native backtrace of a fatal signal after
faulthandler's Python stacks. The card, torch and CUPTI print first; a
record a capture goes to ``<out>/sweep.jsonl``, the stderr of each process
that died to ``<out>/<variant>_<n>.err``.

    python3 profile_sweep.py server --captures 32
    python3 profile_sweep.py bare --variants z2,z3,z5 --captures 32
"""

import argparse
import contextlib
import ctypes
import glob
import http.client
import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
DURATION_S = 2
BARE_VARIANTS = ("z2", "z3", "z5")

BACKTRACE_C = r"""
#define _GNU_SOURCE
#include <execinfo.h>
#include <pthread.h>
#include <signal.h>
#include <stdio.h>
#include <string.h>
#include <sys/syscall.h>
#include <unistd.h>

static void handler(int sig, siginfo_t *si, void *ctx) {
  (void)ctx;
  void *frames[128];
  char msg[200];
  int len = snprintf(msg, sizeof msg,
                     "\n=== native backtrace: signal %d code %d addr %p tid %ld "
                     "pthread 0x%lx ===\n",
                     sig, si ? si->si_code : 0, si ? si->si_addr : 0,
                     (long)syscall(SYS_gettid), (unsigned long)pthread_self());
  if (write(2, msg, len) < 0) {}
  int n = backtrace(frames, 128);
  backtrace_symbols_fd(frames, n, 2);
  if (write(2, "=== end ===\n", 12) < 0) {}
  signal(sig, SIG_DFL);
  raise(sig);
}

__attribute__((constructor)) static void install(void) {
  void *warm[4];
  backtrace(warm, 4);  /* load libgcc_s now, not inside the handler */
  struct sigaction sa;
  memset(&sa, 0, sizeof sa);
  sa.sa_sigaction = handler;
  sa.sa_flags = SA_SIGINFO | SA_NODEFER;
  int sigs[] = {SIGSEGV, SIGABRT, SIGBUS, SIGFPE, SIGILL};
  for (unsigned i = 0; i < sizeof sigs / sizeof *sigs; ++i) sigaction(sigs[i], &sa, 0);
}
"""


def build_backtrace(out):
    """The LD_PRELOAD library that prints a fatal signal's native stack."""
    source, lib = os.path.join(out, "backtrace.c"), os.path.join(out, "libbacktrace_on_signal.so")
    with open(source, "w") as f:
        f.write(BACKTRACE_C)
    subprocess.run(["gcc", "-shared", "-fPIC", "-O1", "-o", lib, source], check=True)
    return lib


def versions():
    import torch

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    print(sys.version.split()[0], torch.__version__, torch.version.cuda, flush=True)
    site = os.path.dirname(os.path.dirname(torch.__file__))
    for path in glob.glob(os.path.join(site, "nvidia", "cuda_cupti", "lib", "libcupti.so.*")):
        version = ctypes.c_uint32()
        ctypes.CDLL(path).cuptiGetVersion(ctypes.byref(version))
        print("CUPTI", os.path.realpath(path), "API version", version.value, flush=True)


def resnet50_on_card():
    import torch

    import chip_smoke
    from client_tpu_torch.models import resnet

    config = resnet.resnet50()
    params = chip_smoke.perturbed_classifier(
        config, torch.Generator(device="cuda").manual_seed(0), (0.1, 0.3))
    return config, params


def count_trace(path, rec):
    """The kernel and runtime events of one Chrome trace into ``rec``."""
    rec["trace_mb"] = round(os.path.getsize(path) / 2**20, 1)
    with open(path, "rb") as f:
        raw = f.read()
    rec["kernels"] = raw.count(b'"cat": "kernel"')
    rec["runtime"] = raw.count(b'"cat": "cuda_runtime"')


def crash_record(rec, returncode, err_path):
    with open(err_path) as f:
        tail = f.read().splitlines()[-80:]
    rec.update(crash=True, exit=returncode, stderr_tail=tail)
    return rec


# -- server mode -------------------------------------------------------------------

def serve():
    """The server process: prints ``PORT <n>`` once up and serves until its
    stdin closes."""
    import faulthandler
    faulthandler.enable()
    import torch

    import chip_smoke
    from client_tpu_torch.models.serving import ImageClassifierModel

    config, params = resnet50_on_card()
    model = ImageClassifierModel(image_size=224, config=config, params=params,
                                 device=torch.device("cuda"))
    model.warmup()
    with chip_smoke.http_server(model) as port:
        print(f"PORT {port}", flush=True)
        sys.stdin.read()
        os._exit(0)


def request(port, path, timeout=120):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request("GET", path)
        response = conn.getresponse()
        body = response.read()
    finally:
        conn.close()
    return response.status, dict(response.getheaders()), body


def success_count(port):
    _, _, body = request(port, "/v2/models/image_classifier/stats", 30)
    return json.loads(body)["model_stats"][0]["inference_stats"]["success"]["count"]


def harness(port):
    """Phase 10d's load, for as long as it is left running."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    env.pop("LD_PRELOAD", None)
    return subprocess.Popen(
        [sys.executable, "-m", "client_tpu_torch.perf", "-m", "image_classifier",
         "-u", f"127.0.0.1:{port}", "-b", "1", "--concurrency-range", "8",
         "--shared-memory", "tpu", "--profile-server", "--measurement-interval", "2000",
         "--max-trials", "1000", "--stability-percentage", "0", "--json-summary"],
        cwd=ROOT, env=env, stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)


def kill(proc):
    if proc is not None and proc.poll() is None:
        proc.kill()
        proc.wait()


def run_server(n, log, out, env):
    done, crashes, segments = 0, 0, 0
    while done < n:
        segments += 1
        err_path = os.path.join(out, f"server_{segments}.err")
        err = open(err_path, "w")
        child = subprocess.Popen([sys.executable, os.path.abspath(__file__), "serve"],
                                 cwd=ROOT, env=env, stdin=subprocess.PIPE,
                                 stdout=subprocess.PIPE, stderr=err, text=True)
        load, crashed = None, False
        try:
            line = child.stdout.readline()
            if not line.startswith("PORT "):
                child.wait(30)
                raise RuntimeError(f"the server did not start (exit {child.poll()})")
            port = int(line.split()[1])
            load = harness(port)
            base = success_count(port)
            while success_count(port) < base + 64:
                if load.poll() is not None:
                    raise RuntimeError("the load did not start")
                time.sleep(0.05)
            while done < n:
                tmp = tempfile.mkdtemp(prefix="sweep_server_")
                rec = {"variant": "server", "i": done, "segment": segments}
                c0, t0 = success_count(port), time.monotonic()
                try:
                    status, headers, body = request(
                        port, f"/v2/debug/profile?duration_s={DURATION_S}&hz=99"
                              f"&jax_trace_dir={tmp}/t")
                except (OSError, http.client.HTTPException) as e:
                    status, headers, body = None, {}, repr(e).encode()
                rec["request_s"] = round(time.monotonic() - t0, 3)
                done += 1
                with contextlib.suppress(subprocess.TimeoutExpired):
                    child.wait(1 if status is None else 0.05)
                if child.poll() is not None:
                    crashed, crashes = True, crashes + 1
                    err.flush()
                    log.write(json.dumps(crash_record(rec, child.returncode, err_path)) + "\n")
                    print(f"server capture {done}: CRASH exit {child.returncode}", flush=True)
                    shutil.rmtree(tmp, ignore_errors=True)
                    break
                rec.update(status=status, load_alive=load.poll() is None,
                           requests=success_count(port) - c0)
                if status == 200:
                    count_trace(headers["X-Device-Trace"], rec)
                else:
                    rec["answer"] = body[:300].decode(errors="replace")
                shutil.rmtree(tmp, ignore_errors=True)
                log.write(json.dumps(rec) + "\n")
                print("server " + json.dumps(rec), flush=True)
        finally:
            log.flush()
            kill(load)
            if child.poll() is None:
                child.stdin.close()
                try:
                    child.wait(10)
                except subprocess.TimeoutExpired:
                    kill(child)
            err.close()
            if not crashed:
                os.remove(err_path)
    return {"variant": "server", "captures": done, "crashes": crashes, "segments": segments}


# -- bare mode ---------------------------------------------------------------------

def bare(variant, n):
    """One process of a bare variant: prints one JSON line a capture."""
    import faulthandler
    faulthandler.enable()
    import numpy as np
    import torch

    from client_tpu_torch.models import resnet
    from client_tpu_torch.observability.profiling import maybe_torch_trace

    host = np.random.default_rng(0).normal(size=[8, 224, 224, 3]).astype(np.float32)
    resident = torch.from_numpy(host).cuda()
    if variant == "z5":
        up = torch.randn(4096, 11008, device="cuda", dtype=torch.bfloat16) / 64
        down = torch.randn(11008, 4096, device="cuda", dtype=torch.bfloat16) / 105
    else:
        config, params = resnet50_on_card()
        torch.backends.cudnn.enabled = variant != "z3"
    stop, count = threading.Event(), [0]

    def work():
        with torch.inference_mode():
            while not stop.is_set():
                if variant == "z5":
                    y = resident.reshape(8, -1)[:, :4096].to(torch.bfloat16)
                    for _ in range(32):
                        y = y + torch.nn.functional.silu(y @ up) @ down
                else:
                    resnet.forward(params, resident[:(1, 2, 4, 8)[count[0] % 4]], config)
                torch.cuda.synchronize()
                count[0] += 1

    thread = threading.Thread(target=work, name="model")
    thread.start()
    time.sleep(3)
    for i in range(n):
        tmp = tempfile.mkdtemp()
        c0, t0 = count[0], time.monotonic()
        rec = {"i": i}
        try:
            with maybe_torch_trace(tmp) as trace:
                time.sleep(DURATION_S)
        except RuntimeError as e:  # the port's check: launches and no kernel
            rec["refused"] = str(e)
        else:
            count_trace(trace["path"], rec)
        rec.update(forwards=count[0] - c0, s=round(time.monotonic() - t0, 2))
        print(json.dumps(rec), flush=True)
        shutil.rmtree(tmp)
    stop.set()
    thread.join()
    os._exit(0)


def run_bare(name, n, log, out, env):
    if name not in BARE_VARIANTS:
        raise ValueError(f"unknown variant {name!r}: one of {', '.join(BARE_VARIANTS)}")
    done, crashes, segments = 0, 0, 0
    while done < n:
        segments += 1
        err_path = os.path.join(out, f"{name}_{segments}.err")
        with open(err_path, "w") as err:
            proc = subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "bare-child", name,
                 "--captures", str(n - done)],
                cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=err, text=True)
            for line in proc.stdout:
                rec = dict(json.loads(line), variant=name, segment=segments)
                log.write(json.dumps(rec) + "\n")
                done += 1
                print(name, json.dumps(rec), flush=True)
            proc.wait()
        if proc.returncode != 0:
            crashes, done = crashes + 1, done + 1
            log.write(json.dumps(crash_record({"variant": name, "segment": segments},
                                              proc.returncode, err_path)) + "\n")
            print(f"{name} capture {done}: CRASH exit {proc.returncode}", flush=True)
        else:
            os.remove(err_path)
        log.flush()
    return {"variant": name, "captures": done, "crashes": crashes, "segments": segments}


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("mode", choices=("server", "bare", "serve", "bare-child"))
    parser.add_argument("name", nargs="?", help="the variant of a bare-child process")
    parser.add_argument("--variants", default=",".join(BARE_VARIANTS),
                        help="bare mode: comma-separated, of " + ", ".join(BARE_VARIANTS))
    parser.add_argument("--captures", type=int, default=32)
    parser.add_argument("--out", default=os.path.join(ROOT, "build", "profile_sweep"))
    args = parser.parse_args()
    sys.path.insert(0, ROOT)
    if args.mode == "serve":
        return serve()
    if args.mode == "bare-child":
        return bare(args.name, args.captures)
    os.makedirs(args.out, exist_ok=True)
    versions()
    env = dict(os.environ, LD_PRELOAD=build_backtrace(args.out))
    summaries = []
    with open(os.path.join(args.out, "sweep.jsonl"), "a") as log:
        if args.mode == "server":
            summaries.append(run_server(args.captures, log, args.out, env))
        else:
            for name in args.variants.split(","):
                summaries.append(run_bare(name, args.captures, log, args.out, env))
                print("SUMMARY " + json.dumps(summaries[-1]), flush=True)
        for summary in summaries:
            log.write(json.dumps({"summary": summary}) + "\n")
    for summary in summaries:
        print("SUMMARY " + json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
