"""gRPC over TLS on the port: the C++ front-end's TLS listener
(``csrc/frontend/tls.cc``, libssl through ``dlopen``, ALPN ``h2``) and the
clients' stdlib ``ssl`` transport, on the CPU.

Held to the reference's ``tests/test_tls_frontend.py`` behaviour: a round
trip works (the port's clients, and the reference's grpcio clients with
``ssl=True``), roots that do not match fail the handshake, and a
plaintext client is rejected by the TLS port. Also: a server asked for
TLS whose PEM cannot be loaded exits non-zero naming the cause and never
serves plaintext; a server that does not select ALPN ``h2`` fails the
client's connection; a silent client does not stall the accept loop;
grpcio's ``creds`` object is refused; the harness's
``--ssl-grpc-root-certifications-file``. The certificates are made here with the ``openssl`` CLI, as the
reference's test makes them.
"""

import asyncio
import json
import os
import socket
import ssl
import struct
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

import client_tpu.grpc as ref_grpc
import client_tpu.grpc.aio as ref_grpc_aio
import client_tpu_torch.grpc as port_grpc
import client_tpu_torch.grpc.aio as port_grpc_aio
from client_tpu_torch.utils import InferenceServerException

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGES = {"port": (port_grpc, port_grpc_aio), "ref": (ref_grpc, ref_grpc_aio)}
SIMPLE_A = np.arange(16, dtype=np.int32)[None]
BIG = np.random.default_rng(5).normal(size=[1 << 20]).astype(np.float32)  # 4 MiB


def _make_pair(directory, name, san=True):
    cert, key = str(directory / f"{name}.pem"), str(directory / f"{name}.key")
    command = ["openssl", "req", "-x509", "-newkey", "rsa:2048", "-keyout", key,
               "-out", cert, "-days", "2", "-nodes", "-subj", "/CN=localhost"]
    if san:
        command += ["-addext", "subjectAltName=DNS:localhost,IP:127.0.0.1"]
    subprocess.run(command, check=True, capture_output=True)
    return cert, key


@pytest.fixture(scope="module")
def certs(tmp_path_factory):
    directory = tmp_path_factory.mktemp("tls")
    return {"good": _make_pair(directory, "good"), "wrong": _make_pair(directory, "wrong")}


@pytest.fixture(scope="module")
def tls_server(certs):
    from client_tpu_torch.testing import InProcessServer

    server = InProcessServer(device="cpu", grpc=True, tls=certs["good"]).start()
    yield server
    server.stop()


def _simple_inputs(mod):
    a = mod.InferInput("INPUT0", [1, 16], "INT32")
    a.set_data_from_numpy(SIMPLE_A)
    b = mod.InferInput("INPUT1", [1, 16], "INT32")
    b.set_data_from_numpy(SIMPLE_A)
    return [a, b]


def _big_inputs(mod):
    x = mod.InferInput("INPUT0", list(BIG.shape), "FP32")
    x.set_data_from_numpy(BIG)
    return [x]


def _round_trip(package, kind, url, roots, **kwargs):
    """``simple`` and a 4 MiB identity over TLS: both exact."""
    sync_mod, aio_mod = PACKAGES[package]
    if kind == "sync":
        client = sync_mod.InferenceServerClient(url, ssl=True, root_certificates=roots,
                                                **kwargs)
        try:
            ready = client.is_server_ready()
            simple = client.infer("simple", _simple_inputs(sync_mod)).as_numpy("OUTPUT0")
            big = client.infer("identity_fp32", _big_inputs(sync_mod)).as_numpy("OUTPUT0")
        finally:
            client.close()
        return ready, simple, big

    async def go():
        client = aio_mod.InferenceServerClient(url, ssl=True, root_certificates=roots,
                                               **kwargs)
        try:
            ready = await client.is_server_ready()
            simple = (await client.infer("simple", _simple_inputs(aio_mod))).as_numpy(
                "OUTPUT0")
            big = (await client.infer("identity_fp32", _big_inputs(aio_mod))).as_numpy(
                "OUTPUT0")
        finally:
            await client.close()
        return ready, simple, big

    return asyncio.run(asyncio.wait_for(go(), 60))


@pytest.mark.parametrize("stream_mode", [False, True])
@pytest.mark.parametrize("kind", ["sync", "aio"])
def test_port_clients_round_trip_over_tls(kind, stream_mode, tls_server, certs):
    ready, simple, big = _round_trip("port", kind, tls_server.grpc_url, certs["good"][0],
                                     stream_mode=stream_mode)
    assert ready and np.array_equal(simple, SIMPLE_A + SIMPLE_A)
    assert np.array_equal(big, BIG)


@pytest.mark.parametrize("kind", ["sync", "aio"])
def test_reference_grpcio_clients_round_trip_over_the_port_tls_front_end(
        kind, tls_server, certs):
    """grpcio's own TLS stack (``ssl_channel_credentials``, ALPN h2)
    against the port's listener."""
    ready, simple, big = _round_trip("ref", kind, tls_server.grpc_url, certs["good"][0])
    assert ready and np.array_equal(simple, SIMPLE_A + SIMPLE_A)
    assert np.array_equal(big, BIG)


def _live(package, url, timeout=5.0, **kwargs):
    sync_mod, _ = PACKAGES[package]
    client = sync_mod.InferenceServerClient(url, **kwargs)
    try:
        return client.is_server_live(client_timeout=timeout)
    finally:
        client.close()


@pytest.mark.parametrize("package", ["port", "ref"])
def test_roots_that_do_not_match_fail(package, tls_server, certs):
    with pytest.raises(Exception) as info:
        _live(package, tls_server.grpc_url, ssl=True, root_certificates=certs["wrong"][0])
    text = str(info.value)
    assert "UNAVAILABLE" in text
    if package == "port":
        assert "CERTIFICATE_VERIFY_FAILED" in text


@pytest.mark.parametrize("package", ["port", "ref"])
def test_a_plaintext_client_is_rejected_by_the_tls_port(package, tls_server):
    with pytest.raises(Exception) as info:
        _live(package, tls_server.grpc_url)
    assert "UNAVAILABLE" in str(info.value)


def test_a_tls_client_fails_against_a_plaintext_port(certs):
    from client_tpu_torch.testing import InProcessServer

    with InProcessServer(device="cpu", grpc=True) as plain:
        with pytest.raises(InferenceServerException) as info:
            _live("port", plain.grpc_url, ssl=True, root_certificates=certs["good"][0])
    assert info.value.status() == "StatusCode.UNAVAILABLE"


@pytest.mark.parametrize("alpn", [None, ["http/1.1"]])
def test_the_client_fails_a_server_that_does_not_select_h2(alpn, certs):
    """A TLS server that selects no ALPN protocol, or another one: the
    connection fails UNAVAILABLE, naming ALPN."""
    cert, key = certs["good"]
    context = ssl.create_default_context(ssl.Purpose.CLIENT_AUTH)
    context.load_cert_chain(cert, key)
    if alpn:
        context.set_alpn_protocols(alpn)

    async def go():
        async def serve(reader, writer):
            await reader.read(1 << 16)
            writer.close()

        server = await asyncio.start_server(serve, "127.0.0.1", 0, ssl=context)
        port = server.sockets[0].getsockname()[1]
        client = port_grpc_aio.InferenceServerClient(f"127.0.0.1:{port}", ssl=True,
                                                     root_certificates=cert)
        try:
            with pytest.raises(InferenceServerException) as info:
                await client.is_server_live(client_timeout=5)
        finally:
            await client.close()
            server.close()
            await server.wait_closed()
        return info.value

    error = asyncio.run(asyncio.wait_for(go(), 30))
    assert error.status() == "StatusCode.UNAVAILABLE"
    assert "ALPN h2" in error.message()


def test_a_silent_client_does_not_stall_the_accept_loop(tls_server, certs):
    """A client that connects and never starts its handshake holds only
    its own handshake thread: another client's round trip goes through."""
    silent = socket.create_connection(("127.0.0.1", tls_server.grpc_port))
    try:
        t0 = time.monotonic()
        assert _live("port", tls_server.grpc_url, ssl=True,
                     root_certificates=certs["good"][0])
        assert time.monotonic() - t0 < 5
    finally:
        silent.close()


def _thread_cpu_s():
    """CPU seconds of each of this process's threads, by thread id."""
    ticks = os.sysconf("SC_CLK_TCK")
    seconds = {}
    for tid in os.listdir("/proc/self/task"):
        try:
            with open(f"/proc/self/task/{tid}/stat") as f:
                fields = f.read().rsplit(")", 1)[1].split()
        except OSError:
            continue  # the thread ended meanwhile
        seconds[tid] = (int(fields[11]) + int(fields[12])) / ticks
    return seconds


def test_a_peer_that_stops_reading_does_not_pin_its_pump(certs):
    """A TLS peer asks for a 4 MiB answer and never reads it, so the
    answer backs up in the connection's pump. The server still stops,
    and then the pump gives up its unsent bytes at its flush deadline:
    its thread ends, and no thread of the server spins meanwhile."""
    from client_tpu_torch.grpc import _h2
    from client_tpu_torch.grpc._utils import get_inference_request
    from client_tpu_torch.testing import InProcessServer

    server = InProcessServer(device="cpu", grpc=True, tls=certs["good"]).start()
    before = set(_thread_cpu_s())
    raw = socket.socket()
    # a fixed small receive buffer (no autotuning): the answer cannot fit
    raw.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 4096)
    raw.connect(("127.0.0.1", server.grpc_port))
    context = ssl.create_default_context(cafile=certs["good"][0])
    context.set_alpn_protocols(["h2"])
    peer = context.wrap_socket(raw, server_hostname="localhost")
    try:
        headers = _h2.hpack_encode([
            (":method", "POST"), (":scheme", "https"), (":authority", "localhost"),
            (":path", "/inference.GRPCInferenceService/ModelInfer"),
            ("content-type", "application/grpc"), ("te", "trailers")])
        body = _h2._frame_message(get_inference_request(
            "identity_fp32", _big_inputs(port_grpc)).SerializeToString(), None)
        settings = struct.pack(">HI", _h2.SETTINGS_INITIAL_WINDOW_SIZE, (1 << 31) - 1)
        frames = [_h2.PREFACE, _h2._frame(_h2.SETTINGS, 0, 0, settings),
                  _h2._frame(_h2.WINDOW_UPDATE, 0, 0, struct.pack(">I", (1 << 31) - 65536)),
                  _h2._frame(_h2.HEADERS, _h2.FLAG_END_HEADERS, 1, headers)]
        for at in range(0, len(body), 16384):
            last = at + 16384 >= len(body)
            frames.append(_h2._frame(_h2.DATA, _h2.FLAG_END_STREAM if last else 0, 1,
                                     body[at:at + 16384]))
        peer.sendall(b"".join(frames))
        during = set(_thread_cpu_s()) - before  # the handshake thread, now the pump
        assert during
        time.sleep(1.5)  # the answer is computed and stuck behind the peer
        stopper = threading.Thread(target=server.stop)
        stopper.start()
        stopper.join(60)
        assert not stopper.is_alive()
        deadline = time.monotonic() + 20
        while time.monotonic() < deadline and during & set(_thread_cpu_s()):
            time.sleep(0.1)
        assert not during & set(_thread_cpu_s()), "the pump thread outlived its deadline"
        first = _thread_cpu_s()
        time.sleep(1.0)
        spent = {tid: s - first.get(tid, 0.0) for tid, s in _thread_cpu_s().items()}
        assert max(spent.values()) < 0.5, spent
    finally:
        peer.close()


def test_grpcio_credentials_are_refused():
    with pytest.raises(InferenceServerException, match="grpcio"):
        port_grpc.InferenceServerClient("127.0.0.1:9", creds=object())


def test_an_unreadable_pem_fails_the_in_process_server(certs, tmp_path):
    from client_tpu_torch.testing import InProcessServer

    server = InProcessServer(device="cpu", grpc=True,
                             tls=(certs["good"][0], str(tmp_path / "missing.key")))
    with pytest.raises(OSError, match="missing.key"):
        server.start()
    server.stop()


def _spawn(*flags):
    return subprocess.Popen(
        [sys.executable, "-m", "client_tpu_torch.server", "--device", "cpu", "--http-port", "0",
         "--grpc-port", "0", "--host", "127.0.0.1", *flags],
        cwd=ROOT, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)


@pytest.mark.parametrize("case", ["missing_cert", "mismatched_key"])
def test_the_server_cli_exits_when_its_tls_pair_cannot_be_loaded(case, certs, tmp_path):
    """The server exits 1 and its log names the file; it never answers,
    in plaintext or otherwise."""
    good, wrong = certs["good"], certs["wrong"]
    cert, key = {"missing_cert": (str(tmp_path / "absent.pem"), good[1]),
                 "mismatched_key": (good[0], wrong[1])}[case]
    proc = _spawn("--grpc-tls-cert", cert, "--grpc-tls-key", key)
    try:
        _, err = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode == 1, err
    records = [json.loads(line) for line in err.splitlines() if line.startswith("{")]
    failed = [r for r in records if r["event"] == "server_failed"]
    assert failed and not [r for r in records if r["event"] == "server_started"]
    named = os.path.basename(cert if case == "missing_cert" else key)
    assert named in failed[0]["error"]


def test_the_server_cli_serves_tls(certs):
    """``--grpc-tls-cert/--grpc-tls-key``: ``server_started`` names the
    port, which answers over TLS and refuses plaintext."""
    cert, key = certs["good"]
    proc = _spawn("--grpc-tls-cert", cert, "--grpc-tls-key", key)
    try:
        started = None
        for line in proc.stderr:
            if '"server_started"' in line:
                started = json.loads(line)
                break
        assert started is not None
        assert set(started) >= {"host", "http_port", "grpc_port", "grpc_frontend"}
        assert started["grpc_frontend"] == "native"
        url = f"127.0.0.1:{started['grpc_port']}"
        assert _live("port", url, ssl=True, root_certificates=cert)
        with pytest.raises(InferenceServerException):
            _live("port", url)
    finally:
        proc.terminate()
        proc.communicate(timeout=30)
    assert proc.returncode == 0


def test_perf_harness_over_tls(tls_server, certs, capsys):
    from client_tpu_torch.perf import cli

    code = cli.main(["-m", "simple", "-u", tls_server.grpc_url, "-i", "grpc",
                     "--ssl-grpc-root-certifications-file", certs["good"][0],
                     "--concurrency-range", "2", "--measurement-interval", "200",
                     "--stability-percentage", "100", "--max-trials", "2", "--json-summary"])
    out = capsys.readouterr().out
    assert code == 0, out
    summary = json.loads(out.strip().splitlines()[-1])
    assert summary["errors"] == 0 and summary["count"] > 0
    assert cli.main(["-m", "simple", "-u", "127.0.0.1:9",
                     "--ssl-grpc-root-certifications-file", certs["good"][0]]) == 2
