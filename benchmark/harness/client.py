"""The load: one client process that drives a mix's closed loop.

Started by the harness as ``python client.py '<spec json>'`` while the
model loads. Once imported it prints ``ready`` and waits for ``go <port>
<open_ns> <close_ns>`` on standard input (the server's port and the
window, in ``time.monotonic_ns``, which every process on the machine
shares); it sends from the moment it reads it, and prints one JSON line of
records when it is done. Each of its ``slots`` runs requests back to
back; request ``k`` of a slot is ``traffic.Plan.request(slot, k)``.

After the window closes the slots keep the load on until every request
sent before the close has its first answer (a stream its first token, a
unary request its answer) or has failed; then they stop, and streams
still running are dropped, which cancels them on the server. A line
``stop`` on standard input ends everything at once.

Routes: ``openai_chat_stream`` (an SSE reader over asyncio streams that
stamps each event as its bytes arrive, after the port's
``OpenAiPerfBackend``) and ``kserve_infer`` (the port's own asyncio
client, ``client_tpu_torch.http.aio``, with binary tensors: the ids in
and the answer out under the model type's ``INFER_TENSORS``, which the
spec's ``tensors`` carries).
"""

import asyncio
import base64
import json
import sys
import threading
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(BENCH))
sys.path.insert(0, str(BENCH.parent))

from harness import traffic  # noqa: E402

FOREIGN = ("jax", "jaxlib", "flax", "client_tpu")
HARD_STOP_S = 60.0


async def _read_head(reader):
    head = await reader.readuntil(b"\r\n\r\n")
    lines = head.decode("latin-1").split("\r\n")
    status = int(lines[0].split()[1])
    headers = {}
    for line in lines[1:]:
        if ":" in line:
            key, value = line.split(":", 1)
            headers[key.strip().lower()] = value.strip()
    return status, headers


async def _body_chunks(reader, headers):
    """The response body's pieces as they arrive (chunked or sized)."""
    if "chunked" in headers.get("transfer-encoding", "").lower():
        while True:
            size = int((await reader.readline()).split(b";")[0].strip(), 16)
            if size == 0:
                await reader.readline()
                return
            data = await reader.readexactly(size)
            await reader.readexactly(2)
            yield data
    else:
        length = int(headers.get("content-length", "0"))
        if length:
            yield await reader.readexactly(length)


class ChatSlot:
    """One slot of streaming chat completions over one keep-alive
    connection."""

    def __init__(self, host, port, model):
        self.host, self.port, self.model = host, port, model
        self.conn = None

    async def _connection(self):
        if self.conn is None or self.conn[0].at_eof() or self.conn[1].is_closing():
            self.conn = await asyncio.open_connection(self.host, self.port)
        return self.conn

    def drop(self):
        if self.conn is not None:
            self.conn[1].close()
            self.conn = None

    async def send(self, request, record):
        body = json.dumps({
            "model": self.model, "stream": True, "max_tokens": request["max_tokens"],
            "messages": [{"role": "user", "content": request["prompt"]}],
        }).encode()
        head = (f"POST /v1/chat/completions HTTP/1.1\r\nHost: {self.host}:{self.port}\r\n"
                f"Content-Type: application/json\r\nContent-Length: {len(body)}\r\n\r\n")
        reader, writer = await self._connection()
        record["t_send"] = time.monotonic_ns()
        writer.write(head.encode() + body)
        await writer.drain()
        status, headers = await _read_head(reader)
        # the record's own lists: a stream dropped after the window keeps
        # the tokens that reached it
        stamps, tokens, done, buf = record["stamps"], record["tokens"], False, b""
        async for data in _body_chunks(reader, headers):
            now = time.monotonic_ns()
            buf += data
            while b"\n\n" in buf:
                event, buf = buf.split(b"\n\n", 1)
                if not event.startswith(b"data:"):
                    continue
                payload = event[5:].strip()
                if payload == b"[DONE]":
                    done = True
                    continue
                if status != 200:
                    continue
                doc = json.loads(payload)
                if "error" in doc:
                    raise RuntimeError(f"in-band error: {doc['error']}")
                content = doc["choices"][0].get("delta", {}).get("content")
                if content:
                    ids = [int(w[3:]) for w in content.split()]
                    stamps.extend([now] * len(ids))
                    tokens.extend(ids)
                    record.setdefault("t_first", now)
        if status != 200:
            raise RuntimeError(f"HTTP {status}: {buf[:200]!r}")
        if headers.get("connection", "").lower() == "close":
            self.drop()
        record["done"] = done
        if not done or len(tokens) != request["max_tokens"]:
            raise RuntimeError(f"stream ended with {len(tokens)} of {request['max_tokens']} "
                               f"tokens, done={done}")


class InferSlot:
    """One slot of KServe ``/infer`` requests through the port's client."""

    def __init__(self, client, model, sample, tensors):
        self.client, self.model, self.sample = client, model, sample
        self.input, self.output = tensors

    def drop(self):
        pass

    async def send(self, request, record):
        from client_tpu_torch.http.aio import InferInput, InferRequestedOutput

        ids = request["ids"][None, :]
        tensor = InferInput(self.input, list(ids.shape), "INT32")
        tensor.set_data_from_numpy(ids, binary_data=True)
        output = InferRequestedOutput(self.output, binary_data=True)
        record["t_send"] = time.monotonic_ns()
        result = await self.client.infer(self.model, [tensor], outputs=[output])
        answer = result.as_numpy(self.output)
        record["t_first"] = time.monotonic_ns()
        record["done"] = True
        record["length"] = int(ids.shape[1])
        if self.sample(request["slot"], request["k"]):
            record["answer"] = base64.b64encode(answer.astype("<f4").tobytes()).decode()


def in_check_sample(seed, slot, k, share):
    """Whether request (slot, k) is among those the check compares: a
    draw from the seed, the same in every process."""
    import numpy as np

    rng = np.random.default_rng(np.random.SeedSequence([int(seed), 0x5A, slot, k]))
    return rng.random() < share


async def _run_slot(slot_index, slot, plan, stop, records):
    k = 0
    while not stop.is_set():
        now = time.monotonic_ns()
        request = plan.request(slot_index, k)
        record = {"slot": slot_index, "k": k, "t_send": now, "stamps": [], "tokens": []}
        records.append(record)
        k += 1
        try:
            await slot.send(request, record)
        except asyncio.CancelledError:
            record["cancelled"] = True
            raise
        except Exception as e:  # noqa: BLE001 - a failed request is a record, not a crash
            record["error"] = f"{type(e).__name__}: {e}"[:300]
            slot.drop()


async def _watch(window, stop, records):
    """Set ``stop`` once the window has closed and every request sent
    before the close has its first answer or has failed."""
    close_ns = window[1]
    while not stop.is_set():
        if time.monotonic_ns() >= close_ns and all(
                "t_first" in r or "error" in r for r in records if r["t_send"] < close_ns):
            stop.set()
            return
        await asyncio.sleep(0.02)


async def _main(spec):
    plan = traffic.Plan(spec["mix"], spec["seed"], spec.get("vocab_size", 0))
    loop = asyncio.get_running_loop()
    stop = asyncio.Event()
    go = loop.create_future()

    def read_stdin():
        # the harness closes standard input while it waits for the
        # records: only ``stop`` stops; an end before ``go`` gives up
        for line in sys.stdin:
            words = line.split()
            if words[:1] == ["go"] and not go.done():
                loop.call_soon_threadsafe(go.set_result, tuple(int(w) for w in words[1:4]))
            elif words[:1] == ["stop"]:
                loop.call_soon_threadsafe(stop.set)
                return
        if not go.done():
            loop.call_soon_threadsafe(go.cancel)

    threading.Thread(target=read_stdin, daemon=True).start()
    route = spec["mix"]["route"]
    if route == "kserve_infer":
        from client_tpu_torch.http.aio import InferenceServerClient
    elif route != "openai_chat_stream":
        raise ValueError(f"unknown route {route!r}")
    print("ready", flush=True)
    port, open_ns, close_ns = await go
    window = (open_ns, close_ns)
    client = None
    if route == "openai_chat_stream":
        slots = [ChatSlot(spec["host"], port, spec["model"]) for _ in spec["slots"]]
    else:
        client = InferenceServerClient(f"{spec['host']}:{port}",
                                       concurrency=len(spec["slots"]), network_timeout=120.0)
        share = spec.get("check_share", 0.0)

        def sample(slot, k):
            return in_check_sample(spec["seed"], slot, k, share)

        slots = [InferSlot(client, spec["model"], sample, spec["tensors"])
                 for _ in spec["slots"]]
    records = []
    tasks = [asyncio.create_task(_run_slot(index, slot, plan, stop, records))
             for index, slot in zip(spec["slots"], slots)]
    tasks.append(asyncio.create_task(_watch(window, stop, records)))
    waiter = asyncio.create_task(stop.wait())
    deadline = (window[1] - time.monotonic_ns()) / 1e9 + HARD_STOP_S
    await asyncio.wait([waiter, asyncio.gather(*tasks, return_exceptions=True)],
                       timeout=max(deadline, 1.0), return_when=asyncio.FIRST_COMPLETED)
    for task in tasks:
        task.cancel()
    waiter.cancel()
    await asyncio.gather(*tasks, waiter, return_exceptions=True)
    for slot in slots:
        slot.drop()
    if client is not None:
        await client.close()
    foreign = sorted({name.split(".")[0] for name in sys.modules} & set(FOREIGN))
    sys.stdout.write(json.dumps({"records": records, "foreign_modules": foreign}) + "\n")
    sys.stdout.flush()


if __name__ == "__main__":
    asyncio.run(_main(json.loads(sys.argv[1])))
