"""Launch N server replicas as one service — the fleet you can run.

Everything upstream of this module already exists: the clients'
:class:`~client_tpu_torch.lifecycle.EndpointPool` routes/hedges across
replicas, the perf harness scrapes and merges N ``/metrics`` endpoints
(``--metrics-url a,b,c``), and ``InProcessServer`` drains before it
stops. This module closes the loop with a runner that actually *owns* N
replicas:

* :class:`FleetRunner` — N :class:`~client_tpu_torch.testing.InProcessServer`
  replicas in one process (threaded event loops, like the lifecycle
  tests), each with its own ServerCore/repository. Used by the perf
  harness's ``--fleet N`` flag and the chaos tests.
  :meth:`restart_replica` cycles one replica through the REAL
  ``drain()`` path — readiness flips false, in-flight work finishes,
  front-ends close — then restarts it at the SAME ports so pools keep
  probing the same address.
* :class:`FleetRestartDriver` — the fleet flavor of the harness's
  ``--rolling-restart``: while a measurement runs, cycle replicas
  through drain -> restart round-robin (one at a time, never two).
* ``python -m client_tpu_torch.perf.fleet_runner --serve`` — one replica
  as a subprocess (its own GIL and CPU budget, so aggregate throughput
  can scale past one interpreter), serving HTTP and, as the reference's
  does, gRPC on the native front-end (``--grpc-port``, 0 for any free
  port). Prints a JSON line with the bound ports, serves until SIGTERM,
  drains on the way out; ``python -m client_tpu_torch.router
  --replica-ports-file`` reads the same file.
* :class:`DeviceBoundModel` — a host-free stand-in for an
  accelerator-bound model: each batched execution *waits* (the device
  would be computing; the host is idle), so one replica's capacity is
  ``max_batch_size / step_time`` regardless of host CPU — the workload
  shape where replicas add capacity and routing policy quality shows.

The replicas serve HTTP and, with ``grpc=True``, the native gRPC
front-end; the port has no grpc.aio server, so there is no ``"aio"``.
Their built-in models and cores run on ``device`` (``cuda`` unless the
caller passes ``"cpu"``; with no card the default raises).
"""

import argparse
import json
import os
import signal
import threading
import time
from typing import Callable, List, Optional, Sequence

import numpy as np

from client_tpu_torch.server.model_repository import Model


class DeviceBoundModel(Model):
    """Simulated accelerator-bound model: OUTPUT0 = INPUT0, after one
    device-step delay per batched execution.

    ``time.sleep`` in the execution thread releases the GIL — exactly
    the profile of a host waiting on a device step — so a replica's
    throughput is capacity-bound (``max_batch_size / step_s`` per
    replica), not host-CPU-bound. The batcher serializes executions per
    model, which is the single-device-queue semantics real serving has.
    """

    platform = "custom"
    backend = "custom"
    device = "cpu"
    inputs = [{"name": "INPUT0", "datatype": "INT32", "shape": [4]}]
    outputs = [{"name": "OUTPUT0", "datatype": "INT32", "shape": [4]}]

    def __init__(
        self,
        name: str = "device_sim",
        step_s: float = 0.02,
        max_batch_size: int = 4,
        sleep: Callable[[float], None] = time.sleep,
        slo: Optional[dict] = None,
    ):
        self.name = name
        self.step_s = step_s
        self.max_batch_size = max_batch_size
        self._sleep = sleep
        # one device queue per model instance: unbatched requests bypass
        # the serial batcher and run on the server's thread pool, so
        # without this lock a replica would be 32-way concurrent and
        # never saturate (the SLO burn signal feeds on real queueing)
        self._device_lock = threading.Lock()
        if slo is not None:
            # e.g. {"latency_target_ms": 60, "window_s": 3}: the server's
            # LiveTelemetry picks this up on first traffic, which is what
            # the SLO autoscaler's burn-rate signal feeds on
            self.slo = dict(slo)

    def warmup(self) -> None:
        pass

    def execute(self, inputs, parameters):
        a = inputs.get("INPUT0")
        if a is None:
            raise ValueError(f"model '{self.name}' expects INPUT0")
        with self._device_lock:
            self._sleep(self.step_s)
        return {"OUTPUT0": np.asarray(a)}


class FleetRunner:
    """N in-process server replicas behind one url list.

    Parameters
    ----------
    size:
        Replica count.
    grpc / host / builtin_models / chaos / drain_timeout_s / device:
        Passed to each replica's
        :class:`~client_tpu_torch.testing.InProcessServer` (``grpc``:
        False, or True / ``"native"`` for the native front-end).
    model_repository:
        Optional directory every replica loads as the server's
        ``--model-repository`` does (each ``<name>/model.py`` defines
        ``create_model(device)``).
    model_factories:
        Optional callables, each returning a fresh
        :class:`~client_tpu_torch.server.model_repository.Model` to register
        on a replica's repository (called per replica AND per restart —
        repositories are per-replica, so instances must not be shared).
    """

    def __init__(
        self,
        size: int,
        grpc=False,
        host: str = "127.0.0.1",
        builtin_models: bool = True,
        chaos=None,
        drain_timeout_s: float = 5.0,
        model_factories: Optional[Sequence[Callable[[], Model]]] = None,
        device=None,
        model_repository: Optional[str] = None,
    ):
        if size < 1:
            raise ValueError("fleet size must be >= 1")
        from client_tpu_torch.utils import resolve_device

        # a fleet on the card needs one: raise here, not in a replica
        self._device = resolve_device(device)
        self.size = size
        self._grpc = grpc
        self._host = host
        self._builtin_models = builtin_models
        self._chaos = chaos
        self._drain_timeout_s = drain_timeout_s
        self._model_factories = list(model_factories or ())
        self._model_repository = model_repository
        self.replicas: List = []
        self._lock = threading.Lock()
        self._stopped = False
        self.restarts = 0
        self.replacements = 0

    # -- lifecycle -----------------------------------------------------------

    def _new_server(self, http_port: int = 0, grpc_port: int = 0):
        from client_tpu_torch.server.core import ServerCore
        from client_tpu_torch.server.model_repository import build_repository
        from client_tpu_torch.testing import InProcessServer

        repository = build_repository(self._model_repository,
                                      builtin=self._builtin_models, device=self._device)
        server = InProcessServer(
            core=ServerCore(repository, device=self._device),
            grpc=self._grpc,
            host=self._host,
            builtin_models=False,
            chaos=self._chaos,
            http_port=http_port,
            grpc_port=grpc_port,
            drain_timeout_s=self._drain_timeout_s,
            device=self._device,
        )
        for factory in self._model_factories:
            server.core.repository.add_model(factory())
        return server

    def start(self) -> "FleetRunner":
        try:
            for _ in range(self.size):
                self.replicas.append(self._new_server().start())
        except BaseException:
            self.stop()
            raise
        return self

    def stop(self) -> None:
        # under the same lock restart_replica holds: a restart mid-drain
        # (e.g. left running by a cancelled FleetRestartDriver task)
        # finishes its swap first, so its replacement is in the list and
        # gets stopped here instead of leaking on a daemon thread
        with self._lock:
            self._stopped = True
            replicas, self.replicas = self.replicas, []
        for server in replicas:
            try:
                server.stop()
            except Exception:  # noqa: BLE001 - teardown is best-effort
                pass

    def __enter__(self) -> "FleetRunner":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- addressing ----------------------------------------------------------

    @property
    def http_urls(self) -> List[str]:
        return [server.http_url for server in self.replicas]

    @property
    def grpc_urls(self) -> List[str]:
        return [server.grpc_url for server in self.replicas]

    def urls(self, protocol: str) -> List[str]:
        return self.grpc_urls if protocol == "grpc" else self.http_urls

    @property
    def metrics_urls(self) -> List[str]:
        """Every replica's /metrics endpoint (the HTTP front-end)."""
        return self.http_urls

    # -- chaos ---------------------------------------------------------------

    def restart_replica(
        self, index: int, drain_timeout_s: Optional[float] = None
    ) -> None:
        """Cycle one replica through the real lifecycle: ``drain()``
        (readiness false, in-flight and queued work finishes, leftovers
        fail cleanly), front-ends down, then a fresh replica at the SAME
        http/grpc ports — the address every client pool keeps probing.
        Serialized under a lock: a rolling restart is one replica at a
        time by definition (and :meth:`stop` takes the same lock, so a
        restart racing shutdown either completes its swap — and the
        replacement is stopped with the rest — or sees the stopped flag
        and does nothing)."""
        with self._lock:
            if self._stopped:
                return
            old = self.replicas[index]
            http_port, grpc_port = old.http_port, old.grpc_port
            old.stop(
                drain_timeout_s
                if drain_timeout_s is not None
                else self._drain_timeout_s
            )
            replacement = self._new_server(
                http_port=http_port or 0, grpc_port=grpc_port or 0
            )
            self.replicas[index] = replacement.start()
            self.restarts += 1

    def stop_replica(self, index: int) -> None:
        """Drain and stop one replica WITHOUT restarting it (the
        kill-a-replica chaos scenario; the pool should route around the
        dead address with zero client-observed failures)."""
        with self._lock:
            if self._stopped:
                return
            self.replicas[index].stop()

    def replace_replica(self, index: int):
        """Replace one liveness-dead replica with a fresh one at NEW
        ports (a hung replica may still hold its old sockets, and its
        exit code — e.g. a pod whose supervised recovery failed — says
        the address is not coming back). Distinct from
        :meth:`restart_replica`: no drain is attempted, the replica is
        already gone; the caller must have pulled its addresses from
        routing FIRST. Returns the started replacement."""
        with self._lock:
            if self._stopped:
                raise RuntimeError("fleet is stopped")
            dead = self.replicas[index]
            replacement = self._new_server().start()
            self.replicas[index] = replacement
            self.replacements += 1
        try:
            # best-effort teardown of whatever is left of the old one;
            # zero drain budget — nothing routable is in-flight there
            dead.stop(0.0)
        except Exception:  # noqa: BLE001 - it was dead to begin with
            pass
        return replacement

    # -- elasticity (the autoscaler's two verbs) -----------------------------

    def add_replica(self):
        """Launch one more replica under live traffic; returns the
        started :class:`~client_tpu_torch.testing.InProcessServer` so the
        caller (the autoscaler) can announce its addresses to the
        router. ``size`` tracks live membership."""
        with self._lock:
            if self._stopped:
                raise RuntimeError("fleet is stopped")
            server = self._new_server().start()
            self.replicas.append(server)
            self.size = len(self.replicas)
            return server

    def remove_replica(self, index: int = -1):
        """Drain and retire one replica (default: the newest). Refuses
        to empty the fleet. The caller must pull the replica's addresses
        from any router FIRST — drain only finishes in-flights; it
        cannot protect requests routed to it afterwards. Returns the
        stopped server (its ports identify which addresses left)."""
        with self._lock:
            if self._stopped:
                raise RuntimeError("fleet is stopped")
            if len(self.replicas) <= 1:
                raise ValueError("refusing to remove the last replica")
            server = self.replicas.pop(index)
            self.size = len(self.replicas)
        server.stop()
        return server


class FleetRestartDriver:
    """``--rolling-restart`` over a live fleet: every ``period_s``
    seconds, drain -> restart the next replica round-robin while the
    measurement runs. The harness report's dropped/rerouted split then
    answers whether the fleet rode through it."""

    def __init__(self, fleet: FleetRunner, period_s: float):
        self.fleet = fleet
        self.period_s = period_s
        self.cycles = 0
        self.errors: List[str] = []
        self._task = None
        self._stopped = False

    def start(self) -> None:
        import asyncio

        self._task = asyncio.ensure_future(self._run())

    async def _run(self) -> None:
        import asyncio

        index = 0
        while True:
            await asyncio.sleep(self.period_s)
            try:
                # restart blocks on the drain + port rebind: off the loop
                await asyncio.to_thread(
                    self.fleet.restart_replica, index % self.fleet.size
                )
                index += 1
                self.cycles += 1
            except asyncio.CancelledError:
                raise
            except Exception as e:  # noqa: BLE001 - chaos must not kill the run
                if len(self.errors) < 8:
                    self.errors.append(str(e))

    async def stop(self) -> None:
        import asyncio

        if self._stopped:
            return
        self._stopped = True
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except (asyncio.CancelledError, Exception):  # noqa: BLE001
                pass
            self._task = None


class Autoscaler:
    """SLO-burn-driven fleet sizing: the control loop that closes the
    router tier.

    The signal is ``tpu_slo_latency_burn_rate`` — the same number the
    alerting surface exports: how fast the fleet is spending its latency
    error budget (1.0 = exactly on target). Each tick reads the MAX burn
    across live replicas (the autoscaler's job is the worst replica's
    overload, not the average), then applies hysteresis: ``high_ticks``
    consecutive ticks at/above ``burn_high`` add a replica (up to
    ``max_replicas``); ``low_ticks`` consecutive ticks at/below
    ``burn_low`` drain one (down to ``min_replicas``). Asymmetric on
    purpose — scaling out is cheap and urgent, scaling in is neither.

    Scale events keep the router in the loop so they stay
    client-invisible: on scale-out the replica starts FIRST, then
    ``on_scale_out(server)`` announces it (the router routes to it once
    its readiness probe passes); on scale-in ``on_scale_in(server)``
    pulls the addresses from routing BEFORE the drain, so no new request
    can target the leaving replica while it finishes its in-flights.

    **Liveness replacement** (the fleet tier of the self-healing stack)
    rides the same tick: a replica whose readiness probe has been down
    for ``dead_ticks`` consecutive ticks is declared dead and REPLACED —
    its addresses pulled from routing first (``on_scale_in``), a fresh
    replica started and announced (``on_scale_out``), the corpse stopped
    with zero drain budget. This is deliberately a different verb from
    burn scaling: burn says the fleet is the wrong SIZE, a dead liveness
    probe says one MEMBER is gone (a crashed pod coordinator, a replica
    whose supervised recovery failed and exited) — shrinking would
    compound the outage. ``dead_ticks`` is the hysteresis that keeps an
    ordinary drain-for-restart (readiness intentionally false for a few
    ticks) from triggering a replacement.

    :meth:`observe` is the pure decision function (unit-testable with no
    fleet at all); :meth:`tick` is one read-decide-act cycle;
    :meth:`start` runs ticks on a daemon thread every ``interval_s``.
    """

    def __init__(
        self,
        fleet: FleetRunner,
        min_replicas: int = 1,
        max_replicas: int = 4,
        burn_high: float = 1.0,
        burn_low: float = 0.1,
        high_ticks: int = 2,
        low_ticks: int = 6,
        interval_s: float = 0.5,
        model_name: str = "device_sim",
        burn_signal: Optional[Callable[[], float]] = None,
        liveness_signal: Optional[Callable[[], List[bool]]] = None,
        dead_ticks: int = 4,
        on_scale_out: Optional[Callable] = None,
        on_scale_in: Optional[Callable] = None,
        logger=None,
        clock: Callable[[], float] = time.monotonic,
    ):
        if min_replicas < 1 or max_replicas < min_replicas:
            raise ValueError("need 1 <= min_replicas <= max_replicas")
        self.fleet = fleet
        self.min_replicas = min_replicas
        self.max_replicas = max_replicas
        self.burn_high = burn_high
        self.burn_low = burn_low
        self.high_ticks = high_ticks
        self.low_ticks = low_ticks
        self.interval_s = interval_s
        self.model_name = model_name
        self._burn_signal = burn_signal
        self._liveness_signal = liveness_signal
        self.dead_ticks = dead_ticks
        self.on_scale_out = on_scale_out
        self.on_scale_in = on_scale_in
        self._logger = logger
        self._clock = clock
        self._high = 0
        self._low = 0
        # id(server) -> consecutive not-ready ticks (keyed by identity,
        # not index: burn scaling shifts indices under the counters)
        self._down: dict = {}
        self.events: List[dict] = []
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    # -- signal --------------------------------------------------------------

    def current_burn(self) -> float:
        """Max ``burn_rate`` across live replicas (0.0 while telemetry
        is still warming — never scale on an absent signal)."""
        if self._burn_signal is not None:
            return self._burn_signal()
        burns = []
        for server in list(self.fleet.replicas):
            try:
                status = server.core.metrics.telemetry.slo_status(
                    self.model_name
                )
            except Exception:  # noqa: BLE001 - replica mid-restart
                continue
            if status:
                burns.append(float(status.get("burn_rate", 0.0)))
        return max(burns, default=0.0)

    def current_liveness(self) -> List[bool]:
        """Per-replica readiness, positionally aligned with
        ``fleet.replicas``. The in-process default reads each replica's
        ``core.ready`` (exactly what the HTTP ``/v2/health/ready`` probe
        serves); subprocess fleets inject ``liveness_signal`` instead."""
        if self._liveness_signal is not None:
            return list(self._liveness_signal())
        alive = []
        for server in list(self.fleet.replicas):
            try:
                alive.append(bool(server.core.ready))
            except Exception:  # noqa: BLE001 - a dead replica IS the signal
                alive.append(False)
        return alive

    def check_liveness(self) -> Optional[int]:
        """Fold one liveness sample into the per-replica down counters;
        returns the index of a replica down ``dead_ticks`` consecutive
        ticks (lowest such index), or ``None``."""
        replicas = list(self.fleet.replicas)
        alive = self.current_liveness()
        seen = set()
        victim = None
        for index, server in enumerate(replicas):
            key = id(server)
            seen.add(key)
            if index < len(alive) and alive[index]:
                self._down.pop(key, None)
                continue
            count = self._down.get(key, 0) + 1
            self._down[key] = count
            if victim is None and count >= self.dead_ticks:
                victim = index
        for key in list(self._down):
            if key not in seen:
                del self._down[key]
        return victim

    # -- decision (pure) -----------------------------------------------------

    def observe(self, burn: float) -> str:
        """Fold one burn sample into the hysteresis counters; returns
        the decision: ``"scale_out"`` / ``"scale_in"`` / ``"hold"``."""
        size = self.fleet.size
        if burn >= self.burn_high:
            self._high += 1
            self._low = 0
            if self._high >= self.high_ticks and size < self.max_replicas:
                self._high = 0
                return "scale_out"
        elif burn <= self.burn_low:
            self._low += 1
            self._high = 0
            if self._low >= self.low_ticks and size > self.min_replicas:
                self._low = 0
                return "scale_in"
        else:
            self._high = 0
            self._low = 0
        return "hold"

    # -- actuation -----------------------------------------------------------

    def replace_dead(self, index: int) -> None:
        """Actuate one liveness replacement: routing out first (the
        address is already failing every request sent to it), fresh
        replica in, announce it, book the MTTR on the replacement's own
        metrics registry (the fleet scrape merges per-replica
        registries, so the sample is visible fleet-wide)."""
        started = self._clock()
        dead = self.fleet.replicas[index]
        if self.on_scale_in is not None:
            self.on_scale_in(dead)
        replacement = self.fleet.replace_replica(index)
        if self.on_scale_out is not None:
            self.on_scale_out(replacement)
        self._down.pop(id(dead), None)
        duration = self._clock() - started
        try:
            replacement.core.metrics.observe_recovery(
                "fleet", "success", duration
            )
        except Exception:  # noqa: BLE001 - booking must not fail recovery
            pass
        event = {
            "decision": "replace",
            "index": index,
            "size": self.fleet.size,
            "duration_s": round(duration, 3),
        }
        self.events.append(event)
        if self._logger is not None:
            self._logger.info("autoscale", **event)

    def tick(self) -> str:
        victim = self.check_liveness()
        if victim is not None:
            self.replace_dead(victim)
            return "replace"
        burn = self.current_burn()
        decision = self.observe(burn)
        if decision == "scale_out":
            server = self.fleet.add_replica()
            if self.on_scale_out is not None:
                self.on_scale_out(server)
        elif decision == "scale_in":
            # routing first, then drain: remove_replica's drain protects
            # in-flights, the router removal protects everything after
            server = self.fleet.replicas[-1]
            if self.on_scale_in is not None:
                self.on_scale_in(server)
            self.fleet.remove_replica(-1)
        if decision != "hold":
            event = {
                "decision": decision,
                "burn": round(burn, 3),
                "size": self.fleet.size,
            }
            self.events.append(event)
            if self._logger is not None:
                self._logger.info("autoscale", **event)
        return decision

    def start(self) -> "Autoscaler":
        if self._thread is None:
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._run, name="fleet-autoscaler", daemon=True
            )
            self._thread.start()
        return self

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.tick()
            except Exception:  # noqa: BLE001 - scaling must not die
                pass

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=30)
            self._thread = None


# ---------------------------------------------------------------------------
# subprocess replica mode


def write_ports_file(path: str, ports: dict) -> None:
    """Publish a serving subprocess's bound ports as one JSON document,
    atomically (write-temp + rename): a reader polling the path sees
    either nothing or the complete document, never a partial write.
    Replaces stdout scanning — ports travel as a file handoff that
    survives whatever else the child prints."""
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(ports, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def read_ports_file(path: str) -> Optional[dict]:
    """The reader half: None until the file exists and parses (the
    write is atomic, so a parse failure just means 'not yet')."""
    try:
        with open(path, "r", encoding="utf-8") as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def _serve_one(args) -> int:
    factories: List[Callable[[], Model]] = []
    if args.device_sim:
        step_ms, _, batch = args.device_sim.partition(":")
        step_s = float(step_ms) / 1000.0
        max_batch = int(batch) if batch else 4

        def factory() -> Model:
            return DeviceBoundModel(step_s=step_s, max_batch_size=max_batch)

        factories.append(factory)
    fleet = FleetRunner(
        1,
        host=args.host,
        grpc="native",
        builtin_models=not args.no_builtin_models,
        drain_timeout_s=args.drain_timeout,
        model_factories=factories,
        device=args.device,
    )
    fleet.replicas.append(
        fleet._new_server(
            http_port=args.http_port, grpc_port=args.grpc_port
        ).start()
    )
    server = fleet.replicas[0]
    ports = {"http_port": server.http_port, "grpc_port": server.grpc_port}
    if args.ports_file:
        write_ports_file(args.ports_file, ports)
    print(json.dumps(ports), flush=True)
    stop = threading.Event()
    for signum in (signal.SIGTERM, signal.SIGINT):
        signal.signal(signum, lambda *_: stop.set())
    stop.wait()
    fleet.stop()
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m client_tpu_torch.perf.fleet_runner",
        description="serve ONE fleet replica as a subprocess (prints a "
        "JSON ports line, drains on SIGTERM)",
    )
    parser.add_argument("--serve", action="store_true", required=True)
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--http-port", type=int, default=0)
    parser.add_argument("--grpc-port", type=int, default=0)
    parser.add_argument("--drain-timeout", type=float, default=5.0)
    parser.add_argument(
        "--ports-file",
        default=None,
        metavar="PATH",
        help="also write the bound-ports JSON to PATH (atomic write; "
        "spawners poll the file instead of scanning stdout)",
    )
    parser.add_argument(
        "--device-sim",
        default=None,
        metavar="STEP_MS[:BATCH]",
        help="register a DeviceBoundModel ('device_sim'): simulated "
        "device-step milliseconds and max batch size",
    )
    parser.add_argument("--no-builtin-models", action="store_true")
    parser.add_argument(
        "--device", default=None,
        help="the replica's device (default cuda; 'cpu' on a host without "
        "a card)",
    )
    args = parser.parse_args(argv)
    return _serve_one(args)


if __name__ == "__main__":
    raise SystemExit(main())
