"""Replicated serving fleet: N replicas behind one discovery operation.

The reference edge-AI deployment runs ONE ``tensor_query_server`` per
device and leaves replication to the operator (tensor_query_hybrid only
*discovers* whatever happens to be advertised). This module is the
missing operator: ``nns-fleet`` launches and supervises N replica
*processes* — separate interpreters, so N CPU-bound replicas scale past
the GIL — each advertising itself under the same operation with a
refreshed load block. Clients front the fleet with
``tensor_query_client operation=<op> reliable=true
balance=shortest-slack`` (see ``query/balance.py``) and route every
frame to the replica with the shortest expected completion.

Per replica the launcher provides:

- an isolated state dir (``<state>/replica<i>``) holding the resilient
  dedup-window checkpoint a graceful shutdown writes and the next boot
  restores — the exactly-once half of rolling restarts;
- a SHARED kernel build cache (``<state>/compile-cache`` via
  ``NNSTPU_COMPILE_CACHE``, read by ``ops/_build.py`` behind its file
  lock): the first replica pays each ``nvcc`` build, siblings and
  restarts load the libraries;
- crash supervision: an exited replica is relaunched with bounded
  exponential backoff (``nns_fleet_restarts_total`` counts, the backoff
  caps at :data:`RESTART_BACKOFF_MAX_S`, and a replica that stays up
  :data:`RESTART_RESET_S` earns its counter back);
- rolling deploys: :meth:`FleetLauncher.rolling_restart` cycles one
  replica at a time through SIGTERM (checkpoint) → respawn (restore) →
  re-advertise, so the fleet never loses more than one replica of
  capacity and in-flight frames ride the client's sticky reconnect.

Two replica flavors: the built-in echo replica (``--replica`` mode of
this module — a resilient ``QueryServer`` whose worker spins for
``--spin-ms`` of CPU then echoes the frame back doubled; the fleet
bench and chaos smoke use it as a deterministic stand-in for a model)
and arbitrary pipelines via ``--desc`` (launched through ``nns-launch``
with per-replica checkpoint dirs; ``{index}`` in the description is
substituted per replica).

Kill switches: no fleet process is ever implied — this module only runs
when invoked. Clients keep their exact single-server path with
``balance=off`` (default) or ``NNSTPU_FLEET=0``.

Port of ``nnstreamer_tpu/serving/fleet.py``. Replicas are spawned with
``subprocess.Popen`` (a fresh interpreter, never a fork of a process
that holds CUDA). A ``--desc`` replica runs ``python -m
nnstreamer_tpu_torch.cli`` on the package device, ``cuda:0``, unless
``env={"NNSTPU_TORCH_DEVICE": "cpu"}`` asks for the CPU; the echo
replica computes on the host. One addition the JAX launcher lacks
(ROADMAP C.44): with ``metrics=True`` a ``--desc`` replica also gets a
metrics server on a free port, passed as ``--metrics-port`` and
substituted for ``{metrics_port}`` in the description, so its serversrc
can advertise it for federation. Without it no ``--desc`` fleet can be
federated, and a replica's own counts (its fused regions' dispatches,
its kernels' launches: ``/metrics.json``'s ``regions`` and
``launches``) could not be read from outside its process.
"""

from __future__ import annotations

import argparse
import json
import os
import pickle
import signal
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

from nnstreamer_tpu_torch.log import get_logger

log = get_logger("fleet")

#: crash-restart backoff: base * 2^restarts, capped here (seconds)
RESTART_BACKOFF_BASE_S = 0.5
RESTART_BACKOFF_MAX_S = 10.0
#: a replica up this long gets its restart counter reset — distinguishes
#: a crash loop from the occasional fault
RESTART_RESET_S = 30.0
#: dedup/continuity checkpoint file inside a replica's state dir
CHECKPOINT_FILE = "query_server.pkl"


def _free_port() -> int:
    """A TCP port nothing listens on right now (the OS picks it)."""
    with socket.socket() as probe:
        probe.bind(("127.0.0.1", 0))
        return probe.getsockname()[1]


class ReplicaHandle:
    """One supervised replica process."""

    def __init__(self, index: int, state_dir: Path):
        self.index = index
        self.state_dir = state_dir
        self.proc: Optional[subprocess.Popen] = None
        self.restarts = 0
        self.started_t = 0.0
        self.next_spawn_t = 0.0
        #: set while the launcher itself is taking the replica down
        #: (rolling restart / stop) so the supervisor doesn't race it
        self.expected_exit = False

    def alive(self) -> bool:
        return self.proc is not None and self.proc.poll() is None


def _fleet_metrics():
    from nnstreamer_tpu_torch.obs import get_registry

    reg = get_registry()
    return {
        "up": reg.gauge(
            "nns_fleet_replicas_up",
            "Live replica processes under fleet supervision"),
        "restarts": reg.counter(
            "nns_fleet_restarts_total",
            "Replica processes relaunched after an unexpected exit"),
    }


class FleetLauncher:
    """Spawn and supervise N replicas behind one discovery operation.

    With ``broker_port=0`` the launcher starts its own pub/sub broker
    (the TCP shim — cross-process capable) and replicas/clients are
    pointed at it; pass an existing broker's port to join one. Replica
    ports are ``base_port + index`` when ``base_port`` is set (stable
    endpoints across restarts — what the balancer's sticky reconnect
    wants), else each boot binds an ephemeral port and re-advertises.
    """

    def __init__(self, replicas: int, operation: str = "fleet",
                 broker_host: str = "127.0.0.1", broker_port: int = 0,
                 state_dir: Optional[str] = None, base_port: int = 0,
                 spin_ms: float = 2.0, budget_ms: float = 0.0,
                 advertise_interval_s: float = 0.25,
                 desc: Optional[str] = None, metrics: bool = False,
                 log_invokes: bool = False,
                 env: Optional[Dict[str, str]] = None):
        if replicas < 1:
            raise ValueError("fleet needs at least one replica")
        self.replicas = int(replicas)
        self.operation = operation
        self.broker_host = broker_host
        self.broker_port = int(broker_port)
        self.base_port = int(base_port)
        self.spin_ms = float(spin_ms)
        self.budget_ms = float(budget_ms)
        self.advertise_interval_s = float(advertise_interval_s)
        self.desc = desc
        self.metrics = bool(metrics)
        self.log_invokes = bool(log_invokes)
        self.extra_env = dict(env or {})
        if state_dir:
            self.state_dir = Path(state_dir)
        else:
            import tempfile

            self.state_dir = Path(tempfile.mkdtemp(prefix="nns-fleet-"))
        self._broker = None  # owned Broker when broker_port was 0
        self._handles: List[ReplicaHandle] = []
        self._lock = threading.Lock()
        self._stopping = threading.Event()
        self._supervisor: Optional[threading.Thread] = None
        self._m = _fleet_metrics()

    # -- lifecycle ----------------------------------------------------------
    def start(self) -> "FleetLauncher":
        if self.broker_port == 0:
            from nnstreamer_tpu_torch.query.pubsub import Broker

            self._broker = Broker(host="127.0.0.1", port=0).start()
            self.broker_host = "127.0.0.1"
            self.broker_port = self._broker.port
            log.info("fleet broker on 127.0.0.1:%d", self.broker_port)
        self.state_dir.mkdir(parents=True, exist_ok=True)
        (self.state_dir / "compile-cache").mkdir(exist_ok=True)
        self._stopping.clear()
        for i in range(self.replicas):
            h = ReplicaHandle(i, self.state_dir / f"replica{i}")
            h.state_dir.mkdir(parents=True, exist_ok=True)
            self._handles.append(h)
            self._spawn(h)
        self._supervisor = threading.Thread(
            target=self._supervise_loop, name="fleet-supervisor",
            daemon=True)
        self._supervisor.start()
        return self

    def _replica_cmd(self, h: ReplicaHandle) -> List[str]:
        if self.desc:
            desc = self.desc.replace("{index}", str(h.index))
            cmd = [sys.executable, "-m", "nnstreamer_tpu_torch.cli"]
            if self.metrics:
                port = _free_port()
                desc = desc.replace("{metrics_port}", str(port))
                cmd += ["--metrics-port", str(port)]
            return cmd + [desc, "--checkpoint-dir", str(h.state_dir)]
        cmd = [sys.executable, "-m", "nnstreamer_tpu_torch.serving.fleet",
               "--replica",
               "--operation", self.operation,
               "--broker-host", self.broker_host,
               "--broker-port", str(self.broker_port),
               "--port", str(self.base_port + h.index
                             if self.base_port else 0),
               "--state-dir", str(h.state_dir),
               "--spin-ms", str(self.spin_ms),
               "--advertise-interval-s", str(self.advertise_interval_s)]
        if self.budget_ms > 0:
            cmd += ["--budget-ms", str(self.budget_ms)]
        if self.metrics:
            cmd += ["--metrics-port", "0"]
        if self.log_invokes:
            cmd += ["--invoke-log", str(h.state_dir / "invokes.log")]
        return cmd

    def _spawn(self, h: ReplicaHandle) -> None:
        env = dict(os.environ)
        env["NNSTPU_COMPILE_CACHE"] = str(self.state_dir / "compile-cache")
        env.update(self.extra_env)
        h.expected_exit = False
        h.started_t = time.monotonic()
        # replica output goes to its state dir, not the launcher's
        # stdout — bench/CI consumers parse the launcher's JSON lines
        with open(h.state_dir / "replica.log", "ab") as out:
            h.proc = subprocess.Popen(self._replica_cmd(h), env=env,
                                      stdout=out,
                                      stderr=subprocess.STDOUT)
        log.info("replica %d spawned (pid %d)", h.index, h.proc.pid)
        self._m["up"].set(self.replicas_up())

    def _supervise_loop(self) -> None:
        while not self._stopping.wait(0.2):
            now = time.monotonic()
            for h in self._handles:
                with self._lock:
                    if h.expected_exit or h.alive():
                        if h.alive() and h.restarts and \
                                now - h.started_t > RESTART_RESET_S:
                            h.restarts = 0
                        continue
                    if h.proc is None:
                        continue
                    if h.next_spawn_t == 0.0:
                        rc = h.proc.returncode
                        h.restarts += 1
                        backoff = min(
                            RESTART_BACKOFF_MAX_S,
                            RESTART_BACKOFF_BASE_S
                            * 2 ** min(h.restarts - 1, 6))
                        h.next_spawn_t = now + backoff
                        self._m["restarts"].inc()
                        self._m["up"].set(self.replicas_up())
                        log.warning(
                            "replica %d exited rc=%s; restart %d in "
                            "%.1fs", h.index, rc, h.restarts, backoff)
                        continue
                    if now >= h.next_spawn_t:
                        h.next_spawn_t = 0.0
                        self._spawn(h)

    def replicas_up(self) -> int:
        return sum(1 for h in self._handles if h.alive())

    # -- discovery-side readiness ------------------------------------------
    def endpoints(self, timeout: float = 10.0,
                  expect: Optional[int] = None
                  ) -> List[Tuple[str, int]]:
        """Wait until ``expect`` (default: all) replicas advertise, and
        return their (host, port) list."""
        from nnstreamer_tpu_torch.query.discovery import ServerDiscovery

        want = self.replicas if expect is None else int(expect)
        disco = ServerDiscovery(self.broker_host, self.broker_port,
                                self.operation)
        try:
            deadline = time.monotonic() + timeout
            while True:
                found = disco.servers_now()
                if len(found) >= want or time.monotonic() > deadline:
                    return sorted(found)
                time.sleep(0.05)
        finally:
            disco.close()

    # -- controlled restarts ------------------------------------------------
    def kill_replica(self, index: int, graceful: bool = True,
                     wait_s: float = 10.0) -> None:
        """Take one replica down (SIGTERM = checkpoint first, SIGKILL =
        crash). The supervisor relaunches it with backoff."""
        h = self._handles[index]
        if not h.alive():
            return
        h.proc.send_signal(signal.SIGTERM if graceful else signal.SIGKILL)
        try:
            h.proc.wait(timeout=wait_s)
        except subprocess.TimeoutExpired:
            h.proc.kill()
            h.proc.wait(timeout=wait_s)
        self._m["up"].set(self.replicas_up())

    def restart_replica(self, index: int, graceful: bool = True,
                        wait_s: float = 10.0) -> None:
        """Deterministic restart (no supervisor backoff): checkpoint →
        kill → respawn → wait for the fresh advertisement."""
        h = self._handles[index]
        with self._lock:
            h.expected_exit = True
        if h.alive():
            h.proc.send_signal(signal.SIGTERM if graceful
                               else signal.SIGKILL)
            try:
                h.proc.wait(timeout=wait_s)
            except subprocess.TimeoutExpired:
                h.proc.kill()
                h.proc.wait(timeout=wait_s)
        with self._lock:
            h.restarts = 0
            h.next_spawn_t = 0.0
            self._spawn(h)
        # back up before a replica counts as deployed: its ad must be
        # re-published (port may have changed when base_port is 0)
        self.endpoints(timeout=wait_s, expect=self.replicas)

    def rolling_restart(self, graceful: bool = True,
                        wait_s: float = 15.0) -> None:
        """Deploy rehearsal: cycle every replica through checkpoint →
        kill → restore, one at a time, never dropping more than one
        replica of capacity."""
        for i in range(self.replicas):
            log.info("rolling restart: replica %d", i)
            self.restart_replica(i, graceful=graceful, wait_s=wait_s)

    def stop(self) -> None:
        self._stopping.set()
        if self._supervisor is not None:
            self._supervisor.join(timeout=5.0)
            self._supervisor = None
        for h in self._handles:
            h.expected_exit = True
            if h.alive():
                h.proc.send_signal(signal.SIGTERM)
        deadline = time.monotonic() + 10.0
        for h in self._handles:
            if h.proc is None:
                continue
            try:
                h.proc.wait(timeout=max(0.1,
                                        deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                h.proc.kill()
                h.proc.wait(timeout=5.0)
        self._m["up"].set(0)
        if self._broker is not None:
            self._broker.stop()
            self._broker = None


# ---------------------------------------------------------------------------
# built-in echo replica (--replica): a resilient QueryServer + CPU spin
# ---------------------------------------------------------------------------
def _replica_main(args: argparse.Namespace,
                  announce: Callable[[str], None]) -> int:
    from nnstreamer_tpu_torch.query.discovery import ServerAdvertiser
    from nnstreamer_tpu_torch.query.server import QueryServer
    from nnstreamer_tpu_torch.tensors.buffer import TensorBuffer

    state_dir = Path(args.state_dir) if args.state_dir else None
    ckpt = state_dir / CHECKPOINT_FILE if state_dir else None

    server = QueryServer(host="127.0.0.1", port=int(args.port),
                         resilient=True).start()
    if ckpt and ckpt.exists():
        try:
            server.restore_state(pickle.loads(ckpt.read_bytes()))
            log.info("replica restored dedup state from %s", ckpt)
        except Exception as e:  # noqa: BLE001 — a bad checkpoint must
            # not keep the replica down; it just boots cold
            log.warning("checkpoint %s unreadable (%s); cold boot",
                        ckpt, e)

    metrics_srv = None
    if args.metrics_port is not None:
        from nnstreamer_tpu_torch.obs.server import MetricsServer

        metrics_srv = MetricsServer(host="127.0.0.1",
                                    port=int(args.metrics_port)).start()

    service_ewma = [max(args.spin_ms, 0.1)]  # ms, seeded with the spin

    def _load() -> dict:
        load = {"queue_depth": int(server.incoming.qsize()),
                "service_ms": round(service_ewma[0], 3)}
        if args.budget_ms > 0:
            load["slack_headroom_ms"] = round(
                args.budget_ms
                - (load["queue_depth"] + 1) * service_ewma[0], 3)
        return load

    advertiser = ServerAdvertiser(
        args.broker_host, int(args.broker_port), args.operation,
        "127.0.0.1", server.port,
        metrics_port=metrics_srv.port if metrics_srv else None,
        load_fn=_load, refresh_s=float(args.advertise_interval_s))
    advertiser.publish()
    # the replica process's one machine-readable stdout line (the
    # launcher's CI smoke parses it); emission goes through the CLI
    # entry point's announce callable, not a library print
    announce(json.dumps({"replica": "up", "port": server.port,
                         "pid": os.getpid()}))

    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *_: stop.set())
    signal.signal(signal.SIGINT, lambda *_: stop.set())

    invoke_log = open(args.invoke_log, "a") if args.invoke_log else None
    spin_s = max(0.0, float(args.spin_ms)) / 1e3
    try:
        while not stop.is_set():
            buf = server.get_buffer(timeout=0.1)
            if buf is None:
                continue
            t0 = time.monotonic()
            if spin_s:
                # CPU-bound on purpose: fleet scaling must come from
                # real process parallelism, not sleep concurrency
                while time.monotonic() - t0 < spin_s:
                    pass
            out = TensorBuffer([t * 2 for t in buf.to_host().tensors],
                               pts=buf.pts)
            out.meta.update(buf.meta)
            if invoke_log is not None:
                invoke_log.write(
                    f"{buf.meta.get('net_instance', '')}:"
                    f"{buf.meta.get('net_req_id', -1)}\n")
                invoke_log.flush()
            service_ewma[0] += 0.2 * ((time.monotonic() - t0) * 1e3
                                      - service_ewma[0])
            server.send_result(buf.meta.get("query_client_id", 0), out)
    finally:
        if invoke_log is not None:
            invoke_log.close()
        if ckpt:
            # the deploy contract: state lands on disk BEFORE the ad is
            # retracted, so the successor replays instead of re-invoking
            ckpt.write_bytes(pickle.dumps(server.checkpoint_state()))
            log.info("replica checkpointed dedup state to %s", ckpt)
        try:
            advertiser.retract()
        except OSError:
            pass
        server.stop()
        if metrics_srv is not None:
            metrics_srv.stop()
    return 0


# ---------------------------------------------------------------------------
# nns-fleet CLI
# ---------------------------------------------------------------------------
def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="nns-fleet-torch",
        description="Launch and supervise a replicated serving fleet "
                    "behind one discovery operation (see "
                    "docs/distributed.md, Replicated fleet).")
    ap.add_argument("-n", "--replicas", type=int, default=2,
                    help="replica process count (default 2)")
    ap.add_argument("--operation", default="fleet",
                    help="discovery operation clients subscribe to")
    ap.add_argument("--broker-host", default="127.0.0.1")
    ap.add_argument("--broker-port", type=int, default=0,
                    help="pub/sub broker port; 0 starts an owned broker "
                         "on a free port (printed at startup)")
    ap.add_argument("--base-port", type=int, default=0,
                    help="replica i serves on base+i (stable endpoints "
                         "across restarts); 0 = ephemeral ports")
    ap.add_argument("--state-dir", default=None,
                    help="fleet state root: per-replica checkpoint dirs "
                         "+ the shared compile cache (default: a fresh "
                         "temp dir)")
    ap.add_argument("--desc", default=None,
                    help="pipeline description to run per replica via "
                         "nns-launch ({index} substituted); default is "
                         "the built-in echo replica")
    ap.add_argument("--spin-ms", type=float, default=2.0,
                    help="echo replica: CPU-bound service time per "
                         "frame (ms)")
    ap.add_argument("--budget-ms", type=float, default=0.0,
                    help="echo replica: SLO budget advertised through "
                         "the ad's slack_headroom_ms")
    ap.add_argument("--advertise-interval-s", type=float, default=0.25,
                    help="discovery-ad refresh cadence carrying the "
                         "live load block")
    ap.add_argument("--metrics", action="store_true",
                    help="give each replica a /metrics.json server, "
                         "advertised for fleet federation (a --desc "
                         "replica's serversrc names it as "
                         "metrics-port={metrics_port})")
    ap.add_argument("--rolling-restart", action="store_true",
                    help="once all replicas advertise, cycle each "
                         "through checkpoint → kill → restore (deploy "
                         "rehearsal), then keep serving")
    ap.add_argument("--duration-s", type=float, default=0.0,
                    help="exit after this long (0 = serve until "
                         "SIGINT/SIGTERM)")
    # internal: replica-process mode (spawned by FleetLauncher)
    ap.add_argument("--replica", action="store_true",
                    help=argparse.SUPPRESS)
    ap.add_argument("--port", type=int, default=0,
                    help=argparse.SUPPRESS)
    ap.add_argument("--metrics-port", type=int, default=None,
                    help=argparse.SUPPRESS)
    ap.add_argument("--invoke-log", default=None,
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)

    if args.replica:
        return _replica_main(args, lambda line: print(line, flush=True))

    fleet = FleetLauncher(
        replicas=args.replicas, operation=args.operation,
        broker_host=args.broker_host, broker_port=args.broker_port,
        state_dir=args.state_dir, base_port=args.base_port,
        spin_ms=args.spin_ms, budget_ms=args.budget_ms,
        advertise_interval_s=args.advertise_interval_s,
        desc=args.desc, metrics=args.metrics).start()
    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *_: stop.set())
    signal.signal(signal.SIGINT, lambda *_: stop.set())
    try:
        eps = fleet.endpoints(timeout=30.0)
        print(json.dumps({
            "fleet": args.operation,
            "broker": f"{fleet.broker_host}:{fleet.broker_port}",
            "replicas": fleet.replicas_up(),
            "endpoints": [f"{h}:{p}" for h, p in eps],
            "state_dir": str(fleet.state_dir),
        }), flush=True)
        if args.rolling_restart:
            fleet.rolling_restart()
            print(json.dumps({"rolling_restart": "done",
                              "replicas": fleet.replicas_up()}),
                  flush=True)
        deadline = (time.monotonic() + args.duration_s
                    if args.duration_s > 0 else None)
        while not stop.is_set():
            if deadline is not None and time.monotonic() >= deadline:
                break
            stop.wait(0.2)
    finally:
        fleet.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
