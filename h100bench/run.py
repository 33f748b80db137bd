"""Run one cell of ``BENCHMARK.json`` once and print its result line.

    python3 -m h100bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. A run makes the weights and the
configuration's pool of inputs on the card from ``--seed``, builds the
mix's launch string through the port's ``parse_launch`` with the model
registered by ``register_torch_model``, feeds each of its sources from a
thread of its own, warms up the cell's own shapes (the eager first
window and the CUDA-graph capture) and runs the cell's load for a
preroll, then measures for ``--seconds``. Once the window has closed it
drains every frame it sent, reads the device's peak memory, frees the
program, and has the plain reference judge every answer the sinks
received. The last line of standard output is one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer metrics, each
read from the run's records by ``metrics/<name>.py``),
``device``, with ``--trace 1`` ``breakdown``, and last ``checks``: each
number compared, with its limit. The same numbers end standard error.

It fails, and prints no result, without as many CUDA cards as the cell
asks for, and when JAX or the JAX package is loaded once the window has
closed. The port's kernel builds and every compile cache live in fixed
directories under ``h100bench/.cache`` of the checkout.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import subprocess
import sys
import threading
import time
from dataclasses import dataclass, field
from types import SimpleNamespace
from typing import Dict, List, Optional

if __package__ in (None, ""):  # run as a file: the checkout's root on the path
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))

from h100bench import cells  # noqa: E402

#: top-level module names the process must not hold once the window closed
FORBIDDEN = ("jax", "jaxlib", "flax", "nnstreamer_tpu")
CACHE = os.path.join(cells.HERE, ".cache")
#: seconds of the window's end under the profiler (at most 0.4 of it)
PROFILE_S = 1.0
#: seconds of the window's end under the frame ledger, and the records
#: a thread's ledger ring holds: the busiest thread records some three a
#: frame, and a ring that overflows loses the ledger's frames
LEDGER_S = 5.0
LEDGER_RECORDS = 1 << 20
#: seconds to wait for the warm-up's answers (the first run builds B1)
WARMUP_TIMEOUT_S = 300.0
#: seconds past the window's close to wait for every frame sent
DRAIN_TIMEOUT_S = 60.0


def process_start() -> float:
    """``time.monotonic()`` of this process's start (Linux: its start in
    clock ticks since boot against the uptime); now, where unreadable."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.monotonic() - (uptime - start_ticks /
                                   os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return time.monotonic()


def fix_caches() -> None:
    """Every build and kernel cache at a fixed path in the checkout, so
    only a checkout's first run builds; no JAX through a library."""
    for env, sub in (("NNSTPU_COMPILE_CACHE", "nnstpu"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[env] = os.path.join(CACHE, sub)
    os.environ["USE_FLAX"] = "0"


def forbidden_modules() -> List[str]:
    """The :data:`FORBIDDEN` names among the loaded modules' top-level
    names (compared whole: ``nnstreamer_tpu_torch`` is not
    ``nnstreamer_tpu``)."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN))


def power_limit() -> Optional[str]:
    """``nvidia-smi``'s name and power limit of the first card."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=False).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        return None
    return out[0] if out else None


@dataclass
class Sink:
    """The sink's callback: each buffer's arrival time, pts and answers."""
    answers_of: object
    records: list = field(default_factory=list)
    frames: int = 0
    cond: threading.Condition = field(default_factory=threading.Condition)

    def __call__(self, buf) -> None:
        t = time.monotonic()
        got = self.answers_of(buf)
        with self.cond:
            self.records.append((t, buf.pts, got))
            self.frames += len(got)
            self.cond.notify_all()

    def wait_for(self, frames: int, timeout: float) -> bool:
        with self.cond:
            return self.cond.wait_for(lambda: self.frames >= frames, timeout)


class Pusher(threading.Thread):
    """Pushes pool frames into ``appsrc`` from frame ``k``: as fast as it
    accepts them (``due`` None; once stopped it completes the last
    window of ``batch`` frames), or each at its due time. Records each
    frame's push time and whether ``appsrc`` took it."""

    def __init__(self, src, pool, k: int, due=None, batch: int = 1):
        super().__init__(name="h100bench-pusher", daemon=True)
        self.src, self.pool, self.k, self.due = src, pool, k, due
        self.batch = batch
        self.stop = threading.Event()
        self.pushed: List[tuple] = []  # (frame k, push time, accepted)

    def run(self) -> None:
        n = len(self.pool)
        if self.due is None:
            while not self.stop.is_set() or self.k % self.batch:
                ok = self.src.push([self.pool[self.k % n]], pts=self.k)
                self.pushed.append((self.k, time.monotonic(), ok))
                self.k += 1
            return
        for t_due in self.due:
            if self.stop.is_set():
                return
            wait = t_due - time.monotonic()
            if wait > 0:
                time.sleep(wait)
            ok = self.src.push([self.pool[self.k % n]], pts=self.k)
            self.pushed.append((self.k, time.monotonic(), ok))
            self.k += 1


@dataclass
class Feed:
    """One branch of the pipeline: a source, the sink callback of the
    sink it feeds, the frames the source took in order, its thread."""
    src: object
    sink: Sink
    accepted: List[int] = field(default_factory=list)
    pusher: Optional[Pusher] = None


def _fence_total(pipeline_name: str):
    """(seconds, fences) of every dispatch window of the pipeline."""
    from nnstreamer_tpu_torch.obs import get_registry

    s = n = 0
    for m in get_registry().collect():
        if m.name == "nns_filter_fence_wait_seconds" and \
                m.labels.get("pipeline") == pipeline_name:
            s += m.sum
            n += m.count
    return s, n


def _say(what: str) -> None:
    print(f"h100bench {time.monotonic():.3f} {what}", file=sys.stderr,
          flush=True)


class GcPauses:
    """The interpreter's garbage collections while armed: each holds the
    lock every thread of the pipeline needs."""

    def __init__(self):
        self.pauses: List[tuple] = []  # (generation, seconds)
        self._t = None
        self.armed = False

    def __call__(self, phase, info) -> None:
        if not self.armed:
            return
        if phase == "start":
            self._t = time.perf_counter()
        elif self._t is not None:
            self.pauses.append((info["generation"],
                                time.perf_counter() - self._t))
            self._t = None

    def summary(self) -> Dict[str, float]:
        return {"gc_collections": len(self.pauses),
                "gc_total_ms": sum(p for _, p in self.pauses) * 1e3,
                "gc_max_ms": max((p for _, p in self.pauses), default=0.0)
                * 1e3,
                "gc_gen2": sum(1 for g, _ in self.pauses if g == 2)}


def run_cell(cell: cells.Cell, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t_process: Optional[float] = None
             ) -> Dict[str, object]:
    """One run of ``cell``; returns the result (without printing it).
    ``device`` is ``"cuda"`` on the card; the tests drive a run on the
    CPU at a small size."""
    import torch

    import nnstreamer_tpu_torch as nt
    from nnstreamer_tpu_torch.filters.torch_backend import (
        register_torch_model,
        unregister_torch_model,
    )
    from nnstreamer_tpu_torch.obs import timeline
    from nnstreamer_tpu_torch.pipeline.pipeline import Pipeline

    from h100bench import stats, traffic, weights

    t_process = time.monotonic() if t_process is None else t_process
    cfg, prog, ref = cell.config.data, cell.config.program, \
        cell.config.reference
    mix = cell.traffic
    # the package's own spelling: a fused region compares devices whole
    dev = torch.device("cuda:0" if device == "cuda" else device)
    on_card = dev.type == "cuda"
    nt.set_device(dev)
    batch = int(mix["batch"])

    w = weights.make(ref.specs(cfg), seed, dev, getattr(torch, cfg["dtype"]))
    frames = prog.inputs(cfg, seed, int(mix["pool_frames"]), dev)
    pool = list(frames.cpu().numpy())
    if on_card:
        # the peak is the program's: not the draws' temporaries above
        torch.cuda.reset_peak_memory_stats(dev)
    model = "h100bench_" + "".join(c if c.isalnum() else "_"
                                   for c in cell.name)
    register_torch_model(model, prog.module(cfg, w, dev))
    name = f"{model}_{seed}"
    pipe = nt.parse_launch(traffic.describe(mix, prog, cfg, model),
                           pipeline=Pipeline(name=name))
    feeds = []
    for _, src, sink_element in traffic.branches(pipe):
        feeds.append(Feed(src, Sink(prog.answers)))
        sink_element.connect(feeds[-1].sink)

    warm = int(mix["warmup_windows"]) * batch
    prof = tl = None
    p0 = p1 = p0_ns = p1_ns = None
    fence0 = (0.0, 0)
    pauses = GcPauses()
    gc.callbacks.append(pauses)
    pipe.start()
    try:
        for f in feeds:
            for k in range(warm):
                if not f.src.push([pool[k % len(pool)]], pts=k):
                    raise RuntimeError("appsrc refused a warm-up frame")
                f.accepted.append(k)
        for f in feeds:
            if not f.sink.wait_for(warm, WARMUP_TIMEOUT_S):
                raise RuntimeError(f"{f.sink.frames} of {warm} warm-up "
                                   f"frames arrived in "
                                   f"{WARMUP_TIMEOUT_S:.0f} s")
        _say("warmed up")
        dues = [traffic.offsets(mix, seed, seconds, i)
                for i in range(len(feeds))]
        t_base = time.monotonic() + 0.01
        for f, due in zip(feeds, dues):
            f.pusher = Pusher(f.src, pool, warm,
                              None if due is None else t_base + due, batch)
            f.pusher.start()
        t0 = t_base + float(mix["preroll_s"])
        t1 = t0 + seconds
        time.sleep(max(t0 - time.monotonic(), 0.0))
        pauses.armed = True
        cpu0 = time.process_time()
        _say("window open")
        if trace:
            fence0 = _fence_total(name)
            time.sleep(max(t1 - min(LEDGER_S, seconds) - time.monotonic(),
                           0.0))
            tl = timeline.activate(LEDGER_RECORDS)
        if trace and on_card:
            from torch.profiler import ProfilerActivity, profile

            # the card's kernels, copies and the runtime calls that
            # launched them (no host operator events), over the window's
            # last PROFILE_S seconds
            prof = profile(activities=[ProfilerActivity.CUDA])
            time.sleep(max(t1 - min(PROFILE_S, 0.4 * seconds) -
                           time.monotonic(), 0.0))
            prof.start()
            p0, p0_ns = time.monotonic(), time.time_ns()
            _say("profiler started")
        time.sleep(max(t1 - time.monotonic(), 0.0))
        if prof is not None:
            p1, p1_ns = time.monotonic(), time.time_ns()
        cpu1 = time.process_time()
        pauses.armed = False
        _say("window closed")
        if trace:
            timeline.deactivate()
            fence1 = _fence_total(name)
        for f in feeds:
            f.pusher.stop.set()
        for f in feeds:
            f.pusher.join(DRAIN_TIMEOUT_S)
            if f.pusher.is_alive():
                raise RuntimeError("a pushing thread did not stop")
            f.src.end_of_stream()
        msg = pipe.wait(timeout=DRAIN_TIMEOUT_S)
        if msg is None or msg.kind != "eos":
            raise RuntimeError(f"the pipeline did not drain: {msg}")
        if on_card:
            torch.cuda.synchronize()
        _say("drained")
        if prof is not None:
            # stopped only once no thread launches work: stopping the
            # profiler under a concurrent graph replay has hung the process
            prof.stop()
            _say("profiler stopped")
    finally:
        gc.callbacks.remove(pauses)
        for f in feeds:
            if f.pusher is not None:
                f.pusher.stop.set()
        if trace and timeline.ACTIVE is not None:
            timeline.deactivate()
        pipe.stop()
    peak = torch.cuda.max_memory_allocated(dev) if on_card else 0
    regions = pipe.metrics_snapshot().get("regions", {})

    # each branch's answers in arrival order: its i-th frame out is the
    # i-th frame its source took
    arrivals, answers, index, window = [], [], [], []
    lost = refused = 0
    in_order = True
    for f, due in zip(feeds, dues):
        pushed = f.pusher.pushed
        f.accepted += [k for k, _, ok in pushed if ok]
        refused += sum(1 for _, _, ok in pushed if not ok)
        got_t, got = [], []
        for t, pts, ans in sorted(f.sink.records, key=lambda r: r[0]):
            if batch == 1 and pts is not None and \
                    len(got) < len(f.accepted) and \
                    pts != f.accepted[len(got)]:
                in_order = False
            got_t += [t] * len(ans)
            got += ans
        n = min(len(got), len(f.accepted))
        lost += len(f.accepted) - len(got)
        arrived = dict(zip(f.accepted[:n], got_t[:n]))
        arrivals += got_t
        answers += got[:n]
        index += [k % len(pool) for k in f.accepted[:n]]
        # each frame sent after the warm-up: its due time (open loop) or
        # push time (closed loop), and its arrival or None
        sent = ([(t, k) for k, t, _ in pushed] if due is None else
                [(t_base + d, warm + i) for i, d in enumerate(due)])
        window += [(t, arrived.get(k)) for t, k in sent if t0 <= t < t1]
    window.sort(key=lambda r: r[0])
    attempted = len(window)
    failed = sum(1 for _, a in window if a is None)

    sl = None
    if prof is not None:
        from h100bench import trace as tr

        sl = tr.reduce(tr.kineto_events(prof, p0_ns, p1_ns),
                       (p1 - p0) * 1e6)
        sl.frames = sum(1 for t in arrivals if p0 <= t < p1)
    ctx = SimpleNamespace(
        cfg=cfg, program=prog, traffic=mix, cell=cell.name,
        setup_s=t0 - t_process, t0=t0, t1=t1, window_s=seconds,
        arrivals=arrivals, window=window, open_loop=dues[0] is not None,
        window_frames=sum(1 for t in arrivals if t0 <= t < t1),
        ledger=tl.stage_breakdown() if tl is not None else None,
        fence=((fence1[0] - fence0[0], fence1[1] - fence0[1]) if trace
               else (0.0, 0)),
        slice=sl, regions=regions, count=cells.load_count)
    e2e = {}
    for m in cell.end_to_end:
        v = cells.load_metric(m["name"]).read(ctx)
        if v is not None:
            e2e[m["name"]] = v
    trend = {}
    lat = stats.latencies_ms(ctx)
    if lat:
        # a backlog that grows shows as a later quarter waiting longer
        q = max(len(lat) // 4, 1)
        trend = {"latency_p50_ms_first_quarter": stats.quantile(lat[:q], 50),
                 "latency_p50_ms_last_quarter": stats.quantile(lat[-q:], 50)}
    lateness = [(t - t_base - due[k - warm]) * 1e3
                for f, due in zip(feeds, dues) if due is not None
                for k, t, _ in f.pusher.pushed
                if t0 <= t_base + due[k - warm] < t1]

    # free the program before the reference runs: the peak is read
    unregister_torch_model(model)
    del pipe, feeds, src, sink_element
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    t_judge = time.monotonic()
    numbers = ref.judge(cfg, w, frames, prog.served(answers, index)) \
        if index else {}
    judge_s = time.monotonic() - t_judge
    limits = cfg.get("limits", {})
    checks = {k: {"value": v, "limit": limits.get(k)}
              for k, v in numbers.items()}
    correct = bool(index) and lost == 0 and in_order and all(
        c["limit"] is not None and c["value"] <= c["limit"]
        for c in checks.values())
    checks["frames_lost"] = {"value": lost, "limit": 0}
    checks["out_of_order"] = {"value": int(not in_order), "limit": 0}

    if trace:
        metrics = {}
        for m in cell.per_layer:
            v = cells.load_metric(m["name"]).read(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end if m["name"] in e2e}
    dev_info = {
        "platform": "gpu" if on_card else "cpu",
        "kind": torch.cuda.get_device_name(dev) if on_card else "cpu",
        "count": 1, "memory_peak_bytes": int(peak),
        "power": power_limit() if on_card else None}
    out = {"correct": correct, "attempted": attempted, "failed": failed,
           "metrics": metrics, "device": dev_info}
    if sl is not None:
        dev_info["busy_s"] = sl.busy_us / 1e6
        dev_info["window_s"] = sl.wall_us / 1e6
        out["breakdown"] = sl.breakdown()
    out["info"] = {
        "cell": cell.name, "seed": seed, "seconds": seconds,
        "frames_in_window": ctx.window_frames, "frames_out": len(arrivals),
        "refused_by_appsrc": refused, "judge_s": judge_s,
        "regions": regions, **e2e, **trend, **pauses.summary(),
        # the process's CPU seconds a second of the window: the host's
        # share of the work, next to the frames it got done
        "process_cpu_per_s": (cpu1 - cpu0) / seconds,
        **({"generator_late_ms_p50": stats.quantile(lateness, 50),
            "generator_late_ms_p99": stats.quantile(lateness, 99),
            "generator_late_ms_max": max(lateness)} if lateness else {})}
    out["checks"] = checks
    return out


def main(argv=None) -> int:
    t_process = process_start()
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    fix_caches()
    cell = cells.find_cell(args.workload)

    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"h100bench: {args.workload} needs {cell.chips} CUDA card(s), "
              f"found {n}", file=sys.stderr)
        return 2
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                   t_process=t_process)
    bad = forbidden_modules()
    if bad:
        print(f"h100bench: the run loaded {', '.join(bad)}", file=sys.stderr)
        return 3
    info = out.pop("info")
    checks = out.pop("checks")
    out["checks"] = checks  # the last key of the line
    print("h100bench info " + json.dumps(info), file=sys.stderr)
    for k, c in checks.items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out))
    sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
