#!/usr/bin/env python3
"""One traced run of a benchmark cell with the frame ledger's thread spans
on, and the card's idle time in it put down to the port's own threads.

    python3 tools/idle_causes.py --workload <cell> --seed <n> --seconds <s> [--threads 0|1]

From the root of a checkout, on a machine with the cell's cards. It is
``h100bench.run``'s traced run (``--trace 1``) with three additions: the
window's ledger is activated with ``threads=True`` (``--threads 0`` keeps
the benchmark's own ledger, to measure what the spans cost), each
pipeline thread's ``nns_thread_cpu_seconds_total`` is read as the window
opens and closes, and the profiled slice keeps its idle intervals. The
last line of standard output is the run's result line with one more key,
``threads``: the six thread metrics of ``h100bench/idle.py``
(``idle_*_share``, ``hot_thread_cpu_ms_per_frame``, ``convert_ms``),
each pipeline thread's CPU seconds a second of the window, the share of
the profiled slice each thread's spans cover and the share it waits in
(``wait_*``, ``fence_wait``), and the frames a second the sink received
in the ledger's slice. With ``--threads 0`` the idle shares,
``convert_ms`` and the shares of the slice are absent.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from types import SimpleNamespace

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from h100bench import cells, idle, run, trace  # noqa: E402


def thread_cpu(pipeline_name: str) -> dict:
    """``nns_thread_cpu_seconds_total`` of each thread of the pipeline."""
    from nnstreamer_tpu_torch.obs import get_registry

    return {m.labels["thread"]: m.value for m in get_registry().collect()
            if m.name == "nns_thread_cpu_seconds_total"
            and m.labels.get("pipeline") == pipeline_name}


class Probe:
    """The additions to one ``run.run_cell``: inside ``with Probe(...)``,
    over the functions the run calls by module attribute. ``numbers``
    raises where one of them was never called (the harness changed under
    the probe), rather than return fewer numbers."""

    def __init__(self, threads: bool, pipeline_name: str):
        self.threads = threads
        self.name = pipeline_name
        self.cpu = {}
        self.timeline = None
        self.bounds_ns = None
        self.device = None

    def __enter__(self):
        from nnstreamer_tpu_torch.obs import timeline

        say, activate = run._say, timeline.activate
        kineto, reduce = trace.kineto_events, trace.reduce
        self._orig = (say, activate, kineto, reduce)

        def _say(what):
            if what in ("window open", "window closed"):
                self.cpu[what] = thread_cpu(self.name)
            say(what)

        def _activate(capacity=1 << 16, threads=False):
            self.timeline = activate(capacity, threads=self.threads)
            return self.timeline

        def _kineto(prof, t0_ns, t1_ns):
            self.bounds_ns = (t0_ns, t1_ns)
            return kineto(prof, t0_ns, t1_ns)

        def _reduce(events, wall_us):
            events = list(events)
            self.device = [(a, b) for _, a, b, on in events if on]
            return reduce(events, wall_us)

        run._say, timeline.activate = _say, _activate
        trace.kineto_events, trace.reduce = _kineto, _reduce
        return self

    def __exit__(self, *exc):
        from nnstreamer_tpu_torch.obs import timeline

        run._say, timeline.activate, trace.kineto_events, trace.reduce = \
            self._orig

    def numbers(self, out: dict, seconds: float, batch: int) -> dict:
        on_card = out["device"]["platform"] == "gpu"
        missed = [f"run._say({w!r})" for w in ("window open", "window closed")
                  if w not in self.cpu]
        if self.timeline is None:
            missed.append("timeline.activate")
        if on_card and self.bounds_ns is None:
            missed.append("trace.kineto_events")
        if on_card and self.device is None:
            missed.append("trace.reduce")
        if missed:
            raise RuntimeError("idle_causes: the run never called "
                               + ", ".join(missed))
        cpu0, cpu1 = self.cpu["window open"], self.cpu["window closed"]
        per_thread = {t: cpu1[t] - cpu0.get(t, 0.0) for t in cpu1}
        info = out["info"]
        got = {"thread_cpu_per_s": {t: v / seconds
                                    for t, v in sorted(per_thread.items())}}
        ctx = SimpleNamespace(thread_cpu_s=per_thread,
                              window_frames=info["frames_in_window"],
                              slice=None, ledger_spans=None)
        hot = idle.hot_thread_cpu_ms_per_frame(ctx)
        if hot is not None:
            got["hot_thread_cpu_ms_per_frame"] = hot
        tl = self.timeline
        ledger = tl.stage_breakdown()
        got["ledger_frames_per_s"] = ledger["frames"] * batch / min(
            run.LEDGER_S, seconds)
        if not self.threads:
            return got
        ctx.ledger_spans = [(th, k, s, a / 1e3, None if b is None else b / 1e3,
                             tr, ar)
                            for th, k, s, a, b, tr, ar in
                            tl.profiler_records()]
        conv = idle.exclusive_chain_ms(ctx.ledger_spans)
        if conv is not None:
            got["convert_ms"] = conv
        if on_card:
            t0, t1 = (t / 1e3 for t in self.bounds_ns)
            ctx.slice = SimpleNamespace(
                wall_us=out["device"]["window_s"] * 1e6,
                busy_us=out["device"]["busy_s"] * 1e6,
                idle=idle.idle_intervals(self.device, t0, t1))
            shares = idle.idle_shares(ctx)
            if shares:
                got.update(shares)
                got["idle_shares_sum"] = sum(shares.values())
            got["thread_cover"] = idle.thread_cover(ctx.ledger_spans, t0, t1)
            got["thread_waiting"] = idle.thread_cover(
                ctx.ledger_spans, t0, t1, idle.WAITS + ("fence_wait",))
        return got


def main(argv=None) -> int:
    t_process = run.process_start()
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--threads", type=int, choices=(0, 1), default=1)
    args = ap.parse_args(argv)
    run.fix_caches()
    cell = cells.find_cell(args.workload)

    import torch

    if not torch.cuda.is_available():
        print("idle_causes: needs a CUDA card", file=sys.stderr)
        return 2
    model = "h100bench_" + "".join(c if c.isalnum() else "_"
                                   for c in cell.name)
    with Probe(bool(args.threads), f"{model}_{args.seed}") as probe:
        out = run.run_cell(cell, args.seed, args.seconds, True,
                           t_process=t_process)
    out["threads"] = probe.numbers(out, args.seconds,
                                   int(cell.traffic["batch"]))
    print("idle_causes info " + json.dumps(out.pop("info")), file=sys.stderr)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
