"""nns-launch — the gst-launch-1.0 equivalent CLI, on the port.

Port of ``nnstreamer_tpu/cli.py``. The reference's CLI *is*
``gst-launch-1.0 <pipeline description>``; the same holds here::

    python -m nnstreamer_tpu_torch.cli "videotestsrc num-buffers=30 ! \
        tensor_converter ! tensor_filter framework=jax model=m ! tensor_sink"

(or the ``nns-launch-torch`` console script). The pipeline runs on the
package device, ``cuda:0``; ``--platforms cpu`` asks for the CPU
(``set_device("cpu")``). Without CUDA and without that request the CLI
reports the missing card and exits non-zero before building anything.

Options, as the JAX CLI's:
  -q / --quiet     suppress the per-element stats summary
  -t / --timeout   seconds to wait for EOS (default: run to EOS)
  -v / --verbose   print each buffer a sink receives
  --confchk        print the effective configuration, the device and the
                   registries, and exit
  --check          statically verify the description without running it:
                   the NNS0xx diagnostics of ``analysis/verify.py``
                   (unknown factories and properties, caps
                   intersections, dangling pads, cycles, policy
                   conflicts) against the port's registry; exit 1 on
                   an error-severity diagnostic
  --scaffold KIND NAME
                   write subplugin boilerplate (filter, decoder or
                   converter) importing from nnstreamer_tpu_torch, named
                   ``nnstreamer_tpu_torch_<kind>_<name>.py``: the file
                   the registry finds on NNSTREAMER_TPU_<KIND>_PATH
  --dot FILE       write the started graph (fused regions as clusters)
  --metrics-port, --trace-out, --flight-dir, --slo-budget-ms, --lanes,
  --inflight, --error-policy, --watchdog-s
                   as in the JAX CLI; the ``/metrics.json`` of
                   --metrics-port also carries ``regions`` (each fused
                   region's eager frames, replays, captures) and
                   ``launches`` (the kernel wrappers' counts,
                   ``ops/_counts.py``), which the JAX CLI has not
  --export MODEL OUT
                   export a model (a ``.pt``/``.pth`` file or a registered
                   name) to a ``torch.export`` ``.pt2`` artifact
                   (``filters/artifact.py``); ``--input``/``--inputtype``
                   give or override its input shapes, ``--custom`` is
                   accepted for the JAX CLI's sake
  --checkpoint-dir DIR
                   checkpoint the serving state at stop and restore it at
                   start (``pipeline/continuity.py``)
  --compile-cache DIR
                   keep the kernel libraries in DIR/kernels, so a later
                   run on the same checkout builds none
  --fleet ENDPOINTS
                   with --metrics-port, serve the merged view of replica
                   metrics at /fleet/metrics (``obs/distributed.py``):
                   a comma list of host:port ``/metrics.json`` endpoints,
                   or ``op=NAME[,broker=HOST[:PORT]]`` for the replicas
                   that advertise a metrics port under that operation
"""

from __future__ import annotations

import argparse
import os
import sys


def device_line() -> str:
    """The device the package computes on, for the CLI's banner and
    ``--confchk``: the CUDA card's name, or the CPU when asked for."""
    import torch

    from nnstreamer_tpu_torch.device import get_device

    dev = get_device()
    if dev.type != "cuda":
        return f"{dev} (asked for)"
    if not torch.cuda.is_available():
        return f"{dev} unavailable (torch {torch.__version__}, no CUDA)"
    idx = dev.index or 0
    return (f"{dev} {torch.cuda.get_device_name(idx)} "
            f"({torch.cuda.device_count()} device(s), torch "
            f"{torch.__version__}, CUDA {torch.version.cuda})")


def confchk() -> int:
    """Dump effective config, the device and the registries (reference
    confchk.c)."""
    from nnstreamer_tpu_torch import elements  # noqa: F401 — registers
    from nnstreamer_tpu_torch import native
    from nnstreamer_tpu_torch.config import ENV_PREFIX, get_conf
    from nnstreamer_tpu_torch.registry import (
        CONVERTER,
        DECODER,
        ELEMENT,
        FILTER,
        registered_names,
    )

    conf = get_conf(refresh=True)
    print("nnstreamer_tpu_torch configuration")
    print(f"  conf file : {conf.path or '(none found)'}")
    envs = sorted(k for k in os.environ
                  if k.startswith(ENV_PREFIX) or k.startswith("NNSTPU_"))
    print(f"  env overrides : {', '.join(envs) if envs else '(none)'}")
    allowed = conf.allowed_elements()
    print(f"  element restriction : "
          f"{'ENABLED' if allowed is not None else 'disabled'}")
    if allowed is not None:
        print(f"    allowlist: {', '.join(sorted(allowed)) or '(empty)'}")
    print(f"  native runtime : "
          f"{'available' if native.available() else 'NOT built'}")
    print(f"  device : {device_line()}")
    for kind, label in ((ELEMENT, "elements"), (FILTER, "filters"),
                        (DECODER, "decoders"), (CONVERTER, "converters")):
        names = registered_names(kind)
        print(f"  {label} ({len(names)}): {', '.join(names)}")
    return 0


_SCAFFOLDS = {
    "filter": '''"""Custom filter subplugin "{name}".

Drop this file's directory onto the filter search path and the registry
discovers it on first use (the reference's dlopen-from-conf-paths flow):

    export NNSTREAMER_TPU_FILTER_PATH=$PWD
    nns-launch-torch "... ! tensor_filter framework={name} model=x ! ..."
"""

import numpy as np

from nnstreamer_tpu_torch.filters.api import FilterFramework, FilterProperties
from nnstreamer_tpu_torch.registry import FILTER, subplugin
from nnstreamer_tpu_torch.tensors.types import TensorsInfo


@subplugin(FILTER, "{name}")
class {cls}(FilterFramework):
    NAME = "{name}"

    def open(self, props: FilterProperties) -> None:
        super().open(props)
        # load/prepare your model here; props.model / props.custom are set

    def get_model_info(self):
        # (None, None) = adapt to any input; set_input_info decides output.
        # Return fixed TensorsInfo pairs instead for a fixed-shape model.
        return None, None

    def set_input_info(self, in_info: TensorsInfo) -> TensorsInfo:
        self._info = in_info
        return in_info  # passthrough: output shapes = input shapes

    def invoke(self, inputs):
        # inputs: list of arrays; return list of output arrays
        return [np.asarray(x) for x in inputs]
''',
    "decoder": '''"""Custom decoder subplugin "{name}".

    export NNSTREAMER_TPU_DECODER_PATH=$PWD
    nns-launch-torch "... ! tensor_decoder mode={name} ! ..."
"""

import numpy as np

from nnstreamer_tpu_torch.pipeline.caps import Caps
from nnstreamer_tpu_torch.registry import DECODER, subplugin


@subplugin(DECODER, "{name}")
class {cls}:
    def out_caps(self, config, options) -> Caps:
        return Caps("other/tensors", {{"format": "flexible"}})

    def decode(self, buf, config, options):
        # buf.tensors are host numpy arrays; return a new TensorBuffer
        return buf.with_tensors([np.asarray(t) for t in buf.tensors])

    # Optional fused-device split — delete if host-only:
    # def device_kernel(self, options):
    #     def fn(consts, tensors):  # torch ops, replayed in the fused region
    #         return tensors
    #     return None, fn
    # def host_finalize(self, host_buf, config, options):
    #     return host_buf
''',
    "converter": '''"""Custom converter subplugin "{name}".

    export NNSTREAMER_TPU_CONVERTER_PATH=$PWD
    nns-launch-torch "... ! tensor_converter mode=custom-code:{name} ! ..."
"""

from nnstreamer_tpu_torch.registry import CONVERTER, subplugin
from nnstreamer_tpu_torch.tensors.buffer import TensorBuffer


@subplugin(CONVERTER, "{name}")
class {cls}:
    def convert(self, buf: TensorBuffer, in_caps) -> TensorBuffer:
        # parse buf.tensors (host arrays) into the tensors you want to emit
        return buf
''',
}


def scaffold(kind: str, name: str, out_dir: str = ".") -> int:
    """Write subplugin boilerplate (reference codegen tool equivalent)."""
    import keyword
    import os
    import re

    from nnstreamer_tpu_torch.registry import external_subplugin_filename

    if kind not in _SCAFFOLDS:
        print(f"nns-launch-torch: unknown scaffold kind {kind!r} "
              f"(choose from {', '.join(_SCAFFOLDS)})", file=sys.stderr)
        return 2
    if not re.fullmatch(r"[A-Za-z_][A-Za-z0-9_-]*", name):
        print(f"nns-launch-torch: invalid subplugin name {name!r}",
              file=sys.stderr)
        return 2
    cls = "".join(p.capitalize() for p in re.split(r"[_-]+", name))
    # guard the generated class name: keywords ("none" → None), digit-leading
    # segments ("_1a" → 1a), or shadowing a template import ("caps" → Caps)
    if not cls or not cls[0].isalpha():
        cls = "Plugin" + cls
    if (not cls.isidentifier() or keyword.iskeyword(cls)
            or cls in ("TensorBuffer", "TensorsInfo", "Caps",
                       "FilterFramework", "FilterProperties")):
        cls += "Plugin"
    # the registry's external search looks for exactly this filename on the
    # NNSTREAMER_TPU_<KIND>_PATH search path
    path = os.path.join(out_dir, external_subplugin_filename(kind, name))
    if os.path.exists(path):
        print(f"nns-launch-torch: {path} already exists", file=sys.stderr)
        return 2
    with open(path, "w") as f:
        f.write(_SCAFFOLDS[kind].format(name=name, cls=cls))
    print(f"wrote {path} ({kind} subplugin '{name}') — add its directory to "
          f"NNSTREAMER_TPU_{kind.upper()}_PATH to use it")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="nns-launch-torch",
        description="Run a pipeline description on nnstreamer_tpu_torch "
                    "(gst-launch-1.0 equivalent).",
    )
    ap.add_argument("description", nargs="*",
                    help="pipeline description (may be multiple tokens)")
    ap.add_argument("-t", "--timeout", type=float, default=None)
    ap.add_argument("-q", "--quiet", action="store_true")
    ap.add_argument("-v", "--verbose", action="store_true")
    ap.add_argument("--confchk", action="store_true",
                    help="print effective configuration and exit")
    ap.add_argument("--check", action="store_true",
                    help="statically verify the description (graph, "
                         "caps, policy conflicts: the NNS0xx "
                         "diagnostics) without running it; exit 1 on "
                         "errors")
    ap.add_argument("--scaffold", nargs=2, metavar=("KIND", "NAME"),
                    help="write subplugin boilerplate (KIND: filter, "
                         "decoder or converter) to the current "
                         "directory and exit")
    ap.add_argument("--dot", metavar="FILE",
                    help="write the started pipeline graph (fused "
                         "regions included) as Graphviz dot to FILE")
    ap.add_argument("--metrics-port", type=int, default=None,
                    metavar="PORT",
                    help="serve live Prometheus metrics on "
                         "http://0.0.0.0:PORT/metrics (JSON at "
                         "/metrics.json) while the pipeline runs; "
                         "0 picks a free port (printed at startup)")
    ap.add_argument("--fleet", default=None, metavar="ENDPOINTS",
                    help="federate replica metrics: comma list of "
                         "host:port /metrics.json endpoints (or "
                         "op=NAME[,broker=HOST[:PORT]] for broker "
                         "discovery); merged fleet view served at "
                         "/fleet/metrics on the --metrics-port server")
    ap.add_argument("--export", nargs=2, metavar=("MODEL", "OUT"),
                    help="export a model (a .py with get_model(), a "
                         ".msgpack with --custom module:<factory>, a "
                         ".pt/.pth file or a registered name) to a "
                         "torch.export .pt2 artifact, its batch "
                         "dimension dynamic, and exit")
    ap.add_argument("--platforms", default=None,
                    help="'cpu' runs the package on the CPU "
                         "(set_device('cpu')); 'cuda' (the default) on "
                         "cuda:0")
    ap.add_argument("--custom", default=None,
                    help="custom options for --export (e.g. "
                         "module:mobilenet_v2 for a .msgpack)")
    ap.add_argument("--input", default=None,
                    help="input dims for --export (caps grammar, e.g. "
                         "3:224:224:1)")
    ap.add_argument("--inputtype", default=None,
                    help="input types for --export (e.g. uint8)")
    ap.add_argument("--inflight", type=int, default=None, metavar="K",
                    help="override the dispatch-window depth on every "
                         "element that has an 'inflight' property "
                         "(tensor_filter and fused regions); 0 fences "
                         "every batch, the default is 2")
    ap.add_argument("--lanes", type=int, default=None, metavar="N",
                    help="run the replicable pre-queue ingest segment "
                         "across N worker lanes with in-order reassembly; "
                         "1 is the serial path, NNSTPU_LANES overrides")
    ap.add_argument("--trace-out", metavar="FILE", default=None,
                    help="record the per-frame timeline and write it as "
                         "Perfetto/Chrome trace JSON to FILE at EOS; "
                         "prints the per-stage latency breakdown")
    ap.add_argument("--flight-dir", metavar="DIR", default=None,
                    help="write rate-limited flight-recorder dumps (span "
                         "detail around tail-latency offenders, deadline "
                         "breaches, faults and watchdog trips) as JSON "
                         "files under DIR; the always-on recorder needs "
                         "no flag — NNSTPU_FLIGHT=DIR does the same, "
                         "NNSTPU_FLIGHT=0 turns recording off")
    ap.add_argument("--checkpoint-dir", metavar="DIR", default=None,
                    help="write the serving state (repo slots, scheduler "
                         "estimates, residency order, flight quantiles) "
                         "to DIR at stop and restore it at start; "
                         "NNSTPU_CHECKPOINT=DIR does the same")
    ap.add_argument("--compile-cache", metavar="DIR", default=None,
                    help="build and find the CUDA kernel libraries in "
                         "DIR/kernels: a second run builds none; "
                         "NNSTPU_COMPILE_CACHE=DIR does the same")
    ap.add_argument("--slo-budget-ms", type=float, default=None,
                    metavar="MS",
                    help="pipeline-wide SLO latency budget: deadline "
                         "admission, earliest-deadline-first ordering, "
                         "late-first shedding and feedback-tuned batch "
                         "forming on the admission-point queues; unset/0 "
                         "keeps the plain FIFO path")
    ap.add_argument("--error-policy", default=None, metavar="POLICY",
                    choices=("halt", "skip-frame", "retry", "degrade"),
                    help="pipeline-default element error policy: halt "
                         "(the default), skip-frame, retry or degrade")
    ap.add_argument("--watchdog-s", type=float, default=None, metavar="S",
                    help="fail the pipeline when no frame progresses for "
                         "S seconds while work is in flight; "
                         "NNSTPU_WATCHDOG_S does the same")
    args = ap.parse_args(argv)

    if args.scaffold:
        return scaffold(*args.scaffold)
    if not args.export and (args.custom or args.input or args.inputtype):
        ap.error("--custom/--input/--inputtype only apply with --export "
                 "(in a pipeline description, set them as element "
                 "properties instead)")
    if args.export:
        from nnstreamer_tpu_torch.filters.artifact import export_model

        model, out = args.export
        try:
            out_info = export_model(model, out, custom=args.custom,
                                    input_dims=args.input,
                                    input_types=args.inputtype)
        except Exception as e:  # noqa: BLE001 — the CLI reports any failure
            print(f"nns-launch: export failed: {e}", file=sys.stderr)
            return 1
        print(f"Exported {model} -> {out} (outputs: {out_info})")
        return 0
    if args.compile_cache is not None:
        from nnstreamer_tpu_torch.pipeline.continuity import (
            enable_compile_cache,
        )

        enable_compile_cache(args.compile_cache)
    if args.platforms is not None:
        plat = args.platforms.strip().lower()
        if plat == "cpu":
            from nnstreamer_tpu_torch.device import set_device

            set_device("cpu")
        elif plat not in ("cuda", "gpu"):
            ap.error(f"--platforms {args.platforms!r}: the port runs on "
                     "'cuda' (the default) or 'cpu'")
    if args.confchk:
        return confchk()
    if not args.description:
        ap.error("pipeline description required (or --confchk)")

    from nnstreamer_tpu_torch import parse_launch
    from nnstreamer_tpu_torch.device import resolve_device
    from nnstreamer_tpu_torch.elements.sink import TensorSink

    desc = " ".join(args.description)
    if args.check:
        from nnstreamer_tpu_torch.analysis.diagnostics import (
            has_errors,
            render_text,
        )
        from nnstreamer_tpu_torch.analysis.verify import verify_description

        diags = verify_description(desc)
        if diags or not args.quiet:
            print(render_text(diags))
        return 1 if has_errors(diags) else 0
    try:
        # the package device first: no card and no --platforms cpu is an
        # error before anything is built
        resolve_device()
    except RuntimeError as e:
        print(f"nns-launch: ERROR: {e}", file=sys.stderr)
        return 1
    print(f"Device: {device_line()}")
    try:
        pipe = parse_launch(desc)
    except (ValueError, KeyError) as e:
        print(f"nns-launch: parse error: {e}", file=sys.stderr)
        return 2

    if args.inflight is not None:
        for el in pipe.elements:
            if "inflight" in el._props:
                el.set_property("inflight", max(0, args.inflight))
    if args.lanes is not None:
        pipe.lanes = max(1, args.lanes)
    if args.slo_budget_ms is not None:
        pipe.slo_budget_ms = max(0.0, args.slo_budget_ms)
    if args.error_policy is not None:
        pipe.error_policy = args.error_policy
    if args.watchdog_s is not None:
        pipe.watchdog_s = max(0.0, args.watchdog_s)
    if args.flight_dir is not None:
        pipe.flight_dir = args.flight_dir
    if args.checkpoint_dir is not None:
        pipe.checkpoint_dir = args.checkpoint_dir

    if args.verbose:
        for el in pipe.elements:
            if isinstance(el, TensorSink):
                el.connect(lambda buf, name=el.name:
                           print(f"{name}: {buf!r}"))

    from nnstreamer_tpu_torch.obs import timeline as _timeline

    trace_tl = None
    if args.trace_out is not None:
        trace_tl = _timeline.activate()

    metrics_srv = None
    if args.metrics_port is not None:
        from nnstreamer_tpu_torch.obs import MetricsServer

        federation = None
        if args.fleet:
            federation = _parse_fleet(args.fleet)

        from nnstreamer_tpu_torch.ops._counts import LAUNCHES

        def _extra_sections(p=pipe):
            # the in-process metrics_snapshot()'s recorder sections, on
            # the scraped /metrics.json too; and what only this process
            # counts: its fused regions' eager frames, replays and
            # captures, and its kernel wrappers' launches (a fleet
            # replica's, read through the federation's scrape)
            snap = p.metrics_snapshot()
            out = {k: snap[k] for k in ("slo", "attribution", "quantiles",
                                        "regions") if k in snap}
            out["launches"] = dict(LAUNCHES)
            return out

        metrics_srv = MetricsServer(port=args.metrics_port,
                                    snapshot_fn=_extra_sections,
                                    federation=federation).start()
        print(f"Serving metrics on "
              f"http://0.0.0.0:{metrics_srv.port}/metrics")
        if federation is not None:
            print(f"Serving fleet federation on "
                  f"http://0.0.0.0:{metrics_srv.port}/fleet/metrics")

    print(f"Setting pipeline to PLAYING ({len(pipe.elements)} elements)...")
    try:
        try:
            if args.dot:
                # opened BEFORE start so a bad path fails with nothing
                # running; fusion happens at start, so the dump shows
                # the real graph
                with open(args.dot, "w") as f:
                    pipe.start()
                    f.write(pipe.to_dot())
                print(f"Wrote pipeline graph to {args.dot}")
            msg = pipe.run(timeout=args.timeout)
        except Exception as e:  # noqa: BLE001 — CLI reports any failure
            pipe.stop()  # idempotent; reaps anything --dot start()ed
            print(f"nns-launch: ERROR: {e}", file=sys.stderr)
            return 1
        if msg is None:
            print("nns-launch: timeout waiting for EOS", file=sys.stderr)
            return 3
        print("Got EOS from pipeline.")

        if not args.quiet:
            _print_stats(pipe)
        if trace_tl is not None:
            try:
                trace_tl.export_chrome(args.trace_out)
            except OSError as e:
                print(f"nns-launch: trace export failed: {e}",
                      file=sys.stderr)
                return 1
            print(f"Wrote frame timeline to {args.trace_out} "
                  f"(load in ui.perfetto.dev)")
            _print_trace_breakdown(trace_tl)
        return 0
    finally:
        if trace_tl is not None:
            _timeline.deactivate()
        # the exporter outlives EOS so a scraper can collect the final
        # counters; it stops only when the CLI is about to return
        if metrics_srv is not None:
            metrics_srv.stop()


def _parse_fleet(spec: str):
    """``--fleet`` argument → FederatedMetrics: either a comma list of
    ``host:port`` scrape endpoints, or ``op=NAME[,broker=HOST[:PORT]]``
    for broker discovery of replicas advertising a metrics_port."""
    from nnstreamer_tpu_torch.obs.distributed import FederatedMetrics

    parts = [p.strip() for p in spec.split(",") if p.strip()]
    if any(p.startswith("op=") for p in parts):
        operation = broker_host = None
        broker_port = 1883
        for p in parts:
            k, _, v = p.partition("=")
            if k == "op":
                operation = v
            elif k == "broker":
                h, _, pp = v.partition(":")
                broker_host = h
                if pp:
                    broker_port = int(pp)
        fed = FederatedMetrics(operation=operation,
                               broker_host=broker_host or "127.0.0.1",
                               broker_port=broker_port)
        fed.discover()
        return fed
    endpoints = []
    for p in parts:
        host, _, port = p.rpartition(":")
        endpoints.append((host or "127.0.0.1", int(port)))
    return FederatedMetrics(endpoints=endpoints)


def _print_trace_breakdown(tl) -> None:
    """Post-EOS stage-breakdown footer for --trace-out: where a frame's
    end-to-end time went, and which stage owns the run's variance."""
    bd = tl.stage_breakdown()
    if not bd["frames"]:
        print("-- frame timeline: no completed frames recorded")
        return
    stages = " ".join(f"{k}={v:.2f}" for k, v in bd["stages_ms"].items()
                      if v > 0.0)
    print(f"-- frame timeline: {bd['frames']} frames, "
          f"e2e mean {bd['e2e_mean_ms']:.2f}ms, stages(ms) {stages}, "
          f"unattributed {bd['unattributed_ms']:.2f}ms "
          f"(reconciliation {bd['reconciliation']:.2f})")
    vr = tl.variance_report()
    if vr["dominant_stage"] is not None:
        print(f"-- frame timeline: e2e spread (MAD) "
              f"{vr['e2e_mad_ms']:.2f}ms, dominated by "
              f"{vr['dominant_stage']} "
              f"({vr['dominant_share']:.0%} of the spread)")


def _print_stats(pipe) -> None:
    """Post-EOS per-element table from the metrics snapshot: the
    InvokeStats trio plus drops and end-to-end tail latency, then the
    pool, lanes, scheduler and flight-recorder lines."""
    full = pipe.metrics_snapshot()
    snap = full["elements"]
    print("-- element stats (latency µs / throughput milli-out/s / "
          "invokes / drops / e2e p50,p99 ms)")
    for el in pipe.elements:
        s = snap[el.name]
        drops = s.get("drops", s.get("qos_drops"))
        e2e = (f"{s['e2e_p50_ms']:.1f},{s['e2e_p99_ms']:.1f}"
               if "e2e_p50_ms" in s else "-")
        print(f"  {el.name:28s} {s['latency_us']:>8d}  "
              f"{s['throughput_milli']:>10d}  {s['invokes']:>8d}  "
              f"{drops if drops is not None else '-':>6}  {e2e:>12s}")
    pool = full.get("pool")
    if pool and (pool["hits"] or pool["misses"]):
        print(f"-- ingest pool: hit-rate {pool['hit_rate']:.1%} "
              f"({pool['hits']} hits / {pool['misses']} misses, "
              f"{pool['outstanding']} outstanding)")
    for name, s in (full.get("lanes") or {}).items():
        print(f"-- ingest lanes {name}: {s['lanes']} lanes, "
              f"{s['forwarded']} frames, {s['ingest_fps']:.0f} fps, "
              f"reorder stall {s.get('reorder_stall_s', 0.0):.3f}s")
    sched = full.get("scheduler")
    if sched:
        print(f"-- slo scheduler: budget {sched['budget_ms']:.0f}ms, "
              f"{sched['admitted']} admitted / {sched['rejected']} "
              f"rejected / {sched['shed_late'] + sched['shed_capacity']} "
              f"shed, p99 {sched['p99_ms']:.1f}ms, "
              f"batch-cap {sched['batch_cap']}, "
              f"inflight {sched['inflight_target']}, "
              f"lanes-hint {sched['lanes_hint']}")
    slo = full.get("slo")
    if slo:
        e2e = slo["stages"].get("e2e")
        if e2e:
            print(f"-- flight recorder: {slo['completed']} frames, "
                  f"e2e p50 {e2e['p50_ms']:.2f}ms / "
                  f"p99 {e2e['p99_ms']:.2f}ms (streaming)")
        burn = slo.get("burn")
        if burn:
            print(f"-- slo burn: fast {burn['fast']:.2f}x / "
                  f"slow {burn['slow']:.2f}x of error budget "
                  f"(budget {burn['budget_ms']:.0f}ms"
                  f"{', OVERLOADED' if burn['overloaded'] else ''})")
        dumps = slo.get("dumps")
        if dumps and (dumps["written"] or dumps["suppressed"]):
            print(f"-- flight dumps: {dumps['written']} written / "
                  f"{dumps['suppressed']} rate-limited"
                  + (f", last: {dumps['paths'][-1]}"
                     if dumps["paths"] else ""))
    attr = full.get("attribution")
    if attr and attr.get("dominant_stage"):
        print(f"-- variance attribution: e2e spread (MAD) "
              f"{attr['e2e_mad_ms']:.2f}ms, dominated by "
              f"{attr['dominant_stage']} "
              f"({attr['dominant_share']:.0%} of the spread)"
              + (f", hints {attr['hints']}" if attr["hints"] else ""))


if __name__ == "__main__":
    sys.exit(main())
