#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``nnstreamer_tpu_torch``).

Run from the root of a checkout on a machine with one NVIDIA GPU::

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``nnstreamer_tpu_torch/csrc``,
holds each against its plain PyTorch version on the card, then drives the
flagship classification pipeline (videotestsrc → tensor_converter →
tensor_transform → tensor_filter MobileNetV2 → tensor_decoder
image_labeling → queue → tensor_sink) through
``nnstreamer_tpu_torch.parse_launch`` at the model's full width: 224×224×3
uint8 frames, MobileNetV2 width 1.0, 1001 classes, bfloat16 weights made
from a seed. Each phase prints one JSON line; the script exits non-zero at
the first failed check, and prints the ``{"ok": true, ...}`` line last
only when every phase passed. Without CUDA, or without the package beside
it, it exits non-zero and prints no result.

It imports nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))

#: published peaks of one H100 SXM (NVIDIA data sheet): HBM bytes/s and
#: float32 FLOP/s outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12

FRAMES = 240          # pipeline frames in the measured run
WARMUP_FRAMES = 16    # pipeline frames before it (cuDNN set-up, allocator)
IMAGE = 224
CLASSES = 1001
PROFILED_FRAMES = 48  # pipeline frames in a run under torch.profiler
LOGIT_FRAMES = 4      # frames whose logits are held to the fp32 CPU model
REL_L2_MAX = 2e-2     # bf16 on the card vs fp32 on the CPU, 53 layers
TRANSFORM_CHAIN = [("add", -127.5), ("div", 127.5)]
NORMALIZE_U8_CHAIN = [("sub", 127.5), ("mul", 1.0 / 127.5)]


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def gpu_name_and_power_limit() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0].strip()


def device_time_ms(fn, launches: int = 200):
    """Mean device time of one call of ``fn`` (every kernel and copy it
    runs), from a ``torch.profiler`` trace; None when the trace holds no
    device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(launches):
            fn()
        torch.cuda.synchronize()
    total_us = 0.0
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            total_us += ev.time_range.elapsed_us()
    return total_us / launches / 1e3 if total_us > 0 else None


def cuda_time_ms(fn, launches: int = 200, repeats: int = 7) -> float:
    """Median over ``repeats`` of the mean time of ``launches`` back-to-back
    calls, by CUDA events."""
    import torch

    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(launches):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / launches)
    return statistics.median(times)


# -- phase 2: build ---------------------------------------------------------
def phase_build():
    from nnstreamer_tpu_torch.ops import _build

    t0 = time.monotonic()
    paths = _build.build_all()
    seconds = time.monotonic() - t0
    emit({"phase": "build", "seconds": seconds,
          "libraries": {n: str(p.relative_to(HERE)) for n, p in paths.items()},
          "ptxas": {n: [ln for ln in str(r["output"]).splitlines()
                        if "registers" in ln or "spill" in ln]
                    for n, r in _build.build_log.items()}})


# -- phase 3: kernel B1 against its plain version ---------------------------
def _bits(t):
    import torch

    return t.view({4: torch.int32, 2: torch.int16}[t.element_size()])


def phase_normalize():
    import torch

    from nnstreamer_tpu_torch.ops import preprocess as pp

    dev = torch.device("cuda:0")
    gen = torch.Generator(device="cpu").manual_seed(0)
    shapes = [(224, 224, 3), (8, 224, 224, 3), (1,), (15,), (17,),
              (10 ** 6 + 3,)]
    outs = [torch.float32, torch.bfloat16, torch.float16]
    chains = {"transform": TRANSFORM_CHAIN, "normalize_u8": NORMALIZE_U8_CHAIN}
    cases = 0
    max_abs_err = 0.0
    for shape in shapes:
        n = 1
        for d in shape:
            n *= d
        for in_dtype in (torch.uint8, torch.float32):
            for offset in (0, 1, 3):
                if in_dtype is torch.uint8:
                    base = torch.randint(0, 256, (n + offset,), generator=gen,
                                         dtype=torch.uint8)
                else:
                    base = torch.randn(n + offset, generator=gen) * 200.0
                x = base.to(dev)[offset:].view(shape)
                for cname, ops in chains.items():
                    for out_dtype in outs:
                        y = pp.normalize_chain(x, ops, out_dtype)
                        ref = pp.normalize_chain_reference(x, ops, out_dtype)
                        torch.cuda.synchronize()
                        check(y.shape == ref.shape and y.dtype == ref.dtype,
                              f"normalize_chain {shape} {out_dtype}: shape "
                              f"or dtype differs")
                        same = torch.equal(_bits(y), _bits(ref))
                        err = (y.float() - ref.float()).abs().max().item()
                        max_abs_err = max(max_abs_err, err)
                        check(same, f"normalize_chain {cname} {shape} "
                                    f"{in_dtype}->{out_dtype} offset "
                                    f"{offset}: not bit-identical to the "
                                    f"plain version (max abs err {err})")
                        cases += 1

    # times at the main path's shape: one 224x224x3 uint8 frame -> float32
    x = torch.randint(0, 256, (1, IMAGE, IMAGE, 3), generator=gen,
                      dtype=torch.uint8).to(dev)
    x8 = torch.randint(0, 256, (8, IMAGE, IMAGE, 3), generator=gen,
                       dtype=torch.uint8).to(dev)
    times = {}
    timed = {}
    for tag, xin in (("", x), ("batch8_", x8)):
        def kernel(xin=xin):
            return pp.normalize_chain(xin, TRANSFORM_CHAIN, torch.float32)

        def plain(xin=xin):
            return pp.normalize_chain_reference(xin, TRANSFORM_CHAIN,
                                                torch.float32)

        # calls back to back, by CUDA events: what a caller of the wrapper
        # gets, host overhead included
        times[f"{tag}ms"] = cuda_time_ms(kernel)
        times[f"{tag}plain_ms"] = cuda_time_ms(plain)
        timed[tag] = (kernel, plain)
    bytes_moved = x.numel() * (1 + 4)      # uint8 in once, float32 out once
    flops = x.numel() * len(TRANSFORM_CHAIN)
    bytes_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / FP32_FLOPS * 1e3
    result = {
        "cases": cases, "bit_identical": True, "max_abs_err": max_abs_err,
        "bytes": bytes_moved, "flops": flops,
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "batch8_bound_ms": 8 * max(bytes_ms, ops_ms), **times,
    }
    emit({"phase": "normalize_chain", **result})
    return result, timed


def phase_device_times(timed) -> None:
    """Device time alone of the kernel and its plain version, from
    ``torch.profiler`` traces. Run after the pipeline phase: once the
    profiler has traced the card, later launches cost the host more."""
    out = {}
    for tag, (kernel, plain) in timed.items():
        out[f"{tag}device_ms"] = device_time_ms(kernel)
        out[f"{tag}plain_device_ms"] = device_time_ms(plain)
    emit({"phase": "normalize_chain_device_time", **out})


# -- phase 4: the flagship pipeline -----------------------------------------
def phase_pipeline(power: str):
    import torch

    import nnstreamer_tpu_torch as nt
    from nnstreamer_tpu_torch.filters.torch_backend import (
        register_torch_model,
        unregister_torch_model,
    )
    from nnstreamer_tpu_torch.models.mobilenet_v2 import mobilenet_v2
    from nnstreamer_tpu_torch.ops import preprocess as pp

    nt.set_device(None)  # the package default: cuda:0
    module, in_info, out_info = mobilenet_v2(
        num_classes=CLASSES, image_size=IMAGE, dtype=torch.bfloat16, seed=0)
    register_torch_model("mnv2", module, in_info, out_info)

    seen = {"calls": 0, "param_devices": set(), "transform_out": set(),
            "samples": []}

    def forward_hook(mod, args, out):
        seen["calls"] += 1
        seen["param_devices"].add(str(next(mod.parameters()).device))
        if len(seen["samples"]) < LOGIT_FRAMES:
            seen["samples"].append((args[0].detach().float().cpu(),
                                    out.detach().float().cpu()))

    hook = module.register_forward_hook(forward_hook)
    tmp = tempfile.mkdtemp(prefix="nns_smoke_")
    labels = os.path.join(tmp, "labels.txt")
    with open(labels, "w") as f:
        f.write("\n".join(f"class_{i}" for i in range(CLASSES)) + "\n")

    def launch(n: int):
        pipe = nt.parse_launch(
            f"videotestsrc num-buffers={n} width={IMAGE} height={IMAGE} "
            "pattern=ball ! tensor_converter ! "
            "tensor_transform mode=arithmetic "
            "option=typecast:float32,add:-127.5,div:127.5 ! "
            "tensor_filter framework=jax model=mnv2 name=filter ! "
            f"tensor_decoder mode=image_labeling option1={labels} ! "
            "queue max-size-buffers=32 prefetch-host=true ! "
            "tensor_sink name=out to-host=true")
        filt = pipe.get("filter")
        chain = filt.chain

        def probe(pad, buf):  # what tensor_transform handed the filter
            seen["transform_out"].add(
                (str(buf.tensors[0].device), str(buf.tensors[0].dtype)))
            return chain(pad, buf)

        filt.chain = probe
        return pipe

    try:
        # the warm-up run also keeps the inputs and logits of its first
        # frames for the fp32 check below, so that the measured run does
        # not wait for those copies
        warm = launch(WARMUP_FRAMES)
        warm.run(timeout=600)
        seen.update(calls=0, param_devices=set(), transform_out=set())

        pipe = launch(FRAMES)
        got = []
        pipe.get("out").connect(lambda buf: got.append(buf.meta))
        pp.reset_launches()
        t0 = time.monotonic()
        pipe.run(timeout=900)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        launches = dict(pp.LAUNCHES)
        p50, p99 = pipe.get("out").latency_percentiles(50.0, 99.0)
        measured = {k: v for k, v in seen.items() if k != "samples"}
        trace = profile_pipeline(launch(PROFILED_FRAMES))
    finally:
        hook.remove()
        unregister_torch_model("mnv2")
        shutil.rmtree(tmp, ignore_errors=True)

    check(len(got) == FRAMES, f"{len(got)} of {FRAMES} frames reached the "
                              "sink")
    check(all(isinstance(m.get("label"), str) and m["label"].startswith(
        "class_") for m in got), "a frame came out without a label")
    check(launches["normalize_chain"] == FRAMES,
          f"normalize kernel launched {launches['normalize_chain']} times "
          f"for {FRAMES} frames")
    check(measured["calls"] == FRAMES,
          f"model ran {measured['calls']} times")
    check(measured["param_devices"] == {"cuda:0"},
          f"filter parameters on {measured['param_devices']}")
    check(measured["transform_out"] == {("cuda:0", "torch.float32")},
          f"tensor_transform output was {measured['transform_out']}")

    # the same module in float32 on the CPU, TF32 off, on the same inputs
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    ref_module, _, _ = mobilenet_v2(num_classes=CLASSES, image_size=IMAGE,
                                    dtype=torch.float32, seed=0)
    rel = []
    top1 = []
    for x, logits in seen["samples"]:
        check(tuple(logits.shape) == (1, CLASSES) and
              bool(torch.isfinite(logits).all()),
              f"logits of shape {tuple(logits.shape)} or not finite")
        with torch.inference_mode():
            ref = ref_module(x)
        rel.append(float((logits - ref).norm() / ref.norm()))
        top1.append(int(logits.argmax()) == int(ref.argmax()))
    check(len(rel) == LOGIT_FRAMES, "too few frames captured for the "
                                    "logit check")
    check(max(rel) <= REL_L2_MAX,
          f"bf16 logits on the card vs fp32 on the CPU: relative L2 "
          f"{max(rel)} > {REL_L2_MAX}")
    result = {
        "frames": FRAMES, "labelled": len(got), "launches": launches,
        "fps": FRAMES / wall, "wall_s": wall,
        "latency_p50_ms": p50, "latency_p99_ms": p99,
        "logit_rel_l2": rel, "logit_rel_l2_max_allowed": REL_L2_MAX,
        "top1_agree": top1, "profiled_run": trace, "gpu": power,
    }
    emit({"phase": "pipeline", **result})
    return result


def profile_pipeline(pipe) -> dict:
    """Run ``pipe`` under ``torch.profiler``: the device's busy time per
    frame, its idle share of the run's wall time, and the kernels that take
    the most device time. The profiler slows the host, so the run's own
    rate is not reported as the pipeline's."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        pipe.run(timeout=600)
        torch.cuda.synchronize()
        wall_us = (time.monotonic() - t0) * 1e6
    by_name = {}
    spans = []
    for ev in prof.events():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = ev.time_range.elapsed_us()
        by_name[ev.name] = by_name.get(ev.name, 0.0) + us
        spans.append((ev.time_range.start, ev.time_range.end))
    spans.sort()
    busy_us, end = 0.0, None  # union of device intervals
    for a, b in spans:
        if end is None or a > end:
            busy_us += b - a
            end = b
        elif b > end:
            busy_us += b - end
            end = b
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return {
        "frames": PROFILED_FRAMES,
        "device_busy_ms_per_frame": busy_us / PROFILED_FRAMES / 1e3,
        "device_idle_share": 1.0 - busy_us / wall_us,
        "device_kernels_per_frame": len(spans) / PROFILED_FRAMES,
        "top_device_ms_per_frame": {
            name[:80]: us / PROFILED_FRAMES / 1e3 for name, us in top},
    }


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs one "
              "NVIDIA GPU", file=sys.stderr)
        return 1
    if not os.path.isfile(os.path.join(HERE, "nnstreamer_tpu_torch",
                                       "__init__.py")):
        print("chip_smoke: nnstreamer_tpu_torch is not beside this script; "
              "run it from the root of a checkout", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    import nnstreamer_tpu_torch

    check(os.path.dirname(os.path.dirname(
        os.path.abspath(nnstreamer_tpu_torch.__file__))) == HERE,
        "imported an nnstreamer_tpu_torch from outside this checkout")

    power = gpu_name_and_power_limit()
    kind = torch.cuda.get_device_name(0)
    emit({"phase": "device", "kind": kind,
          "count": torch.cuda.device_count(), "nvidia_smi": power,
          "torch": torch.__version__, "cuda": torch.version.cuda})
    phase_build()
    b1, timed = phase_normalize()
    pipe = phase_pipeline(power)
    phase_device_times(timed)
    for mod in ("jax", "nnstreamer_tpu"):
        check(mod not in sys.modules, f"{mod} was imported")
    emit({"kernels": [{
        "name": "normalize_chain",
        "route": "cuda",
        "source": "nnstreamer_tpu_torch/csrc/normalize.cu",
        "replaces": "nnstreamer_tpu/ops/preprocess.py:52",
        "launches": pipe["launches"]["normalize_chain"],
        "max_abs_err": b1["max_abs_err"],
        "ms": b1["ms"],
        "plain_ms": b1["plain_ms"],
        "bound_ms": b1["bound_ms"],
        "bound_by": b1["bound_by"],
        "library_ms": None,
    }]})
    print(power, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
