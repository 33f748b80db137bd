#!/usr/bin/env python3
"""Time the alternatives of the launch plans of kernels B1 (normalize) and
B3 (int8 quantize) on one NVIDIA GPU, through the wrappers themselves.

Run from the root of a checkout::

    python3 tools/plan_sweep.py

Each alternative is one setting of a plan's constant, made for the run
and undone after it: B1 at 4 and at 16 elements a thread
(``ops/preprocess.py::PASSES_OF_4_MAX``), B3 at 256, 512 and 1024 threads
a block (``ops/quantize.py::THREADS`` and ``THREADS_READ_TWICE``). The
plan functions then make the plan as the wrappers do, and the wrappers
launch it. Each output is held bit for bit against the plain version, and
the device time of one call is taken twice from a ``torch.profiler`` trace
(``chip_smoke.device_time_ms``) to show the spread.

It prints the card's name and power limit, then one JSON line per kernel
and size: ``{"kernel", "n", "shipped": plan, "plans": {name: [plan,
bit_identical, ms, ms]}}``.
"""

from __future__ import annotations

import json
import math
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B1_SIZES = (224 * 224 * 3, 8 * 224 * 224 * 3, 10 ** 6 + 3, 2162688,
            8 * 2 ** 20, 4096 * 4096)
B3_SIZES = (4099, 16384, 37632, 224 * 224 * 3, 458624, 2 ** 20 + 3,
            8 * 2 ** 20, 4096 * 4096)


def sweep(module, cached, plan, settings, run, same, timer):
    """``{name: [plan(), bit_identical, ms, ms]}`` for each ``name:
    {constant: value}`` in ``settings``: the module's constants are set
    for the run and restored after it, and the plan cache ``cached`` is
    emptied around it."""
    out = {}
    for name, values in settings.items():
        saved = {k: getattr(module, k) for k in values}
        try:
            for k, v in values.items():
                setattr(module, k, v)
            cached.cache_clear()
            run()
            out[name] = [plan()._asdict(), bool(same()), timer(run),
                         timer(run)]
        finally:
            for k, v in saved.items():
                setattr(module, k, v)
            cached.cache_clear()
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("plan_sweep: needs one NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    import chip_smoke as c
    from nnstreamer_tpu_torch.ops import _build
    from nnstreamer_tpu_torch.ops import preprocess as pp
    from nnstreamer_tpu_torch.ops import quantize as qz

    print(c.gpu_name_and_power_limit(), flush=True)
    _build.build_all(["normalize", "quantize"])
    dev = torch.device("cuda:0")
    sms = _build.sm_count(0)
    gen = torch.Generator().manual_seed(0)

    for n in B1_SIZES:
        x = torch.randint(0, 256, (n,), generator=gen,
                          dtype=torch.uint8).to(dev)
        ref = pp.normalize_chain_reference(x, c.TRANSFORM_CHAIN,
                                           torch.float32)
        y = [None]

        def run(x=x, y=y):
            y[0] = pp.normalize_chain(x, c.TRANSFORM_CHAIN, torch.float32)

        plans = sweep(
            pp, pp.normalize_plan, lambda: pp.normalize_plan(n, True, sms),
            {"ept4": {"PASSES_OF_4_MAX": math.inf},
             "ept16": {"PASSES_OF_4_MAX": -1.0}},
            run, lambda: torch.equal(y[0].view(torch.int32),
                                     ref.view(torch.int32)),
            c.device_time_ms)
        print(json.dumps({"kernel": "normalize_chain", "n": n,
                          "shipped": pp.normalize_plan(n, True,
                                                       sms)._asdict(),
                          "plans": plans}), flush=True)

    for n in B3_SIZES:
        x = c._quant_input((n,), torch.float32, gen)
        rq, rs = qz.quantize_nearest_reference(x)
        out = [None]

        def run(x=x, out=out):
            out[0] = qz.quantize_int8(x, force="reference")

        plans = sweep(
            qz, qz.device_plan, lambda: qz.quantize_plan(n, 4, sms),
            {f"threads{t}": {"THREADS": t, "THREADS_READ_TWICE": t}
             for t in (256, 512, 1024)},
            run, lambda: torch.equal(out[0][0], rq) and torch.equal(
                out[0][1].view(torch.int32), rs.view(torch.int32)),
            c.device_time_ms)
        print(json.dumps({"kernel": "quantize_int8", "n": n,
                          "shipped": qz.quantize_plan(n, 4, sms)._asdict(),
                          "plans": plans}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
