#!/usr/bin/env python3
"""Time the eager kernel wrappers of a checkout on one NVIDIA GPU, so two
checkouts can be compared within one machine.

Run from the root of a checkout, once per tree and turn (parent, change,
change, parent, ...)::

    python3 tools/ab_wrappers.py path/to/tree

With the tree's own ``nnstreamer_tpu_torch`` (its kernels built into the
tree's ``nnstreamer_tpu_torch/_build``) it times, as ``chip_smoke.py``'s
kernels line does, each wrapper called back to back on the card at the
main paths' shapes: B1 ``normalize_chain`` on one 224×224×3 uint8 frame
with the flagship transform's chain to float32, B3 ``quantize_int8`` in
nearest mode on one float32 frame, and B2 ``flash_attention`` causal on
bf16 [4, 512, 8, 64]. Each time is the median over 7 repeats of the mean
of 200 calls, by CUDA events. It prints one JSON line:
``{"tree", "gpu", "ms": {"normalize_chain": ..., ...}}``.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys


def cuda_time_ms(fn, launches: int = 200, repeats: int = 7) -> float:
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


def times() -> dict:
    import torch

    from nnstreamer_tpu_torch.ops import flash_attention as fa
    from nnstreamer_tpu_torch.ops import preprocess as pp
    from nnstreamer_tpu_torch.ops import quantize as qz

    dev = torch.device("cuda:0")
    gen = torch.Generator().manual_seed(0)
    frame = torch.randint(0, 256, (1, 224, 224, 3), generator=gen,
                          dtype=torch.uint8).to(dev)
    chain = [("add", -127.5), ("div", 127.5)]
    xf = torch.randn((1, 224, 224, 3), generator=gen).to(dev)
    q, k, v = (torch.randn((4, 512, 8, 64), generator=gen)
               .to(torch.bfloat16).to(dev) for _ in range(3))
    return {
        "normalize_chain": cuda_time_ms(
            lambda: pp.normalize_chain(frame, chain, torch.float32)),
        "quantize_int8_nearest": cuda_time_ms(
            lambda: qz.quantize_int8(xf, force="reference")),
        "flash_attention": cuda_time_ms(
            lambda: fa.flash_attention(q, k, v, causal=True)),
    }


def main() -> int:
    if len(sys.argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    tree = os.path.abspath(sys.argv[1])
    os.chdir(tree)
    sys.path.insert(0, tree)
    import torch

    if not torch.cuda.is_available():
        print("ab_wrappers: CUDA is not available", file=sys.stderr)
        return 1
    gpu = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(json.dumps({"tree": sys.argv[1], "gpu": gpu, "ms": times()}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
