#!/usr/bin/env python3
"""Time the batch-8 flagship of two checkouts against each other on one
NVIDIA GPU: run it once per checkout and process, in turns (parent,
change, change, parent, ...), and compare within one machine.

Run from the root of a checkout, once per tree and turn::

    python3 tools/ab_flagship.py path/to/tree            # 3+3 runs
    python3 tools/ab_flagship.py path/to/tree --phase    # chip_smoke's phase

The default mode builds bench.py's batch-8 string (``bench.py:286-341``
with lanes 1 and a blocking ingress queue, as ``chip_smoke.py``'s
``pipeline_batched`` runs it: MobileNetV2 width 1.0 at 224×224×3, 1001
classes, bf16, weights from seed 0, 800 gradient frames) with the tree's
own ``nnstreamer_tpu_torch``, warms it up fused and unfused, then runs it
three times unfused and three times fused, alternating, and prints one
JSON line: ``{"tree", "unfused": [fps, ...], "fused": [fps, ...]}``. With
``--phase`` it runs the tree's ``chip_smoke.phase_pipeline_batched`` and
prints the frames a second and latencies of its timed runs.

Each tree builds its own kernels (``nnstreamer_tpu_torch/_build``).
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import time


def runs(n: int = 800, repeats: int = 3) -> dict:
    import torch

    import nnstreamer_tpu_torch as nt
    from nnstreamer_tpu_torch.filters.torch_backend import (
        register_torch_model,
    )
    from nnstreamer_tpu_torch.models.mobilenet_v2 import mobilenet_v2
    from nnstreamer_tpu_torch.pipeline.pipeline import Pipeline

    nt.set_device(None)
    module, _, _ = mobilenet_v2(num_classes=1001, image_size=224,
                                dtype=torch.bfloat16, seed=0)
    register_torch_model("m", module)
    labels = os.path.join(tempfile.mkdtemp(), "l.txt")
    with open(labels, "w") as f:
        f.write("\n".join(f"c{i}" for i in range(1001)) + "\n")

    def run(frames: int, fuse: bool) -> float:
        desc = (f"videotestsrc num-buffers={frames} width=224 height=224 "
                "pattern=gradient ! tensor_converter ! "
                "queue max-size-buffers=16 ! "
                "tensor_aggregator frames-in=1 frames-out=8 frames-flush=8 "
                "frames-dim=3 concat=true ! "
                "queue max-size-buffers=8 prefetch-device=true ! "
                "tensor_transform mode=arithmetic "
                "option=typecast:float32,add:-127.5,div:127.5 ! "
                "tensor_filter framework=jax model=m inflight=2 ! "
                f"tensor_decoder mode=image_labeling option1={labels} "
                "option2=batched ! queue max-size-buffers=64 "
                "materialize-host=true ! tensor_sink name=out")
        pipe = nt.parse_launch(desc, pipeline=Pipeline(fuse=fuse))
        t0 = time.monotonic()
        pipe.run(timeout=600)
        torch.cuda.synchronize()
        return frames / (time.monotonic() - t0)

    run(80, True)
    run(32, False)
    out = {"unfused": [], "fused": []}
    for _ in range(repeats):
        out["unfused"].append(run(n, False))
        out["fused"].append(run(n, True))
    return out


def phase() -> dict:
    import chip_smoke as c

    r, _ = c.phase_pipeline_batched(c.gpu_name_and_power_limit())
    keep = ("fps", "latency_p50_ms", "latency_p99_ms",
            "latency_p99_ms_after_first_quarter", "wall_s")
    return {"fused": {k: r[k] for k in keep},
            **{name: {k: r[name][k] for k in keep}
               for name in ("unfused", "inflight_1", "batch1_fused",
                            "ball")}}


def main() -> int:
    if len(sys.argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    tree = os.path.abspath(sys.argv[1])
    os.chdir(tree)
    sys.path.insert(0, tree)
    import torch

    if not torch.cuda.is_available():
        print("ab_flagship: CUDA is not available", file=sys.stderr)
        return 1
    result = phase() if "--phase" in sys.argv[2:] else runs()
    print(json.dumps({"tree": sys.argv[1], **result}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
