"""The readings the output check's limits are set from, on the card, in
one process:

    python3 -m h100bench.calibrate --workload <cell> --seeds <first> <count> \\
        --control <count> --seconds <s>

For each seed it runs the cell's timed path at the cell's own load for a
short window (``run.run_cell``: the same pipeline, frames and judge as a
benchmark run) and prints the numbers the judge gave; for the first
``--control`` seeds it also puts the fp8 control in the program's place
on the same weights and frames and prints the numbers the same judge
gives it. A last line sums up each number: the largest the program read,
the smallest the control read, and the limit the configuration holds.
The benchmark's own runs never run the control."""

from __future__ import annotations

import argparse
import json
import sys

from h100bench import cells, run


def control_numbers(cell: cells.Cell, seed: int, device: str = "cuda"):
    """The judge's numbers of the control's answers for ``seed``."""
    import torch

    from h100bench import weights

    cfg, ref, mix = cell.config.data, cell.config.reference, cell.traffic
    w = weights.make(ref.specs(cfg), seed, device,
                     getattr(torch, cfg["dtype"]))
    frames = cell.config.program.inputs(cfg, seed, int(mix["pool_frames"]),
                                        device)
    if device == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return ref.judge(cfg, w, frames, ref.control(cfg, w, frames))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs=2, required=True,
                    metavar=("FIRST", "COUNT"))
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)
    run.fix_caches()
    cell = cells.find_cell(args.workload)

    import torch

    if not torch.cuda.is_available():
        print("h100bench.calibrate: no CUDA card", file=sys.stderr)
        return 2
    program, control = {}, {}
    first, count = args.seeds
    for i, seed in enumerate(range(first, first + count)):
        out = run.run_cell(cell, seed, args.seconds, False)
        got = {k: c["value"] for k, c in out["checks"].items()}
        for k, v in got.items():
            program.setdefault(k, []).append(v)
        line = {"seed": seed, "program": got,
                "frames_out": out["info"]["frames_out"]}
        if i < args.control:
            c = control_numbers(cell, seed)
            for k, v in c.items():
                control.setdefault(k, []).append(v)
            line["control"] = c
        print(json.dumps(line), flush=True)
    limits = cell.config.data.get("limits", {})
    print(json.dumps({"summary": {
        k: {"program_max": max(v), "control_min": min(control[k])
            if k in control else None, "limit": limits.get(k)}
        for k, v in program.items()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
