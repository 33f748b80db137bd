"""Find the knee of an open-loop cell once, on the card, in one process:

    python3 -m h100bench.sweep --workload <cell> --rates 300 350 400 \\
        --seed <n> --seconds <s>

Runs the cell's mix at each offered rate in turn (its ``rate_fps``
replaced) and prints a line a rate: the share of the window's frames
delivered, the latency quantiles, and the median latency of the
window's first and last quarter (a backlog that grows makes the last
higher). The knee is the highest rate that delivers at least 0.99 of
its frames with no growing backlog; the cell's traffic file holds 0.8
of it, written there as a number."""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys

from h100bench import cells, run


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    args = ap.parse_args(argv)
    run.fix_caches()
    cell = cells.find_cell(args.workload)

    import torch

    if not torch.cuda.is_available():
        print("h100bench.sweep: no CUDA card", file=sys.stderr)
        return 2
    for rate in args.rates:
        at = dataclasses.replace(cell, traffic={**cell.traffic,
                                                "rate_fps": rate})
        out = run.run_cell(at, args.seed, args.seconds, False)
        info = out["info"]
        print(json.dumps({
            "rate_fps": rate, "attempted": out["attempted"],
            "failed": out["failed"],
            "delivered_share": 1 - out["failed"] / max(out["attempted"], 1),
            "correct": out["correct"],
            **{k: info.get(k) for k in (
                "latency_p50_ms", "latency_p95_ms",
                "latency_p50_ms_first_quarter",
                "latency_p50_ms_last_quarter", "refused_by_appsrc",
                "generator_late_ms_p50", "generator_late_ms_p99")}}),
            flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
