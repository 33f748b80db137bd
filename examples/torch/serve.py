"""Continuous-batching LM serving on the port: N concurrent prompts share
one batched KV-cached decode program (``serving/engine.py``; the prefills
run kernel B2).

Contrast with examples/torch/llm_stream.py (one stream through the
tensor_repo pipeline loop): the engine multiplexes many streams onto the
same device program.

Runs on cuda:0; NNSTPU_TORCH_DEVICE=cpu runs it on the CPU.
Run: python examples/torch/serve.py
"""

import time

import numpy as np
import torch

from nnstreamer_tpu_torch.models.transformer import (
    TransformerConfig,
    init_params,
)
from nnstreamer_tpu_torch.serving import ContinuousBatchingEngine


def main():
    cfg = TransformerConfig(vocab=4096, d_model=256, n_heads=8, n_layers=4,
                            d_ff=1024, max_seq=256, dtype=torch.bfloat16)
    engine = ContinuousBatchingEngine(
        cfg, init_params(cfg, seed=0), max_streams=4,
        steps_per_dispatch=8, temperature=0.7, top_k=40, seed=42,
        prefix_cache=4,  # multi-turn/system-prompt KV reuse
    ).start()

    rng = np.random.default_rng(0)
    system = rng.integers(1, cfg.vocab, 16).tolist()  # shared preamble
    prompts = [system + rng.integers(1, cfg.vocab, n).tolist() for n in
               (5, 12, 30, 9, 21, 7)]
    t0 = time.monotonic()
    streams = [engine.submit(p, max_new_tokens=48) for p in prompts]
    for s in streams:
        toks = s.result(timeout=600)
        assert s.finish_reason in ("eos", "length"), s.finish_reason
        print(f"stream {s.stream_id}: prompt_len={s.prompt_len} "
              f"generated={len(toks)} ({s.finish_reason}) "
              f"first={toks[:6]}")
    dt = time.monotonic() - t0
    st = engine.stats
    util = st["active_slot_steps"] / max(1, st["slot_steps"])
    print(f"total {st['tokens_generated']} tokens in {dt:.2f}s "
          f"({st['tokens_generated'] / dt:.1f} tok/s aggregate), "
          f"{st['dispatches']} dispatches, slot utilization {util:.0%}, "
          f"prefix hits {st['prefix_hits']} "
          f"({st['prefix_tokens_reused']} prompt tokens reused)")
    engine.stop()


if __name__ == "__main__":
    main()
