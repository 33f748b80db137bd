#!/usr/bin/env python3
"""Drive the serving mesh (``nnstreamer_tpu_torch/parallel/``) across
every visible NVIDIA GPU of one host and hold it to the unmeshed run in
the same process: what one card cannot show (peer copies between cards,
one captured graph per card, the tensor-parallel sum across cards).

    python3 tools/mesh_cards.py            # every visible card
    python3 tools/mesh_cards.py --cpu 4    # rehearsal: 4 logical host
                                           # devices, small sizes, gloo

Checks, each printed as one JSON line:

- ``flagship``: bench.py's batch-8 flagship (MobileNetV2 1.0, 224×224×3,
  1001 classes, bf16, seed 0, 800 gradient frames) with ``mesh=dp-1`` on
  the filter against the unmeshed run: every frame labelled, B1 launched
  once a window on every card (one graph a card), the labels' agreement
  and the largest score difference (a card's shard is 8/N frames, so
  cuDNN may pick other algorithms than for the whole window);
- ``chain``: two elementwise filters at ``dp-1`` behind a queue: values
  exact, 0 reshard bytes at the hand-off;
- ``engine``: the LM of ``chip_smoke.phase_lm_graph`` (fp32, 8 slots,
  K = 8, plain attention) at dp × tp (tp = 2 when the cards are even):
  greedy tokens against the unmeshed engine's, and the paged int8 engine
  at dp over every card;
- ``ring``: the same LM's forward (fp32, one 8 × 512 batch) with the
  sequence over every card (ring attention, ``sp`` = N) against one
  card's logits;
- ``pp_train``: one ``make_pp_train_step`` at pp2 across two cards (× sp
  over the rest, 4 microbatches) against the one-card step: the loss and
  every parameter;
- ``multihost``: two processes joined over NCCL, one card each
  (``CUDA_VISIBLE_DEVICES``), each a dp rank of one ``make_train_step``
  on its half of the batch (``parallel/multihost.py``), against the
  one-process step on the whole batch.

The last line is ``{"ok": true|false, "cards": N, "failed": [...]}``.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FRAMES, BATCH, IMAGE, CLASSES = 800, 8, 224, 1001
LM = dict(vocab=32000, d_model=512, n_heads=8, n_layers=8, d_ff=2048,
          max_seq=512)
LM_PROMPTS, LM_NEW = 12, 32
TRAIN_BATCH, TRAIN_LR, TRAIN_MB = (8, 512), 1e-2, 4
#: fp32, TF32 off: the meshed runs against one card (other summation
#: orders: the ring's online softmax, the gradient sums)
LOGITS_ATOL, LOSS_RTOL, PARAM_ATOL = 1e-3, 1e-4, 1e-5
CHILD_TIMEOUT = 600
CPU = False
failed = []


def check(cond: bool, what: str) -> None:
    if not cond:
        failed.append(what)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def sync() -> None:
    import torch

    if torch.cuda.is_available():
        torch.cuda.synchronize()


def flagship(cards: int) -> None:
    import numpy as np
    import torch

    import nnstreamer_tpu_torch as nt
    from nnstreamer_tpu_torch.filters.torch_backend import (
        register_torch_model,
    )
    from nnstreamer_tpu_torch.models.mobilenet_v2 import mobilenet_v2
    from nnstreamer_tpu_torch.ops._counts import LAUNCHES, reset_launches
    from nnstreamer_tpu_torch.pipeline.pipeline import Pipeline

    module, _, _ = mobilenet_v2(num_classes=CLASSES, image_size=IMAGE,
                                dtype=torch.bfloat16, seed=0)
    register_torch_model("mnv2_cards", module)
    labels = os.path.join(tempfile.mkdtemp(prefix="nns_cards_"), "l.txt")
    with open(labels, "w") as f:
        f.write("\n".join(f"class_{i}" for i in range(CLASSES)) + "\n")

    def run(mesh, name):
        pipe = nt.parse_launch(
            f"videotestsrc num-buffers={FRAMES} width={IMAGE} "
            f"height={IMAGE} pattern=gradient ! tensor_converter ! "
            "queue max-size-buffers=16 ! tensor_aggregator frames-in=1 "
            f"frames-out={BATCH} frames-flush={BATCH} frames-dim=3 "
            "concat=true ! queue max-size-buffers=8 prefetch-device=true ! "
            "tensor_transform mode=arithmetic "
            "option=typecast:float32,add:-127.5,div:127.5 ! "
            "tensor_filter framework=jax model=mnv2_cards name=filter "
            f"{mesh}! tensor_decoder mode=image_labeling option1={labels} "
            "option2=batched ! queue max-size-buffers=64 "
            "materialize-host=true ! tensor_sink name=out to-host=true",
            pipeline=Pipeline(name=name))
        got = []
        pipe.get("out").connect(lambda b: got.append(b.meta))
        reset_launches()
        t0 = time.monotonic()
        pipe.run(timeout=600)
        sync()
        wall = time.monotonic() - t0
        frames = [(lab, float(sc)) for m in got
                  for lab, sc in zip(m["label"], m["score"])]
        regions = list(pipe.metrics_snapshot()["regions"].values())
        return frames, dict(LAUNCHES), wall, regions

    run("", "cards_warm")
    plain, _, plain_wall, _ = run("", "cards_plain")
    meshed, launches, wall, regions = run("mesh=dp-1 ", "cards_mesh")
    windows = FRAMES // BATCH
    agree = sum(a[0] == b[0] for a, b in zip(meshed, plain))
    diff = max((abs(a[1] - b[1]) for a, b in zip(meshed, plain)),
               default=float("nan"))
    check(len(meshed) == FRAMES, f"flagship: {len(meshed)} frames")
    on_card = torch.cuda.is_available()
    # on the CPU the wrapper takes B1's plain version: no launch counts
    check(not on_card or launches["normalize_chain"] == windows * cards,
          f"flagship: B1 {launches['normalize_chain']} for {windows} "
          f"windows on {cards} devices")
    check(len(regions) == 1 and not regions[0]["unspliced"] and
          (not on_card or regions[0]["captures"] == cards),
          f"flagship: regions {regions}")
    check(agree >= 0.99 * FRAMES, f"flagship: {agree} of {FRAMES} labels "
                                  "agree with the unmeshed run")
    emit({"check": "flagship", "devices": cards, "frames": len(meshed),
          "b1_launches": launches["normalize_chain"],
          "captures": regions[0]["captures"] if regions else None,
          "labels_agree": agree, "max_score_diff": diff,
          "fps": FRAMES / wall, "plain_fps": FRAMES / plain_wall})


def chain() -> None:
    import numpy as np
    import torch

    import nnstreamer_tpu_torch as nt
    from nnstreamer_tpu_torch.filters.torch_backend import (
        register_torch_model,
    )
    from nnstreamer_tpu_torch.parallel import serve

    class Scale(torch.nn.Module):
        def forward(self, x):
            return x * 2.0

    class Shift(torch.nn.Module):
        def forward(self, x):
            return x + 1.0

    register_torch_model("cards_a", Scale())
    register_torch_model("cards_b", Shift())
    pipe = nt.parse_launch(
        "appsrc name=src ! tensor_filter framework=jax model=cards_a "
        "name=fa mesh=dp-1 ! queue max-size-buffers=4 ! tensor_filter "
        "framework=jax model=cards_b name=fb mesh=dp-1 ! "
        "tensor_sink name=sink to-host=true")
    r0 = serve.reshard_bytes_total()
    pipe.start()
    try:
        for i in range(BATCH):
            pipe.get("src").push([np.full((BATCH, IMAGE, IMAGE, 3),
                                          float(i), np.float32)])
        pipe.get("src").end_of_stream()
        msg = pipe.wait(timeout=300)
    finally:
        pipe.stop()
    moved = serve.reshard_bytes_total() - r0
    outs = [np.asarray(b.tensors[0]) for b in pipe.get("sink").buffers]
    exact = len(outs) == BATCH and all(np.all(o == 2.0 * i + 1.0)
                                       for i, o in enumerate(outs))
    check(msg is not None and msg.kind == "eos" and exact,
          f"chain: {len(outs)} frames, exact {exact}")
    check(moved == 0, f"chain: {moved} reshard bytes")
    emit({"check": "chain", "frames": len(outs), "exact": exact,
          "reshard_bytes": moved, "handoff": pipe.get("fa")._mesh_handoff})


def engine(cards: int) -> None:
    import numpy as np
    import torch

    from nnstreamer_tpu_torch.models.transformer import (
        TransformerConfig,
        init_params,
    )
    from nnstreamer_tpu_torch.parallel import make_mesh
    from nnstreamer_tpu_torch.serving import ContinuousBatchingEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = TransformerConfig(**LM, dtype=torch.float32)
    params = init_params(cfg, seed=0)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, LM["vocab"], int(n)).tolist()
               for n in rng.integers(8, 40, LM_PROMPTS)]
    tp = 2 if cards % 2 == 0 and cards > 1 else 1
    cases = [("dense", [("dp", cards // tp), ("tp", tp)], {}),
             ("paged_int8", [("dp", cards)],
              dict(kv_quant="int8", block_tokens=16))]
    for tag, axes, kw in cases:
        toks = {}
        for name, mesh in (("plain", None), ("mesh", make_mesh(axes))):
            eng = ContinuousBatchingEngine(
                cfg, params, max_streams=8, steps_per_dispatch=8,
                attention="reference", mesh=mesh, **kw).start()
            try:
                t0 = time.monotonic()
                streams = [eng.submit(p, max_new_tokens=LM_NEW)
                           for p in prompts]
                toks[name] = [s.result(timeout=600) for s in streams]
                wall = time.monotonic() - t0
            finally:
                eng.stop()
            toks[name + "_tps"] = LM_PROMPTS * LM_NEW / wall
        same = sum(a == b for a, b in zip(toks["mesh"], toks["plain"]))
        check(same == LM_PROMPTS, f"engine {tag} {axes}: {same} of "
                                  f"{LM_PROMPTS} prompts equal unmeshed")
        emit({"check": "engine", "case": tag, "mesh": axes,
              "prompts_equal": same, "prompts": LM_PROMPTS,
              "tokens_per_s": toks["mesh_tps"],
              "plain_tokens_per_s": toks["plain_tps"]})


def _train_setup():
    import torch

    from nnstreamer_tpu_torch.models.transformer import (
        TransformerConfig,
        init_params,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = TransformerConfig(**LM, dtype=torch.float32)
    gen = torch.Generator().manual_seed(11)
    tokens = torch.randint(0, cfg.vocab, TRAIN_BATCH, generator=gen,
                           dtype=torch.int32)
    return cfg, init_params, tokens


def _max_diff(a, b) -> float:
    from nnstreamer_tpu_torch.parallel import serve

    return max(float((serve.gather(a[k], "cpu") -
                      serve.gather(b[k], "cpu")).abs().max()) for k in a)


def ring(cards: int) -> None:
    from nnstreamer_tpu_torch.parallel import make_mesh
    from nnstreamer_tpu_torch.parallel.sharded import (
        make_sharded_forward,
        shard_params,
    )

    cfg, init_params, tokens = _train_setup()
    params = init_params(cfg, seed=0)
    one = make_mesh([("dp", 1)])
    want = make_sharded_forward(cfg, one)(shard_params(params, one, cfg),
                                          tokens)
    mesh = make_mesh([("sp", cards)])
    t0 = time.monotonic()
    got = make_sharded_forward(cfg, mesh)(shard_params(params, mesh, cfg),
                                          tokens)
    sync()
    ms = (time.monotonic() - t0) * 1e3
    err = float((got - want).abs().max())
    check(err <= LOGITS_ATOL, f"ring: sp{cards} logits {err} from one card")
    emit({"check": "ring", "mesh": [("sp", cards)], "max_abs_err": err,
          "ms": ms})


def pp_train(cards: int) -> None:
    from nnstreamer_tpu_torch.parallel import make_mesh
    from nnstreamer_tpu_torch.parallel.sharded import (
        make_pp_train_step,
        make_train_step,
        shard_params,
    )

    if cards < 2:
        emit({"check": "pp_train", "skipped": "one card"})
        return
    cfg, init_params, tokens = _train_setup()
    one = make_mesh([("dp", 1)])
    dense, dloss = make_train_step(cfg, one, learning_rate=TRAIN_LR)(
        shard_params(init_params(cfg, seed=0), one, cfg), tokens)
    axes = [("pp", 2), ("sp", cards // 2)]
    mesh = make_mesh(axes)
    b, s = TRAIN_BATCH
    t0 = time.monotonic()
    piped, loss = make_pp_train_step(
        cfg, mesh, num_microbatches=TRAIN_MB, learning_rate=TRAIN_LR)(
        shard_params(init_params(cfg, seed=0), mesh, cfg, pipelined=True),
        tokens.reshape(TRAIN_MB, b // TRAIN_MB, s))
    loss = float(loss)
    ms = (time.monotonic() - t0) * 1e3
    err = _max_diff(piped, dense)
    check(abs(loss - float(dloss)) <= LOSS_RTOL * abs(float(dloss)),
          f"pp_train: loss {loss} != one card's {float(dloss)}")
    check(err <= PARAM_ATOL, f"pp_train: params {err} from one card")
    emit({"check": "pp_train", "mesh": axes, "loss": loss,
          "one_card_loss": float(dloss), "max_param_diff": err, "ms": ms})


#: one process of the multihost check: its half of the batch, one dp rank
CHILD = r"""
import json, sys
import numpy as np, torch
sys.path.insert(0, sys.argv[2])
import mesh_cards as mc
from nnstreamer_tpu_torch.parallel import multihost
from nnstreamer_tpu_torch.parallel.sharded import make_train_step, shard_params
sizes = json.loads(sys.argv[3])
mc.LM, mc.TRAIN_BATCH = sizes["LM"], tuple(sizes["TRAIN_BATCH"])
joined = multihost.initialize()
rank, world = multihost.process_info()
cfg, init_params, tokens = mc._train_setup()
mesh = multihost.global_mesh([("dp", -1)])
params, loss = make_train_step(cfg, mesh, learning_rate=mc.TRAIN_LR)(
    shard_params(init_params(cfg, seed=0), mesh, cfg),
    tokens[multihost.local_batch_slice(tokens.shape[0])])
np.savez(sys.argv[1], **{k: v.gather("cpu").numpy()
                         for k, v in params.items()})
print(json.dumps({"joined": joined, "rank": rank, "world": world,
                  "backend": torch.distributed.get_backend(),
                  "loss": float(loss)}), flush=True)
torch.distributed.destroy_process_group()
"""


def multihost_check(cards: int) -> None:
    import numpy as np

    from nnstreamer_tpu_torch.parallel import make_mesh
    from nnstreamer_tpu_torch.parallel.sharded import (
        make_train_step,
        shard_params,
    )

    if cards < 2:
        emit({"check": "multihost", "skipped": "one card"})
        return
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    out_dir = tempfile.mkdtemp(prefix="nns_cards_mh_")
    procs = []
    t0 = time.monotonic()
    try:
        for i in range(2):
            env = dict(os.environ, NNSTPU_COORDINATOR=f"127.0.0.1:{port}",
                       NNSTPU_NUM_PROCESSES="2", NNSTPU_PROCESS_ID=str(i),
                       PYTHONPATH=HERE)
            if CPU:
                env["NNSTPU_TORCH_DEVICE"] = "cpu"
            else:
                env["CUDA_VISIBLE_DEVICES"] = str(i)
            procs.append(subprocess.Popen(
                [sys.executable, "-c", CHILD,
                 os.path.join(out_dir, f"p{i}.npz"),
                 os.path.dirname(os.path.abspath(__file__)),
                 json.dumps({"LM": LM, "TRAIN_BATCH": TRAIN_BATCH})],
                cwd=HERE, env=env, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True))
        outs = []
        for p in procs:
            out, err = p.communicate(timeout=CHILD_TIMEOUT)
            if p.returncode != 0:
                raise RuntimeError(f"multihost child: {err[-2000:]}")
            outs.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
    wall = time.monotonic() - t0
    cfg, init_params, tokens = _train_setup()
    one = make_mesh([("dp", 1)])
    want, loss = make_train_step(cfg, one, learning_rate=TRAIN_LR)(
        shard_params(init_params(cfg, seed=0), one, cfg), tokens)
    err = 0.0
    for i in range(2):
        got = np.load(os.path.join(out_dir, f"p{i}.npz"))
        for k, v in want.items():
            err = max(err, float(np.abs(
                got[k] - v.gather("cpu").numpy()).max()))
    check([(o["rank"], o["world"], o["joined"]) for o in outs] ==
          [(0, 2, True), (1, 2, True)], f"multihost: {outs}")
    check(abs(outs[0]["loss"] - float(loss)) <= LOSS_RTOL *
          abs(float(loss)), f"multihost: loss {outs[0]['loss']} != "
                            f"{float(loss)}")
    check(err <= PARAM_ATOL, f"multihost: params {err} from one process")
    emit({"check": "multihost", "processes": 2,
          "backend": outs[0]["backend"], "loss": outs[0]["loss"],
          "one_process_loss": float(loss), "max_param_diff": err,
          "wall_s": wall})


def main() -> int:
    sys.path.insert(0, HERE)
    import torch

    import nnstreamer_tpu_torch as nt

    if "--cpu" in sys.argv:
        # the rehearsal: small sizes, logical host devices
        global FRAMES, IMAGE, CLASSES, LM, TRAIN_BATCH, CPU
        n = int(sys.argv[sys.argv.index("--cpu") + 1])
        CPU = True
        nt.set_device("cpu")
        nt.set_host_device_count(n)
        cards = n
        FRAMES, IMAGE, CLASSES = 80, 32, 10
        LM = dict(vocab=97, d_model=64, n_heads=4, n_layers=2, d_ff=128,
                  max_seq=128)
        TRAIN_BATCH = (8, 64)
    else:
        if not torch.cuda.is_available():
            print("mesh_cards: no CUDA device", file=sys.stderr)
            return 1
        nt.set_device(None)
        cards = torch.cuda.device_count()
        emit({"cards": [torch.cuda.get_device_name(i)
                        for i in range(cards)]})
    for step in (lambda: flagship(cards), chain, lambda: engine(cards),
                 lambda: ring(cards), lambda: pp_train(cards),
                 lambda: multihost_check(cards)):
        try:
            step()
        except Exception as e:  # noqa: BLE001 — reported, the rest runs
            failed.append(f"{type(e).__name__}: {e}")
    emit({"ok": not failed, "cards": cards, "failed": failed})
    return 0 if not failed else 1


if __name__ == "__main__":
    sys.exit(main())
