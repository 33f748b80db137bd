#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``nnstreamer_tpu_torch``).

Run from the root of a checkout on a machine with one NVIDIA GPU::

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``nnstreamer_tpu_torch/csrc``,
holds each against its plain PyTorch version on the card, then drives the
port's paths through ``nnstreamer_tpu_torch.parse_launch``:

- LM serving (``appsrc ! tensor_lm_serve ! tensor_sink``): a
  continuous-batching engine with 8 slots serves 12 greedy prompts of
  128 new tokens on a decoder-only transformer at full width (vocab
  32000, d_model 512, 8 heads, 8 layers, d_ff 2048, max_seq 512,
  bfloat16, weights made from a seed); prefill runs kernel B2 (flash
  attention) in every layer, and the engine's K decode steps a dispatch
  are one CUDA graph, captured once and replayed. An fp32 run holds the
  kernel's greedy tokens to the plain attention's, and the bf16 logits to
  the fp32 ones.
- The captured K-step dispatch against its eager body (``lm_graph``): one
  capture at the K that served, replays = dispatches, fp32 tokens
  identical, bf16 rates of both; the int8 KV cache (``lm_kv_int8``: its
  bytes, the 12 × 128 run, fp32 first tokens equal to the raw cache's,
  six decode steps within 0.08 of the raw logits); the prefix cache and
  chunked prefill (``lm_prefix_chunk``: 12 prompts behind a 200-token
  preamble, fp32 tokens identical to a cold engine's with
  ``prefix_cache=4``, ``prefill_chunk=64`` and both).
- The paged KV cache on bench.py's ``lm`` load (``lm_paged``: 32 streams
  over 8 lanes with ``block_tokens=16``, against the monolithic cache;
  fp32 and int8 paged tokens equal to monolithic; a starved pool sheds
  and returns every block) and speculative decoding on bench.py's
  ``spec`` load (``lm_spec``: a 2-layer draft, γ = 4, 800 tokens fused,
  against the plain engine; fp32 tokens equal to greedy, and the
  engine's ``speculate=4`` in both cache modes).
- Sampled decoding, the repo-loop decode step and beam search
  (``lm_sampled``: bench.py's LM configuration with ``temperature=0.8,
  top_k=50, min_p=0.05, seed=7`` through ``tensor_lm_serve``, in turns
  with greedy, one capture each, two runs token-identical; in fp32 a
  stream alone = co-batched, monolithic = paged, in process = over the
  query pair, and the sampler's draws on a 32000-wide row against the
  filtered softmax; ``lm_decode``: bench.py's ``decode`` string, 16 steps
  an invoke as one CUDA graph, no cache copy to the host in the loop,
  tokens equal to eager steps and, in fp32, to ``build_decode_step``;
  ``beam``: W = 4, 32 new tokens, fp32, scores equal to teacher-forced
  rescoring, W = 1 equal to greedy).
- The same engine behind the query pair (``tensor_query_serversrc !
  tensor_lm_serve ! tensor_query_serversink``), fed by four ``appsrc !
  tensor_query_client ! tensor_sink`` clients over 127.0.0.1; in fp32 each
  client's tokens equal the in-process run's.
- The flagship offloaded over the query pair with int8 transport: the
  client runs videotestsrc → tensor_converter → tensor_transform (B1) →
  tensor_quant_enc (kernel B3, on the card) → tensor_query_client; the
  server tensor_quant_dec → tensor_filter MobileNetV2 → tensor_decoder
  image_labeling. Its labels equal an in-process run through the same
  codec, and the client ships about a quarter of the f32 frame's bytes.
- The flagship classification pipeline (videotestsrc → tensor_converter
  → tensor_transform → tensor_filter MobileNetV2 → tensor_decoder
  image_labeling → queue → tensor_sink) at the model's full width:
  224×224×3 uint8 frames, MobileNetV2 width 1.0, 1001 classes, bfloat16
  weights made from a seed; kernel B1 runs once per frame. It runs twice:
  unfused (``Pipeline(fuse=False)``), and with the default, where
  tensor_transform ! tensor_filter ! tensor_decoder is one fused region
  replayed as a CUDA graph with B1 inside (``pipeline_fused``: one capture,
  B1 counted once a frame through the replays, labels and scores bit for
  bit the unfused run's). The offload server fuses tensor_filter !
  tensor_decoder the same way.
- The flagship at bench.py's default batch (``pipeline_batched``): 800
  frames through ``tensor_aggregator`` (batch 8), a ``prefetch-device``
  staging queue (page-locked pool slabs, one copy a drained run), the
  fused region with ``inflight=2`` (B1 once a window: 1 eager window + 99
  replays, one capture), the batched decoder and a ``materialize-host``
  drain (one synchronisation a drained run). Its labels and scores are
  bit-identical unfused, with ``inflight=1`` and with ``NNSTPU_POOL=0``; a
  live source paced for partial windows (``latency-budget-ms``,
  ``pad-device``) keeps one capture and labels every frame as the unpaced
  run; the batch-1 fused flagship on the same frames is its comparison.
- bench.py's string with no cuts (``pipeline_uncut``): lanes 4 and the
  leaky stamp-admission ingress; lanes parity, the frame ledger, fault
  policies (with a pinned list-replay scenario) and the watchdog.
- The same string under the SLO scheduler at a 50 ms budget against
  without it (``pipeline_slo``: each warmed by one run, then measured;
  admissions, rejections, sheds by reason, admitted p50/p99, one capture,
  B1 once a window; a live 200-fps run with the budget delivers the
  unbudgeted run's frames in order, less those it shed, bit for bit when
  it shed none);
  the always-on flight recorder's cost against ``NNSTPU_FLIGHT=0`` and a
  tail dump from injected invoke stalls, its gauges over HTTP
  (``flight``); since ROADMAP A.8b each measured run after its warm-up
  run of the same ``Pipeline`` captures nothing, here and in the
  restarted uncut string; ``tensor_rate``'s QoS dropping frames at the
  fused region
  (``qos``); the LM engine's SLO admission (``lm_slo``: fp32 tokens
  unchanged under a wide budget, ``SloRejected`` counted at 50 ms); and
  ``python3 -m nnstreamer_tpu_torch.cli`` in a new process (``cli``).
- bench.py's detection, pose and recurrence strings at its sizes
  (``ssd``: SSD-MobileNet 300×300, 91 classes, bf16, 800 frames, the
  bounding-box decoder's device NMS as the fused region's last stage, B1
  once a frame; ``pose4``: four 257×257 sources through ``tensor_mux
  sync-mode=slowest`` into one batch-4 PoseNet, then live at 15/1 a
  source; ``lstm``: hidden 128, 800 steps through a ``tensor_repo`` slot
  whose state never leaves the card, bit-identical to eager steps), the
  segmenter with ``image_segment`` (``segment``) and YOLO with
  ``bounding_boxes option1=yolov5`` (``yolo``): each fused against
  unfused, the card's NMS against the CPU's on the same model outputs,
  and, after every timed run, a profiled restart of the ssd, pose4,
  segment and audio pipelines (``*_profile``).

- Keyword spotting, file I/O and the stream algebra (``audio``: 80 s
  of a 16 kHz tone from ``audiotestsrc`` in 100 ms chunks through
  ``tensor_aggregator`` into 159 one-second windows with a 0.5 s hop,
  each held byte for byte to the source's samples, B1 on int16 and a 1-D
  conv classifier (width 64, 12 classes, bf16) in one fused region,
  fused = unfused bit for bit, the logits against the fp32 model on the
  CPU; ``files``: the flagship fed ``ball`` frames by ``multifilesrc``
  and by ``filesrc`` with frames straddling its blocks, labels
  bit-identical frame by frame to ``videotestsrc``'s, the logits through
  ``octet_stream`` and the frames through ``direct_video`` into
  ``filesink``, byte-exact;
  ``algebra``: a ``tensor_if`` gate before the fused flagship, SSD's
  outputs through ``tensor_demux`` and pose4's batch through
  ``tensor_split`` with no copy to the host before the sinks,
  ``tensor_crop`` by a ``custom-easy`` filter's regions, and ``join`` of
  the gate's branches).
- The reference two-port wire, the sparse codec, ``SingleShot`` and the
  pipeline filter (``refwire``): the flagship behind
  ``tensor_query_serversrc wire=nnstreamer caps=...`` serving an
  appsrc-fed ``tensor_query_client wire=nnstreamer``, 240 ``ball``
  frames one in flight, the logits bit-identical in order to an
  in-process run, B1 once a frame on the server, a client with other caps
  DENYed; ``tensor_sparse_enc ! tensor_sparse_dec`` before the flagship
  (labels bit-identical) and after its filter in both layouts (the
  logits' bytes, one D2H a buffer); ``SingleShot`` on the card
  bit-identical to the unfused filter; ``tensor_filter
  framework=pipeline`` around the flagship's transform ! filter (labels
  as the flat string's, B1 once a frame). The flexbuf, protobuf and
  flatbuf codecs and the TFLite backend need packages this machine lacks
  and are held to the JAX package by the CPU tests only.
- Broker discovery and MQTT tensor streams (``pubsub``): the flagship
  behind ``tensor_query_serversrc operation=classify`` found through an
  in-process MQTT broker (and the shim broker) by ``tensor_query_client
  operation=classify``, past a ghost ad naming a closed port, its logits
  bit-identical to an in-process run, B1 once a frame on the server; an
  int8 camera stream (``tensor_quant_enc``, B3 on the card, into
  ``mqttsink``) served by ``mqttsrc ! tensor_quant_dec ! flagship``, its
  labels bit-identical to the codec in one process, each payload a
  reference ``GstMQTTMessageHdr``, the pts rebased by the base epochs;
  the same with both sides SNTP-corrected by a loopback server 3 s ahead.

Kernel B1 is held bit for bit against its plain version on both sides
of its launch plan's switch from 4 to 16 elements a thread, for every
numeric input type (at the flagship's, the ssd's, YOLO's and the
segmenter's frames and the audio path's int16 window among others). Kernel B3
(int8 quantize, nearest and dithered) is held bit for bit against its
plain versions, for every input type, on misaligned views, on both sides
of 64 KB and of what its cooperative grid keeps on chip, and for
byte-identical codec blobs, and its dither is checked unbiased. A trace
shows that one call of either at the frame runs one device operation.

Each phase prints one JSON line; the script exits non-zero at the first
failed check, and prints the ``{"ok": true, ...}`` line last only when
every phase passed. Every ``torch.profiler`` measurement runs after every
timed one (once the profiler has traced the card, later launches cost the
host more). Without CUDA, or without the package beside it, it exits
non-zero and prints no result.

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

#: published peaks of one H100 SXM (NVIDIA data sheet): HBM bytes/s,
#: float32 FLOP/s outside the tensor cores, dense bf16 tensor-core FLOP/s
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
BF16_FLOPS = 989e12

FRAMES = 240          # pipeline frames in the measured run
WARMUP_FRAMES = 16    # pipeline frames before it (cuDNN set-up, allocator)
IMAGE = 224
CLASSES = 1001
PROFILED_FRAMES = 48  # pipeline frames in a run under torch.profiler
#: the flagship at bench.py's default batch: frames a run, the batch (the
#: aggregator's frames-out), frames of the profiled run, and the budget
#: run (a live source at a rate that leaves windows partial)
BATCHED_FRAMES = 800
BATCH = 8
BATCHED_PROFILED_FRAMES = 96
BUDGET_FRAMES = 160
BUDGET_RATE = "200/1"
BUDGET_MS = 10
#: bench.py's string with no cuts (``pipeline_uncut``): its lane count
#: (bench.py:136), the supervision phase's fault period and the watchdog's
#: deadline and the bound on its detection (the run, teardown included)
UNCUT_LANES = 4
#: frames of the longer runs of the uncut string that measure it past the
#: region's start-up (eager first window and capture, 0.2-1.1 s), which a
#: new pipeline pays and during which the leaky ingress drops what the
#: free-running source makes (3,000-6,500 gradient frames a second): at
#: 800 frames the source is done before the first window is, and the
#: first quarter of these runs covers the start-up
STEADY_FRAMES = 40000
FAULT_EVERY = 13
WATCHDOG_S = 1.0
WATCHDOG_MAX_S = 3.0
#: the SLO scheduler's budget (serving/scheduler.py's 50 ms), and one wide
#: enough to admit every LM prompt
SLO_BUDGET_MS = 50.0
LM_SLO_WIDE_MS = 600_000.0
#: the flight recorder's dump run: frames, and the injected invoke stall
FLIGHT_FRAMES = 160
FLIGHT_STALL_MS = 40
FLIGHT_COST_PAIRS = 3      # (on, off, off, on) rounds a string
#: the QoS run: frames and tensor_rate's target (below the source's)
QOS_FRAMES = 240
QOS_RATE = "100/1"
#: the frame ledger's stages the uncut string emits: the tiling ones and
#: the transfer and lane spans beside them
LEDGER_STAGES = ("ingest", "lane_reorder", "queue_wait", "fence_wait",
                 "device", "d2h", "decode", "sink", "h2d", "lane_exec")
LOGIT_FRAMES = 4      # frames whose logits are held to the fp32 CPU model
REL_L2_MAX = 2e-2     # bf16 on the card vs fp32 on the CPU, 53 layers
TRANSFORM_CHAIN = [("add", -127.5), ("div", 127.5)]
NORMALIZE_U8_CHAIN = [("sub", 127.5), ("mul", 1.0 / 127.5)]
#: the audio path's transform, ``typecast:float32,div:32768``, as B1's chain
KWS_CHAIN = [("div", 32768.0)]

# -- kernel B2 and LM serving ------------------------------------------------
#: (q shape, k shape) [b, s, h, d] held against the plain version: the LM
#: prefill shapes (the [4, 512] batch, the 16/32/64 prompt buckets), the
#: long-context shape of the JAX package's attention bench, small and
#: ragged shapes, last q tiles of at most 64 rows behind more k tiles than
#: the bf16/f16 body's ring holds (320, 300), and sq != sk (non-causal only)
FLASH_SHAPES = [((4, 512, 8, 64),) * 2, ((1, 4096, 8, 128),) * 2,
                ((2, 256, 2, 32),) * 2, ((1, 16, 8, 64),) * 2,
                ((1, 32, 8, 64),) * 2, ((1, 64, 8, 64),) * 2,
                ((2, 100, 2, 24),) * 2, ((1, 77, 3, 64),) * 2,
                ((1, 320, 2, 64),) * 2, ((2, 300, 2, 128),) * 2,
                ((1, 64, 2, 64), (1, 200, 2, 64)),
                ((1, 64, 2, 64), (1, 512, 2, 64))]
#: the shape of the misaligned views
FLASH_OFFSET_SHAPE = (1, 77, 3, 64)
FLASH_F32_ERR_MAX = 2e-3   # max abs error, the bound of tests/test_ops.py
FLASH_BF16_TOL = 1e-2      # atol = rtol in bf16
#: share of bf16 (and f16) elements more than one ulp from the plain
#: version's: measured at most 8.0e-5 over every bf16 case on an H100
#: (chip_smoke, CUDA-core body)
FLASH_BF16_ULP_SHARE_MAX = 1e-3
#: contiguous views of a buffer, offset by this many elements so that
#: their base is not 16-byte aligned: the wrapper copies them
FLASH_OFFSETS = (3, 1, 5)
#: shapes timed, bf16, causal: the prefill batch (the kernels line's
#: shape), the long-context one, the largest prompt bucket the LM's main
#: path prefills, and the long-context one at d = 64 (half the GEMMs, the
#: same number of scores: what the time does not lose with d is per-score
#: work on the CUDA cores)
FLASH_TIMED = [(4, 512, 8, 64), (1, 4096, 8, 128), (1, 64, 8, 64),
               (1, 4096, 8, 64)]
FLASH_DTYPES = ("float32", "bfloat16", "float16")
#: SASS opcodes counted in the flash library: wgmma and TMA loads
FLASH_SASS_OPS = ("HGMMA", "UTMALDG")
LM = dict(vocab=32000, d_model=512, n_heads=8, n_layers=8, d_ff=2048,
          max_seq=512)
LM_SLOTS = 8
LM_NEW = 128
#: prompt lengths of the measured run (the JAX package's serving bench)
LM_PROMPT_LENS = (8, 17, 33, 12, 25, 9, 40, 14, 21, 30, 11, 19)
LM_WARM_LENS = (8, 17, 33)
LM_PREFILL_BATCH = (4, 512)
LM_PARITY_NEW = 32
LM_DRIFT_MAX = 2e-2        # bf16 vs fp32 first-token logits, relative L2
LM_PROFILED_NEW = 32       # new tokens per prompt in the profiled run
LM_QUERY_CLIENTS = 4       # client pipelines of the lm_query phase, each
#                            pushing LM_PROMPT_LENS[3k:3k+3] in order
LM_KV_DRIFT_MAX = 0.08     # int8 vs raw cache logits / max|logit|, per step
#                            (tests/test_kv_int8.py:69-73)
LM_KV_STEPS = [9, 14, 27, 5, 18, 40]  # the drift check's steps after the
LM_KV_PROMPT = [7, 3, 11, 30, 2]      # prompt (tests/test_kv_int8.py:55-67)
LM_PREAMBLE = 200          # shared preamble of the lm_prefix_chunk prompts
LM_PREFIX_ENTRIES = 4      # prefix_cache=
LM_PREFILL_CHUNK = 64      # prefill_chunk=
# bench.py's ``lm`` report (bench.py:1236-1300): 32 streams of 8-47-token
# prompts over 8 lanes, 64 new tokens, block_tokens=16, K = 8
LM_PAGED_BLOCK = 16
LM_PAGED_STREAMS = 32
LM_PAGED_NEW = 64
LM_STARVED_BLOCKS = 24     # kv_blocks of the run that must shed
# bench.py's ``spec`` report (bench.py:1192-1233): a max_seq-1024 target
# with proj and w_out damped by 0.3, a 2-layer draft, γ = 4, a 32-token
# prompt, 800 tokens, fused
LM_SPEC_GAMMA = 4
LM_SPEC_DRAFT_LAYERS = 2
LM_SPEC_DAMP = 0.3
LM_SPEC_MAX_SEQ = 1024
LM_SPEC_NEW = 800
LM_SPEC_FP32_NEW = 200     # the fp32 exactness run's tokens
# sampled decoding (lm_sampled): the options and seed of the sampled
# engines, the draws of the card's sampler check (in chunks of rows) and
# its chi-square bound
LM_SAMPLING = dict(temperature=0.8, top_k=50, min_p=0.05, seed=7)
LM_CHI2_DRAWS = 20000
LM_CHI2_CHUNK = 2000
LM_CHI2_P_MIN = 1e-3
# bench.py's ``decode`` (bench.py:999-1050): max_seq 1024, 16 decode steps
# an invoke, 800 tokens; the fp32 check's invokes
LM_DECODE_MAX_SEQ = 1024
LM_DECODE_STEPS = 16
LM_DECODE_TOKENS = 800
LM_DECODE_FP32_INVOKES = 4
LM_DECODE_FP32_SCALE = 20.0
# beam search (beam): width, new tokens, the rescoring bound
LM_BEAM_WIDTH = 4
LM_BEAM_NEW = 32
LM_BEAM_RESCORE_TOL = 1e-3
# pipeline_slo's scheduled measured run as PERF.md §6 records it from when
# a restart captured the region again: the runs that keep their graph are
# reported beside it
RECAPTURING_SLO = {"delivered_of_800": 80, "admitted_p99_ms": [248, 536]}

# -- kernel B3 and the query offload path -------------------------------------
#: lengths held against the plain versions beside the 224x224x3 frame
QUANT_LENGTHS = (1, 3, 1001, 4099, 2 ** 20 + 3)
QUANT_SEEDS = (0, 1, 12345, 2 ** 40 + 7)
#: contiguous views of a buffer offset by this many elements (base not
#: 16-byte aligned): the kernel's scalar path
QUANT_OFFSETS = (1, 3, 5)
#: f32 shapes timed: the frame and 2**20 + 3 (all of x kept on chip),
#: 4096 x 4096 (x past the shared memory: read twice) and 4099 (a small
#: tensor, where the grid barrier sets the time)
QUANT_TIMED = [(1, IMAGE, IMAGE, 3), (2 ** 20 + 3,), (4096, 4096), (4099,)]
DITHER_ERR_MAX = 1.01      # |dequant - x| <= this x scale (tests/test_ops.py:89)
BIAS_ELEMENTS = 2 ** 20    # elements at 0.3 scale in the unbiasedness check
BIAS_TOL = 0.01            # |mean(q) - 0.3| over them, dithered
ENCODE_FRAMES = 8          # device quant_encode blobs held to the host one's
#: non-finite f32 inputs of 4099 elements, {index: value}: NaN in the
#: vectorized body, inf in the scalar tail, both, -inf
QUANT_NON_FINITE = ({2000: "nan"}, {4098: "inf"}, {7: "-inf"},
                    {5: "inf", 4097: "nan"})
QUERY_BYTES_MAX = 0.26     # client bytes sent per frame / the f32 frame's
#: CUDA API calls (runtime ``cuda*`` and low-level ``cu*``) that launch
#: device work, counted on the host side of a profiled run
#: bench.py's detection, pose and recurrence configurations at its sizes
#: (bench.py:728-926), and the segmenter's: frames a measured run, frames
#: of the fused-against-unfused comparison, frames whose model outputs
#: hold the device NMS on the card to the CPU's
SSD_IMAGE = 300
SSD_CLASSES = 91
SSD_FRAMES = 800
SSD_PARITY_FRAMES = 64
SSD_NMS_FRAMES = 8
YOLO_IMAGE = 320
YOLO_CLASSES = 80
YOLO_FRAMES = 16
YOLO_THRESHOLD = 0.26
POSE_IMAGE = 257
POSE_FRAMES = 200          # a source (4 sources: 800 frames)
POSE_PARITY_SETS = 16
POSE_LIVE_FRAMES = 120     # a source, paced at POSE_LIVE_RATE
POSE_LIVE_RATE = "15/1"
LSTM_HIDDEN = 128
LSTM_STEPS = 800
LSTM_REGION_STEPS = 200    # the loop with a fused transform ! filter
LSTM_CPU_ATOL = 1e-5       # card vs fp32 CPU loop after LSTM_STEPS steps
SEG_IMAGE = 256
SEG_CLASSES = 21
SEG_BASE = 32
SEG_PARITY_FRAMES = 32
SEG_FRAMES = 240
# device memory and serving continuity (memory, continuity, lm_memory)
MEM_FRAMES = 64            # the two-model run under the budget: 8 windows
MEM_BUDGET_SHARE = 0.75    # the budget, as a share of the summed weights
MEM_OOM_FRAMES = 160       # the OOM-ladder run: 20 windows
MEM_OOM_FAULT = "filter.invoke:nth=9,kind=oom"
CONT_FRAMES = 800          # the swap run, cut over at half
CONT_DISTINCT = 64         # distinct frames it cycles through
CONT_LSTM_STEPS = 400      # lstm steps before and after the checkpoint
CONT_SWAP_SLACK = 128      # frames a running swap may cut over past 400
LM_MEM_PROMPTS = 8
LM_MEM_NEW = 32
# audio keyword spotting, file I/O and the stream algebra (audio, files,
# algebra): 80 s of 16 kHz audio in 100 ms chunks, 1 s windows, 0.5 s hop
KWS_SAMPLES = 16000
KWS_HOP = 8000
KWS_CHUNK = 1600
KWS_BUFFERS = 800
KWS_RATE = 16000
KWS_CLASSES = 12
# the tone: a 0.5 s hop is 221.618 cycles (a fractional part near the
# golden ratio's), so every window starts at another phase and no two of
# the 159 windows hold the same samples
KWS_FREQ = 443.236
KWS_WINDOWS = (KWS_BUFFERS * KWS_CHUNK - KWS_SAMPLES) // KWS_HOP + 1  # 159
FILES_FRAMES = 240
FILES_BLOCK = 65536        # filesrc blocks: a 150,528 B frame straddles them
GATE_FRAMES = 64           # tensor_if gate and join, appsrc frames
GATE_THRESHOLD = 64        # frame mean; dark frames are scaled to 1/10
DEMUX_FRAMES = 32          # SSD frames through tensor_demux
SPLIT_SETS = 16            # pose4 sets through tensor_split
CROP_FRAMES = 32           # 300x300 frames through tensor_crop
# the reference wire, the sparse codec, SingleShot and the pipeline filter
# (refwire): ball frames through the wire (and the sparse pair before the
# flagship), warm-up frames before them, logits through each sparse
# layout, SingleShot invokes, frames through the pipeline filter
REFWIRE_FRAMES = 240
REFWIRE_WARMUP = 8
REFWIRE_SPARSE_FRAMES = 64
REFWIRE_SINGLE_FRAMES = 16
REFWIRE_NESTED_FRAMES = 64
# broker discovery and MQTT tensor streams (pubsub): ball frames behind
# operation= over MQTT (and over the shim broker), frames of the int8
# camera stream, frames whose logits go into mqttsink, frames of the
# NTP-corrected stream, the mock SNTP server's offset and the bound on the
# measured one (tests/test_mqtt.py:317)
PUBSUB_FRAMES = 240
PUBSUB_WARMUP = 8
PUBSUB_SHIM_FRAMES = 32
PUBSUB_DEVICE_FRAMES = 16
PUBSUB_NTP_FRAMES = 16
PUBSUB_NTP_OFFSET_NS = 3_000_000_000
PUBSUB_NTP_TOL_NS = 200_000_000
HOST_LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC",
                     "cudaLaunchCooperativeKernel", "cuLaunchKernel",
                     "cuLaunchKernelEx", "cudaGraphLaunch", "cudaMemcpyAsync",
                     "cudaMemsetAsync")


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


#: (phase, time.monotonic()) at each phase's line: a phase's seconds run
#: from the line before it to its own
_phase_marks = [("start", time.monotonic())]


def emit(obj) -> None:
    if "phase" in obj:
        _phase_marks.append((obj["phase"], time.monotonic()))
    print(json.dumps(obj), flush=True)


def phase_seconds() -> dict:
    """Seconds each phase took, in the order they ran (a phase that prints
    twice adds up), and the run's total so far."""
    out: dict = {}
    for (_, t0), (name, t1) in zip(_phase_marks, _phase_marks[1:]):
        out[name] = out.get(name, 0.0) + (t1 - t0)
    return {"phase_seconds": out,
            "total_s": time.monotonic() - _phase_marks[0][1]}


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
def sass_op_counts(path, ops) -> dict:
    """Instructions of each opcode in ``ops`` in a built library's SASS
    (``cuobjdump -sass``, from the toolkit beside nvcc)."""
    import re

    from nnstreamer_tpu_torch.ops import _build

    tool = os.path.join(os.path.dirname(_build.find_nvcc()), "cuobjdump")
    text = subprocess.run([tool, "-sass", str(path)], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    return {op: len(re.findall(rf"\b{op}\b", text)) for op in ops}


def arm_compile_cache() -> str:
    """The kernels build into a compile cache of this run (cold: 3
    misses), ``smoke_out/compile-cache`` of the checkout; every process
    this script starts finds them there (``NNSTPU_COMPILE_CACHE``), and
    the continuity phase's second boot builds none."""
    from nnstreamer_tpu_torch.pipeline import continuity

    cache = os.path.join(HERE, "smoke_out", "compile-cache")
    shutil.rmtree(cache, ignore_errors=True)
    os.environ[continuity.CACHE_ENV] = cache
    return continuity.enable_compile_cache(cache)


def phase_build():
    from nnstreamer_tpu_torch.ops import _build

    t0 = time.monotonic()
    paths = _build.build_all()
    seconds = time.monotonic() - t0
    sass = sass_op_counts(paths["flash_attention"], FLASH_SASS_OPS)
    emit({"phase": "build", "seconds": seconds,
          "build_seconds": {n: r["seconds"]
                            for n, r in _build.build_log.items()},
          "libraries": {n: str(p.relative_to(HERE)) for n, p in paths.items()},
          "ptxas": {n: [ln for ln in str(r["output"]).splitlines()
                        if any(w in ln for w in ("registers", "spill",
                                                 "wgmma", "setmaxnreg"))]
                    for n, r in _build.build_log.items()},
          "flash_attention_sass": sass})
    check(sass["HGMMA"] > 0, "no wgmma (HGMMA) in the flash library")
    check(sass["UTMALDG"] > 0, "no TMA load (UTMALDG) in the flash library")


# -- phase 3: kernel B1 against its plain version ---------------------------
def _bits(t):
    import torch

    return t.view({4: torch.int32, 2: torch.int16}[t.element_size()])


def phase_normalize():
    import torch

    from nnstreamer_tpu_torch.ops import _build
    from nnstreamer_tpu_torch.ops import preprocess as pp

    dev = torch.device("cuda:0")
    sms = _build.sm_count(0)
    gen = torch.Generator(device="cpu").manual_seed(0)
    # the launch plan's switch from 4 to 16 elements a thread, and past it
    # with a ragged tail
    switch = int(4 * pp.THREADS * pp.WAVE_BLOCKS_PER_SM * sms *
                 pp.PASSES_OF_4_MAX)
    shapes = [(224, 224, 3), (8, 224, 224, 3), (1,), (15,), (17,),
              (10 ** 6 + 3,), (switch,), (switch + 17,),
              # the frames of the ssd, yolo and segment paths
              (1, SSD_IMAGE, SSD_IMAGE, 3), (1, YOLO_IMAGE, YOLO_IMAGE, 3),
              (1, SEG_IMAGE, SEG_IMAGE, 3)]
    outs = [torch.float32, torch.bfloat16, torch.float16]
    chains = {"transform": TRANSFORM_CHAIN, "normalize_u8": NORMALIZE_U8_CHAIN}
    frame_plan = pp.normalize_plan(IMAGE * IMAGE * 3, True, sms)
    check(frame_plan.blocks >= sms,
          f"normalize plan at the frame: {frame_plan} has fewer blocks than "
          f"the card's {sms} SMs")
    check([pp.normalize_plan(n, True, sms).ept
           for n in (switch, switch + 17)] == [4, 16],
          "the plan does not switch to 16 elements a thread at "
          f"{switch} elements")
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

    # every other input type (ROADMAP.md C.8), converted to float32 as
    # .to(torch.float32) converts it: held to the plain version on the
    # CPU, where torch converts every type (unsigned types made as the
    # signed ones of their width, viewed)
    signed = {torch.uint16: torch.int16, torch.uint32: torch.int32,
              torch.uint64: torch.int64}
    for in_dtype in pp.IN_CODES:
        if in_dtype in (torch.uint8, torch.float32):
            continue
        for n in (IMAGE * IMAGE * 3, switch + 17):
            for offset in (0, 1):
                m = n + offset
                if in_dtype.is_floating_point:
                    base = (torch.randn(m, generator=gen,
                                        dtype=torch.float64) * 1e4
                            ).to(in_dtype)
                elif in_dtype is torch.bool:
                    base = torch.randint(0, 2, (m,), generator=gen) > 0
                else:
                    base = torch.randint(-2 ** 40, 2 ** 40, (m,),
                                         generator=gen).to(
                        signed.get(in_dtype, in_dtype))
                    base = base.view(in_dtype)
                x = base.to(dev)[offset:]
                for cname, ops in chains.items():
                    for out_dtype in outs:
                        y = pp.normalize_chain(x, ops, out_dtype).cpu()
                        ref = pp.normalize_chain_reference(x.cpu(), ops,
                                                           out_dtype)
                        err = (y.float() - ref.float()).abs().max().item()
                        max_abs_err = max(max_abs_err, err)
                        check(torch.equal(_bits(y), _bits(ref)),
                              f"normalize_chain {cname} {n} {in_dtype}->"
                              f"{out_dtype} offset {offset}: not "
                              f"bit-identical to the plain version (max abs "
                              f"err {err})")
                        cases += 1

    # the audio path's window: int16 [16000, 1] through its chain, on
    # aligned and misaligned views
    for offset in (0, 1, 3):
        base = torch.randint(-2 ** 15, 2 ** 15, (KWS_SAMPLES + offset,),
                             generator=gen, dtype=torch.int16)
        x = base.to(dev)[offset:].view(KWS_SAMPLES, 1)
        for out_dtype in outs:
            y = pp.normalize_chain(x, KWS_CHAIN, out_dtype)
            ref = pp.normalize_chain_reference(x, KWS_CHAIN, out_dtype)
            err = (y.float() - ref.float()).abs().max().item()
            max_abs_err = max(max_abs_err, err)
            check(torch.equal(_bits(y), _bits(ref)),
                  f"normalize_chain kws int16 [{KWS_SAMPLES}, 1] offset "
                  f"{offset} -> {out_dtype}: not bit-identical to the plain "
                  f"version (max abs err {err})")
            cases += 1

    # signed zeros: 0.0 and -0.0 are equal keys to Python, but x / -0.0 is
    # -inf where x / 0.0 is +inf (x > 0 here, so no NaN)
    x = torch.randint(1, 256, (IMAGE, IMAGE, 3), generator=gen,
                      dtype=torch.uint8).to(dev)
    for ops in ([("div", 0.0)], [("div", -0.0)], [("mul", -0.0)],
                [("add", -0.0), ("mul", -1.0)]):
        y = pp.normalize_chain(x, ops, torch.float32)
        ref = pp.normalize_chain_reference(x, ops, torch.float32)
        check(torch.equal(_bits(y), _bits(ref)),
              f"normalize_chain {ops}: not bit-identical to the plain "
              "version")
        cases += 1

    # times at the main path's shape (one 224x224x3 uint8 frame -> float32),
    # at 8 frames and at 10**6 + 3 elements, at the other paths' frames,
    # and at the audio path's int16 window: tag -> (shape, dtype, chain)
    u8 = (torch.uint8, TRANSFORM_CHAIN)
    timed_shapes = {"": ((1, IMAGE, IMAGE, 3), *u8),
                    "batch8_": ((8, IMAGE, IMAGE, 3), *u8),
                    "big_": ((10 ** 6 + 3,), *u8),
                    "ssd_": ((1, SSD_IMAGE, SSD_IMAGE, 3), *u8),
                    "segment_": ((1, SEG_IMAGE, SEG_IMAGE, 3), *u8),
                    "kws_": ((KWS_SAMPLES, 1), torch.int16, KWS_CHAIN)}
    times = {}
    timed = {}
    for tag, (shape, in_dtype, chain) in timed_shapes.items():
        info = torch.iinfo(in_dtype)
        xin = torch.randint(info.min, info.max + 1, shape, generator=gen,
                            dtype=in_dtype).to(dev)

        def kernel(xin=xin, chain=chain):
            return pp.normalize_chain(xin, chain, torch.float32)

        def plain(xin=xin, chain=chain):
            return pp.normalize_chain_reference(xin, chain, torch.float32)

        # calls back to back, by CUDA events: what a caller of the wrapper
        # gets, host overhead included
        times[f"{tag}ms"] = cuda_time_ms(kernel)
        times[f"{tag}plain_ms"] = cuda_time_ms(plain)
        n = xin.numel()
        # each input read once, the f32 output written once
        bytes_ms = n * (xin.element_size() + 4) / HBM_BYTES_PER_S * 1e3
        ops_ms = n * len(chain) / FP32_FLOPS * 1e3
        times[f"{tag}bound_ms"] = max(bytes_ms, ops_ms)
        times[f"{tag}bound_by"] = "bytes" if bytes_ms >= ops_ms \
            else "operations"
        times[f"{tag}plan"] = pp.normalize_plan(
            n, xin.data_ptr() % 16 == 0, sms)._asdict()
        timed[tag] = (kernel, plain)
    n = IMAGE * IMAGE * 3
    result = {
        "cases": cases, "bit_identical": True, "max_abs_err": max_abs_err,
        "bytes": n * (1 + 4), "flops": n * len(TRANSFORM_CHAIN),
        "sms": sms, "plan_switch_elements": switch, **times,
    }
    emit({"phase": "normalize_chain", **result})
    return result, timed


def phase_device_times(name: str, timed) -> None:
    """Device time alone of each kernel and its yardsticks, from
    ``torch.profiler`` traces (``timed``: tag → {prefix: fn, launches}).
    Run after every timed phase: once the profiler has traced the card,
    later launches cost the host more."""
    out = {}
    for tag, fns in timed.items():
        fns = dict(fns)
        launches = fns.pop("launches", 200)
        for prefix, fn in fns.items():
            out[f"{tag}{prefix}device_ms"] = device_time_ms(fn, launches)
    emit({"phase": f"{name}_device_time", **out})
    return out


def device_ops_per_call(fn, calls: int = 20) -> dict:
    """Device operations (kernels, memsets, copies) that one call of ``fn``
    runs, by name, from a ``torch.profiler`` trace of ``calls`` calls."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    ops = {}
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            ops[ev.name] = ops.get(ev.name, 0) + 1
    return {name: count / calls for name, count in ops.items()}


def one_launch_check() -> None:
    """One B1 call and one B3 call at the frame each run exactly one
    device operation: the trace of 20 calls holds one kernel's name and
    nothing else (no memset, no copy), at most once a call. The profiler
    may drop an event at the start of its window, so the count is held
    to between 0.9 and 1 a call. Runs in the process ``phase_one_launch``
    starts, on the frame-shaped calls of ``phase_normalize`` and
    ``phase_quantize``."""
    import torch

    from nnstreamer_tpu_torch.ops import preprocess as pp
    from nnstreamer_tpu_torch.ops import quantize as qz

    gen = torch.Generator().manual_seed(0)
    xin = torch.randint(0, 256, (1, IMAGE, IMAGE, 3), generator=gen,
                        dtype=torch.uint8).to("cuda:0")
    x = _quant_input((1, IMAGE, IMAGE, 3), torch.float32, gen)
    out = {}
    for name, fn in (
            ("normalize_chain",
             lambda: pp.normalize_chain(xin, TRANSFORM_CHAIN, torch.float32)),
            ("quantize_int8", lambda: qz.quantize_int8(x, force="reference"))):
        ops = device_ops_per_call(fn)
        out[name] = ops
        kernels = [op for op, per_call in ops.items()
                   if "mem" not in op.lower() and 0.9 <= per_call <= 1.0]
        check(len(ops) == 1 and len(kernels) == 1,
              f"one {name} call at the frame ran device operations {ops}, "
              "not one kernel")
    emit({"phase": "one_launch", "device_ops_per_call": out})


def phase_one_launch() -> None:
    """``one_launch_check`` in a new process (the kernels load from this
    run's build): on an H100 ``torch.profiler`` lost a growing share of
    device events as a process aged — a minute of idle sleep turned
    complete 10-call traces into 4 events of 10 (PERF.md §6) — and this
    script's process is minutes old by now."""
    proc = subprocess.run(
        [sys.executable, "-c",
         "import chip_smoke as c; c.one_launch_check()"],
        cwd=HERE, capture_output=True, text=True, timeout=300)
    check(proc.returncode == 0,
          f"one_launch: rc {proc.returncode}: {proc.stderr[-2000:]}")
    print(proc.stdout.strip().splitlines()[-1], flush=True)


# -- phase: kernel B2 against its plain version -----------------------------
def attention_bound(qshape, kshape, causal: bool, elem_bytes: int):
    """Bytes, operations and the least time of one attention call on this
    card: q, k, v read once and o written once over the HBM rate; the
    QK and PV products (4·d operations per (query, key) pair this call
    needs — the causal pairs only) over the dense bf16 tensor-core rate."""
    b, sq, h, d = qshape
    sk = kshape[1]
    nbytes = elem_bytes * (2 * b * sq * h * d + 2 * b * sk * h * d)
    pairs = sum(min(i + 1, sk) for i in range(sq)) if causal else sq * sk
    flops = 4 * b * h * d * pairs
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / BF16_FLOPS * 1e3
    return {"bytes": nbytes, "flops": flops,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


def b2_tensor_core_ms(shape):
    """Time at the dense bf16 peak of the GEMMs that B2's bf16/f16 body
    issues for a causal self-attention call on ``shape`` [b, s, h, d]:
    whole 64 x 64 tiles of every 64 q rows up to their last live k tile,
    d padded to 64, 128 or 256, QK once and P.V twice (the split P)."""
    b, s, h, d = shape
    dpad = 64 if d <= 64 else 128 if d <= 128 else 256
    tiles = sum(min(s - 1, q0 + 63) // 64 + 1 for q0 in range(0, s, 64))
    return b * h * tiles * 3 * 2 * 64 * 64 * dpad / BF16_FLOPS * 1e3


def _bf16_ulps_apart(a, b):
    """Share of elements of two bf16 (or f16) tensors more than one ulp
    apart (by their bit patterns)."""
    import torch

    d = (a.view(torch.int16).int() - b.view(torch.int16).int()).abs()
    return float((d > 1).float().mean())


def phase_flash_attention():
    import torch
    import torch.nn.functional as F

    from nnstreamer_tpu_torch.ops import flash_attention as fa
    from nnstreamer_tpu_torch.ops._counts import LAUNCHES, reset_launches

    dev = torch.device("cuda:0")
    # the plain version in full fp32 (cuBLAS would round f32 einsums to
    # TF32 with these on)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator().manual_seed(1)
    cases = []
    max_err = dict.fromkeys(FLASH_DTYPES, 0.0)
    max_ulp_share = 0.0
    for qshape, kshape in FLASH_SHAPES:
        base = [torch.randn(shape, generator=gen).to(dev)
                for shape in (qshape, kshape, kshape)]
        for causal in (True, False):
            if causal and qshape != kshape:
                continue
            for dtype in (getattr(torch, dt) for dt in FLASH_DTYPES):
                q, k, v = (t.to(dtype) for t in base)
                reset_launches()
                out = fa.flash_attention(q, k, v, causal=causal)
                ref = fa.attention_reference(q, k, v, causal=causal)
                torch.cuda.synchronize()
                what = f"flash_attention {qshape}/{kshape} causal={causal} " \
                       f"{dtype}"
                check(LAUNCHES["flash_attention"] == 1,
                      f"{what}: the kernel did not run ({LAUNCHES})")
                check(out.shape == ref.shape and out.dtype == ref.dtype,
                      f"{what}: shape or dtype differs")
                check(bool(torch.isfinite(out).all()),
                      f"{what}: not finite")
                err = (out.float() - ref.float()).abs().max().item()
                name = str(dtype).split(".")[-1]
                max_err[name] = max(max_err[name], err)
                case = {"q": qshape, "k": kshape, "causal": causal,
                        "dtype": name, "max_abs_err": err}
                if dtype is torch.float32:
                    check(err <= FLASH_F32_ERR_MAX,
                          f"{what}: max abs err {err} > {FLASH_F32_ERR_MAX}")
                else:
                    close = torch.allclose(out.float(), ref.float(),
                                           atol=FLASH_BF16_TOL,
                                           rtol=FLASH_BF16_TOL)
                    check(close, f"{what}: not within atol=rtol="
                                 f"{FLASH_BF16_TOL} (max abs err {err})")
                    case["share_over_1ulp"] = _bf16_ulps_apart(out, ref)
                    check(case["share_over_1ulp"] <= FLASH_BF16_ULP_SHARE_MAX,
                          f"{what}: {case['share_over_1ulp']} of the "
                          f"elements more than one ulp apart > "
                          f"{FLASH_BF16_ULP_SHARE_MAX}")
                    max_ulp_share = max(max_ulp_share,
                                        case["share_over_1ulp"])
                cases.append(case)

    # contiguous views whose base is not 16-byte aligned
    shape = FLASH_OFFSET_SHAPE
    n = 1
    for dim in shape:
        n *= dim
    for dtype in (getattr(torch, dt) for dt in FLASH_DTYPES):
        views = []
        for offset in FLASH_OFFSETS:
            buf = torch.randn(n + offset, generator=gen).to(dev).to(dtype)
            views.append(buf[offset:].view(shape))
        check(all(t.is_contiguous() and t.data_ptr() % 16 for t in views),
              "the offset views are aligned")
        reset_launches()
        out = fa.flash_attention(*views, causal=True)
        ref = fa.attention_reference(*views, causal=True)
        torch.cuda.synchronize()
        what = f"flash_attention {shape} {dtype} offsets {FLASH_OFFSETS}"
        check(LAUNCHES["flash_attention"] == 1,
              f"{what}: the kernel did not run ({LAUNCHES})")
        err = (out.float() - ref.float()).abs().max().item()
        tol = FLASH_F32_ERR_MAX if dtype is torch.float32 else FLASH_BF16_TOL
        check(torch.allclose(out.float(), ref.float(), atol=tol, rtol=tol),
              f"{what}: max abs err {err}")
        name = str(dtype).split(".")[-1]
        max_err[name] = max(max_err[name], err)
        cases.append({"q": shape, "k": shape, "causal": True, "dtype": name,
                      "offsets": FLASH_OFFSETS, "max_abs_err": err})

    # a head dimension outside the kernel's rule raises on the card
    q = torch.zeros((1, 16, 2, 12), device=dev)
    try:
        fa.flash_attention(q, q, q)
        raised = False
    except ValueError:
        raised = True
    check(raised, "flash_attention took head_dim 12 on the card")

    # causality across k tiles: keys and values from 128 on must not touch
    # the rows before 128 — bit for bit
    for dtype in (getattr(torch, dt) for dt in FLASH_DTYPES):
        q, k, v = (torch.randn((1, 256, 1, 16), generator=gen).to(dev)
                   .to(dtype) for _ in range(3))
        out = fa.flash_attention(q, k, v, causal=True)
        k2, v2 = k.clone(), v.clone()
        k2[:, 128:] = 0
        v2[:, 128:] = 0
        out2 = fa.flash_attention(q, k2, v2, causal=True)
        torch.cuda.synchronize()
        check(torch.equal(out[:, :128], out2[:, :128]),
              f"flash_attention {dtype}: rows before 128 moved when later "
              "keys changed")

    timed_ms = {}
    timed = {}
    for shape in FLASH_TIMED:
        q, k, v = (torch.randn(shape, generator=gen).to(dev)
                   .to(torch.bfloat16) for _ in range(3))
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))  # [b, h, s, d]

        def kernel(q=q, k=k, v=v):
            return fa.flash_attention(q, k, v, causal=True)

        def plain(q=q, k=k, v=v):
            return fa.attention_reference(q, k, v, causal=True)

        def library(q=qt, k=kt, v=vt):
            return F.scaled_dot_product_attention(q, k, v, is_causal=True)

        launches = 200 if shape[1] <= 512 else 20
        tag = "x".join(str(n) for n in shape)
        timed_ms[tag] = {
            "ms": cuda_time_ms(kernel, launches),
            "plain_ms": cuda_time_ms(plain, launches),
            "library_ms": cuda_time_ms(library, launches),
            "tensor_core_ms": b2_tensor_core_ms(shape),
            **attention_bound(shape, shape, True, 2),
        }
        timed[f"{tag}_"] = {"": kernel, "plain_": plain,
                            "library_": library, "launches": launches}
    result = {"cases": len(cases), "max_abs_err": max(max_err.values()),
              "max_abs_err_by_dtype": max_err,
              "f32_err_max_allowed": FLASH_F32_ERR_MAX,
              "bf16_tol": FLASH_BF16_TOL,
              "bf16_share_over_1ulp_max": max_ulp_share,
              "bf16_share_over_1ulp_max_allowed": FLASH_BF16_ULP_SHARE_MAX,
              "causality_bit_identical": True, "timed_bf16_causal": timed_ms,
              "case_list": cases}
    emit({"phase": "flash_attention", **result})
    return result, timed


# -- phase: kernel B3 against its plain versions -----------------------------
def _quant_input(shape, dtype, gen):
    """Seeded input of ``dtype`` on the card: floats spread over ±200,
    integers over their range (int32 and int64 wide enough that the
    conversion to f32 rounds)."""
    import torch

    n = 1
    for d in shape:
        n *= d
    if dtype.is_floating_point:
        return (torch.randn(n, generator=gen) * 200.0).to(dtype).view(
            shape).to("cuda:0")
    lo, hi = {torch.uint8: (0, 256), torch.int8: (-128, 128),
              torch.int16: (-32768, 32768),
              torch.int32: (-2 ** 31, 2 ** 31 - 1),
              torch.int64: (-2 ** 62, 2 ** 62)}[dtype]
    return torch.randint(lo, hi, (n,), generator=gen,
                         dtype=torch.int64).to(dtype).view(shape).to("cuda:0")


def quantize_bound(n: int, elem_bytes: int) -> dict:
    """Bytes and the least time of one quantize call on this card: x read
    once, q and the scale written once, over the HBM rate (the n compares
    and multiplies are far below the f32 rate). ``two_pass_bytes`` is what
    a kernel that cannot keep x on chip moves: x read twice."""
    nbytes = n * elem_bytes + n + 4
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = 2 * n / FP32_FLOPS * 1e3
    two_pass = 2 * n * elem_bytes + n + 4
    return {"bytes": nbytes, "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "two_pass_bytes": two_pass,
            "two_pass_bound_ms": two_pass / HBM_BYTES_PER_S * 1e3}


def phase_quantize():
    import numpy as np
    import torch

    from nnstreamer_tpu_torch.elements.quant import quant_encode
    from nnstreamer_tpu_torch.ops import _build
    from nnstreamer_tpu_torch.ops import quantize as qz
    from nnstreamer_tpu_torch.ops._counts import LAUNCHES, reset_launches

    gen = torch.Generator().manual_seed(3)
    dtypes = list(qz.IN_CODES)
    shapes = [(1, IMAGE, IMAGE, 3)] + [(n,) for n in QUANT_LENGTHS]
    cases = 0
    max_abs_err = 0
    max_dither_err = 0.0

    def held(x, what):
        nonlocal cases, max_abs_err, max_dither_err
        reset_launches()
        q, s = qz.quantize_int8(x, force="reference")
        rq, rs = qz.quantize_nearest_reference(x)
        torch.cuda.synchronize()
        check(LAUNCHES["quantize_int8"] == 1,
              f"quantize_int8 {what}: the kernel did not run ({LAUNCHES})")
        check(q.shape == x.shape and q.dtype == torch.int8 and
              s.shape == (1,) and s.dtype == torch.float32,
              f"quantize_int8 {what}: shape or dtype")
        err = int((q.int() - rq.int()).abs().max())
        max_abs_err = max(max_abs_err, err)
        check(torch.equal(q, rq) and torch.equal(s.view(torch.int32),
                                                 rs.view(torch.int32)),
              f"quantize_int8 {what} nearest: not bit-identical to the "
              f"plain version (max abs err {err})")
        cases += 1
        xf = x.float()
        for seed in QUANT_SEEDS:
            q, s = qz.quantize_int8(x, seed=seed, force="dither")
            rq, _ = qz.quantize_dither_reference(x, seed)
            torch.cuda.synchronize()
            err = int((q.int() - rq.int()).abs().max())
            max_abs_err = max(max_abs_err, err)
            check(torch.equal(q, rq), f"quantize_int8 {what} dither seed "
                                      f"{seed}: not bit-identical to the "
                                      f"plain Philox version ({err})")
            derr = float(((qz.dequantize_int8(q, s) - xf).abs().max()
                          / s[0]).item())
            max_dither_err = max(max_dither_err, derr)
            check(derr <= DITHER_ERR_MAX, f"quantize_int8 {what} dither "
                                          f"seed {seed}: error {derr} scale")
            cases += 1

    for shape in shapes:
        for dtype in dtypes:
            held(_quant_input(shape, dtype, gen), f"{shape} {dtype}")

    # small tensors at 64 KB of x minus and plus one 16-element vector (f32,
    # f64 and uint8, also at a misaligned view), and just past what the
    # kernel keeps on chip (f32; also at a misaligned view)
    sms = _build.sm_count(0)
    plans = {}
    for dtype in (torch.float32, torch.float64, torch.uint8):
        size = torch.empty((), dtype=dtype).element_size()
        small = 64 * 1024 // size
        for n in (small - 16, small, small + 16):
            held(_quant_input((n,), dtype, gen), f"({n},) {dtype}")
        base = _quant_input((small + 1,), dtype, gen)
        held(base[1:], f"({small},) {dtype} view at offset 1")
    over = sms * qz.kept_per_block(4) + 16
    plan = qz.quantize_plan(over, 4, sms)
    check(plan.kept == 0,
          f"quantize plan for {over} f32 keeps x on chip: {plan}")
    held(_quant_input((over,), torch.float32, gen), f"({over},) f32")
    base = _quant_input((over + 3,), torch.float32, gen)
    held(base[3:], f"({over},) f32 view at offset 3")
    plans[f"{over}xtorch.float32"] = plan._asdict()
    # the f32 frame: all SMs, x staged once from HBM
    frame_plan = qz.quantize_plan(IMAGE * IMAGE * 3, 4, sms)
    check(frame_plan.blocks >= sms - 4 and frame_plan.kept == frame_plan.chunk,
          f"the f32 frame's plan: {frame_plan}")

    for dtype in (torch.float32, torch.bfloat16, torch.uint8):
        n = IMAGE * IMAGE * 3
        for offset in QUANT_OFFSETS:
            base = _quant_input((n + offset,), dtype, gen)
            view = base[offset:].view(1, IMAGE, IMAGE, 3)
            check(view.is_contiguous() and view.data_ptr() % 16 != 0,
                  "the offset view is aligned")
            held(view, f"{dtype} view at offset {offset}")

    # a type the kernel does not take raises on the card; empty launches none
    for bad in (torch.bool, torch.complex64):
        try:
            qz.quantize_int8(torch.zeros(4, dtype=bad, device="cuda:0"))
            raised = False
        except TypeError:
            raised = True
        check(raised, f"quantize_int8 took {bad} on the card")
    reset_launches()
    q, s = qz.quantize_int8(torch.empty(0, device="cuda:0"))
    check(q.numel() == 0 and float(s[0]) == np.float32(1e-30) and
          LAUNCHES["quantize_int8"] == 0, "empty input")

    # non-finite input: q and the scale's bits as the plain version on the
    # host gives them (a NaN quotient to 0, a NaN scale as 0x7fc00000), and
    # the device codec blob as the host codec's
    for spots in QUANT_NON_FINITE:
        x = _quant_input((4099,), torch.float32, gen)
        for i, v in spots.items():
            x[i] = float(v)
        rq, rs = qz.quantize_nearest_reference(x.cpu())
        for force in ("reference", "dither"):
            q, s = qz.quantize_int8(x, seed=5, force=force)
            check(torch.equal(q.cpu(), rq) and
                  s.cpu().numpy().tobytes() == rs.numpy().tobytes(),
                  f"quantize_int8 {force} with {spots}: q or scale differs "
                  f"from the plain version (scale {s.item()} vs "
                  f"{rs.item()})")
            cases += 1
        with np.errstate(invalid="ignore"):
            check(quant_encode(x) == quant_encode(x.cpu().numpy()),
                  f"{spots}: device quant_encode blob differs from the host's")

    # device encode vs host encode of the same values: byte-identical blobs
    for i in range(ENCODE_FRAMES):
        frame = _quant_input((1, IMAGE, IMAGE, 3), torch.float32, gen) / 200
        check(quant_encode(frame) == quant_encode(frame.cpu().numpy()),
              f"frame {i}: device quant_encode blob differs from the host's")

    # unbiased dither: 0.3 scale rounds to 0 by nearest, to 0.3 on average
    step = 0.01
    x = torch.full((BIAS_ELEMENTS + 1,), 0.3 * step, device="cuda:0")
    x[0] = 127 * step
    bias = {}
    for seed in QUANT_SEEDS:
        q, _ = qz.quantize_int8(x, seed=seed, force="dither")
        bias[seed] = float(q[1:].double().mean())
        check(abs(bias[seed] - 0.3) <= BIAS_TOL,
              f"dither seed {seed}: mean {bias[seed]} not within {BIAS_TOL} "
              "of 0.3")
    q, _ = qz.quantize_int8(x, force="reference")
    nearest_mean = float(q[1:].double().mean())
    check(nearest_mean == 0.0, f"nearest mean {nearest_mean}")

    times, timed = {}, {}
    for shape in QUANT_TIMED:
        x = _quant_input(shape, torch.float32, gen)

        def kernel(x=x):
            return qz.quantize_int8(x, force="reference")

        def dither(x=x):
            return qz.quantize_int8(x, seed=7, force="dither")

        def plain(x=x):
            return qz.quantize_nearest_reference(x)

        def plain_dither(x=x):  # Philox in int64 ops: fewer calls
            return qz.quantize_dither_reference(x, 7)

        tag = "x".join(str(d) for d in shape)
        times[tag] = {"plan": qz.quantize_plan(x.numel(), 4,
                                               sms)._asdict(),
                      "ms": cuda_time_ms(kernel),
                      "dither_ms": cuda_time_ms(dither),
                      "plain_ms": cuda_time_ms(plain),
                      "dither_plain_ms": cuda_time_ms(plain_dither,
                                                      launches=20, repeats=5),
                      **quantize_bound(x.numel(), 4)}
        timed[f"{tag}_"] = {"": kernel, "dither_": dither, "plain_": plain}
        timed[f"{tag}_dither_"] = {"plain_": plain_dither, "launches": 20}
    result = {"cases": cases, "bit_identical": True,
              "max_abs_err": max_abs_err,
              "dither_err_over_scale_max": max_dither_err,
              "dither_err_max_allowed": DITHER_ERR_MAX,
              "dither_mean_at_0.3": bias, "nearest_mean_at_0.3": nearest_mean,
              "encode_frames_byte_identical": ENCODE_FRAMES,
              "non_finite_cases": len(QUANT_NON_FINITE),
              "plans": plans, "timed_f32": times}
    emit({"phase": "quantize", **result})
    return result, timed


# -- phases: LM serving through tensor_lm_serve ------------------------------
def _lm_prompts():
    """The measured run's prompts, then the warm-up prompts, from one seed
    (the JAX package's serving bench draws them the same way)."""
    import numpy as np

    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, LM["vocab"], n).tolist()
               for n in LM_PROMPT_LENS]
    warm = [rng.integers(1, LM["vocab"], n).tolist() for n in LM_WARM_LENS]
    return prompts, warm


def _serve(prompts, new_tokens: int, engine_name: str = "lm"):
    """One run of ``appsrc ! tensor_lm_serve ! tensor_sink``: push every
    prompt, end the stream, run the pipeline to EOS. Returns the response
    buffers (in submission order: one client, FIFO) and the wall time."""
    import numpy as np

    import nnstreamer_tpu_torch as nt

    pipe = nt.parse_launch(
        f"appsrc name=src ! tensor_lm_serve engine={engine_name} "
        f"max-new-tokens={new_tokens} ! tensor_sink name=out")
    got = []
    pipe.get("out").connect(lambda buf: got.append(buf))
    src = pipe.get("src")
    for p in prompts:
        src.push([np.asarray(p, np.int32)])
    src.end_of_stream()
    t0 = time.monotonic()
    pipe.run(timeout=900)
    return got, time.monotonic() - t0


def _b2_prefills(engine, stats0) -> int:
    """Admissions since ``stats0`` (a copy of ``engine.stats``) whose prompt
    went through the bucketed prefill, where kernel B2 runs in every
    layer: a chunked prefill and a prefix hit run the chunk program."""
    if engine.prefill_chunk is not None:
        return 0
    return (engine.stats["prefills"] - stats0["prefills"]) - (
        engine.stats["prefix_hits"] - stats0["prefix_hits"])


def _fp32_engine(**kw):
    """An fp32 engine of the LM configuration (TF32 is off since
    lm_parity), 8 slots, K = 8."""
    import torch

    from nnstreamer_tpu_torch.models.transformer import (
        TransformerConfig,
        init_params,
    )
    from nnstreamer_tpu_torch.serving import ContinuousBatchingEngine

    cfg = TransformerConfig(**LM, dtype=torch.float32)
    return ContinuousBatchingEngine(cfg, init_params(cfg, seed=0),
                                    max_streams=LM_SLOTS,
                                    steps_per_dispatch=8, **kw)


def _token_quantiles(engine) -> dict:
    return {f"{name}_{which}_ms": (est.quantile() or 0.0) * 1e3
            for name, pair in engine._lm_stats._q.items()
            for which, est in pair.items()}


def _check_responses(got, n_prompts: int, new_tokens: int, what: str):
    """Every response full-length int32 ids in the vocab, logprobs finite
    and <= 0, finished by length. Returns the tokens generated."""
    import numpy as np

    check(len(got) == n_prompts, f"{what}: {len(got)} of {n_prompts} "
                                 "responses")
    total = 0
    for i, buf in enumerate(got):
        toks_i = np.asarray(buf.tensors[0])
        lps = np.asarray(buf.tensors[1])
        check(toks_i.dtype == np.int32 and toks_i.shape == (new_tokens,),
              f"{what} response {i}: tokens {toks_i.dtype} {toks_i.shape}")
        check(bool(((toks_i >= 0) & (toks_i < LM["vocab"])).all()),
              f"{what} response {i}: token ids out of range")
        check(lps.dtype == np.float32 and lps.shape == (new_tokens,) and
              bool(np.isfinite(lps).all()) and bool((lps <= 0).all()),
              f"{what} response {i}: logprobs not finite and <= 0")
        check(buf.meta.get("lm_finish_reason") == "length",
              f"{what} response {i}: finish "
              f"{buf.meta.get('lm_finish_reason')}")
        total += toks_i.size
    return total


def _check_graph(engine, what: str, captures_max: int = 1) -> dict:
    """The engine's K-step program was captured once at the K it served,
    and at most ``captures_max`` times in its life (2 under "auto": the
    initial K, then the chosen one), and every dispatch was a replay."""
    g = engine.graph_stats
    check(g["captures"] and g["captures"][-1] == engine.K and
          g["captures"].count(engine.K) == 1 and
          len(g["captures"]) <= captures_max,
          f"{what}: captures {g['captures']} at K={engine.K}")
    check(g["replays"] == engine.stats["dispatches"] > 0,
          f"{what}: {g['replays']} replays for "
          f"{engine.stats['dispatches']} dispatches")
    return {"captures": list(g["captures"]), "capture_s": g["capture_s"],
            "replays": g["replays"], "dispatches": engine.stats["dispatches"]}


def phase_lm_serving(power: str):
    import numpy as np
    import torch

    import nnstreamer_tpu_torch as nt
    from nnstreamer_tpu_torch.models.transformer import (
        TransformerConfig,
        init_params,
    )
    from nnstreamer_tpu_torch.obs.flight import LMTokenStats
    from nnstreamer_tpu_torch.ops._counts import LAUNCHES, reset_launches
    from nnstreamer_tpu_torch.serving import (
        ContinuousBatchingEngine,
        register_engine,
        unregister_engine,
    )

    nt.set_device(None)  # the package default: cuda:0
    cfg = TransformerConfig(**LM, dtype=torch.bfloat16)
    engine = ContinuousBatchingEngine(cfg, init_params(cfg, seed=0),
                                      max_streams=LM_SLOTS,
                                      steps_per_dispatch="auto")
    placed = {str(t.device) for t in engine.params.values()}
    placed.add(str(engine._cache.device))
    check(placed == {"cuda:0"}, f"params and cache on {placed}")
    prompts, warm = _lm_prompts()
    engine.start()
    register_engine("lm", engine)
    try:
        for p in warm:  # every prompt bucket of the run, off the clock
            engine.generate(p, max_new_tokens=engine.K, timeout=600)
        # the measured run's latency quantiles only
        engine._lm_stats = LMTokenStats(engine.obs_name)
        stats0 = dict(engine.stats)
        reset_launches()
        got, wall = _serve(prompts, LM_NEW)
        torch.cuda.synchronize()
        launches = dict(LAUNCHES)
        prefills = engine.stats["prefills"] - stats0["prefills"]
        b2_prefills = _b2_prefills(engine, stats0)
        q = _token_quantiles(engine)

        # prefill of a [4, 512] batch through the engine's own prefill
        # program (kernel B2 in every layer), median of 3
        toks = torch.from_numpy(np.random.default_rng(1).integers(
            1, cfg.vocab, LM_PREFILL_BATCH).astype(np.int32)).to("cuda:0")
        samples = []
        with torch.inference_mode():
            for i in range(4):
                torch.cuda.synchronize()
                t0 = time.monotonic()
                engine._prefill_fn(engine.params, toks)
                torch.cuda.synchronize()
                if i:  # the first call is the warm-up
                    samples.append(toks.numel() / (time.monotonic() - t0))
    finally:
        engine.stop()
        unregister_engine("lm")

    total = _check_responses(got, len(prompts), LM_NEW, "lm_serving")
    check(prefills == len(prompts), f"{prefills} prefills for "
                                    f"{len(prompts)} prompts")
    check(launches["flash_attention"] == cfg.n_layers * b2_prefills,
          f"flash kernel launched {launches['flash_attention']} times for "
          f"{b2_prefills} bucketed prefills of {cfg.n_layers} layers")
    result = {
        "config": {**LM, "dtype": "bfloat16", "slots": LM_SLOTS,
                   "new_tokens": LM_NEW, "prompts": len(prompts)},
        "responses": len(got), "tokens": total, "wall_s": wall,
        "tokens_per_s": total / wall, "K": engine.K,
        "prefills": prefills, "b2_prefills": b2_prefills,
        "launches": launches, **q, "graph": dict(engine.graph_stats),
        "prefill_batch": list(LM_PREFILL_BATCH),
        "prefill_tokens_per_s": statistics.median(samples),
        "prefill_tokens_per_s_samples": samples, "gpu": power,
    }
    emit({"phase": "lm_serving", **result})
    return result, engine, [np.asarray(b.tensors[0]).tolist() for b in got]


def phase_lm_parity(bf16_engine):
    """fp32, TF32 off: kernel B2 and the plain attention give the same
    greedy tokens; bf16 first-token logits stay near the fp32 ones."""
    import numpy as np
    import torch

    from nnstreamer_tpu_torch.ops._counts import LAUNCHES, reset_launches

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    prompts, _ = _lm_prompts()
    tokens, launches, engines = {}, {}, {}
    for mode in ("auto", "reference"):
        eng = _fp32_engine(attention=mode).start()
        try:
            reset_launches()
            streams = [eng.submit(p, max_new_tokens=LM_PARITY_NEW)
                       for p in prompts]
            tokens[mode] = [s.result(timeout=600) for s in streams]
            torch.cuda.synchronize()
            launches[mode] = dict(LAUNCHES)
        finally:
            eng.stop()
        engines[mode] = eng
    differ = [i for i, (a, b) in enumerate(zip(tokens["auto"],
                                                tokens["reference"]))
              if a != b]
    check(not differ, f"fp32 greedy tokens of prompts {differ} differ "
                      "between kernel B2 and the plain attention")
    check(all(len(t) == LM_PARITY_NEW for t in tokens["auto"]),
          "a parity stream came back short")
    check(launches["auto"]["flash_attention"] == LM["n_layers"] * len(prompts)
          and launches["reference"]["flash_attention"] == 0,
          f"attention launches {launches}")

    fp32 = engines["auto"]
    rel, top1 = [], []
    with torch.inference_mode():
        for p in prompts:
            n = len(p)
            padded = np.zeros((1, fp32._bucket(n)), np.int32)
            padded[0, :n] = p
            toks = torch.from_numpy(padded).to("cuda:0")
            lengths = torch.tensor([n], device="cuda:0")
            lb = bf16_engine._prefill_fn(bf16_engine.params, toks, lengths)[0]
            lf = fp32._prefill_fn(fp32.params, toks, lengths)[0]
            rel.append(float((lb - lf).norm() / lf.norm()))
            top1.append(int(lb.argmax()) == int(lf.argmax()))
    check(max(rel) <= LM_DRIFT_MAX,
          f"bf16 vs fp32 first-token logits: relative L2 {max(rel)} > "
          f"{LM_DRIFT_MAX}")
    result = {"prompts": len(prompts), "new_tokens": LM_PARITY_NEW,
              "tokens_identical": True,
              "flash_launches": launches["auto"]["flash_attention"],
              "bf16_logit_rel_l2": rel, "bf16_logit_rel_l2_max": max(rel),
              "rel_l2_max_allowed": LM_DRIFT_MAX, "top1_agree": top1}
    emit({"phase": "lm_parity", **result})
    return result, fp32, tokens["auto"]


def _host_calls_per_dispatch(prof) -> dict:
    """From a trace of a captured engine's run: the host's launch calls
    between one graph launch and the next, per dispatch (the median is the
    steady state: one replay and the block's fetch; an interval that holds
    an admission also holds its prefill's launches), and the device's idle
    share from the first graph launch to the trace's last device event
    (the decode after the first admission wave)."""
    import torch

    calls = sorted((ev.time_range.start, ev.name) for ev in prof.events()
                   if ev.device_type != torch.autograd.DeviceType.CUDA
                   and ev.name in HOST_LAUNCH_CALLS)
    graphs = [t for t, name in calls if name == "cudaGraphLaunch"]
    intervals = [[name for t, name in calls if a <= t < b]
                 for a, b in zip(graphs, graphs[1:])]
    if not intervals:
        return {"graph_launches": len(graphs)}
    counts = [len(iv) for iv in intervals]
    steady = statistics.median_low(counts)
    typical = next(iv for iv in intervals if len(iv) == steady)
    spans = sorted((max(ev.time_range.start, graphs[0]), ev.time_range.end)
                   for ev in prof.events()
                   if ev.device_type == torch.autograd.DeviceType.CUDA
                   and ev.time_range.end > graphs[0])
    busy, end = 0.0, None  # union of device intervals after the launch
    for a, b in spans:
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    return {"graph_launches": len(graphs),
            "host_launch_calls_per_dispatch_median": steady,
            "host_launch_calls_per_dispatch_max": max(counts),
            "host_launch_calls_per_dispatch_by_call": {
                name: typical.count(name) for name in sorted(set(typical))},
            "device_idle_share_from_first_replay":
                1.0 - busy / (end - graphs[0]) if end else None}


def profile_lm(engine, eager_engine) -> None:
    """One serving run of each engine under ``torch.profiler`` (the
    captured one first): the device's busy time per generated token, its
    idle share of the run, kernels and host launch calls per token and per
    dispatch, and the kernels that take the most device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from nnstreamer_tpu_torch.serving import register_engine, unregister_engine

    prompts, _ = _lm_prompts()
    prompts = prompts[:LM_SLOTS]
    out = {}
    for tag, eng in (("captured", engine), ("eager", eager_engine)):
        eng.start()
        register_engine("lm", eng)
        try:
            dispatches0 = eng.stats["dispatches"]
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.monotonic()
                got, _ = _serve(prompts, LM_PROFILED_NEW)
                torch.cuda.synchronize()
                wall_us = (time.monotonic() - t0) * 1e6
        finally:
            eng.stop()
            unregister_engine("lm")
        tokens = sum(len(buf.tensors[0]) for buf in got)
        check(tokens == len(prompts) * LM_PROFILED_NEW,
              f"profiled LM run ({tag}) produced {tokens} tokens")
        dispatches = eng.stats["dispatches"] - dispatches0
        prof_tok = device_profile(prof, wall_us, tokens, "token")
        out[tag] = {
            "K": eng.K, "dispatches": dispatches, **prof_tok,
            "host_launches_per_dispatch": prof_tok[
                "host_launches_per_token"] * tokens / dispatches,
            **_host_calls_per_dispatch(prof)}
    emit({"phase": "lm_profile", "prompts": len(prompts),
          "new_tokens": LM_PROFILED_NEW, **out})


# -- phases: tensor_lm_serve behind the query pair ----------------------------
def _serve_over_query(engine_name: str, prompts, new_tokens: int,
                      clients: int = LM_QUERY_CLIENTS):
    """``tensor_query_serversrc ! tensor_lm_serve ! tensor_query_serversink``
    with ``clients`` ``appsrc ! tensor_query_client ! tensor_sink``
    pipelines over 127.0.0.1, client k pushing its share of the prompts
    in order with all of them in flight (with one client the engine's
    stream ids follow the push order). Returns each client's response
    buffers (in arrival order) and the wall time from the first push to
    the last response."""
    import numpy as np

    import nnstreamer_tpu_torch as nt

    server = nt.parse_launch(
        "tensor_query_serversrc name=ss port=0 id=32 ! "
        f"tensor_lm_serve engine={engine_name} max-new-tokens={new_tokens} "
        "! tensor_query_serversink id=32")
    server.start()
    per = len(prompts) // clients
    pipes, got = [], []
    try:
        port = server.get("ss").port
        for k in range(clients):
            pipe = nt.parse_launch(
                f"appsrc name=src ! tensor_query_client dest-host=127.0.0.1 "
                f"dest-port={port} max-in-flight={per} timeout=600 ! "
                "tensor_sink name=out")
            got.append([])
            pipe.get("out").connect(lambda buf, k=k: got[k].append(buf))
            pipes.append(pipe)
        t0 = time.monotonic()
        for pipe in pipes:
            pipe.start()
        for k, pipe in enumerate(pipes):
            src = pipe.get("src")
            for j, p in enumerate(prompts[k * per:(k + 1) * per]):
                src.push([np.asarray(p, np.int32)], pts=j)
            src.end_of_stream()
        for pipe in pipes:
            msg = pipe.wait(timeout=900)
            check(msg is not None and msg.kind == "eos",
                  f"an LM query client ended with {msg}")
        wall = time.monotonic() - t0
    finally:
        for pipe in pipes:
            pipe.stop()
        server.stop()
    return got, wall


def _common_prefix(a, b) -> int:
    n = 0
    for x, y in zip(a, b):
        if x != y:
            break
        n += 1
    return n


def phase_lm_query(power: str, bf16_engine, fp32_engine, local_bf16):
    """The bf16 engine of the lm_serving phase behind the query pair (12
    prompts × 128 tokens from 4 clients), then the fp32 engine of the
    lm_parity phase (TF32 off, 32 tokens) over the query pair and in
    process: every client's tokens must equal the in-process run's.

    The bf16 responses are held to their prompts by content: each shares
    at least as long a prefix with the lm_serving phase's in-process
    response to its own prompt as with the response to any other prompt
    (the two runs batch differently, so bf16 tokens may part late)."""
    import numpy as np
    import torch

    from nnstreamer_tpu_torch.obs.flight import LMTokenStats
    from nnstreamer_tpu_torch.serving import register_engine, unregister_engine

    prompts, _ = _lm_prompts()
    per = len(prompts) // LM_QUERY_CLIENTS
    bf16_engine.start()
    register_engine("lmq", bf16_engine)
    try:
        bf16_engine._lm_stats = LMTokenStats(bf16_engine.obs_name)
        got, wall = _serve_over_query("lmq", prompts, LM_NEW)
        torch.cuda.synchronize()
        q = _token_quantiles(bf16_engine)
    finally:
        bf16_engine.stop()
        unregister_engine("lmq")
    total = 0
    own_prefix = []
    for k, bufs in enumerate(got):
        check(len(bufs) == per, f"client {k}: {len(bufs)} of {per} responses")
        for j, buf in enumerate(bufs):
            toks = np.asarray(buf.tensors[0])
            prefix = [_common_prefix(toks.tolist(), ref) for ref in local_bf16]
            own = prefix[k * per + j]
            check(own >= max(prefix), f"client {k} response {j}: shares "
                                      f"{own} tokens with its own prompt's "
                                      f"in-process response, {max(prefix)} "
                                      "with another's")
            own_prefix.append(own)
            lps = np.asarray(buf.tensors[1])
            check(toks.dtype == np.int32 and toks.shape == (LM_NEW,) and
                  bool(((toks >= 0) & (toks < LM["vocab"])).all()),
                  f"client {k}: tokens {toks.dtype} {toks.shape}")
            check(lps.dtype == np.float32 and lps.shape == (LM_NEW,) and
                  bool(np.isfinite(lps).all()) and bool((lps <= 0).all()),
                  f"client {k}: logprobs not finite and <= 0")
            total += toks.size

    # fp32, TF32 off: over the query pair and in process, the same tokens
    fp32_engine.start()
    register_engine("lmp", fp32_engine)
    try:
        remote, _ = _serve_over_query("lmp", prompts, LM_PARITY_NEW)
        local, _ = _serve(prompts, LM_PARITY_NEW, engine_name="lmp")
    finally:
        fp32_engine.stop()
        unregister_engine("lmp")
    local_toks = [np.asarray(b.tensors[0]).tolist() for b in local]
    check(len(local_toks) == len(prompts), "in-process fp32 run came back "
                                           "short")
    differ = []
    for k, bufs in enumerate(remote):
        toks = [np.asarray(b.tensors[0]).tolist() for b in bufs]
        if toks != local_toks[k * per:(k + 1) * per]:
            differ.append(k)
    check(not differ, f"fp32 tokens of clients {differ} differ from the "
                      "in-process tensor_lm_serve run")
    result = {"clients": LM_QUERY_CLIENTS, "prompts_per_client": per,
              "responses": sum(len(b) for b in got), "tokens": total,
              "wall_s": wall, "tokens_per_s": total / wall, **q,
              "bf16_own_prefix_vs_in_process": own_prefix,
              "fp32_new_tokens": LM_PARITY_NEW,
              "fp32_tokens_equal_in_process": True, "gpu": power}
    emit({"phase": "lm_query", **result})
    return result


# -- phase: the flagship offloaded over the query pair with int8 transport ----
def phase_query_offload(power: str):
    import numpy as np
    import torch

    import nnstreamer_tpu_torch as nt
    from nnstreamer_tpu_torch.filters.torch_backend import (
        register_torch_model,
        unregister_torch_model,
    )
    from nnstreamer_tpu_torch.models.mobilenet_v2 import mobilenet_v2
    from nnstreamer_tpu_torch.ops._counts import LAUNCHES, reset_launches

    nt.set_device(None)  # the package default: cuda:0
    module, in_info, out_info = mobilenet_v2(
        num_classes=CLASSES, image_size=IMAGE, dtype=torch.bfloat16, seed=0)
    register_torch_model("mnv2q", module, in_info, out_info)
    seen = {"calls": 0, "param_devices": set()}

    def forward_hook(mod, args, out):
        if torch.cuda.is_current_stream_capturing():
            return  # a capture records the kernels; it runs none
        seen["calls"] += 1
        seen["param_devices"].add(str(next(mod.parameters()).device))

    hook = module.register_forward_hook(forward_hook)
    tmp = tempfile.mkdtemp(prefix="nns_smoke_")
    labels = os.path.join(tmp, "labels.txt")
    with open(labels, "w") as f:
        f.write("\n".join(f"class_{i}" for i in range(CLASSES)) + "\n")
    frames = (f"videotestsrc num-buffers={{n}} width={IMAGE} height={IMAGE} "
              "pattern=ball ! tensor_converter ! "
              "tensor_transform mode=arithmetic "
              "option=typecast:float32,add:-127.5,div:127.5 ! "
              "tensor_quant_enc ! ")
    server = nt.parse_launch(
        "tensor_query_serversrc name=ss port=0 id=31 ! tensor_quant_dec ! "
        "tensor_filter framework=jax model=mnv2q ! "
        f"tensor_decoder mode=image_labeling option1={labels} ! "
        "tensor_query_serversink id=31")
    try:
        server.start()
        port = server.get("ss").port

        def client(n: int):
            return nt.parse_launch(
                frames.format(n=n) +
                f"tensor_query_client name=qc dest-host=127.0.0.1 "
                f"dest-port={port} timeout=60 ! tensor_sink name=out")

        client(WARMUP_FRAMES).run(timeout=600)
        seen.update(calls=0, param_devices=set())
        pipe = client(FRAMES)
        got = []
        pipe.get("out").connect(lambda buf: got.append(
            np.asarray(buf.tensors[0]).tobytes().decode()))

        def sent_bytes():  # the counter's labels are shared with the warm-up
            return pipe.metrics_snapshot()["elements"]["qc"]["sent_bytes"]

        def server_replays():  # the server fuses filter ! decoder
            return sum(r["replays"] for r in server.metrics_snapshot().get(
                "regions", {}).values())

        sent0 = sent_bytes()
        replays0 = server_replays()
        reset_launches()
        t0 = time.monotonic()
        pipe.run(timeout=900)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        launches = dict(LAUNCHES)
        # model runs: eager forwards, and replays of a graph holding one
        measured = dict(seen, calls=seen["calls"] + server_replays()
                        - replays0)
        p50, p99 = pipe.get("out").latency_percentiles(50.0, 99.0)
        sent = sent_bytes() - sent0

        # the same module in process, through the same codec
        ref = nt.parse_launch(
            frames.format(n=FRAMES) + "tensor_quant_dec ! "
            "tensor_filter framework=jax model=mnv2q ! "
            f"tensor_decoder mode=image_labeling option1={labels} ! "
            "tensor_sink name=out")
        want = []
        ref.get("out").connect(lambda buf: want.append(buf.meta["label"]))
        ref.run(timeout=900)
    finally:
        server.stop()
        hook.remove()
        unregister_torch_model("mnv2q")
        shutil.rmtree(tmp, ignore_errors=True)

    frame_bytes = IMAGE * IMAGE * 3 * 4
    check(len(got) == FRAMES, f"{len(got)} of {FRAMES} labels came back")
    differ = [i for i, (a, b) in enumerate(zip(got, want)) if a != b]
    check(len(want) == FRAMES and not differ,
          f"labels of frames {differ[:10]} differ from the in-process run")
    check(launches["normalize_chain"] == FRAMES and
          launches["quantize_int8"] == FRAMES,
          f"client launches {launches} for {FRAMES} frames")
    check(measured["calls"] == FRAMES, f"model ran {measured['calls']} times")
    check(measured["param_devices"] == {"cuda:0"},
          f"filter parameters on {measured['param_devices']}")
    check(sent / FRAMES <= QUERY_BYTES_MAX * frame_bytes,
          f"{sent / FRAMES} bytes sent per frame")
    result = {"frames": FRAMES, "labels_equal_in_process": FRAMES,
              "launches": launches, "fps": FRAMES / wall, "wall_s": wall,
              "latency_p50_ms": p50, "latency_p99_ms": p99,
              "sent_bytes_per_frame": sent / FRAMES,
              "f32_frame_bytes": frame_bytes,
              "sent_share_of_f32_frame": sent / FRAMES / frame_bytes,
              "gpu": power}
    emit({"phase": "query_offload", **result})
    return result


# -- phase 4: the flagship pipeline, unfused and fused ------------------------
def phase_pipeline(power: str):
    """The flagship through ``parse_launch``: first explicitly unfused
    (``Pipeline(fuse=False)``), probed at the filter's chain, then with the
    default, where tensor_transform ! tensor_filter ! tensor_decoder is one
    fused region replayed as a CUDA graph. Both timed runs come before both
    profiled runs. Emits the ``pipeline`` and ``pipeline_fused`` lines."""
    import numpy as np
    import torch

    import nnstreamer_tpu_torch as nt
    from nnstreamer_tpu_torch.filters.torch_backend import (
        register_torch_model,
        unregister_torch_model,
    )
    from nnstreamer_tpu_torch.models.mobilenet_v2 import mobilenet_v2
    from nnstreamer_tpu_torch.ops import preprocess as pp
    from nnstreamer_tpu_torch.pipeline.pipeline import Pipeline

    nt.set_device(None)  # the package default: cuda:0
    module, in_info, out_info = mobilenet_v2(
        num_classes=CLASSES, image_size=IMAGE, dtype=torch.bfloat16, seed=0)
    register_torch_model("mnv2", module, in_info, out_info)

    seen = {"calls": 0, "param_devices": set(), "transform_out": set(),
            "samples": []}

    def forward_hook(mod, args, out):
        if torch.cuda.is_current_stream_capturing():
            return  # a capture records the kernels; it runs none
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

    def launch(n: int, fuse: bool):
        pipe = nt.parse_launch(
            f"videotestsrc num-buffers={n} width={IMAGE} height={IMAGE} "
            "pattern=ball ! tensor_converter ! "
            "tensor_transform mode=arithmetic "
            "option=typecast:float32,add:-127.5,div:127.5 ! "
            "tensor_filter framework=jax model=mnv2 name=filter ! "
            f"tensor_decoder mode=image_labeling option1={labels} ! "
            "queue max-size-buffers=32 prefetch-host=true ! "
            "tensor_sink name=out to-host=true",
            pipeline=Pipeline(fuse=fuse))
        if fuse:
            return pipe
        filt = pipe.get("filter")
        chain = filt.chain

        def probe(pad, buf):  # what tensor_transform handed the filter
            seen["transform_out"].add(
                (str(buf.tensors[0].device), str(buf.tensors[0].dtype)))
            return chain(pad, buf)

        filt.chain = probe
        return pipe

    def timed_run(fuse: bool):
        pipe = launch(FRAMES, fuse)
        got = []
        pipe.get("out").connect(lambda buf: got.append(buf.meta))
        pp.reset_launches()
        t0 = time.monotonic()
        pipe.run(timeout=900)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        launches = dict(pp.LAUNCHES)
        p50, p99 = pipe.get("out").latency_percentiles(50.0, 99.0)
        return pipe, got, launches, wall, p50, p99

    try:
        # the warm-up run also keeps the inputs and logits of its first
        # frames for the fp32 check below, so that the measured run does
        # not wait for those copies
        launch(WARMUP_FRAMES, False).run(timeout=600)
        seen.update(calls=0, param_devices=set(), transform_out=set())
        _, got, launches, wall, p50, p99 = timed_run(False)
        measured = {k: v for k, v in seen.items() if k != "samples"}

        launch(WARMUP_FRAMES, True).run(timeout=600)
        seen.update(calls=0, param_devices=set(), transform_out=set())
        fpipe, fgot, flaunches, fwall, fp50, fp99 = timed_run(True)
        fmeasured = {k: v for k, v in seen.items() if k != "samples"}
        regions = fpipe.metrics_snapshot().get("regions", {})
        member_types = [[m.ELEMENT_NAME for m in r.members]
                        for r in fpipe._regions or ()]

        trace = profile_pipeline(launch(PROFILED_FRAMES, False))
        ftrace = profile_pipeline(launch(PROFILED_FRAMES, True))
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
        "frames": FRAMES, "labelled": len(got), "fused": False,
        "launches": launches,
        "fps": FRAMES / wall, "wall_s": wall,
        "latency_p50_ms": p50, "latency_p99_ms": p99,
        "logit_rel_l2": rel, "logit_rel_l2_max_allowed": REL_L2_MAX,
        "top1_agree": top1, "profiled_run": trace, "gpu": power,
    }
    emit({"phase": "pipeline", **result})

    # the fused run: every frame labelled as the unfused run labelled it,
    # B1 counted once a frame through the graph's replays, one capture,
    # and no frame but the first outside the graph
    check(len(fgot) == FRAMES and all(
        isinstance(m.get("label"), str) and m["label"].startswith("class_")
        for m in fgot), f"fused: {len(fgot)} of {FRAMES} frames labelled")
    differ = [i for i, (a, b) in enumerate(zip(fgot, got))
              if (a["label"], a["label_index"],
                  np.float32(a["score"]).tobytes()) !=
              (b["label"], b["label_index"], np.float32(b["score"]).tobytes())]
    check(not differ, f"fused: labels or scores of frames {differ[:10]} "
                      "differ from the unfused run")
    check(flaunches["normalize_chain"] == FRAMES,
          f"fused: normalize kernel counted {flaunches['normalize_chain']} "
          f"times for {FRAMES} frames")
    check(len(regions) == 1 and member_types == [[
        "tensor_transform", "tensor_filter", "tensor_decoder"]],
          f"fused: regions {member_types}")
    (region,) = regions.values()
    check(not region["unspliced"], "fused: the region fell back to the "
                                   "member chain")
    check(region["captures"] == 1 and region["eager_frames"] == 1 and
          region["replays"] == FRAMES - 1,
          f"fused: {region['captures']} captures, {region['eager_frames']} "
          f"frames outside the graph, {region['replays']} replays")
    check(fmeasured["calls"] + region["replays"] == FRAMES,
          f"fused: model ran {fmeasured['calls']} times outside the graph "
          f"and {region['replays']} in it")
    check(fmeasured["param_devices"] == {"cuda:0"},
          f"fused: filter parameters on {fmeasured['param_devices']}")
    # the idle share at each timed run's rate: the profiled busy time a
    # frame over the timed run's time a frame
    busy = {"fused": ftrace["device_busy_ms_per_frame"] * FRAMES / fwall,
            "unfused": trace["device_busy_ms_per_frame"] * FRAMES / wall}
    fused = {
        "frames": FRAMES, "labelled": len(fgot),
        "labels_scores_bit_identical_to_unfused": FRAMES - len(differ),
        "launches": flaunches, "region": region,
        "fps": FRAMES / fwall, "wall_s": fwall,
        "latency_p50_ms": fp50, "latency_p99_ms": fp99,
        "profiled_run": ftrace,
        "device_idle_share_at_timed_rate": 1.0 - busy["fused"] / 1e3,
        "unfused": {"fps": FRAMES / wall, "latency_p50_ms": p50,
                    "latency_p99_ms": p99,
                    "device_kernels_per_frame":
                        trace["device_kernels_per_frame"],
                    "host_launches_per_frame":
                        trace["host_launches_per_frame"],
                    "device_idle_share": trace["device_idle_share"],
                    "device_idle_share_at_timed_rate":
                        1.0 - busy["unfused"] / 1e3},
        "gpu": power,
    }
    emit({"phase": "pipeline_fused", **fused})
    return result, fused


def labelled_frames(metas):
    """(label, index, f32 score bits) per real frame of the sink's buffers'
    metas, in order."""
    import numpy as np

    out = []
    for m in metas:
        labs, idx, sc = m["label"], m["label_index"], m["score"]
        if isinstance(labs, str):
            labs, idx, sc = [labs], [idx], [sc]
        k = m.get("valid_frames", len(labs))
        out += [(a, int(b), np.float32(c).tobytes())
                for a, b, c in zip(labs[:k], idx[:k], sc[:k])]
    return out


def phase_pipeline_batched(power: str):
    """The flagship as bench.py launches it by default: batch 8 through
    ``tensor_aggregator``, a ``prefetch-device`` staging queue, the
    filter's dispatch window (``inflight=2``), the batched decoder and a
    ``materialize-host`` drain, fused (transform ! filter ! decoder is one
    CUDA graph with B1 inside, once a window). It runs lanes 1 and a plain
    ingress queue; ``pipeline_uncut`` runs bench.py's lanes 4 and leaky,
    stamp-admission ingress, so this phase's string has no cuts of its
    own to record.

    The timed runs: the string as given (``pattern=gradient``, 800 frames);
    the same unfused, with ``inflight=1`` and with ``NNSTPU_POOL=0``, each
    bit-identical to it in labels, indices and f32 scores; with
    ``pattern=ball`` (frames that differ, so a staging slab recycled under
    a copy in flight would show) pool on against pool off; a live source
    paced so that the latency budget flushes partial windows (padded on
    the device), labelled as the unpaced ball run; and the batch-1 fused
    flagship on the same frames, as the comparison. Returns what the
    profiled runs after every timed phase need."""
    import numpy as np
    import torch

    import nnstreamer_tpu_torch as nt
    from nnstreamer_tpu_torch.filters.torch_backend import (
        register_torch_model,
    )
    from nnstreamer_tpu_torch.models.mobilenet_v2 import mobilenet_v2
    from nnstreamer_tpu_torch.ops import preprocess as pp
    from nnstreamer_tpu_torch.pipeline.pipeline import Pipeline
    from nnstreamer_tpu_torch.tensors.buffer import transfer_snapshot
    from nnstreamer_tpu_torch.tensors.pool import get_pool, pinned_view

    nt.set_device(None)  # the package default: cuda:0
    slab = get_pool().acquire((BATCH, IMAGE, IMAGE, 3), np.uint8)
    check(pinned_view(slab) is not None and pinned_view(slab).is_pinned(),
          "batched: a staging slab on the card is not page-locked")
    del slab
    module, _, _ = mobilenet_v2(num_classes=CLASSES, image_size=IMAGE,
                                dtype=torch.bfloat16, seed=0)
    register_torch_model("mnv2_b8", module)
    samples = []

    def forward_hook(mod, args, out):
        # not while capturing (no kernel runs), not the shape probe on
        # the meta device
        if not torch.cuda.is_current_stream_capturing() and not samples \
                and out.device.type != "meta":
            samples.append((args[0][:LOGIT_FRAMES].detach().float().cpu(),
                            out[:LOGIT_FRAMES].detach().float().cpu()))

    hook = module.register_forward_hook(forward_hook)
    tmp = tempfile.mkdtemp(prefix="nns_smoke_b8_")
    labels = os.path.join(tmp, "labels.txt")
    with open(labels, "w") as f:
        f.write("\n".join(f"class_{i}" for i in range(CLASSES)) + "\n")
    runs = {"n": 0}

    def launch(n, fuse=True, inflight=2, pattern="gradient", budget="",
               live="", batch=BATCH):
        runs["n"] += 1
        src = (f"videotestsrc num-buffers={n} width={IMAGE} "
               f"height={IMAGE} pattern={pattern} {live}! "
               "tensor_converter ! ")
        transform = ("tensor_transform mode=arithmetic "
                     "option=typecast:float32,add:-127.5,div:127.5 ! "
                     "tensor_filter framework=jax model=mnv2_b8 name=filter "
                     f"inflight={inflight} ! ")
        if batch == 1:  # the fused flagship of the pipeline phase
            desc = (src + transform + "tensor_decoder mode=image_labeling "
                    f"option1={labels} ! queue max-size-buffers=32 "
                    "prefetch-host=true ! tensor_sink name=out to-host=true")
        else:
            desc = (src + "queue max-size-buffers=16 ! "
                    "tensor_aggregator frames-in=1 frames-out=8 "
                    f"frames-flush=8 frames-dim=3 concat=true {budget}! "
                    "queue max-size-buffers=8 prefetch-device=true ! "
                    + transform +
                    "tensor_decoder mode=image_labeling "
                    f"option1={labels} option2=batched ! "
                    "queue max-size-buffers=64 materialize-host=true ! "
                    "tensor_sink name=out to-host=true")
        return nt.parse_launch(desc, pipeline=Pipeline(
            name=f"b{batch}_{runs['n']}", fuse=fuse))

    def timed(pipe, n, env_pool=None):
        got, pts = [], []
        sink = pipe.get("out")
        sink.connect(lambda buf: (got.append(buf.meta), pts.append(buf.pts)))
        old = os.environ.get("NNSTPU_POOL")
        if env_pool is not None:
            os.environ["NNSTPU_POOL"] = env_pool
        pool0, xfer0 = get_pool().snapshot(), transfer_snapshot()
        pp.reset_launches()
        try:
            t0 = time.monotonic()
            pipe.run(timeout=900)
            torch.cuda.synchronize()
            wall = time.monotonic() - t0
        finally:
            if env_pool is not None:
                if old is None:
                    os.environ.pop("NNSTPU_POOL")
                else:
                    os.environ["NNSTPU_POOL"] = old
        launches = dict(pp.LAUNCHES)
        pool1, xfer1 = get_pool().snapshot(), transfer_snapshot()
        snap = pipe.metrics_snapshot()
        regions = list(snap.get("regions", {}).values())
        frames = labelled_frames(got)
        check(len(frames) == n, f"batched: {len(frames)} of {n} frames "
                                "labelled")
        check(all(isinstance(f[0], str) and f[0].startswith("class_")
                  for f in frames), "batched: a frame without a label")
        check(pts == sorted(pts), "batched: windows out of order")
        check(all(not r["unspliced"] for r in regions),
              "batched: a region fell back to the member chain")
        hits = pool1["hits"] - pool0["hits"]
        misses = pool1["misses"] - pool0["misses"]
        xfer = {k: xfer1[k] - xfer0[k] for k in xfer1}
        p50, p99 = sink.latency_percentiles(50.0, 99.0)
        # without the first quarter of the frames: the free-running source
        # fills the queues while the region runs its eager first window
        # and captures, and those frames wait for both
        # a leaky ingress may deliver fewer frames than a quarter skips
        s50, s99 = sink.latency_percentiles(50.0, 99.0, skip=n // 4) \
            or (None, None)
        windows = len(got)
        dispatch = regions[0] if regions else snap["elements"]["filter"]
        return {
            "frames": frames, "metas": got, "windows": windows,
            "launches": launches, "regions": regions, "sink": sink,
            "fps": n / wall, "wall_s": wall,
            "latency_p50_ms": p50, "latency_p99_ms": p99,
            "latency_p50_ms_after_first_quarter": s50,
            "latency_p99_ms_after_first_quarter": s99,
            "latency_samples": len(sink.latencies),
            "pool_hits": hits, "pool_misses": misses,
            "pool_hit_rate": hits / (hits + misses) if hits + misses
            else None,
            "pool_copy_waits": pool1["copy_waits"] - pool0["copy_waits"],
            "h2d_batched_events": xfer["h2d_batched_events"],
            "h2d_batched_frames": xfer["h2d_batched_frames"],
            "h2d_events": xfer["h2d_events"],
            "d2h_batched_events": xfer["d2h_batched_events"],
            "d2h_syncs": xfer["d2h_syncs"],
            "d2h_syncs_per_window": xfer["d2h_syncs"] / max(windows, 1),
            "h2d_copies_per_window": (xfer["h2d_batched_events"] +
                                      xfer["h2d_events"]) / max(windows, 1),
            "fence_wait_s": dispatch.get("fence_wait_s", 0.0),
            "fence_wait_p50_ms": dispatch.get("fence_wait_p50_ms"),
            "fence_wait_p99_ms": dispatch.get("fence_wait_p99_ms"),
            "inflight_limit": dispatch.get("inflight_limit"),
        }

    def summary(r):
        return {k: v for k, v in r.items()
                if k not in ("frames", "metas", "regions", "sink")}

    def same(a, b, what):
        differ = [i for i, (x, y) in enumerate(zip(a["frames"],
                                                     b["frames"])) if x != y]
        check(len(a["frames"]) == len(b["frames"]) and not differ,
              f"batched: {what}: frames {differ[:10]} differ")
        return len(a["frames"]) - len(differ)

    n = BATCHED_FRAMES
    try:
        # warm-ups: cuDNN and allocator set-up at batch 8, both paths; the
        # first (eager) window's frames differ, for the logit check
        launch(10 * BATCH, pattern="ball").run(timeout=600)
        launch(4 * BATCH, fuse=False).run(timeout=600)
        main = timed(launch(n), n)
        unfused = timed(launch(n, fuse=False), n)
        inflight1 = timed(launch(n, inflight=1), n)
        pool_off = timed(launch(n), n, env_pool="0")
        ball = timed(launch(n, pattern="ball"), n)
        ball_off = timed(launch(n, pattern="ball"), n, env_pool="0")
        budget = timed(launch(BUDGET_FRAMES, pattern="ball", budget=(
            f"latency-budget-ms={BUDGET_MS} pad-device=true "), live=(
            f"is-live=true framerate={BUDGET_RATE} ")), BUDGET_FRAMES)
        launch(WARMUP_FRAMES, batch=1).run(timeout=600)
        single = timed(launch(n, batch=1), n)
    finally:
        hook.remove()

    # one window: B1 once in it, the region captured once at [8,224,224,3]
    windows = n // BATCH
    (region,) = main["regions"]
    check(region["captures"] == 1 and region["eager_frames"] == 1 and
          region["replays"] == windows - 1,
          f"batched: {region['captures']} captures, "
          f"{region['eager_frames']} windows outside the graph, "
          f"{region['replays']} replays")
    for name, r in (("fused", main), ("unfused", unfused),
                    ("inflight=1", inflight1), ("pool off", pool_off)):
        check(r["launches"]["normalize_chain"] == windows,
              f"batched, {name}: normalize kernel counted "
              f"{r['launches']['normalize_chain']} times for {windows} "
              "windows")
        check(r["d2h_syncs"] == r["d2h_batched_events"] and
              r["d2h_syncs_per_window"] <= 1.0,
              f"batched, {name}: {r['d2h_syncs']} device-to-host waits "
              f"for {r['d2h_batched_events']} grouped fetches")
        check(r["h2d_copies_per_window"] <= 1.0,
              f"batched, {name}: {r['h2d_copies_per_window']} uploads a "
              "window")
    check(not unfused["regions"], "batched: the unfused run fused")
    check(main["inflight_limit"] == 2 and inflight1["inflight_limit"] == 1,
          "batched: the region did not adopt the filter's inflight")
    identical = {
        "unfused": same(main, unfused, "fused vs unfused"),
        "inflight_1": same(main, inflight1, "inflight 2 vs 1"),
        "pool_off": same(main, pool_off, "pool on vs NNSTPU_POOL=0"),
        "ball_pool_off": same(ball, ball_off,
                              "ball, pool on vs NNSTPU_POOL=0"),
    }
    check(main["pool_hits"] > 0, "batched: the pool never recycled a slab")

    # the budget run: partial windows, trimmed, labelled as unpaced
    valid = [m.get("valid_frames", BATCH) for m in budget["metas"]]
    partial = [v for v in valid if v < BATCH]
    check(partial, "budget: no partial window")
    trimmed = [len(b.tensors[0]) == b.meta["valid_frames"]
               for b in budget["sink"].buffers if "valid_frames" in b.meta]
    check(all(trimmed), "budget: a partial window was not trimmed")
    check(budget["latency_samples"] == BUDGET_FRAMES,
          f"budget: {budget['latency_samples']} latency samples for "
          f"{BUDGET_FRAMES} frames")
    (bregion,) = budget["regions"]
    check(bregion["captures"] == 1 and not bregion["unspliced"],
          f"budget: {bregion['captures']} captures")
    paced = [f[:2] for f in budget["frames"]]
    unpaced = [f[:2] for f in ball["frames"][:BUDGET_FRAMES]]
    check(paced == unpaced, "budget: labels differ from the unpaced run")
    budget_scores_same = sum(a == b for a, b in zip(
        budget["frames"], ball["frames"][:BUDGET_FRAMES]))

    # bf16 logits of the first window's first frames against fp32 on the
    # CPU (TF32 off), the bound of the pipeline phase
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    ref_module, _, _ = mobilenet_v2(num_classes=CLASSES, image_size=IMAGE,
                                    dtype=torch.float32, seed=0)
    (x, logits), = samples
    check(tuple(logits.shape) == (LOGIT_FRAMES, CLASSES) and
          bool(torch.isfinite(logits).all()),
          f"batched: logits of shape {tuple(logits.shape)} or not finite")
    with torch.inference_mode():
        ref = ref_module(x)
    rel = [float((lg - rf).norm() / rf.norm()) for lg, rf in zip(logits,
                                                                   ref)]
    check(max(rel) <= REL_L2_MAX,
          f"batched: bf16 logits vs fp32 on the CPU: relative L2 "
          f"{max(rel)} > {REL_L2_MAX}")
    result = {
        "frames": n, "batch": BATCH, "labelled": len(main["frames"]),
        "cuts": [],
        "bit_identical_frames": identical,
        "region": region,
        **{k: v for k, v in summary(main).items()},
        "logit_rel_l2": rel, "logit_rel_l2_max_allowed": REL_L2_MAX,
        "unfused": summary(unfused), "inflight_1": summary(inflight1),
        "pool_off": summary(pool_off), "ball": summary(ball),
        "ball_pool_off": summary(ball_off),
        "budget": {**summary(budget), "windows_valid_frames": valid,
                   "partial_windows": len(partial),
                   "captures": bregion["captures"],
                   "labels_equal_unpaced": len(paced),
                   "scores_bit_identical_to_unpaced": budget_scores_same},
        "batch1_fused": summary(single),
        "gpu": power,
    }
    return result, launch


def profile_pipeline_batched(result, launch) -> None:
    """The profiled runs of the batched and the batch-1 fused flagship,
    after every timed phase; emits the ``pipeline_batched`` line."""
    from nnstreamer_tpu_torch.filters.torch_backend import (
        unregister_torch_model,
    )

    try:
        trace = profile_pipeline(launch(BATCHED_PROFILED_FRAMES),
                                 BATCHED_PROFILED_FRAMES)
        trace1 = profile_pipeline(launch(PROFILED_FRAMES, batch=1),
                                  PROFILED_FRAMES)
    finally:
        unregister_torch_model("mnv2_b8")
    result["profiled_run"] = trace
    result["host_launches_per_window"] = \
        trace.get("host_launches_per_replayed_frame")
    result["device_busy_ms_per_frame"] = trace["device_busy_ms_per_frame"]
    result["device_idle_share_at_timed_rate"] = \
        1.0 - trace["device_busy_ms_per_frame"] * result["fps"] / 1e3
    single = result["batch1_fused"]
    single["profiled_run"] = trace1
    single["host_launches_per_frame_replayed"] = \
        trace1.get("host_launches_per_replayed_frame")
    single["device_busy_ms_per_frame"] = trace1["device_busy_ms_per_frame"]
    single["device_idle_share_at_timed_rate"] = \
        1.0 - trace1["device_busy_ms_per_frame"] * single["fps"] / 1e3
    emit({"phase": "pipeline_batched", **result})


def uncut_desc(n, model, labels, pattern="gradient", leaky=True,
               live_rate=None, sink="tensor_sink name=sink to-host=true"):
    """bench.py's flagship string (``bench.py:286-341``) at its defaults:
    ``leaky`` the saturation run's leaky stamp-admission ingress, else a
    blocking one; ``live_rate`` paces the source (``is-live=true``)."""
    live = f" is-live=true framerate={live_rate}" if live_rate else ""
    return (f"videotestsrc num-buffers={n} width={IMAGE} height={IMAGE} "
            f"pattern={pattern}{live} ! tensor_converter ! "
            "queue name=q_ingress max-size-buffers=16 "
            + ("leaky=downstream " if leaky else "")
            + "stamp-admission=true ! "
            "tensor_aggregator frames-in=1 frames-out=8 frames-flush=8 "
            "frames-dim=3 concat=true ! "
            "queue max-size-buffers=8 prefetch-device=true ! "
            "tensor_transform mode=arithmetic "
            "option=typecast:float32,add:-127.5,div:127.5 ! "
            f"tensor_filter framework=jax model={model} name=filter "
            "inflight=2 ! "
            f"tensor_decoder mode=image_labeling option1={labels} "
            "option2=batched ! queue max-size-buffers=64 "
            "materialize-host=true ! " + sink)


def _counter_total(name, **labels) -> float:
    """The sum of every series of counter ``name`` whose labels include
    ``labels``."""
    from nnstreamer_tpu_torch.obs import get_registry

    return sum(m["value"] for m in get_registry().snapshot()["metrics"]
               if m["name"] == name and all(
                   m.get("labels", {}).get(k) == v
                   for k, v in labels.items()))


def _gated_staging_queue(windows: int):
    """Hold the worker of the queue named ``q_stage`` until ``windows``
    windows and the EOS are queued, so it hands them on as one list: which
    windows a fault meets inside a list, and which alone, is then not up
    to the threads' timing (``tests/test_torch_supervise.py`` pins the
    same scenario against the JAX package on the CPU). Returns a restore
    function."""
    from nnstreamer_tpu_torch.pipeline.pipeline import Queue

    drain = Queue._drain

    def gated(self):
        if self.name == "q_stage":
            t_end = time.monotonic() + 60
            while self._q.qsize() < windows + 1 and \
                    not self._stop_evt.is_set() and time.monotonic() < t_end:
                time.sleep(0.001)
        return drain(self)

    Queue._drain = gated
    return lambda: setattr(Queue, "_drain", drain)


def supervision_pinned(labels: str, spec: str) -> dict:
    """The fault-parity scenario of ``tests/test_torch_supervise.py`` at
    full width on the card: bench.py's string at lanes 4 with a blocking
    ingress, 200 ball frames (25 windows) handed to the fused region as
    one list, ``filter.invoke`` every 13th invoke. The 13th fails inside
    the list and is chained again; the 26th fails alone in the per-window
    replay: ``skip-frame`` loses exactly window 25, ``retry`` delivers all
    25, bit-identical to the clean run; 2 faults injected either way."""
    import torch

    import nnstreamer_tpu_torch as nt
    from nnstreamer_tpu_torch.pipeline import faults
    from nnstreamer_tpu_torch.pipeline.pipeline import Pipeline

    frames, windows = 200, 25
    out = {}
    for policy in (None, "skip-frame", "retry"):
        desc = uncut_desc(frames, "mnv2_uncut", labels, pattern="ball",
                          leaky=False).replace(
            "queue max-size-buffers=8 prefetch-device=true",
            "queue name=q_stage max-size-buffers=64 prefetch-device=true")
        name = f"pinned_{policy or 'clean'}"
        pipe = nt.parse_launch(desc, pipeline=Pipeline(name=name),
                               error_policy=policy)
        pipe.lanes = UNCUT_LANES
        metas = []
        pipe.get("sink").connect(lambda b: metas.append(b.meta))
        inj = faults.activate(spec) if policy else None
        restore = _gated_staging_queue(windows)
        try:
            msg = pipe.run(timeout=600)
            torch.cuda.synchronize()
        finally:
            restore()
            faults.deactivate()
        check(msg is not None and msg.kind == "eos", f"{name}: no EOS")
        out[policy or "clean"] = {
            "frames": labelled_frames(metas),
            "injected": len(inj.fired_set("filter.invoke")) if inj else 0,
            "skipped": _counter_total("nns_fault_skipped_frames_total",
                                      pipeline=name),
        }
    clean = out["clean"]["frames"]
    check(len(clean) == frames, "pinned: the clean run lost frames")
    check(out["retry"]["frames"] == clean and out["retry"]["injected"] == 2,
          f"pinned retry: {len(out['retry']['frames'])} frames, "
          f"{out['retry']['injected']} injected")
    check(out["skip-frame"]["frames"] == clean[:BATCH * (windows - 1)] and
          out["skip-frame"]["injected"] == 2 and
          out["skip-frame"]["skipped"] == 1,
          f"pinned skip-frame: {len(out['skip-frame']['frames'])} frames, "
          f"{out['skip-frame']['injected']} injected, "
          f"{out['skip-frame']['skipped']} skipped")
    return {"frames": frames, "spec": spec,
            **{k: {"delivered": len(v["frames"]), "injected": v["injected"],
                   "windows_skipped": v["skipped"]}
               for k, v in out.items()}}


def phase_pipeline_uncut(power: str) -> dict:
    """bench.py's flagship string with no cuts (``bench.py:286-341`` at its
    defaults): 800 gradient frames, lanes 4 (``pipe.lanes`` set after
    ``parse_launch``, as bench.py does), a leaky ``stamp-admission``
    ingress queue, batch 8 through ``tensor_aggregator``, a
    ``prefetch-device`` staging queue, ``inflight=2``, ``option2=batched``
    and a ``materialize-host`` drain, fused (B1 once a window inside the
    region's one captured graph). Then, in the same call:

    - lanes parity: a blocking ingress and ball frames at lanes 4 and 1
      fused, lanes 4 unfused and ``NNSTPU_LANES=1``: labels, indices and
      f32 scores bit-identical in order, 800 of 800;
    - the frame ledger: the uncut string under ``timeline.tracing()``
      (its per-stage split, the stages reconciling with the sink's mean
      e2e within max(10 %, 0.5 ms)) and again under
      ``profiler_correlation`` (B1's kernels in the profiler's trace);
    - supervision: ``filter.invoke`` faults every 13th window under
      ``retry`` (all frames, bit-identical, one capture) and
      ``skip-frame`` (exactly the fired windows lost), and a 5 s stall at
      the 5th fence that the watchdog (1 s) fails within 3 s.

    No timed run takes the ``degrade`` policy's CPU rung."""
    import numpy as np
    import torch

    import nnstreamer_tpu_torch as nt
    from nnstreamer_tpu_torch.filters.torch_backend import (
        register_torch_model,
        unregister_torch_model,
    )
    from nnstreamer_tpu_torch.models.mobilenet_v2 import mobilenet_v2
    from nnstreamer_tpu_torch.obs import get_registry
    from nnstreamer_tpu_torch.obs import timeline
    from nnstreamer_tpu_torch.ops import preprocess as pp
    from nnstreamer_tpu_torch.pipeline import faults
    from nnstreamer_tpu_torch.pipeline.element import FlowError
    from nnstreamer_tpu_torch.pipeline.pipeline import Pipeline

    nt.set_device(None)
    module, _, _ = mobilenet_v2(num_classes=CLASSES, image_size=IMAGE,
                                dtype=torch.bfloat16, seed=0)
    register_torch_model("mnv2_uncut", module)
    tmp = tempfile.mkdtemp(prefix="nns_smoke_uncut_")
    labels = os.path.join(tmp, "labels.txt")
    with open(labels, "w") as f:
        f.write("\n".join(f"class_{i}" for i in range(CLASSES)) + "\n")
    out_dir = os.path.join(HERE, "smoke_out", "uncut")
    os.makedirs(out_dir, exist_ok=True)
    runs = {"n": 0}

    def launch(n, pattern="gradient", leaky=True, lanes=UNCUT_LANES,
               fuse=True, **options):
        """bench.py's string: with ``leaky`` exactly as bench.py builds it
        for a saturation run, else its ingress blocking."""
        runs["n"] += 1
        desc = uncut_desc(n, "mnv2_uncut", labels, pattern=pattern,
                          leaky=leaky)
        pipe = nt.parse_launch(desc, pipeline=Pipeline(
            name=f"uncut_{runs['n']}", fuse=fuse), **options)
        pipe.lanes = lanes  # as bench.py sets it (bench.py:342)
        return pipe

    def degraded():
        return sum(m["value"] for m in get_registry().snapshot()["metrics"]
                   if m["name"] == "nns_fault_degraded_total")

    def bus_errors(pipe):
        """Errors posted on the bus after the message ``run()`` returned
        on (a leaky run's EOS can come first)."""
        errors = []
        while True:
            msg = pipe.pop_message(timeout=0)
            if msg is None:
                return errors
            if msg.kind == "error":
                errors.append(str(msg.error))

    def timed(pipe, n, every_frame=True):
        metas, arrivals = [], []
        sink = pipe.get("sink")
        sink.connect(lambda buf: (metas.append(buf.meta),
                                  arrivals.append(time.monotonic())))
        deg0 = degraded()
        pp.reset_launches()
        t0 = time.monotonic()
        pipe.run(timeout=900)
        torch.cuda.synchronize()
        eos = time.monotonic()
        wall = eos - t0
        launches = dict(pp.LAUNCHES)
        errors = bus_errors(pipe)
        check(not errors, f"uncut: errors on the bus: {errors}")
        snap = pipe.metrics_snapshot()
        frames = labelled_frames(metas)
        check(all(isinstance(f[0], str) and f[0].startswith("class_")
                  for f in frames), "uncut: a frame without a label")
        check(len(frames) == 8 * len(metas),
              "uncut: a window of fewer than 8 frames")
        if every_frame:
            check(len(frames) == n, f"uncut: {len(frames)} of {n} frames "
                                    "labelled")
        check(degraded() == deg0, "uncut: a run took the degrade rung")
        regions = list(snap.get("regions", {}).values())
        q = snap["elements"]["q_ingress"]
        c50, c99 = sink.latency_percentiles(50.0, 99.0)
        a50, a99 = sink.latency_percentiles(50.0, 99.0, base="admitted")
        # a leaky ingress may deliver fewer frames than a quarter skips
        s50, s99 = sink.latency_percentiles(50.0, 99.0, skip=n // 4) \
            or (None, None)
        return {
            "frames": frames, "regions": regions, "pipe": pipe,
            "launches": launches.get("normalize_chain", 0),
            "windows": len(metas), "labelled": len(frames),
            "fps_created": n / wall, "fps_delivered": len(frames) / wall,
            # bench.py's rate (_steady_fps): the frames after the first
            # window's arrival over the span from it to EOS
            "fps_steady": ((len(arrivals) - 1) * BATCH
                           / (eos - arrivals[0]))
            if len(arrivals) > 1 else None,
            "first_window_s": arrivals[0] - t0 if arrivals else None,
            "wall_s": wall,
            "latency_p50_ms": c50, "latency_p99_ms": c99,
            "admitted_p50_ms": a50, "admitted_p99_ms": a99,
            "latency_p50_ms_after_first_quarter": s50,
            "latency_p99_ms_after_first_quarter": s99,
            "admitted_samples": len(sink.admitted_latencies),
            "drops": q.get("drops", 0), "admitted": q.get("admitted"),
            "admitted_revoked": q.get("admitted_revoked"),
            "lanes": snap.get("lanes"),
        }

    def summary(r):
        return {k: v for k, v in r.items() if k not in ("frames",
                                                         "regions", "pipe")}

    def queue_wait_by_place(tl, pipe, skip):
        """The ledger's mean ``queue_wait`` a delivered frame, split by
        where it waited: which queue (or the aggregator, or the region's
        list) backs up says which stage after it sets the pace."""
        ledger = tl.frame_ledger(skip)
        done = {seq for seq, d in ledger.items() if "e2e" in d}
        places = {}
        for el in pipe.elements:
            if el.ELEMENT_NAME == "queue":
                places[el.name] = (
                    "ingress queue" if el.get_property("stamp_admission")
                    else "staging queue (prefetch-device)"
                    if el.get_property("prefetch_device")
                    else "drain queue (materialize-host)")
            elif el.ELEMENT_NAME == "tensor_aggregator":
                places[el.name] = "aggregator (window forming)"
        for r in pipe._regions or ():
            places[r.name] = "fused region (its turn in a list)"
        total = {}
        for _thread, kind, seq, t0, t1, track, _args in tl._snapshot():
            if kind == "queue_wait" and seq in done and t1 is not None:
                place = places.get(track, track)
                total[place] = total.get(place, 0.0) + (t1 - t0)
        return {k: v / len(done) * 1e3 for k, v in total.items()} \
            if done else {}

    def one_capture(r, what):
        (region,) = r["regions"]
        check(region["captures"] == 1 and not region["unspliced"],
              f"uncut, {what}: {region['captures']} captures")
        # B1 once a window the region dispatched, eager or replayed
        check(r["launches"] == r["windows"] ==
              region["eager_frames"] + region["replays"],
              f"uncut, {what}: normalize kernel counted {r['launches']} "
              f"times for {r['windows']} windows")
        return region

    n = BATCHED_FRAMES
    result = {"frames": n, "batch": BATCH, "lanes": UNCUT_LANES,
              "gpu": power}
    try:
        warm = launch(10 * BATCH, pattern="ball")
        warm.run(timeout=600)
        check(not bus_errors(warm), "uncut: the warm-up run failed")
        # 1. the uncut string
        main = timed(launch(n), n, every_frame=False)
        region = one_capture(main, "bench string")
        # A.8b: the same Pipeline object again, a plain restart: the
        # region replays its graph from the first window, no capture
        sink = main["pipe"].get("sink")
        for kept in (sink.latencies, sink.admitted_latencies,
                     sink.buffers):
            kept.clear()
        again = timed(main["pipe"], n, every_frame=False)
        (again_region,) = again["regions"]
        check(again_region["captures"] == 1 and
              again["launches"] == again["windows"],
              f"uncut, restarted: {again_region['captures']} captures in "
              f"all, normalize kernel {again['launches']} for "
              f"{again['windows']} windows")
        check(main["admitted"] == n and
              main["admitted_revoked"] == main["drops"],
              f"uncut: {main['admitted']} admitted, "
              f"{main['admitted_revoked']} revoked, {main['drops']} drops")
        check(main["lanes"] and all(
            s["lanes"] == UNCUT_LANES and s["forwarded"] == n
            for s in main["lanes"].values()),
            f"uncut: lanes snapshot {main['lanes']}")
        # the same string at lanes 1, in turn, for lanes 4's gain; then
        # both past the region's start-up, over STEADY_FRAMES
        serial = timed(launch(n, lanes=1), n, every_frame=False)
        one_capture(serial, "bench string, lanes 1")
        long4 = timed(launch(STEADY_FRAMES), STEADY_FRAMES,
                      every_frame=False)
        long1 = timed(launch(STEADY_FRAMES, lanes=1), STEADY_FRAMES,
                      every_frame=False)
        for key, r in (("lanes 4", long4), ("lanes 1", long1)):
            one_capture(r, f"bench string, {STEADY_FRAMES} frames, {key}")
        result.update({
            "bench_string": summary(main), "region": region,
            # the restarted run (0 captures) beside the cold one and the
            # scheduled run of when a restart captured again
            "bench_string_restarted": {
                **summary(again),
                "captures": again_region["captures"] - region["captures"]},
            "recapturing_slo_scheduled": RECAPTURING_SLO,
            "bench_string_lanes_1": summary(serial),
            "steady": {"frames": STEADY_FRAMES, "lanes_4": summary(long4),
                       "lanes_1": summary(long1)},
            "lanes_4_over_1": {
                "fps_created": main["fps_created"] / serial["fps_created"],
                "fps_steady": long4["fps_steady"] / long1["fps_steady"],
            }})

        # 2. lanes parity on ball frames through a blocking ingress
        parity = {
            "lanes_4": timed(launch(n, "ball", leaky=False), n),
            "lanes_1": timed(launch(n, "ball", leaky=False, lanes=1), n),
            "lanes_4_unfused": timed(launch(n, "ball", leaky=False,
                                            fuse=False), n),
        }
        os.environ["NNSTPU_LANES"] = "1"
        try:
            parity["nnstpu_lanes_1"] = timed(launch(n, "ball",
                                                    leaky=False), n)
        finally:
            os.environ.pop("NNSTPU_LANES")
        clean = parity["lanes_4"]
        identical = {}
        for key, r in parity.items():
            differ = [i for i, (a, b) in enumerate(zip(r["frames"],
                                                       clean["frames"]))
                      if a != b]
            check(len(r["frames"]) == n and not differ,
                  f"uncut, lanes parity {key}: frames {differ[:10]} differ")
            identical[key] = n - len(differ)
        for key in ("lanes_4", "lanes_1", "nnstpu_lanes_1"):
            one_capture(parity[key], key)
        check(parity["lanes_1"]["lanes"] is None and
              parity["nnstpu_lanes_1"]["lanes"] is None,
              "uncut: the serial path spliced lanes")
        check(parity["lanes_4"]["lanes"] is not None,
              "uncut: lanes 4 spliced no lanes")
        result["lanes_parity"] = {
            "bit_identical_frames": identical,
            **{k: summary(v) for k, v in parity.items()}}

        # 3. the frame ledger: the timeline alone, then with the profiler
        with timeline.tracing() as tl:
            traced = timed(launch(n), n, every_frame=False)
        ledger_path = os.path.join(out_dir, "ledger.json")
        tl.export_chrome(ledger_path)
        with open(ledger_path) as f:
            doc = json.load(f)
        kinds = {e["name"] for e in doc["traceEvents"] if e["ph"] == "X"}
        check(set(LEDGER_STAGES) <= kinds,
              f"uncut ledger: no slices of "
              f"{sorted(set(LEDGER_STAGES) - kinds)}")
        skip = n // 4
        bd = tl.stage_breakdown(skip_frames=skip)
        gap = abs(bd["e2e_mean_ms"] - bd["covered_ms"])
        check(bd["frames"] > 0 and
              gap <= max(0.10 * bd["e2e_mean_ms"], 0.5),
              f"uncut ledger: stages cover {bd['covered_ms']} ms of a "
              f"{bd['e2e_mean_ms']} ms mean e2e")
        check(set(traced["frames"]) <= set(main["frames"]),
              "uncut ledger: traced labels differ from the untraced run")
        one_capture(traced, "traced")
        # the split with every frame delivered: the same string with its
        # ingress blocking, lanes 4 and 1, the first quarter skipped
        steady_split = {}
        for lanes in (UNCUT_LANES, 1):
            with timeline.tracing() as tl_b:
                traced_b = timed(launch(n, leaky=False, lanes=lanes), n)
            bd_b = tl_b.stage_breakdown(skip_frames=skip)
            gap_b = abs(bd_b["e2e_mean_ms"] - bd_b["covered_ms"])
            check(bd_b["frames"] > 0 and
                  gap_b <= max(0.10 * bd_b["e2e_mean_ms"], 0.5),
                  f"uncut blocking ledger, lanes {lanes}: stages cover "
                  f"{bd_b['covered_ms']} ms of a {bd_b['e2e_mean_ms']} ms "
                  "mean e2e")
            check(set(traced_b["frames"]) <= set(main["frames"]),
                  "uncut blocking ledger: labels differ from the untraced "
                  "run")
            steady_split[f"lanes_{lanes}"] = {
                "breakdown": bd_b,
                "queue_wait_ms_by_place": queue_wait_by_place(
                    tl_b, traced_b["pipe"], skip),
                "variance": tl_b.variance_report(skip_frames=skip),
                "run": summary(traced_b)}
        with timeline.tracing() as tl2, \
                timeline.profiler_correlation(out_dir) as prof:
            profiled = timed(launch(n), n, every_frame=False)
        tl2.export_chrome(os.path.join(out_dir, "ledger_profiled.json"))
        with open(prof.trace_path) as f:
            ptrace = json.load(f)
        b1_events = [e for e in ptrace["traceEvents"]
                     if e.get("cat") == "kernel" and
                     "normalize_chain_kernel" in e.get("name", "")]
        check(len(b1_events) == profiled["launches"],
              f"uncut profiler: {len(b1_events)} normalize kernels for "
              f"{profiled['launches']} launches")
        bd2 = tl2.stage_breakdown(skip_frames=skip)
        gap2 = abs(bd2["e2e_mean_ms"] - bd2["covered_ms"])
        check(bd2["frames"] > 0 and
              gap2 <= max(0.10 * bd2["e2e_mean_ms"], 0.5),
              f"uncut profiled ledger: stages cover {bd2['covered_ms']} "
              f"ms of a {bd2['e2e_mean_ms']} ms mean e2e")
        result["ledger"] = {
            "skip_frames": skip, "breakdown": bd,
            "queue_wait_ms_by_place": queue_wait_by_place(
                tl, traced["pipe"], skip),
            "variance": tl.variance_report(skip_frames=skip),
            "blocking_ingress": steady_split,
            "slices": sorted(kinds), "run": summary(traced),
            "profiled": {"breakdown": bd2, "run": summary(profiled),
                         "normalize_kernel_events": len(b1_events)},
            "files": [os.path.relpath(p, HERE) for p in (
                ledger_path, prof.trace_path)],
        }

        # 4. supervision, blocking ingress, ball frames
        spec = f"filter.invoke:every={FAULT_EVERY},kind=raise"
        inj = faults.activate(spec)
        try:
            retry = timed(launch(n, "ball", leaky=False,
                                 error_policy="retry"), n)
        finally:
            faults.deactivate()
        check(retry["frames"] == clean["frames"],
              "uncut retry: frames differ from the clean run")
        retry_region = one_capture(retry, "retry")
        fired_retry = inj.fired_set("filter.invoke")
        inj = faults.activate(spec)
        try:
            skipped = timed(launch(n, "ball", leaky=False,
                                   error_policy="skip-frame"), n,
                            every_frame=False)
        finally:
            faults.deactivate()
        fired = inj.fired_set("filter.invoke")
        # a window that failed alone meets the policy and is dropped; one
        # that failed inside a list is chained again first, as the JAX
        # package does (ROADMAP C.13), so which faults cost a window
        # depends on how the staging queue's worker gathered its runs:
        # the lost windows are the skipped count, and the survivors are
        # the clean run's frames in order
        lost = round(_counter_total("nns_fault_skipped_frames_total",
                                    pipeline=skipped["pipe"].name))
        it = iter(clean["frames"])
        in_order = all(any(f == g for g in it) for f in skipped["frames"])
        check(fired and in_order and lost <= len(fired) and
              len(skipped["frames"]) == n - BATCH * lost,
              f"uncut skip-frame: {len(skipped['frames'])} frames, "
              f"{lost} windows skipped, fired {fired}")
        pinned = supervision_pinned(labels, spec)
        faults.activate("dispatch.fence:nth=5,kind=stall,ms=5000")
        pipe = launch(n, "ball", leaky=False, watchdog_s=WATCHDOG_S)
        t0 = time.monotonic()
        err = None
        try:
            pipe.run(timeout=60)
        except FlowError as e:
            err = str(e)
        finally:
            faults.deactivate()
        wd_wall = time.monotonic() - t0
        check(err is not None and "watchdog" in err,
              f"uncut watchdog: the run ended with {err!r}")
        check(wd_wall <= WATCHDOG_MAX_S,
              f"uncut watchdog: the FlowError came after {wd_wall} s")
        result["supervision"] = {
            "spec": spec,
            "retry": {**summary(retry), "fired": fired_retry,
                      "captures": retry_region["captures"],
                      "bit_identical_frames": n},
            "skip_frame": {**summary(skipped), "fired": fired,
                           "windows_skipped": lost,
                           "frames_lost": n - len(skipped["frames"])},
            "pinned": pinned,
            "watchdog": {"spec": "dispatch.fence:nth=5,kind=stall,ms=5000",
                         "watchdog_s": WATCHDOG_S, "error": err,
                         "run_s": wd_wall},
            "degraded_total": degraded(),
        }
    finally:
        faults.deactivate()
        unregister_torch_model("mnv2_uncut")
    emit({"phase": "pipeline_uncut", **result})
    return result


# -- the SLO scheduler, the flight recorder, QoS, the CLI (ROADMAP A.11b,
# A.12) ------------------------------------------------------------------------
def _flagship_model(name, declare_io=False):
    """MobileNetV2 width 1.0, 224×224×3, 1001 classes, bf16, seed 0,
    registered under ``name`` (with its input and output infos when
    ``declare_io``, for a stream whose caps carry no shapes); and a labels
    file."""
    import torch

    from nnstreamer_tpu_torch.filters.torch_backend import (
        register_torch_model,
    )
    from nnstreamer_tpu_torch.models.mobilenet_v2 import mobilenet_v2

    module, in_info, out_info = mobilenet_v2(
        num_classes=CLASSES, image_size=IMAGE, dtype=torch.bfloat16, seed=0)
    if declare_io:
        register_torch_model(name, module, in_info, out_info)
    else:
        register_torch_model(name, module)
    labels = os.path.join(tempfile.mkdtemp(prefix="nns_smoke_slo_"),
                          "labels.txt")
    with open(labels, "w") as f:
        f.write("\n".join(f"class_{i}" for i in range(CLASSES)) + "\n")
    return module, labels


def _counter(name, **labels) -> float:
    from nnstreamer_tpu_torch.obs import get_registry

    c = get_registry().get(name, **labels)
    return float(c.value) if c is not None else 0.0


def _warm_then_measure(pipe, n):
    """Run ``pipe`` once to warm it (cuDNN, the allocator, the staging
    pool, the shape probe, the region's one capture; the scheduler's
    estimate), then again, timed, on the same Pipeline object: since
    ROADMAP A.8b the region keeps its graph across the plain restart, so
    the measured run replays from its first window. Returns the measured
    run's record (``captures``: the measured run's)."""
    import torch

    from nnstreamer_tpu_torch.ops import preprocess as pp

    pipe.run(timeout=600)
    sink = pipe.get("sink")
    sink.latencies.clear()
    sink.admitted_latencies.clear()
    sink.buffers.clear()
    name = pipe.name
    q = dict(pipeline=name, element="q_ingress")
    before = {k: _counter(k, **q) for k in (
        "nns_queue_admitted_total", "nns_queue_admitted_revoked_total",
        "nns_queue_drops_total")}
    sched = {k: _counter("nns_sched_shed_total", pipeline=name, reason=k)
             for k in ("late", "capacity")}
    rej0 = _counter("nns_sched_rejected_total", pipeline=name)
    (region,) = pipe._regions
    reg0 = (region.captures, region.eager_frames, region.replays)
    metas, arrivals = [], []
    sink.connect(lambda buf: (metas.append(buf.meta),
                              arrivals.append(time.monotonic())))
    pp.reset_launches()
    t0 = time.monotonic()
    msg = pipe.run(timeout=600)
    torch.cuda.synchronize()
    eos = time.monotonic()
    launches = pp.LAUNCHES.get("normalize_chain", 0)
    check(msg is not None and msg.kind == "eos", f"{name}: no EOS ({msg})")
    frames = labelled_frames(metas)
    span = eos - arrivals[0] if arrivals else 0.0
    adm = len(sink.admitted_latencies)
    a = {k: _counter(k, **q) - v for k, v in before.items()}
    shed = {k: _counter("nns_sched_shed_total", pipeline=name, reason=k) - v
            for k, v in sched.items()}
    rejected = _counter("nns_sched_rejected_total", pipeline=name) - rej0
    stamped = a["nns_queue_admitted_total"]
    revoked = a["nns_queue_admitted_revoked_total"]
    a50, a99 = sink.latency_percentiles(50.0, 99.0, base="admitted") \
        or (None, None)
    c50, c99 = sink.latency_percentiles(50.0, 99.0) or (None, None)
    snap = pipe.metrics_snapshot()
    return {
        "frames": frames, "metas": metas,
        "created": n, "delivered": len(frames), "windows": len(metas),
        "fps_created": n / (eos - t0),
        "fps_delivered": len(frames) / (eos - t0),
        "fps_steady": (len(arrivals) - 1) * BATCH / span if span else None,
        # bench.py's accounting (bench.py:590-627): the served admitted
        # population a second over first arrival → EOS, and the offered
        # traffic turned away (door rejections, post-stamp sheds/drops)
        "admitted_fps": adm / span if span else None,
        "shed_ratio": ((rejected + revoked) / (stamped + rejected)
                       if stamped + rejected else None),
        "admitted": stamped, "revoked": revoked, "rejected": rejected,
        "drops": a["nns_queue_drops_total"], "shed": shed,
        "admitted_samples": adm,
        "admitted_p50_ms": a50, "admitted_p99_ms": a99,
        "latency_p50_ms": c50, "latency_p99_ms": c99,
        "first_window_s": arrivals[0] - t0 if arrivals else None,
        "wall_s": eos - t0,
        "captures": region.captures - reg0[0],
        "captures_total": region.captures,
        "region_windows": (region.eager_frames - reg0[1]
                           + region.replays - reg0[2]),
        "launches": launches,
        "scheduler": snap.get("scheduler"),
    }


def phase_pipeline_slo(power: str) -> dict:
    """bench.py's uncut string (lanes 4, the leaky stamp-admission ingress,
    batch 8, 800 gradient frames) with the SLO scheduler at the 50 ms budget
    of ``serving/scheduler.py`` against the same string without it, each
    warmed once and measured on the same Pipeline object, in turns; a
    blocking unscheduled run labels the frames for reference; and a live
    200-fps run of 160 ball frames with the budget against without it: a
    uniform budget makes the EDF heap FIFO, so the same frames in the same
    order, less those shed as late (bit-identical when none were). Each
    measured run captures nothing: the region keeps the warm-up run's
    graph across the restart (ROADMAP A.8b). bench.py's contract (admitted
    p99 ≤ 2× budget while ``admitted_fps`` ≥ 80 % of the unscheduled
    rate) is reported, not gated, beside the figures of when the restart
    captured again."""
    import nnstreamer_tpu_torch as nt
    from nnstreamer_tpu_torch.filters.torch_backend import (
        unregister_torch_model,
    )
    from nnstreamer_tpu_torch.pipeline.pipeline import Pipeline

    nt.set_device(None)
    _module, labels = _flagship_model("mnv2_slo")
    n = BATCHED_FRAMES
    runs = {"n": 0}

    def launch(budget, frames=n, **kw):
        runs["n"] += 1
        pipe = nt.parse_launch(
            uncut_desc(frames, "mnv2_slo", labels, **kw),
            pipeline=Pipeline(name=f"slo_{runs['n']}"),
            slo_budget_ms=budget)
        pipe.lanes = UNCUT_LANES
        return pipe

    def summary(r):
        return {k: v for k, v in r.items() if k not in ("frames", "metas")}

    def held(r, what, ref_labels):
        # A.8b: the warm-up run captured, the measured run replays only
        check(r["captures"] == 0 and r["captures_total"] == 1,
              f"slo {what}: {r['captures']} captures in the measured run, "
              f"{r['captures_total']} in all")
        check(r["launches"] == r["region_windows"] == r["windows"],
              f"slo {what}: B1 {r['launches']} for {r['windows']} windows "
              f"({r['region_windows']} the region took)")
        check(r["delivered"] == BATCH * r["windows"] and all(
            f[0].startswith("class_") for f in r["frames"]),
            f"slo {what}: a frame without a label")
        check(set(r["frames"]) <= ref_labels,
              f"slo {what}: labels differ from the blocking run's")
        # every delivered frame carries its admission stamp: no shed
        # frame reached the sink
        check(r["admitted_samples"] == r["delivered"],
              f"slo {what}: {r['admitted_samples']} admitted samples for "
              f"{r['delivered']} frames")
        # admitted = delivered + revoked, less the aggregator's last
        # partial window (under 8 frames, dropped at EOS without a budget)
        tail = r["admitted"] - r["revoked"] - r["delivered"]
        check(0 <= tail < BATCH, f"slo {what}: admitted {r['admitted']}, "
                                 f"revoked {r['revoked']}, delivered "
                                 f"{r['delivered']}")
        r["aggregator_tail"] = tail

    result = {"frames": n, "budget_ms": SLO_BUDGET_MS, "gpu": power}
    try:
        ref = _warm_then_measure(launch(0.0, leaky=False), n)
        check(ref["delivered"] == n, "slo: the blocking run lost frames")
        ref_labels = set(ref["frames"])
        sched = _warm_then_measure(launch(SLO_BUDGET_MS), n)
        plain = _warm_then_measure(launch(0.0), n)
        held(sched, "scheduled", ref_labels)
        held(plain, "unscheduled", ref_labels)
        check(sched["scheduler"] is not None and plain["scheduler"] is None,
              "slo: the scheduler attached where it should not, or not")
        check(sched["rejected"] + sched["admitted"] == n,
              f"slo: {sched['rejected']} rejected + {sched['admitted']} "
              f"admitted of {n}")
        contract = {
            "admitted_p99_ms": sched["admitted_p99_ms"],
            "p99_limit_ms": 2 * SLO_BUDGET_MS,
            "admitted_fps": sched["admitted_fps"],
            "unscheduled_fps_steady": plain["fps_steady"],
            "admitted_fps_over_unscheduled": (
                sched["admitted_fps"] / plain["fps_steady"]
                if sched["admitted_fps"] and plain["fps_steady"] else None),
        }
        contract["met"] = bool(
            contract["admitted_p99_ms"] is not None and
            contract["admitted_p99_ms"] <= contract["p99_limit_ms"] and
            contract["admitted_fps_over_unscheduled"] is not None and
            contract["admitted_fps_over_unscheduled"] >= 0.8)
        # live-paced, blocking ingress: a uniform budget keeps FIFO order,
        # so the budget run delivers the unbudgeted run's frames in order,
        # less exactly the frames it shed or rejected; with none shed, bit
        # for bit
        live = {}
        for key, budget in (("budget", SLO_BUDGET_MS), ("none", 0.0)):
            live[key] = _warm_then_measure(
                launch(budget, frames=BUDGET_FRAMES, pattern="ball",
                       leaky=False, live_rate=BUDGET_RATE), BUDGET_FRAMES)
            check(live[key]["captures"] == 0,
                  f"slo live {key}: {live[key]['captures']} captures in "
                  "the measured run")
        check(live["none"]["delivered"] == BUDGET_FRAMES,
              f"slo live: {live['none']['delivered']} of {BUDGET_FRAMES} "
              "frames without the budget")
        lost = int(live["budget"]["revoked"] + live["budget"]["rejected"])
        kept = BUDGET_FRAMES - lost
        check(live["budget"]["delivered"] == kept - kept % BATCH,
              f"slo live: {live['budget']['delivered']} of {BUDGET_FRAMES} "
              f"frames delivered with {lost} shed or rejected "
              f"({live['budget']['shed']})")
        it = iter(f[:2] for f in live["none"]["frames"])
        check(all(any(f[:2] == g for g in it)
                  for f in live["budget"]["frames"]),
              "slo live: the budget changed the frames' order or labels")
        if lost == 0:
            check(live["budget"]["frames"] == live["none"]["frames"],
                  "slo live: frames differ with the budget")
        result.update({
            "scheduled": summary(sched), "unscheduled": summary(plain),
            "blocking_reference": summary(ref), "contract": contract,
            # the measured runs' captures (0: A.8b) beside the figures of
            # when the restart captured again
            "measured_captures": {"scheduled": sched["captures"],
                                  "unscheduled": plain["captures"]},
            "recapturing_scheduled": RECAPTURING_SLO,
            "live": {"rate": BUDGET_RATE, "frames": BUDGET_FRAMES,
                     "shed_or_rejected": lost,
                     "bit_identical": lost == 0,
                     "budget": summary(live["budget"]),
                     "none": summary(live["none"])},
        })
    finally:
        unregister_torch_model("mnv2_slo")
    emit({"phase": "pipeline_slo", **result})
    return result


def phase_flight(power: str) -> dict:
    """The always-on flight recorder's cost and its tail dump:

    - the batch-8 blocking string (lanes 1) and bench.py's uncut string
      (lanes 4, leaky ingress), 800 gradient frames, each timed six times
      with the recorder on (the default) and six with ``NNSTPU_FLIGHT=0``,
      in turns; the blocking runs' outputs bit-identical;
    - ``NNSTPU_FLIGHT=<dir>`` and ``filter.invoke`` stalls on the fused
      batch-8 flagship with no queue before the region: one dump file, its
      window around a stalled window, and ``attribution()`` naming
      ``device``;
    - ``nns_stage_p50_ms`` / ``nns_stage_p99_ms`` read through
      ``obs/server.py`` over HTTP on 127.0.0.1."""
    import urllib.request

    import torch

    import nnstreamer_tpu_torch as nt
    from nnstreamer_tpu_torch.filters.torch_backend import (
        unregister_torch_model,
    )
    from nnstreamer_tpu_torch.obs import MetricsServer
    from nnstreamer_tpu_torch.ops import preprocess as pp
    from nnstreamer_tpu_torch.pipeline import faults
    from nnstreamer_tpu_torch.pipeline.pipeline import Pipeline

    nt.set_device(None)
    _module, labels = _flagship_model("mnv2_flight")
    n = BATCHED_FRAMES
    runs = {"n": 0}

    def run(recorder, leaky, lanes):
        runs["n"] += 1
        if recorder:
            os.environ.pop("NNSTPU_FLIGHT", None)
        else:
            os.environ["NNSTPU_FLIGHT"] = "0"
        try:
            pipe = nt.parse_launch(
                uncut_desc(n, "mnv2_flight", labels, leaky=leaky),
                pipeline=Pipeline(name=f"flight_{runs['n']}"))
            pipe.lanes = lanes
            metas, arrivals = [], []
            pipe.get("sink").connect(lambda b: (metas.append(b.meta),
                                                arrivals.append(
                                                    time.monotonic())))
            t0 = time.monotonic()
            msg = pipe.run(timeout=600)
            torch.cuda.synchronize()
            eos = time.monotonic()
        finally:
            os.environ.pop("NNSTPU_FLIGHT", None)
        check(msg is not None and msg.kind == "eos", "flight: no EOS")
        check((pipe._flight is not None) == recorder,
              f"flight: recorder {pipe._flight} with recorder={recorder}")
        span = eos - arrivals[0] if len(arrivals) > 1 else 0.0
        return {"frames": labelled_frames(metas),
                "fps_created": n / (eos - t0),
                "fps_steady": (len(arrivals) - 1) * BATCH / span
                if span else None,
                "delivered": BATCH * len(metas), "wall_s": eos - t0}

    result = {"frames": n, "gpu": power}
    try:
        cost = {}
        for string, leaky, lanes in (("batch8_blocking", False, 1),
                                     ("uncut", True, UNCUT_LANES)):
            rs = {"on": [], "off": []}
            # in turns, each side first as often: run-to-run spread on
            # the card's host is wide (PERF.md §6), so six runs a side
            for recorder in (True, False, False, True) * FLIGHT_COST_PAIRS:
                rs["on" if recorder else "off"].append(
                    run(recorder, leaky, lanes))
            if not leaky:
                for r in rs["on"] + rs["off"]:
                    check(r["frames"] == rs["on"][0]["frames"] and
                          len(r["frames"]) == n,
                          "flight: the recorder changed the output")
            key = "fps_created" if leaky else "fps_steady"
            on = statistics.median(r[key] for r in rs["on"])
            off = statistics.median(r[key] for r in rs["off"])
            cost[string] = {
                "metric": key, "recorder_on": [r[key] for r in rs["on"]],
                "recorder_off": [r[key] for r in rs["off"]],
                "on_quartiles": statistics.quantiles(
                    [r[key] for r in rs["on"]], n=4),
                "off_quartiles": statistics.quantiles(
                    [r[key] for r in rs["off"]], n=4),
                "delivered_on": [r["delivered"] for r in rs["on"]],
                "delivered_off": [r["delivered"] for r in rs["off"]],
                "on_over_off_median": on / off if off else None}
        result["cost"] = cost

        # a tail dump from injected invoke stalls, no queue before the
        # region (a queue absorbs the stall as its own queue_wait)
        dump_dir = tempfile.mkdtemp(prefix="nns_smoke_flight_")
        os.environ["NNSTPU_FLIGHT"] = dump_dir
        os.environ["NNSTPU_FLIGHT_MIN_SAMPLES"] = "6"
        stall = f"filter.invoke:every=2,kind=stall,ms={FLIGHT_STALL_MS}"
        faults.activate(stall)
        try:
            pipe = nt.parse_launch(
                f"videotestsrc num-buffers={FLIGHT_FRAMES} width={IMAGE} "
                f"height={IMAGE} pattern=ball ! tensor_converter ! "
                "tensor_aggregator frames-in=1 frames-out=8 frames-flush=8 "
                "frames-dim=3 concat=true ! tensor_transform "
                "mode=arithmetic option=typecast:float32,add:-127.5,"
                "div:127.5 ! tensor_filter framework=jax model=mnv2_flight "
                f"inflight=2 ! tensor_decoder mode=image_labeling "
                f"option1={labels} option2=batched ! "
                "tensor_sink name=sink to-host=true",
                pipeline=Pipeline(name="flight_dump"))
            pp.reset_launches()
            msg = pipe.run(timeout=600)
        finally:
            faults.deactivate()
            os.environ.pop("NNSTPU_FLIGHT", None)
            os.environ.pop("NNSTPU_FLIGHT_MIN_SAMPLES", None)
        check(msg is not None and msg.kind == "eos", "flight dump: no EOS")
        (region,) = pipe._regions
        check(not region._dead and region.captures == 1,
              "flight dump: the region fell back or captured again")
        files = [os.path.join(dump_dir, f) for f in os.listdir(dump_dir)
                 if f.endswith(".json")]
        check(len(files) == 1, f"flight dump: {len(files)} dump files")
        with open(files[0]) as f:
            doc = json.load(f)
        stalled = doc["trigger"]["seq"]
        check(doc["trigger"]["kind"] == "fault" and stalled is not None and
              any(s["seq"] == stalled and s["kind"] == "device"
                  for s in doc["spans"]),
              f"flight dump: trigger {doc['trigger']}")
        check(doc["window"]["seq_lo"] <= stalled <= doc["window"]["seq_hi"],
              "flight dump: the stalled window outside the dump's window")
        attr = pipe.metrics_snapshot()["attribution"]
        check(attr["dominant_stage"] == "device",
              f"flight: attribution names {attr['dominant_stage']}")
        # the gauges over HTTP
        with MetricsServer(host="127.0.0.1", port=0) as srv:
            text = urllib.request.urlopen(
                f"http://127.0.0.1:{srv.port}/metrics", timeout=10
            ).read().decode()
        gauges = {}
        for line in text.splitlines():
            if line.startswith(("nns_stage_p50_ms", "nns_stage_p99_ms")) \
                    and 'pipeline="flight_dump"' in line:
                stage = line.split('stage="', 1)[1].split('"', 1)[0]
                if stage in ("e2e", "device"):
                    gauges[f"{line.split('{', 1)[0]}[{stage}]"] = float(
                        line.rsplit(None, 1)[1])
        check(len(gauges) == 4 and all(v > 0 for v in gauges.values()),
              f"flight: gauges over HTTP {gauges}")
        result["dump"] = {
            "spec": stall, "frames": FLIGHT_FRAMES,
            "file": os.path.basename(files[0]),
            "trigger": doc["trigger"], "window": doc["window"],
            "attribution": attr, "gauges_http": gauges,
            "launches": pp.LAUNCHES.get("normalize_chain", 0),
            "windows": region.eager_frames + region.replays,
        }
        check(result["dump"]["launches"] == result["dump"]["windows"],
              "flight dump: B1 not once a window")
    finally:
        unregister_torch_model("mnv2_flight")
    emit({"phase": "flight", **result})
    return result


def phase_qos(power: str) -> dict:
    """``tensor_rate framerate=100/1 throttle=true`` behind the fused batch-1
    flagship's filter, the source's stream at 1000/1: the QoS interval
    reaches the region (transform ! filter), which drops the frames that
    come too soon before any copy or replay. The rate sits before the
    decoder: behind it the caps are text, and ``tensor_rate`` posts QoS
    only for tensor caps, in both packages (ROADMAP C.15). Checks: the
    drops counted, every delivered frame labelled as an unthrottled run
    of the same frames labels it (by its trace seq, the source's frame
    index), and B1 once for each frame the region ran."""
    import torch

    import nnstreamer_tpu_torch as nt
    from nnstreamer_tpu_torch.filters.torch_backend import (
        unregister_torch_model,
    )
    from nnstreamer_tpu_torch.obs.timeline import TRACE_SEQ_META
    from nnstreamer_tpu_torch.ops import preprocess as pp
    from nnstreamer_tpu_torch.pipeline.pipeline import Pipeline

    nt.set_device(None)
    _module, labels = _flagship_model("mnv2_qos")

    def run(name, rate):
        desc = (f"videotestsrc num-buffers={QOS_FRAMES} width={IMAGE} "
                f"height={IMAGE} pattern=ball framerate=1000/1 ! "
                "tensor_converter ! tensor_transform mode=arithmetic "
                "option=typecast:float32,add:-127.5,div:127.5 ! "
                "tensor_filter framework=jax model=mnv2_qos name=filter ! "
                + (f"tensor_rate name=rate framerate={rate} throttle=true ! "
                   if rate else "")
                + f"tensor_decoder mode=image_labeling option1={labels} ! "
                "tensor_sink name=sink to-host=true")
        pipe = nt.parse_launch(desc, pipeline=Pipeline(name=name))
        got = []
        pipe.get("sink").connect(lambda b: got.append(
            (b.meta[TRACE_SEQ_META], b.meta["label"], b.meta["label_index"])))
        pp.reset_launches()
        msg = pipe.run(timeout=600)
        torch.cuda.synchronize()
        check(msg is not None and msg.kind == "eos", f"qos {name}: no EOS")
        return pipe, got, pp.LAUNCHES.get("normalize_chain", 0)

    try:
        _ref_pipe, ref, _ = run("qos_ref", None)
        check(len(ref) == QOS_FRAMES, "qos: the unthrottled run lost frames")
        by_seq = {s: (lab, idx) for s, lab, idx in ref}
        pipe, got, launches = run("qos_rate", QOS_RATE)
        (region,) = pipe._regions
        ran = region.eager_frames + region.replays
        check(not region._dead and region.captures == 1,
              "qos: the region fell back or captured again")
        check(region.qos_drops > 0 and region.qos_drops + ran == QOS_FRAMES,
              f"qos: {region.qos_drops} dropped + {ran} run of "
              f"{QOS_FRAMES}")
        check(launches == ran, f"qos: B1 {launches} for {ran} frames run")
        check(got and all(by_seq[s] == (lab, idx) for s, lab, idx in got),
              "qos: a delivered frame's label differs from the "
              "unthrottled run's")
        rate = pipe.get("rate")
        result = {"frames": QOS_FRAMES, "rate": QOS_RATE,
                  "qos_interval_s": pipe.get("filter")._qos_interval_s,
                  "qos_drops": region.qos_drops, "frames_run": ran,
                  "launches": launches, "delivered": len(got),
                  "rate_dropped": rate.dropped,
                  "rate_duplicated": rate.duplicated, "gpu": power}
    finally:
        unregister_torch_model("mnv2_qos")
    emit({"phase": "qos", **result})
    return result


def phase_lm_slo(power: str, fp32_tokens) -> dict:
    """The engine of ``lm_serving`` with ``slo_budget_ms``:

    - fp32 with a budget that admits all 12 prompts: greedy tokens
      identical to ``lm_parity``'s run without a budget;
    - bf16 at the 50 ms budget: a first burst of 12 prompts meets a cold
      estimate and is admitted (128 tokens each, B2 in every prefill);
      a second burst meets the estimate the first left, and exactly the
      submits that raise ``SloRejected`` are counted in
      ``nns_sched_rejected_total``."""
    import torch

    import nnstreamer_tpu_torch as nt
    from nnstreamer_tpu_torch.models.transformer import (
        TransformerConfig,
        init_params,
    )
    from nnstreamer_tpu_torch.ops._counts import LAUNCHES, reset_launches
    from nnstreamer_tpu_torch.serving import (
        ContinuousBatchingEngine,
        SloRejected,
    )

    nt.set_device(None)
    prompts, _ = _lm_prompts()
    eng = _fp32_engine(slo_budget_ms=LM_SLO_WIDE_MS).start()
    try:
        streams = [eng.submit(p, max_new_tokens=LM_PARITY_NEW)
                   for p in prompts]
        tokens = [s.result(timeout=600) for s in streams]
        wide = eng._slo.snapshot()
    finally:
        eng.stop()
    differ = [i for i, (a, b) in enumerate(zip(tokens, fp32_tokens))
              if a != b]
    check(not differ and len(tokens) == len(fp32_tokens),
          f"lm_slo: fp32 tokens of prompts {differ} differ with a budget")
    check(wide["admitted"] == len(prompts) and wide["rejected"] == 0,
          f"lm_slo: the wide budget rejected {wide['rejected']}")

    cfg = TransformerConfig(**LM, dtype=torch.bfloat16)
    eng = ContinuousBatchingEngine(cfg, init_params(cfg, seed=0),
                                   max_streams=LM_SLOTS,
                                   steps_per_dispatch="auto",
                                   slo_budget_ms=SLO_BUDGET_MS).start()
    try:
        rej0 = _counter("nns_sched_rejected_total", pipeline=eng.obs_name)
        stats0 = dict(eng.stats)
        reset_launches()
        first = [eng.submit(p, max_new_tokens=LM_NEW) for p in prompts]
        out = [s.result(timeout=600) for s in first]
        torch.cuda.synchronize()
        flash = LAUNCHES.get("flash_attention", 0)
        b2_prefills = _b2_prefills(eng, stats0)
        est_ms = eng._slo.estimator.service_time_s() * 1e3
        raised, admitted = 0, []
        for p in prompts:
            try:
                admitted.append(eng.submit(p, max_new_tokens=LM_NEW))
            except SloRejected:
                raised += 1
        for s in admitted:
            check(len(s.result(timeout=600)) == LM_NEW,
                  "lm_slo: an admitted stream came back short")
        snap = eng._slo.snapshot()
        rejected = _counter("nns_sched_rejected_total",
                            pipeline=eng.obs_name) - rej0
    finally:
        eng.stop()
    check(all(len(t) == LM_NEW for t in out),
          "lm_slo: a first-burst stream came back short")
    check(b2_prefills == len(prompts) and flash == cfg.n_layers * b2_prefills,
          f"lm_slo: flash kernel {flash} for {b2_prefills} prefills")
    check(raised == rejected == snap["rejected"] and raised > 0,
          f"lm_slo: {raised} raised, {rejected} counted")
    check(snap["admitted"] == len(prompts) + len(admitted),
          f"lm_slo: {snap['admitted']} admitted")
    result = {
        "wide_budget_ms": LM_SLO_WIDE_MS, "fp32_tokens_identical": True,
        "prompts": len(prompts), "fp32_new_tokens": LM_PARITY_NEW,
        "budget_ms": SLO_BUDGET_MS, "first_burst_admitted": len(first),
        "service_estimate_ms": est_ms,
        "second_burst_rejected": raised,
        "second_burst_admitted": len(admitted),
        "nns_sched_rejected_total": rejected, "flash_launches": flash,
        "scheduler": snap, "gpu": power}
    emit({"phase": "lm_slo", **result})
    return result


def _timed_serve(engine, prompts, new_tokens: int, name: str) -> dict:
    """The warm-up prompts, then one measured ``_serve`` run: tokens/s and
    the run's TTFT and inter-token quantiles."""
    from nnstreamer_tpu_torch.obs.flight import LMTokenStats
    from nnstreamer_tpu_torch.serving import register_engine, unregister_engine

    _, warm = _lm_prompts()
    engine.start()
    register_engine(name, engine)
    try:
        for p in warm:
            engine.generate(p, max_new_tokens=engine.K, timeout=600)
        engine._lm_stats = LMTokenStats(engine.obs_name)
        got, wall = _serve(prompts, new_tokens, engine_name=name)
    finally:
        engine.stop()
        unregister_engine(name)
    total = _check_responses(got, len(prompts), new_tokens, name)
    return {"tokens": total, "wall_s": wall, "tokens_per_s": total / wall,
            **_token_quantiles(engine)}


def phase_lm_graph(power: str, bf16_engine, fp32_engine, fp32_tokens):
    """The engine's K-step dispatch as one CUDA graph against its eager
    body (the private ``_eager_dispatch``), in this call:

    - the captured engines of lm_serving (bf16, "auto") and lm_parity
      (fp32): one capture at the K that served, at most 2 in a life,
      replays = dispatches, the seconds each capture took;
    - fp32 (TF32 off), 12 prompts × 32 tokens: an eager engine's greedy
      tokens identical to lm_parity's captured ones;
    - bf16, 12 × 128 through tensor_lm_serve: tokens/s, TTFT and
      inter-token p50/p99, captured, eager, captured (reported);
    - one replayed decode step's device time against the fp32 upcast of
      the cache in ``_attend_cache`` (CUDA events)."""
    import torch

    from nnstreamer_tpu_torch.models.transformer import (
        TransformerConfig,
        init_params,
    )
    from nnstreamer_tpu_torch.ops._counts import LAUNCHES, reset_launches
    from nnstreamer_tpu_torch.serving import ContinuousBatchingEngine

    graphs = {"bf16": _check_graph(bf16_engine, "lm_graph bf16", 2),
              "fp32": _check_graph(fp32_engine, "lm_graph fp32")}
    prompts, _ = _lm_prompts()
    reset_launches()
    b2 = 0
    eager32 = _fp32_engine()
    eager32._eager_dispatch = True
    eager32.start()
    try:
        stats0 = dict(eager32.stats)
        streams = [eager32.submit(p, max_new_tokens=LM_PARITY_NEW)
                   for p in prompts]
        tokens = [s.result(timeout=600) for s in streams]
        b2 += _b2_prefills(eager32, stats0)
    finally:
        eager32.stop()
    check(eager32.graph_stats["captures"] == [],
          "lm_graph: the eager engine captured")
    differ = [i for i, (a, b) in enumerate(zip(tokens, fp32_tokens))
              if a != b]
    check(not differ and len(tokens) == len(fp32_tokens),
          f"lm_graph: fp32 tokens of prompts {differ} differ between the "
          "captured and the eager dispatch")

    cfg = TransformerConfig(**LM, dtype=torch.bfloat16)
    eager = ContinuousBatchingEngine(cfg, init_params(cfg, seed=0),
                                     max_streams=LM_SLOTS,
                                     steps_per_dispatch=bf16_engine.K)
    eager._eager_dispatch = True
    rates = {}
    for tag, eng in (("captured", bf16_engine), ("eager", eager),
                     ("captured_again", bf16_engine)):
        stats0 = dict(eng.stats)
        rates[tag] = _timed_serve(eng, prompts, LM_NEW, f"lmg_{tag}")
        b2 += _b2_prefills(eng, stats0)
    torch.cuda.synchronize()
    flash = LAUNCHES["flash_attention"]
    check(flash == cfg.n_layers * b2,
          f"lm_graph: flash kernel {flash} for {b2} bucketed prefills")
    graphs["bf16"] = _check_graph(bf16_engine, "lm_graph bf16", 2)

    # one decode step's device time, replayed, against the upcast of the
    # bf16 cache that _attend_cache makes in every layer (k and v to fp32)
    prog = bf16_engine._program
    with torch.inference_mode():
        step_ms = cuda_time_ms(prog.run, launches=20, repeats=5) / prog.K
        ck, cv = bf16_engine._cache.values[0]
        upcast_ms = cfg.n_layers * cuda_time_ms(
            lambda: (ck.float(), cv.float()), launches=50, repeats=5)
    bf16_engine._reload = True  # the timing runs moved the program's state
    result = {
        "graphs": graphs, "K": bf16_engine.K,
        "fp32_prompts": len(prompts), "fp32_new_tokens": LM_PARITY_NEW,
        "fp32_tokens_identical": True, "rates": rates,
        "captured_over_eager": rates["captured"]["tokens_per_s"] /
        rates["eager"]["tokens_per_s"],
        "flash_launches": flash, "b2_prefills": b2,
        "replayed_step_device_ms": step_ms,
        "attend_upcast_ms_per_step": upcast_ms,
        "attend_upcast_share_of_step": upcast_ms / step_ms,
        "attend_upcast_bound_ms_per_step": cfg.n_layers * 2 * ck.numel() *
        (2 + 4) / HBM_BYTES_PER_S * 1e3,
        "gpu": power}
    emit({"phase": "lm_graph", **result})
    return result, eager


def phase_lm_kv_int8(power: str, fp32_tokens) -> dict:
    """The int8 KV cache (``kv_quant="int8"``) at full width:

    - its bytes against the bf16 cache's: ≤ 0.5 + 4/dh + 0.05
      (tests/test_kv_int8.py:30-41);
    - a bf16 int8 engine serves the 12 × 128 run through tensor_lm_serve,
      every response full-length with finite logprobs ≤ 0, captured once;
    - in fp32 each prompt's first token equals the raw engine's
      (lm_parity's);
    - ``build_decode_step`` on the card, fp32, six steps: the int8 cache's
      logits within 0.08 × max|logit| of the raw cache's."""
    import torch

    from nnstreamer_tpu_torch.models.transformer import (
        TransformerConfig,
        build_decode_step,
        build_prefill,
        init_cache,
        init_params,
        prepare_params,
    )
    from nnstreamer_tpu_torch.ops._counts import LAUNCHES, reset_launches
    from nnstreamer_tpu_torch.serving import ContinuousBatchingEngine

    cfg = TransformerConfig(**LM, dtype=torch.bfloat16)
    raw = init_cache(cfg, LM_SLOTS, device="cuda:0")
    q8 = init_cache(cfg, LM_SLOTS, kv_codec="int8", device="cuda:0")
    ratio = q8.nbytes / raw.nbytes
    bound = 0.5 + 4 / cfg.head_dim + 0.05
    check(ratio <= bound and q8.dtype is torch.int8,
          f"lm_kv_int8: int8 cache {q8.nbytes} B, {ratio} of bf16's")
    sizes = {"bf16_bytes": raw.nbytes, "int8_bytes": q8.values.nbytes,
             "scale_bytes": q8.scale.nbytes}
    del raw, q8

    prompts, _ = _lm_prompts()
    eng = ContinuousBatchingEngine(cfg, init_params(cfg, seed=0),
                                   max_streams=LM_SLOTS,
                                   steps_per_dispatch=8, kv_quant="int8")
    reset_launches()
    stats0 = dict(eng.stats)
    served = _timed_serve(eng, prompts, LM_NEW, "lm_int8")
    torch.cuda.synchronize()
    flash = LAUNCHES["flash_attention"]
    b2 = _b2_prefills(eng, stats0)
    check(flash == cfg.n_layers * b2, f"lm_kv_int8: flash kernel {flash} "
                                      f"for {b2} bucketed prefills")
    graph = _check_graph(eng, "lm_kv_int8")

    eng32 = _fp32_engine(kv_quant="int8").start()
    try:
        streams = [eng32.submit(p, max_new_tokens=1) for p in prompts]
        firsts = [s.result(timeout=600) for s in streams]
    finally:
        eng32.stop()
    check([f[0] for f in firsts] == [t[0] for t in fp32_tokens],
          f"lm_kv_int8: fp32 first tokens {firsts} differ from the raw "
          "cache's")

    cfg32 = TransformerConfig(**LM, dtype=torch.float32)
    params = prepare_params(init_params(cfg32, seed=0), cfg32, "cuda:0")
    logits = {}
    with torch.inference_mode():
        for codec in (None, "int8"):
            _, cache = build_prefill(cfg32, kv_codec=codec)(
                params, torch.tensor([LM_KV_PROMPT], dtype=torch.int32,
                                     device="cuda:0"))
            step = build_decode_step(cfg32, kv_codec=codec)
            out, tok = [], LM_KV_STEPS[0]
            for i, nxt in enumerate(LM_KV_STEPS[1:] + [0]):
                lg, cache = step(params, torch.tensor(
                    [tok], dtype=torch.int32, device="cuda:0"), cache,
                    len(LM_KV_PROMPT) + i)
                out.append(lg)
                tok = nxt
            logits[codec] = torch.stack(out, 1)
    err = float((logits[None] - logits["int8"]).abs().max())
    ref = float(logits[None].abs().max())
    check(err < LM_KV_DRIFT_MAX * ref,
          f"lm_kv_int8: int8 logits {err} from the raw cache's "
          f"(max |logit| {ref})")
    result = {**sizes, "int8_over_bf16": ratio, "ratio_bound": bound,
              "served": served, "flash_launches": flash, "b2_prefills": b2,
              "graph": graph, "fp32_first_tokens_equal_raw": True,
              "decode_steps": len(LM_KV_STEPS),
              "step_drift_over_max_logit": err / ref,
              "drift_bound": LM_KV_DRIFT_MAX, "gpu": power}
    emit({"phase": "lm_kv_int8", **result})
    return result


def _preamble_prompts():
    """LM_PREAMBLE tokens from seed 1, each measured-run prompt after it."""
    import numpy as np

    preamble = np.random.default_rng(1).integers(
        1, LM["vocab"], LM_PREAMBLE).tolist()
    prompts, _ = _lm_prompts()
    return [preamble + p for p in prompts]


def phase_lm_prefix_chunk(power: str) -> dict:
    """The prefix cache and chunked prefill in fp32 (TF32 off): 12 prompts
    sharing a 200-token preamble, 32 tokens each, submitted at once. A
    cold engine; ``prefix_cache=4`` (11 or more hits); ``prefill_chunk=64``;
    both. Every engine's greedy tokens identical to the cold one's, and
    kernel B2 once a layer for each bucketed (cold, unchunked) prefill."""
    import torch

    from nnstreamer_tpu_torch.ops._counts import LAUNCHES, reset_launches

    prompts = _preamble_prompts()
    runs, tokens = {}, {}
    variants = (("cold", {}), ("prefix", {"prefix_cache": LM_PREFIX_ENTRIES}),
                ("chunked", {"prefill_chunk": LM_PREFILL_CHUNK}),
                ("prefix_chunked", {"prefix_cache": LM_PREFIX_ENTRIES,
                                    "prefill_chunk": LM_PREFILL_CHUNK}))
    flash_total = b2_total = 0
    for tag, kw in variants:
        eng = _fp32_engine(**kw)
        reset_launches()
        eng.start()
        try:
            t0 = time.monotonic()
            streams = [eng.submit(p, max_new_tokens=LM_PARITY_NEW)
                       for p in prompts]
            tokens[tag] = [s.result(timeout=600) for s in streams]
            wall = time.monotonic() - t0
        finally:
            eng.stop()
        torch.cuda.synchronize()
        flash = LAUNCHES["flash_attention"]
        b2 = _b2_prefills(eng, {"prefills": 0, "prefix_hits": 0})
        check(flash == LM["n_layers"] * b2,
              f"lm_prefix_chunk {tag}: flash kernel {flash} for {b2} "
              "bucketed prefills")
        flash_total += flash
        b2_total += b2
        runs[tag] = {"wall_s": wall, "flash_launches": flash,
                     "b2_prefills": b2, "graph": _check_graph(eng, tag),
                     **{k: eng.stats[k] for k in (
                         "prefills", "prefill_chunks", "prefix_hits",
                         "prefix_tokens_reused")},
                     **_token_quantiles(eng)}
        if tag != "cold":
            differ = [i for i, (a, b) in enumerate(zip(tokens[tag],
                                                        tokens["cold"]))
                      if a != b]
            check(not differ, f"lm_prefix_chunk {tag}: tokens of prompts "
                              f"{differ} differ from the cold engine's")
        if "prefix" in tag:
            check(eng.stats["prefix_hits"] >= len(prompts) - 1,
                  f"lm_prefix_chunk {tag}: {eng.stats['prefix_hits']} hits")
    check(all(len(t) == LM_PARITY_NEW for t in tokens["cold"]),
          "lm_prefix_chunk: a cold stream came back short")
    result = {"prompts": len(prompts), "preamble": LM_PREAMBLE,
              "new_tokens": LM_PARITY_NEW,
              "prefix_cache": LM_PREFIX_ENTRIES,
              "prefill_chunk": LM_PREFILL_CHUNK, "tokens_identical": True,
              "runs": runs, "flash_launches": flash_total,
              "b2_prefills": b2_total, "gpu": power}
    emit({"phase": "lm_prefix_chunk", **result})
    return result


def phase_lm_paged(power: str) -> dict:
    """The paged KV cache (``block_tokens``) as bench.py's ``lm`` report
    drives it (bench.py:1236-1300): bf16, 8 lanes, K = 8, block_tokens 16;
    32 streams of 8-47-token prompts (numpy seed 0) submitted at once, 64
    new tokens each, after three warm-up prompts; then the same load on
    the monolithic engine. Tokens/s, TTFT and inter-token p99,
    ``concurrent_streams_max``, ``kv_sheds`` and arena bytes a token slot
    for both. Checks: one capture (the paged K-step dispatch), replays =
    dispatches; B2 n_layers times a cold prefill; in fp32 the paged tokens
    of 12 × 32 equal the monolithic engine's, and with ``kv_quant="int8"``
    likewise; a starved pool (``kv_blocks=24``) sheds and every block
    returns."""
    import numpy as np
    import torch

    from nnstreamer_tpu_torch.models.transformer import (
        TransformerConfig,
        init_params,
    )
    from nnstreamer_tpu_torch.obs.flight import LMTokenStats
    from nnstreamer_tpu_torch.ops._counts import LAUNCHES, reset_launches
    from nnstreamer_tpu_torch.serving import ContinuousBatchingEngine

    cfg = TransformerConfig(**LM, dtype=torch.bfloat16)
    params = init_params(cfg, seed=0)
    reset_launches()
    b2 = 0
    runs, loads = {}, {}
    for tag, block in (("paged", LM_PAGED_BLOCK), ("monolithic", 0)):
        eng = ContinuousBatchingEngine(cfg, params, max_streams=LM_SLOTS,
                                       steps_per_dispatch=8,
                                       block_tokens=block).start()
        try:
            check(eng.paged == bool(block), f"lm_paged {tag}: paged "
                                            f"{eng.paged}")
            rng = np.random.default_rng(0)
            for warm in LM_WARM_LENS:  # every bucket, off the clock
                eng.generate(rng.integers(1, cfg.vocab, warm).tolist(),
                             max_new_tokens=eng.K, timeout=600)
            lens = rng.integers(8, 48, LM_PAGED_STREAMS)
            prompts = [rng.integers(1, cfg.vocab, n).tolist() for n in lens]
            eng._lm_stats = LMTokenStats(eng.obs_name)
            stats0 = dict(eng.stats)
            t0 = time.monotonic()
            streams = [eng.submit(p, max_new_tokens=LM_PAGED_NEW)
                       for p in prompts]
            toks = [s.result(timeout=600) for s in streams]
            wall = time.monotonic() - t0
            b2 += _b2_prefills(eng, {"prefills": 0, "prefix_hits": 0})
            total = sum(len(t) for t in toks)
            check(total == LM_PAGED_STREAMS * LM_PAGED_NEW and all(
                s.finish_reason == "length" for s in streams),
                f"lm_paged {tag}: {total} tokens")
            if eng.paged:
                pool = eng._pool
                per_slot = pool.nbytes / (pool.num_blocks
                                          * pool.block_tokens)
                arena = pool.nbytes
                check(pool.live_blocks() == 0,
                      f"lm_paged: {pool.live_blocks()} blocks live after "
                      "the run")
            else:
                arena = eng._cache.nbytes
                per_slot = arena / (eng.B * eng.S)
            q = _token_quantiles(eng)
            runs[tag] = {
                "tokens": total, "wall_s": wall,
                "tokens_per_s": total / wall,
                "ttft_p99_ms": q["ttft_p99_ms"],
                "intertoken_p99_ms": q["token_p99_ms"],
                "concurrent_streams_max": eng.stats["concurrent_streams_max"],
                "kv_sheds": eng.stats["kv_sheds"],
                "kv_defers": eng.stats["kv_defers"],
                "dispatches": eng.stats["dispatches"] - stats0["dispatches"],
                "kv_bytes": arena, "kv_bytes_per_token_slot": per_slot}
            loads[tag] = toks
        finally:
            eng.stop()
        # after stop(): the monolithic engine processes a block behind
        runs[tag]["graph"] = _check_graph(eng, f"lm_paged {tag}")
    check(runs["paged"]["concurrent_streams_max"] > LM_SLOTS,
          f"lm_paged: at most {runs['paged']['concurrent_streams_max']} "
          f"streams at once on {LM_SLOTS} lanes")
    bf16_same = [i for i, (a, b) in enumerate(zip(loads["paged"],
                                                   loads["monolithic"]))
                 if a != b]

    # fp32 (TF32 off since lm_parity): paged = monolithic, raw and int8
    prompts, _ = _lm_prompts()
    fp32 = {}
    for tag, kw in (("raw", {}), ("int8", {"kv_quant": "int8"})):
        for block in (LM_PAGED_BLOCK, 0):
            eng = _fp32_engine(block_tokens=block, **kw).start()
            try:
                streams = [eng.submit(p, max_new_tokens=LM_PARITY_NEW)
                           for p in prompts]
                fp32[tag, block] = [s.result(timeout=600) for s in streams]
                b2 += _b2_prefills(eng, {"prefills": 0, "prefix_hits": 0})
            finally:
                eng.stop()
            _check_graph(eng, f"lm_paged fp32 {tag}")
        differ = [i for i, (a, b) in enumerate(zip(
            fp32[tag, LM_PAGED_BLOCK], fp32[tag, 0])) if a != b]
        check(not differ and all(len(t) == LM_PARITY_NEW
                                 for t in fp32[tag, 0]),
              f"lm_paged fp32 {tag}: tokens of prompts {differ} differ "
              "between the paged and the monolithic cache")

    # a starved pool: 16 streams want up to 7 blocks each on 24 blocks
    eng = ContinuousBatchingEngine(cfg, params, max_streams=LM_SLOTS,
                                   steps_per_dispatch=8,
                                   block_tokens=LM_PAGED_BLOCK,
                                   kv_blocks=LM_STARVED_BLOCKS).start()
    try:
        rng = np.random.default_rng(2)
        streams = [eng.submit(rng.integers(1, cfg.vocab, n).tolist(),
                              max_new_tokens=LM_PAGED_NEW)
                   for n in rng.integers(8, 48, LM_PAGED_STREAMS // 2)]
        for s in streams:
            s.result(timeout=600)
        b2 += _b2_prefills(eng, {"prefills": 0, "prefix_hits": 0})
        reasons = [s.finish_reason for s in streams]
        starved = {"kv_blocks": LM_STARVED_BLOCKS,
                   "streams": len(streams),
                   "kv_sheds": eng.stats["kv_sheds"],
                   "kv_defers": eng.stats["kv_defers"],
                   "shed": reasons.count("shed"),
                   "length": reasons.count("length"),
                   "live_blocks_after": eng._pool.live_blocks()}
    finally:
        eng.stop()
    check(starved["kv_sheds"] > 0 and starved["live_blocks_after"] == 0 and
          starved["shed"] + starved["length"] == len(streams),
          f"lm_paged starved: {starved}")
    torch.cuda.synchronize()
    flash = LAUNCHES["flash_attention"]
    check(flash == cfg.n_layers * b2,
          f"lm_paged: flash kernel {flash} for {b2} bucketed prefills")
    result = {
        "config": {**LM, "dtype": "bfloat16", "lanes": LM_SLOTS, "K": 8,
                   "block_tokens": LM_PAGED_BLOCK,
                   "streams": LM_PAGED_STREAMS, "new_tokens": LM_PAGED_NEW},
        "runs": runs,
        "paged_over_monolithic": runs["paged"]["tokens_per_s"] /
        runs["monolithic"]["tokens_per_s"],
        # reported, not gated: identical by construction (PERF.md §6)
        "bf16_tokens_differ_streams": bf16_same,
        "fp32_tokens_identical": True, "int8_tokens_identical": True,
        "starved": starved, "flash_launches": flash, "b2_prefills": b2,
        "gpu": power}
    emit({"phase": "lm_paged", **result})
    return result


def _spec_target(dtype):
    """bench.py's spec target: the LM configuration at max_seq 1024,
    weights from seed 0 with ``proj`` and ``w_out`` damped by 0.3 (a
    low-entropy model, the regime speculation exists for)."""
    from nnstreamer_tpu_torch.models.transformer import (
        TransformerConfig,
        init_params,
    )

    cfg = TransformerConfig(**{**LM, "max_seq": LM_SPEC_MAX_SEQ},
                            dtype=dtype)
    params = init_params(cfg, seed=0)
    params = {**params, "proj": params["proj"] * LM_SPEC_DAMP,
              "w_out": params["w_out"] * LM_SPEC_DAMP}
    return cfg, params


def phase_lm_spec(power: str) -> dict:
    """Speculative decoding as bench.py's ``spec`` report drives it
    (bench.py:1192-1233): ``SpeculativeDecoder`` with a 2-layer draft
    sliced from the damped target, γ = 4, 4 rounds a dispatch, a 32-token
    prompt, 800 tokens, ``fused=True`` (one warm-up generation, then the
    timed one), against the plain greedy rate of the same target (a
    1-lane engine, K = 8, captured) in the same call. Tokens/s of both,
    ``mean_accepted``, rounds, dispatches, host reads. Checks: in fp32
    the decoder's 200 tokens equal the plain engine's; the engine with
    ``speculate=4`` in both cache modes gives the non-speculative engine's
    fp32 tokens (12 × 32) with drafts made and accepted, its round
    captured once; B2 n_layers times a target prefill (the draft's prefill
    is plain)."""
    import dataclasses

    import numpy as np
    import torch

    from nnstreamer_tpu_torch.models.speculative import (
        SpeculativeDecoder,
        draft_from_target,
    )
    from nnstreamer_tpu_torch.ops._counts import LAUNCHES, reset_launches
    from nnstreamer_tpu_torch.serving import ContinuousBatchingEngine

    prompt = np.random.default_rng(0).integers(1, LM["vocab"], 32).tolist()
    reset_launches()
    b2 = 0
    rates, tokens = {}, {}
    for dtype, new in ((torch.bfloat16, LM_SPEC_NEW),
                       (torch.float32, LM_SPEC_FP32_NEW)):
        tag = "bf16" if dtype is torch.bfloat16 else "fp32"
        cfg, params = _spec_target(dtype)
        dcfg, dparams = draft_from_target(cfg, params, LM_SPEC_DRAFT_LAYERS)
        dec = SpeculativeDecoder(cfg, params, dcfg, dparams,
                                 gamma=LM_SPEC_GAMMA)
        dec.generate(prompt, max_new_tokens=new, fused=True)  # warm-up
        dec.stats.update(rounds=0, tokens=0, dispatches=0, host_reads=0)
        t0 = time.monotonic()
        out = dec.generate(prompt, max_new_tokens=new, fused=True)
        torch.cuda.synchronize()
        dt = time.monotonic() - t0
        b2 += 2
        check(dec.graph_stats["captures"] == 1 and
              dec.graph_stats["replays"] >= dec.stats["host_reads"] > 0,
              f"lm_spec {tag}: decoder graph {dec.graph_stats}")
        plain = ContinuousBatchingEngine(cfg, params, max_streams=1,
                                         steps_per_dispatch=8).start()
        try:
            plain.generate(prompt, max_new_tokens=plain.K, timeout=600)
            t0 = time.monotonic()
            ref = plain.generate(prompt, max_new_tokens=new, timeout=600)
            pdt = time.monotonic() - t0
            b2 += plain.stats["prefills"]
        finally:
            plain.stop()
        _check_graph(plain, f"lm_spec plain {tag}")
        check(len(out) == len(ref) == new,
              f"lm_spec {tag}: {len(out)} and {len(ref)} tokens")
        tokens[tag] = (out, ref)
        rates[tag] = {
            "tokens": len(out), "spec_tokens_per_s": len(out) / dt,
            "plain_tokens_per_s": len(ref) / pdt,
            "spec_over_plain": pdt / dt,
            "mean_accepted": dec.mean_accepted,
            "rounds": dec.stats["rounds"],
            "dispatches": dec.stats["dispatches"],
            "host_reads": dec.stats["host_reads"],
            "shared_prefix_with_plain": _common_prefix(out, ref),
            "capture_s": dec.graph_stats["capture_s"]}
    check(tokens["fp32"][0] == tokens["fp32"][1],
          f"lm_spec: fp32 speculative tokens differ from greedy after "
          f"{rates['fp32']['shared_prefix_with_plain']}")

    # the engine's speculate=4, both cache modes, fp32 on the damped target
    # at the LM configuration's max_seq
    cfg, params = _spec_target(torch.float32)
    cfg = dataclasses.replace(cfg, max_seq=LM["max_seq"])
    prompts, _ = _lm_prompts()
    engines = {}
    for tag, kw in (("plain", {}),
                    ("spec", {"speculate": LM_SPEC_GAMMA,
                              "speculate_layers": LM_SPEC_DRAFT_LAYERS}),
                    ("spec_paged", {"speculate": LM_SPEC_GAMMA,
                                    "speculate_layers": LM_SPEC_DRAFT_LAYERS,
                                    "block_tokens": LM_PAGED_BLOCK})):
        eng = ContinuousBatchingEngine(cfg, params, max_streams=LM_SLOTS,
                                       steps_per_dispatch=8, **kw).start()
        try:
            streams = [eng.submit(p, max_new_tokens=LM_PARITY_NEW)
                       for p in prompts]
            tokens[tag] = [s.result(timeout=600) for s in streams]
        finally:
            eng.stop()
        # after stop(): the plain engine processes a block behind
        b2 += _b2_prefills(eng, {"prefills": 0, "prefix_hits": 0})
        engines[tag] = {k: eng.stats[k] for k in (
            "dispatches", "spec_drafted", "spec_accepted", "prefills")}
        engines[tag]["captures"] = list(eng.graph_stats["captures"])
        engines[tag]["replays"] = eng.graph_stats["replays"]
        if tag != "plain":
            differ = [i for i, (a, b) in enumerate(zip(tokens[tag],
                                                        tokens["plain"]))
                      if a != b]
            check(not differ, f"lm_spec {tag}: fp32 tokens of prompts "
                              f"{differ} differ from the plain engine's")
            e = engines[tag]
            check(e["spec_drafted"] > 0 and e["spec_accepted"] > 0,
                  f"lm_spec {tag}: {e}")
            check(e["captures"] == [LM_SPEC_GAMMA] and
                  e["replays"] == e["dispatches"] > 0,
                  f"lm_spec {tag}: round graph {e}")
    torch.cuda.synchronize()
    flash = LAUNCHES["flash_attention"]
    check(flash == LM["n_layers"] * b2,
          f"lm_spec: flash kernel {flash} for {b2} target prefills")
    result = {
        "config": {**LM, "max_seq": LM_SPEC_MAX_SEQ, "damp": LM_SPEC_DAMP,
                   "draft_layers": LM_SPEC_DRAFT_LAYERS,
                   "gamma": LM_SPEC_GAMMA, "prompt": len(prompt),
                   "new_tokens": LM_SPEC_NEW, "fused": True},
        "rates": rates, "fp32_tokens_identical": True,
        "engine": engines, "engine_fp32_tokens_identical": True,
        "flash_launches": flash, "b2_prefills": b2, "gpu": power}
    emit({"phase": "lm_spec", **result})
    return result


# -- phases: sampled decoding, the decode loop, beam search ----------------
def _sampled_serve(engine, prompts, new_tokens: int, name: str) -> dict:
    """Start ``engine``, run the warm-up prompts (every prompt bucket, off
    the clock; they take the first stream ids), then one measured
    ``_serve``: its tokens, rate, quantiles, B2 launches and graph
    counts. Stops the engine."""
    import numpy as np
    import torch

    from nnstreamer_tpu_torch.obs.flight import LMTokenStats
    from nnstreamer_tpu_torch.ops._counts import LAUNCHES, reset_launches
    from nnstreamer_tpu_torch.serving import register_engine, unregister_engine

    _, warm = _lm_prompts()
    engine.start()
    register_engine(name, engine)
    try:
        for p in warm:
            engine.generate(p, max_new_tokens=engine.K, timeout=600)
        engine._lm_stats = LMTokenStats(engine.obs_name)
        stats0 = dict(engine.stats)
        reset_launches()
        got, wall = _serve(prompts, new_tokens, engine_name=name)
        torch.cuda.synchronize()
        launches = LAUNCHES["flash_attention"]
    finally:
        engine.stop()
        unregister_engine(name)
    total = _check_responses(got, len(prompts), new_tokens, name)
    b2_prefills = _b2_prefills(engine, stats0)
    check(launches == LM["n_layers"] * b2_prefills,
          f"{name}: B2 launched {launches} times for {b2_prefills} cold "
          f"prefills of {LM['n_layers']} layers")
    return {"tokens": [np.asarray(b.tensors[0]).tolist() for b in got],
            "generated": total, "wall_s": wall,
            "tokens_per_s": total / wall, "flash_launches": launches,
            "b2_prefills": b2_prefills,
            "graph": _check_graph(engine, name), **_token_quantiles(engine)}


def sampler_on_the_card() -> dict:
    """The engine's sampler on one fixed 32000-wide logit row, drawn
    LM_CHI2_DRAWS times by one stream (counters 0..n-1) on the card: every
    draw inside the filtered set (the JAX sampler's formula, on the
    host), the counts against the exact filtered softmax by a
    chi-square, and the card's Philox words equal to
    ``ops/quantize.py``'s 16-bit-limb Philox on the same keys."""
    import numpy as np
    import torch
    from scipy import stats

    from nnstreamer_tpu_torch.models import transformer as ttr
    from nnstreamer_tpu_torch.ops.quantize import philox4x32_10

    V = LM["vocab"]
    temperature, top_k, min_p = (LM_SAMPLING["temperature"],
                                 LM_SAMPLING["top_k"], LM_SAMPLING["min_p"])
    row = np.random.default_rng(3).normal(0, 3, V).astype(np.float32)
    # the filter in fp32, as the JAX formula computes it; the softmax of
    # what it keeps in float64
    scaled = row / np.float32(temperature)
    support = scaled >= np.sort(scaled)[-top_k]
    support &= scaled >= scaled[support].max() + np.float32(np.log(min_p))
    scaled = np.where(support, scaled.astype(np.float64), -np.inf)
    probs = np.exp(scaled - scaled.max())
    probs /= probs.sum()
    sample = ttr.make_sampler(V, temperature, top_k, min_p)
    logits = torch.from_numpy(row).to("cuda:0")
    toks = []
    with torch.inference_mode():
        for c0 in range(0, LM_CHI2_DRAWS, LM_CHI2_CHUNK):
            n = min(LM_CHI2_CHUNK, LM_CHI2_DRAWS - c0)
            keys = ttr.sampling_keys(LM_SAMPLING["seed"], [0] * n,
                                     np.arange(c0, c0 + n), "cuda:0")
            t, _ = sample(logits.expand(n, V), keys)
            toks.append(t.cpu().numpy())
        keys = ttr.sampling_keys(LM_SAMPLING["seed"], [0] * LM_CHI2_CHUNK,
                                 np.arange(LM_CHI2_CHUNK), "cuda:0")
        u = ttr.philox_uniforms(keys).cpu()
        ctr = torch.arange(LM_CHI2_CHUNK, dtype=torch.int64, device="cuda:0")
        zero = torch.zeros_like(ctr)
        words = philox4x32_10((ctr, zero, zero, zero),
                              (LM_SAMPLING["seed"], 0))[0].cpu()
    check(torch.equal(u, words >> 8),
          "the sampler's Philox differs from ops/quantize.py's on the card")
    toks = np.concatenate(toks)
    outside = int((~support[toks]).sum())
    check(outside == 0, f"sampler: {outside} draws outside the filtered set")
    counts = np.bincount(toks, minlength=V).astype(np.float64)
    expected = probs * LM_CHI2_DRAWS
    big = expected >= 5
    obs = np.append(counts[big], counts[~big].sum())
    exp = np.append(expected[big], expected[~big].sum())
    if exp[-1] == 0:
        obs, exp = obs[:-1], exp[:-1]
    p = float(stats.chisquare(obs, exp).pvalue)
    check(p >= LM_CHI2_P_MIN, f"sampler chi-square p = {p} < "
                              f"{LM_CHI2_P_MIN}")
    return {"draws": LM_CHI2_DRAWS, "support": int(support.sum()),
            "distinct_drawn": int((counts > 0).sum()), "chi2_p": p,
            "chi2_bins": int(obs.size), "philox_equal": True,
            **sampler_step_times()}


def graph_replay_ms(fn) -> float:
    """Device time of ``fn``'s kernels back to back: ``fn`` captured once
    as a CUDA graph (after a warm-up run on the capture stream), its
    replays timed by ``cuda_time_ms`` — a decode step's view of them,
    without the eager launches."""
    import torch

    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        fn()
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        fn()
    return cuda_time_ms(graph.replay)


def sampler_step_times() -> dict:
    """What sampling adds to a decode step of the LM configuration (8
    lanes, K = 8), each as a captured graph's replay: the sampled draw
    with logprobs (the filter, softmax, int64 CDF, searchsorted) and the
    greedy one (argmax, logprobs) on [8, 32000] fp32 logits, and a
    dispatch's Philox call ([8, 8] counters)."""
    import numpy as np
    import torch

    from nnstreamer_tpu_torch.models import transformer as ttr

    V = LM["vocab"]
    sampling = {k: LM_SAMPLING[k] for k in ("temperature", "top_k", "min_p")}
    logits = torch.from_numpy(np.random.default_rng(4).normal(
        0, 3, (LM_SLOTS, V)).astype(np.float32)).to("cuda:0")
    keys = ttr.sampling_keys(LM_SAMPLING["seed"], range(LM_SLOTS),
                             np.arange(LM_SLOTS), "cuda:0")
    ctr = keys[:, 1:] + torch.arange(8, device="cuda:0")
    dispatch_keys = torch.stack([keys[:, :1].expand_as(ctr), ctr], dim=-1)
    u = ttr.philox_uniforms(keys)
    sampled = ttr.make_sampler(V, **sampling, with_logprobs=True)
    greedy = ttr.make_sampler(V, 0.0, with_logprobs=True)
    with torch.inference_mode():
        return {
            "sampled_draw_graph_ms": graph_replay_ms(
                lambda: sampled.draw(logits, u)),
            "greedy_draw_graph_ms": graph_replay_ms(
                lambda: greedy.draw(logits, None)),
            "philox_dispatch_graph_ms": graph_replay_ms(
                lambda: ttr.philox_uniforms(dispatch_keys)),
        }


def phase_lm_sampled(power: str, K: int = 8) -> dict:
    """Sampled decoding (ROADMAP A.13.5) through ``tensor_lm_serve`` on the
    LM configuration, bf16, 8 slots, 12 prompts × 128 tokens, at the K
    that lm_serving chose: greedy, sampled (``LM_SAMPLING``), sampled,
    greedy, each a fresh engine (stream ids from 0). Checks: one capture
    and replays = dispatches each; B2 once a layer of each cold prefill;
    the two sampled runs token-identical. Then fp32 with TF32 off, 12 × 32:
    a stream served alone = co-batched, monolithic = paged
    (``block_tokens=16``), in process = behind the query pair; and the
    sampler on a fixed 32000-wide row (``sampler_on_the_card``)."""
    import numpy as np
    import torch

    import nnstreamer_tpu_torch as nt
    from nnstreamer_tpu_torch.models.transformer import (
        TransformerConfig,
        init_params,
    )
    from nnstreamer_tpu_torch.serving import (
        ContinuousBatchingEngine,
        register_engine,
        unregister_engine,
    )

    nt.set_device(None)
    prompts, _ = _lm_prompts()
    cfg = TransformerConfig(**LM, dtype=torch.bfloat16)
    params = init_params(cfg, seed=0)
    sampling = dict(LM_SAMPLING)
    runs = {}
    for i, name in enumerate(("greedy", "sampled", "sampled2", "greedy2")):
        kw = sampling if name.startswith("sampled") else {}
        eng = ContinuousBatchingEngine(cfg, params, max_streams=LM_SLOTS,
                                       steps_per_dispatch=K, **kw)
        runs[name] = _sampled_serve(eng, prompts, LM_NEW,
                                    f"lm_sampled_{i}")
    check(runs["sampled"]["tokens"] == runs["sampled2"]["tokens"],
          "lm_sampled: two runs of the sampled engine differ")
    check(runs["greedy"]["tokens"] == runs["greedy2"]["tokens"],
          "lm_sampled: two runs of the greedy engine differ")
    check(runs["sampled"]["tokens"] != runs["greedy"]["tokens"],
          "lm_sampled: the sampled engine emitted the greedy tokens")

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    fcfg = TransformerConfig(**LM, dtype=torch.float32)
    fparams = init_params(fcfg, seed=0)

    def fp32(**kw):
        return ContinuousBatchingEngine(fcfg, fparams, max_streams=LM_SLOTS,
                                        steps_per_dispatch=8, **sampling,
                                        **kw)

    parity = {}
    for mode, kw in (("monolithic", {}),
                     ("paged", {"block_tokens": LM_PAGED_BLOCK})):
        eng = fp32(**kw).start()
        register_engine("lm_sampled_fp32", eng)
        try:
            got, _ = _serve(prompts, LM_PARITY_NEW, "lm_sampled_fp32")
        finally:
            eng.stop()
            unregister_engine("lm_sampled_fp32")
        parity[mode] = [np.asarray(b.tensors[0]).tolist() for b in got]
        check(eng.paged == (mode == "paged"), f"lm_sampled: {mode} engine")
    eng = fp32().start()
    try:
        alone = eng.generate(prompts[0], max_new_tokens=LM_PARITY_NEW,
                             timeout=600)
    finally:
        eng.stop()
    eng = fp32().start()
    register_engine("lm_sampled_q", eng)
    try:
        got, _ = _serve_over_query("lm_sampled_q", prompts, LM_PARITY_NEW,
                                   clients=1)
        over_query = [np.asarray(b.tensors[0]).tolist() for b in got[0]]
    finally:
        eng.stop()
        unregister_engine("lm_sampled_q")
    mono = parity["monolithic"]
    check(parity["paged"] == mono, "lm_sampled: fp32 paged tokens differ "
                                   "from the monolithic engine's")
    check(alone == mono[0],
          "lm_sampled: a stream alone differs from it co-batched")
    check(over_query == mono, "lm_sampled: fp32 tokens over the query pair "
                              "differ from in process")
    sampler = sampler_on_the_card()

    def rates(r):
        return {k: v for k, v in r.items() if k != "tokens"}

    result = {
        "config": {**LM, "dtype": "bfloat16", "slots": LM_SLOTS, "K": K,
                   "new_tokens": LM_NEW, "prompts": len(prompts),
                   **sampling},
        "greedy": rates(runs["greedy"]), "sampled": rates(runs["sampled"]),
        "sampled2": rates(runs["sampled2"]),
        "greedy2": rates(runs["greedy2"]),
        "sampled_over_greedy_tokens_per_s": [
            runs[s]["tokens_per_s"] / runs[g]["tokens_per_s"]
            for s, g in (("sampled", "greedy"), ("sampled2", "greedy2"))],
        "flash_launches": runs["sampled"]["flash_launches"] +
        runs["sampled2"]["flash_launches"],
        "two_runs_identical": True,
        "fp32": {"new_tokens": LM_PARITY_NEW, "paged_equal": True,
                 "alone_equal_co_batched": True, "query_equal": True},
        "sampler": sampler, "gpu": power,
    }
    emit({"phase": "lm_sampled", **result})
    return result


def decode_desc(num, model="lm_decode_bench", slot="lm_bench"):
    """bench.py's ``measure_decode`` string (bench.py:1030-1036)."""
    return (f"tensor_reposrc slot={slot} num-buffers={num} timeout=120 ! "
            f"tensor_filter framework=jax model={model} name=filter "
            "input-combination=i0,i1,i2 ! "
            f"tee name=t  t. ! tensor_reposink slot={slot}  "
            "t. ! tensor_sink name=sink to-host=false")


def phase_lm_decode(power: str) -> dict:
    """bench.py's ``decode`` (``measure_decode``, bench.py:999-1050) at its
    sizes: the LM configuration at max_seq 1024, bf16, K = 16 decode steps
    an invoke through ``TransformerStreamStep`` (one CUDA graph), a 2-buffer
    warm run, then 50 invokes (800 tokens) whose final slot state is
    fetched in the timed window; steps/s is bench.py's steady rate.
    Checks: one capture over both runs; no device→host copy while the loop
    runs; the tokens equal ``build_greedy_stream_step`` run eagerly on
    the card with the prepared params; in fp32 with TF32 off, a loop's
    tokens equal a chain of ``build_decode_step`` calls with argmax (the
    matmul weights scaled, so that the chain's tokens vary)."""
    import numpy as np
    import torch

    import nnstreamer_tpu_torch as nt
    from nnstreamer_tpu_torch.elements.repo import GLOBAL_REPO
    from nnstreamer_tpu_torch.filters.torch_backend import (
        register_torch_model,
        unregister_torch_model,
    )
    from nnstreamer_tpu_torch.models.transformer import (
        MATMUL_WEIGHTS,
        TransformerConfig,
        build_decode_step,
        build_greedy_stream_step,
        greedy_stream_model,
        init_cache,
        init_params,
        prepare_params,
    )
    from nnstreamer_tpu_torch.pipeline.pipeline import Pipeline
    from nnstreamer_tpu_torch.tensors.buffer import (
        TensorBuffer,
        transfer_snapshot,
    )

    nt.set_device(None)
    K, n = LM_DECODE_STEPS, LM_DECODE_TOKENS // LM_DECODE_STEPS

    def seed(cfg, slot="lm_bench"):
        GLOBAL_REPO.set(slot, TensorBuffer(
            [np.asarray([1], np.int32),
             init_cache(cfg, 1, device="cuda:0").values,
             np.asarray(0, np.int32)], pts=0))

    def loop(cfg, model, num, name, slot="lm_bench"):
        """Seed the slot, run ``num`` invokes; (arrivals, eos fetched,
        tokens, final state, transfers in the loop)."""
        register_torch_model("lm_decode_bench", model)
        try:
            seed(cfg, slot)
            pipe = nt.parse_launch(decode_desc(num, slot=slot),
                                   pipeline=Pipeline(name=name))
            x0 = transfer_snapshot()
            arrivals, _, _, _ = _collect_arrivals(pipe)
            x1 = transfer_snapshot()
            final = GLOBAL_REPO.get(slot)
            check(final is not None, f"{name}: the slot is empty")
            np.asarray(final.tensors[0].cpu())  # the chain ran: in window
            fetched = time.monotonic()
            toks = [t for b in pipe.get("sink").buffers
                    for t in b.tensors[3].cpu().tolist()]
            GLOBAL_REPO.remove(slot)
        finally:
            unregister_torch_model("lm_decode_bench")
        return arrivals, fetched, toks, final, {
            k: x1[k] - x0[k] for k in ("d2h_events", "h2d_events")}

    cfg = TransformerConfig(**{**LM, "max_seq": LM_DECODE_MAX_SEQ},
                            dtype=torch.bfloat16)
    params = init_params(cfg, seed=0)
    model = greedy_stream_model(cfg, params, steps=K)
    loop(cfg, model, 2, "lm_decode_warm")
    arrivals, fetched, toks, final, moved = loop(cfg, model, n, "lm_decode")
    check(len(arrivals) == n, f"lm_decode: {len(arrivals)} of {n} invokes")
    check(len(toks) == n * K, f"lm_decode: {len(toks)} tokens")
    check(model.graph_stats["captures"] == 1,
          f"lm_decode: {model.graph_stats['captures']} captures")
    check(moved["d2h_events"] == 0,
          f"lm_decode: {moved['d2h_events']} device→host copies in the loop")
    check(final.tensors[1].device.type == "cuda" and
          tuple(final.tensors[1].shape) == (LM["n_layers"], 2, 1,
                                             LM_DECODE_MAX_SEQ,
                                             LM["n_heads"],
                                             LM["d_model"] // LM["n_heads"]),
          "lm_decode: the final cache is not the card's [L, 2, 1, S, h, dh]")
    check(int(final.tensors[2]) == n * K, "lm_decode: final position")
    step = build_greedy_stream_step(cfg, steps=K)
    p = prepare_params(params, cfg, "cuda:0")
    state = (torch.tensor([1], dtype=torch.int32, device="cuda:0"),
             init_cache(cfg, 1, device="cuda:0").values,
             torch.tensor(0, dtype=torch.int32, device="cuda:0"))
    want = []
    with torch.inference_mode():
        for _ in range(n):
            out = step(p, *state)
            want.extend(out[3].cpu().tolist())
            state = out[:3]
    check(toks == want, "lm_decode: the loop's tokens differ from the "
                        "step function's eager steps on the card")

    torch.backends.cuda.matmul.allow_tf32 = False
    fcfg = TransformerConfig(**{**LM, "max_seq": LM_DECODE_MAX_SEQ},
                             dtype=torch.float32)
    # the matmul weights scaled, so that the greedy chain does not repeat
    # its input token as the seed-0 weights' chain does
    fparams = {k: v * LM_DECODE_FP32_SCALE if k in MATMUL_WEIGHTS else v
               for k, v in init_params(fcfg, seed=0).items()}
    fmodel = greedy_stream_model(fcfg, fparams, steps=K)
    _, _, ftoks, _, _ = loop(fcfg, fmodel, LM_DECODE_FP32_INVOKES,
                             "lm_decode_fp32", "lm_fp32")
    decode = build_decode_step(fcfg)
    p = prepare_params(fparams, fcfg, "cuda:0")
    cache = init_cache(fcfg, 1, device="cuda:0")
    tok = torch.tensor([1], dtype=torch.int32, device="cuda:0")
    chain = []
    with torch.inference_mode():
        for pos in range(LM_DECODE_FP32_INVOKES * K):
            logits, cache = decode(p, tok, cache, pos)
            tok = torch.argmax(logits, -1).to(torch.int32)
            chain.append(int(tok[0]))
    check(ftoks == chain, "lm_decode: fp32 loop tokens differ from a chain "
                          "of build_decode_step calls")
    check(len(set(chain)) > 1, "lm_decode: the fp32 chain repeats one token")
    result = {
        "config": {**LM, "max_seq": LM_DECODE_MAX_SEQ, "dtype": "bfloat16",
                   "steps_per_invoke": K, "invokes": n},
        "steps_per_s": steady_fps(arrivals, fetched, frames_per_buffer=K),
        "wall_s": fetched - arrivals[0], "tokens": len(toks),
        "distinct_tokens": len(set(toks)),
        "captures": model.graph_stats["captures"],
        "replays": model.graph_stats["replays"],
        "d2h_events_in_loop": moved["d2h_events"],
        "h2d_events_in_loop": moved["h2d_events"],
        "cache_bytes": final.tensors[1].numel() *
        final.tensors[1].element_size(),
        "eager_equal": True, "fp32_chain_equal": True,
        "fp32_tokens": len(chain), "fp32_distinct_tokens": len(set(chain)),
        "gpu": power,
    }
    emit({"phase": "lm_decode", **result})
    return result


def phase_beam(power: str) -> dict:
    """Beam search (ROADMAP A.13.8) on the LM configuration in fp32 (TF32
    off), W = 4, max_new = 32, on the card: every beam's score equals its
    teacher-forced rescoring (a plain full forward) within 1e-3; W = 1
    equals greedy decoding (prefill + decode steps, argmax); the beams are
    distinct, best first; a search's time is reported (median of 3 after
    one warm-up)."""
    import numpy as np
    import torch

    import nnstreamer_tpu_torch as nt
    from nnstreamer_tpu_torch.models import BeamSearcher
    from nnstreamer_tpu_torch.models.transformer import (
        TransformerConfig,
        build_decode_step,
        build_forward,
        build_prefill,
        init_params,
        prepare_params,
    )

    nt.set_device(None)
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = TransformerConfig(**LM, dtype=torch.float32)
    params = init_params(cfg, seed=0)
    prompts, _ = _lm_prompts()
    prompt = prompts[0]
    bs = BeamSearcher(cfg, params, beam_width=LM_BEAM_WIDTH,
                      max_new=LM_BEAM_NEW)
    times = []
    for _ in range(4):
        torch.cuda.synchronize()
        t0 = time.monotonic()
        seqs, scores = bs.search(prompt)
        times.append(time.monotonic() - t0)
    check(seqs.shape == (LM_BEAM_WIDTH, LM_BEAM_NEW) and
          bool(np.isfinite(scores).all()), "beam: shapes or scores")
    check(list(scores) == sorted(scores, reverse=True),
          "beam: not best first")
    check(len({tuple(s) for s in seqs.tolist()}) == LM_BEAM_WIDTH,
          "beam: two beams are the same hypothesis")
    p = prepare_params(params, cfg, "cuda:0")
    fwd = build_forward(cfg)
    errs = []
    with torch.inference_mode():
        for seq, score in zip(seqs.tolist(), scores):
            toks = torch.tensor([prompt + seq], dtype=torch.int32,
                                device="cuda:0")
            logp = torch.log_softmax(fwd(p, toks)[0].float(), dim=-1)
            n = len(prompt)
            want = float(sum(logp[n + j - 1, seq[j]]
                             for j in range(len(seq))))
            errs.append(abs(float(score) - want))
    check(max(errs) <= LM_BEAM_RESCORE_TOL,
          f"beam: score vs rescoring {max(errs)} > {LM_BEAM_RESCORE_TOL}")
    one, _ = BeamSearcher(cfg, params, beam_width=1,
                          max_new=LM_BEAM_NEW).search(prompt)
    prefill, decode = build_prefill(cfg), build_decode_step(cfg)
    greedy = []
    with torch.inference_mode():
        logits, cache = prefill(p, torch.tensor([prompt], dtype=torch.int32,
                                                device="cuda:0"))
        tok = torch.argmax(logits, -1).to(torch.int32)
        greedy.append(int(tok[0]))
        for j in range(LM_BEAM_NEW - 1):
            logits, cache = decode(p, tok, cache, len(prompt) + j)
            tok = torch.argmax(logits, -1).to(torch.int32)
            greedy.append(int(tok[0]))
    check(one[0].tolist() == greedy, "beam: W = 1 differs from greedy")
    result = {"config": {**LM, "dtype": "float32", "beam_width": LM_BEAM_WIDTH,
                         "max_new": LM_BEAM_NEW, "prompt_len": len(prompt)},
              "search_s_median": statistics.median(times[1:]),
              "search_s": times, "scores": [float(s) for s in scores],
              "rescore_err_max": max(errs),
              "rescore_tol": LM_BEAM_RESCORE_TOL, "width1_is_greedy": True,
              "distinct": True, "gpu": power}
    emit({"phase": "beam", **result})
    return result


def phase_cli(power: str) -> dict:
    """``python3 -m nnstreamer_tpu_torch.cli --slo-budget-ms 50
    --metrics-port 0 "<the batch-8 string, 160 frames>"``: the model is a
    pickled MobileNetV2 (seed 0, bf16) in a ``.pt`` file. It exits 0 and
    reports the CUDA device."""
    import torch

    from nnstreamer_tpu_torch.models.mobilenet_v2 import mobilenet_v2

    module, _, _ = mobilenet_v2(num_classes=CLASSES, image_size=IMAGE,
                                dtype=torch.bfloat16, seed=0)
    tmp = tempfile.mkdtemp(prefix="nns_smoke_cli_")
    model = os.path.join(tmp, "mnv2.pt")
    torch.save(module, model)
    labels = os.path.join(tmp, "labels.txt")
    with open(labels, "w") as f:
        f.write("\n".join(f"class_{i}" for i in range(CLASSES)) + "\n")
    desc = uncut_desc(BUDGET_FRAMES, model, labels, pattern="ball",
                      leaky=False)
    t0 = time.monotonic()
    proc = subprocess.run(
        [sys.executable, "-m", "nnstreamer_tpu_torch.cli", "--slo-budget-ms",
         str(SLO_BUDGET_MS), "--metrics-port", "0", desc],
        cwd=HERE, capture_output=True, text=True, timeout=300)
    wall = time.monotonic() - t0
    kind = torch.cuda.get_device_name(0)
    check(proc.returncode == 0,
          f"cli: rc {proc.returncode}: {proc.stderr[-2000:]}")
    check(f"Device: cuda:0 {kind}" in proc.stdout,
          f"cli: no CUDA device line in {proc.stdout[:500]!r}")
    check("Got EOS from pipeline." in proc.stdout and
          "-- slo scheduler: budget" in proc.stdout and
          "Serving metrics on http://0.0.0.0:" in proc.stdout,
          f"cli: output {proc.stdout[-1500:]!r}")
    lines = [ln for ln in proc.stdout.splitlines()
             if ln.startswith(("Device:", "-- slo scheduler",
                               "-- flight recorder"))]
    result = {"rc": proc.returncode, "wall_s": wall, "lines": lines,
              "frames": BUDGET_FRAMES, "gpu": power}
    emit({"phase": "cli", **result})
    return result


# -- the detection, pose, recurrence and segmentation paths (ROADMAP A.17) --
def _collect_arrivals(pipe, sink="sink"):
    """Run ``pipe`` to EOS as bench.py's ``_collect`` does: sink arrival
    times, and the EOS instant after a device fence. Returns (arrivals,
    the run's start, eos, B1 launches of the run)."""
    import gc

    import torch

    from nnstreamer_tpu_torch.ops import preprocess as pp

    arrivals = []
    pipe.get(sink).connect(lambda b: arrivals.append(time.monotonic()))
    gc.collect()
    gc.disable()
    pp.reset_launches()
    t0 = time.monotonic()
    try:
        msg = pipe.run(timeout=900)
    finally:
        gc.enable()
    torch.cuda.synchronize()
    eos = time.monotonic()
    check(msg is not None and msg.kind == "eos",
          f"{pipe.name}: no EOS ({msg})")
    return arrivals, t0, eos, pp.LAUNCHES.get("normalize_chain", 0)


def steady_fps(arrivals, eos, frames_per_buffer: int = 1):
    """bench.py's ``_steady_fps``: frames after the first arrival over
    first arrival → EOS."""
    span = eos - arrivals[0] if arrivals else 0.0
    return (len(arrivals) - 1) * frames_per_buffer / span if span > 0 \
        else None


def _region_of(pipe, members):
    (region,) = pipe._regions
    got = [m.ELEMENT_NAME for m in region.members]
    check(got == members, f"{pipe.name}: region members {got}")
    check(not region._dead, f"{pipe.name}: the region fell back")
    return region


def _sink_rows(pipe, sink="sink"):
    """(row tensor bytes, meta) of every buffer the sink kept."""
    import numpy as np

    return [(np.asarray(b[0]).tobytes(), b.meta)
            for b in pipe.get(sink).buffers]


def ssd_desc(n, model, pattern="gradient", size=SSD_IMAGE, decoder=None):
    """bench.py's ``measure_ssd`` string (its ``yolo`` variant names
    another model and decoder mode)."""
    decoder = decoder or \
        f"option1=mobilenet-ssd option4={size}:{size} option7=meta"
    return (f"videotestsrc num-buffers={n} width={size} height={size} "
            f"pattern={pattern} ! tensor_converter ! "
            "queue max-size-buffers=8 ! "
            "tensor_transform mode=arithmetic "
            "option=typecast:float32,add:-127.5,div:127.5 ! "
            f"tensor_filter framework=jax model={model} name=filter ! "
            f"tensor_decoder mode=bounding_boxes {decoder} ! "
            "queue max-size-buffers=64 materialize-host=true ! "
            "tensor_sink name=sink to-host=true")


def _dets_match(a, b, tol: float) -> bool:
    """Two detection lists are the same set, floats within ``tol``."""
    def key(d):
        return (d["class"], d["box"])

    if len(a) != len(b):
        return False
    for x, y in zip(sorted(a, key=key), sorted(b, key=key)):
        if x["class"] != y["class"] or abs(x["score"] - y["score"]) > tol \
                or max(abs(p - q) for p, q in zip(x["box"], y["box"])) > tol:
            return False
    return True


def _run_rows(desc, name, fuse: bool):
    """The sink rows of ``desc``, fused (the default) or not."""
    import nnstreamer_tpu_torch as nt
    from nnstreamer_tpu_torch.pipeline.pipeline import Pipeline

    pipe = nt.parse_launch(desc, pipeline=Pipeline(fuse=fuse, name=name))
    msg = pipe.run(timeout=900)
    check(msg is not None and msg.kind == "eos", f"{name}: no EOS ({msg})")
    return _sink_rows(pipe)


def _fused_unfused_rows(desc, name):
    """The sink rows of ``desc`` fused and unfused."""
    return (_run_rows(desc, f"{name}_fused", True),
            _run_rows(desc, f"{name}_unfused", False))


def _ball_frames(n, size):
    """``videotestsrc pattern=ball`` frames as host arrays."""
    import nnstreamer_tpu_torch as nt

    pipe = nt.parse_launch(
        f"videotestsrc num-buffers={n} width={size} height={size} "
        "pattern=ball ! tensor_converter ! tensor_sink name=sink")
    pipe.run(timeout=300)
    return [b[0] for b in pipe.get("sink").buffers]


def phase_ssd(power: str) -> dict:
    """bench.py's ``ssd`` string at its sizes: SSD-MobileNet 300×300, 91
    classes, bf16, batch 1, 800 gradient frames through the fused region
    tensor_transform (B1) ! tensor_filter ! tensor_decoder bounding_boxes
    (device NMS in the graph). Checks: every frame delivered with
    detections and a [≤100, 6] row tensor, B1 once a frame, one capture;
    64 ball frames fused and unfused bit-identical; the device half on
    the card against the same function on the CPU for the fetched model
    outputs of 8 frames."""
    import numpy as np
    import torch

    import nnstreamer_tpu_torch as nt
    from nnstreamer_tpu_torch.decoders.bounding_boxes import (
        DEVICE_K_TOTAL,
        BoundingBoxes,
    )
    from nnstreamer_tpu_torch.filters.torch_backend import (
        register_torch_model,
        unregister_torch_model,
    )
    from nnstreamer_tpu_torch.models.ssd_mobilenet import ssd_mobilenet
    from nnstreamer_tpu_torch.pipeline.pipeline import Pipeline
    from nnstreamer_tpu_torch.tensors.buffer import TensorBuffer

    nt.set_device(None)
    module, _, _ = ssd_mobilenet(num_classes=SSD_CLASSES,
                                 image_size=SSD_IMAGE,
                                 dtype=torch.bfloat16, seed=0)
    # stays registered for profile_restarted, which unregisters it
    register_torch_model("ssd", module)
    try:
        pipe = nt.parse_launch(ssd_desc(SSD_FRAMES, "ssd"),
                               pipeline=Pipeline(name="ssd"))
        arrivals, t0, eos, launches = _collect_arrivals(pipe)
        region = _region_of(pipe, ["tensor_transform", "tensor_filter",
                                   "tensor_decoder"])
        rows = [b[0] for b in pipe.get("sink").buffers]
        metas = [b.meta for b in pipe.get("sink").buffers]
        p50, p99 = pipe.get("sink").latency_percentiles(50.0, 99.0)
        fused, unfused = _fused_unfused_rows(
            ssd_desc(SSD_PARITY_FRAMES, "ssd", "ball"), "ssd_parity")
        # the device half on the card and on the CPU, on the same fetched
        # model outputs of 8 ball frames
        outs = []
        with torch.inference_mode():
            for f in _ball_frames(SSD_NMS_FRAMES, SSD_IMAGE):
                x = (torch.from_numpy(np.asarray(f)).cuda().float() - 127.5) \
                    / 127.5
                outs.append([t.cpu() for t in module(x)])
    except BaseException:
        unregister_torch_model("ssd")
        raise
    check(len(rows) == SSD_FRAMES, f"ssd: {len(rows)} of {SSD_FRAMES} "
                                   "frames reached the sink")
    check(all("detections" in m for m in metas), "ssd: a frame without "
                                                 "detections meta")
    check(all(r.ndim == 2 and r.shape[1] == 6 and
              r.shape[0] <= DEVICE_K_TOTAL for r in rows),
          "ssd: a row tensor is not [<=100, 6]")
    check(all(len(m["detections"]) == r.shape[0]
              for m, r in zip(metas, rows)), "ssd: rows != detections")
    check(launches == SSD_FRAMES, f"ssd: B1 launched {launches} times for "
                                  f"{SSD_FRAMES} frames")
    check(region.captures == 1 and region.eager_frames == 1 and
          region.replays == SSD_FRAMES - 1,
          f"ssd: {region.captures} captures, {region.eager_frames} eager, "
          f"{region.replays} replays")
    differ = [i for i, (a, b) in enumerate(zip(fused, unfused))
              if a[0] != b[0]]
    check(len(fused) == len(unfused) == SSD_PARITY_FRAMES and not differ,
          f"ssd: fused rows of frames {differ[:10]} differ from unfused")
    dec = BoundingBoxes()
    options = {"option1": "mobilenet-ssd",
               "option4": f"{SSD_IMAGE}:{SSD_IMAGE}", "option7": "meta"}
    consts, fn = dec.device_kernel(options)
    nms_equal, max_err = 0, 0.0
    for boxes, scores in outs:
        (cpu,) = fn(consts, [boxes, scores])
        (card,) = fn(consts, [boxes.cuda(), scores.cuda()])
        card = card.cpu()
        a = dec.host_finalize(TensorBuffer([cpu.numpy()]), None, options)
        b = dec.host_finalize(TensorBuffer([card.numpy()]), None, options)
        if _dets_match(a.meta["detections"], b.meta["detections"], 1e-5):
            nms_equal += 1
        max_err = max(max_err, float((cpu - card).abs().max()))
    check(nms_equal == SSD_NMS_FRAMES,
          f"ssd: the device NMS on the card gave another detection set "
          f"than on the CPU in {SSD_NMS_FRAMES - nms_equal} of "
          f"{SSD_NMS_FRAMES} frames")
    saturated = sum(len(m["detections"]) >= DEVICE_K_TOTAL for m in metas)
    result = {"frames": SSD_FRAMES, "delivered": len(rows),
              "fps": steady_fps(arrivals, eos), "wall_s": eos - arrivals[0],
              # the first frame: its eager run, the capture, cold cuDNN
              "first_frame_s": arrivals[0] - t0,
              "latency_p50_ms": p50, "latency_p99_ms": p99,
              "saturated_frames": saturated,
              "detections_mean": float(np.mean([len(m["detections"])
                                                for m in metas])),
              "launches": launches, "captures": region.captures,
              "replays": region.replays,
              "fused_unfused_bit_identical": SSD_PARITY_FRAMES - len(differ),
              "nms_card_vs_cpu_equal_frames": nms_equal,
              "nms_card_vs_cpu_max_abs_err": max_err, "gpu": power}
    emit({"phase": "ssd", **result})
    return result, pipe


def phase_yolo(power: str) -> dict:
    """bench.py's ``ssd`` string with YOLO at 320×320, 80 classes (the
    JAX factory's float32) and ``bounding_boxes option1=yolov5
    option3=0.26 option7=meta``: 16 ball frames fused and unfused,
    bit-identical."""
    import nnstreamer_tpu_torch as nt
    from nnstreamer_tpu_torch.filters.torch_backend import (
        register_torch_model,
        unregister_torch_model,
    )
    from nnstreamer_tpu_torch.models.yolo import yolo_detector
    from nnstreamer_tpu_torch.pipeline.pipeline import Pipeline

    nt.set_device(None)
    module, _, _ = yolo_detector(num_classes=YOLO_CLASSES,
                                 image_size=YOLO_IMAGE, seed=0)
    register_torch_model("yolo", module)
    # random weights put every class × objectness score near 0.26 (both
    # logits near 0): option3 at that level keeps about half the anchors,
    # so the NMS selects boxes
    desc = ssd_desc(YOLO_FRAMES, "yolo", "ball", YOLO_IMAGE,
                    f"option1=yolov5 option3={YOLO_THRESHOLD} option7=meta")
    try:
        pipe = nt.parse_launch(desc, pipeline=Pipeline(name="yolo"))
        arrivals, _, eos, launches = _collect_arrivals(pipe)
        region = _region_of(pipe, ["tensor_transform", "tensor_filter",
                                   "tensor_decoder"])
        fused = _sink_rows(pipe)
        unfused = _run_rows(desc, "yolo_unfused", False)
    finally:
        unregister_torch_model("yolo")
    differ = [i for i, (a, b) in enumerate(zip(fused, unfused))
              if a[0] != b[0]]
    check(len(fused) == len(unfused) == YOLO_FRAMES and not differ,
          f"yolo: fused rows of frames {differ[:10]} differ from unfused")
    check(launches == YOLO_FRAMES and region.captures == 1,
          f"yolo: B1 {launches} for {YOLO_FRAMES} frames, "
          f"{region.captures} captures")
    result = {"frames": YOLO_FRAMES, "launches": launches,
              "captures": region.captures,
              "fused_unfused_bit_identical": YOLO_FRAMES - len(differ),
              "detections_mean": sum(len(m["detections"])
                                     for _, m in fused) / len(fused),
              "fps_16_frames": steady_fps(arrivals, eos), "gpu": power}
    emit({"phase": "yolo", **result})
    return result


def _batched4(net):
    """bench.py's ``batched4`` as an ``nn.Module``: four uint8 frames
    concatenated along the batch and normalized inside the model."""
    import torch

    class Batched4(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.net = net

        def forward(self, a, b, c, d):
            x = torch.cat([a, b, c, d], dim=0).float()
            return self.net((x - 127.5) / 127.5)

    return Batched4()


def pose4_desc(n, live=""):
    """bench.py's ``measure_pose_mux`` string."""
    srcs = " ".join(
        f"videotestsrc num-buffers={n} width={POSE_IMAGE} "
        f"height={POSE_IMAGE} pattern=gradient {live}! tensor_converter ! "
        "mux. " for _ in range(4))
    return ("tensor_mux name=mux sync-mode=slowest ! "
            "tensor_filter framework=jax model=pose4 name=filter ! "
            "tensor_decoder mode=pose_estimation option2=meta ! "
            "queue max-size-buffers=64 materialize-host=true ! "
            "tensor_sink name=sink to-host=true " + srcs)


def phase_pose4(power: str) -> dict:
    """bench.py's ``pose4``: 4 videotestsrc 257×257 → tensor_mux
    sync-mode=slowest → PoseNet at batch 4, bf16 (normalized inside the
    model) → pose_estimation option2=meta; 200 frames a source, then a
    live run at 15/1 a source, 120 frames, scored on its second half.
    Checks: 800 frames decoded, each buffer [4, 17, 3]; fused and unfused
    bit-identical on 16 sets (with other patterns on the four sources)."""
    import numpy as np
    import torch

    import nnstreamer_tpu_torch as nt
    from nnstreamer_tpu_torch.filters.torch_backend import (
        register_torch_model,
        unregister_torch_model,
    )
    from nnstreamer_tpu_torch.models.posenet import posenet
    from nnstreamer_tpu_torch.pipeline.pipeline import Pipeline

    nt.set_device(None)
    net, _, _ = posenet(image_size=POSE_IMAGE, batch=4,
                        dtype=torch.bfloat16, seed=0)
    # stays registered for profile_restarted, which unregisters it
    register_torch_model("pose4", _batched4(net))
    try:
        pipe = nt.parse_launch(pose4_desc(POSE_FRAMES),
                               pipeline=Pipeline(name="pose4"))
        arrivals, t0, eos, _ = _collect_arrivals(pipe)
        region = _region_of(pipe, ["tensor_filter", "tensor_decoder"])
        bufs = list(pipe.get("sink").buffers)
        sat = pipe.get("sink").latency_percentiles(50.0, 99.0)
        parity = pose4_desc(POSE_PARITY_SETS).replace(
            "pattern=gradient", "pattern=ball", 2)
        fused, unfused = _fused_unfused_rows(parity, "pose4_parity")
        live = nt.parse_launch(
            pose4_desc(POSE_LIVE_FRAMES,
                       f"is-live=true framerate={POSE_LIVE_RATE} "),
            pipeline=Pipeline(name="pose4_live"))
        live_arrivals, _, live_eos, _ = _collect_arrivals(live)
        lat = live.get("sink").latency_percentiles(
            50.0, 99.0, skip=POSE_LIVE_FRAMES // 2 * 4)
    except BaseException:
        unregister_torch_model("pose4")
        raise
    frames = 4 * len(bufs)
    check(frames == 4 * POSE_FRAMES, f"pose4: {frames} of {4 * POSE_FRAMES}"
                                     " frames decoded")
    check(all(tuple(np.asarray(b[0]).shape) == (4, 17, 3) and
              len(b.meta["keypoints"]) == 4 for b in bufs),
          "pose4: an output is not [4, 17, 3] with 4 keypoint lists")
    check(region.captures == 1, f"pose4: {region.captures} captures")
    differ = [i for i, (a, b) in enumerate(zip(fused, unfused))
              if a[0] != b[0]]
    check(len(fused) == len(unfused) == POSE_PARITY_SETS and not differ,
          f"pose4: fused keypoints of sets {differ[:10]} differ")
    result = {"frames": frames, "sets": len(bufs),
              "fps": steady_fps(arrivals, eos, frames_per_buffer=4),
              "first_set_s": arrivals[0] - t0,
              "latency_sat_p50_ms": sat[0], "latency_sat_p99_ms": sat[1],
              "latency_p50_ms": lat[0], "latency_p99_ms": lat[1],
              "live_rate_per_source": POSE_LIVE_RATE,
              "live_sets": len(live_arrivals),
              "live_fps": steady_fps(live_arrivals, live_eos,
                                     frames_per_buffer=4),
              "captures": region.captures, "replays": region.replays,
              "fused_unfused_bit_identical": POSE_PARITY_SETS - len(differ),
              "gpu": power}
    emit({"phase": "pose4", **result})
    return result, pipe


def _lstm_step(cell):
    """bench.py's ``step`` as an ``nn.Module``: the state [2·hidden] is
    [h, c] and the cell feeds itself (x = h)."""
    import torch

    class LSTMStep(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.cell = cell

        def forward(self, state):
            hidden = self.cell.hidden
            s = state.reshape(1, 2 * hidden).float()
            h, c = s[:, :hidden], s[:, hidden:]
            _, h2, c2 = self.cell(h, h, c)
            return torch.cat([h2, c2], dim=1).reshape(2 * hidden)

    return LSTMStep()


def lstm_desc(num, slot="lstm", extra=""):
    """bench.py's ``measure_lstm`` string; ``extra`` goes before the
    filter."""
    return (f"tensor_reposrc slot={slot} num-buffers={num} "
            f"initial-dim={2 * LSTM_HIDDEN} initial-type=float32 "
            "initial-value=0.01 timeout=30 ! " + extra +
            "tensor_filter framework=jax model=lstm name=filter ! "
            f"tee name=t  t. ! tensor_reposink slot={slot}  "
            "t. ! tensor_sink name=sink to-host=false")


def phase_lstm(power: str) -> dict:
    """bench.py's ``lstm``: hidden 128, fp32, tensor_reposrc !
    tensor_filter ! tee ! tensor_reposink plus a device sink; a 2-step
    warm run, then 800 steps. Checks: the final slot state bit-identical
    to 800 eager calls of the module on the card and within 1e-5 of an
    fp32 CPU loop (TF32 off); no region forms (a lone filter between a
    source and a tee), so no capture; no device→host copy while the loop
    runs. A second loop with a typecast transform before the filter makes
    transform ! filter a fused region: it captures once, takes the host
    first frame and the slot's tensors after it as one signature, and its
    state equals the eager steps'."""
    import torch

    import nnstreamer_tpu_torch as nt
    from nnstreamer_tpu_torch.elements.repo import GLOBAL_REPO
    from nnstreamer_tpu_torch.filters.torch_backend import (
        register_torch_model,
        unregister_torch_model,
    )
    from nnstreamer_tpu_torch.models.lstm import lstm_cell
    from nnstreamer_tpu_torch.pipeline.pipeline import Pipeline
    from nnstreamer_tpu_torch.tensors.buffer import transfer_snapshot

    nt.set_device(None)
    torch.backends.cuda.matmul.allow_tf32 = False
    cell, _, _ = lstm_cell(input_dim=LSTM_HIDDEN, hidden=LSTM_HIDDEN,
                           batch=1, seed=0)
    step = _lstm_step(cell)
    register_torch_model("lstm", step)

    def eager(n, device):
        state = torch.full((2 * LSTM_HIDDEN,), 0.01, device=device)
        with torch.inference_mode():
            for _ in range(n):
                state = step(state)
        return state

    try:
        GLOBAL_REPO.remove("lstm")
        nt.parse_launch(lstm_desc(2)).run(timeout=300)
        GLOBAL_REPO.get("lstm", consume=True)
        pipe = nt.parse_launch(lstm_desc(LSTM_STEPS),
                               pipeline=Pipeline(name="lstm"))
        x0 = transfer_snapshot()
        arrivals, _, eos, _ = _collect_arrivals(pipe)
        x1 = transfer_snapshot()
        final = GLOBAL_REPO.get("lstm")
        check(final is not None, "lstm: the slot is empty after the run")
        state = final.tensors[0]
        state_host = state.cpu()  # the final state, fetched in the window
        eos_fetched = time.monotonic()
        GLOBAL_REPO.remove("lstm")
        region_pipe = nt.parse_launch(
            lstm_desc(LSTM_REGION_STEPS, "lstm_region",
                      "tensor_transform mode=typecast option=float32 ! "),
            pipeline=Pipeline(name="lstm_region"))
        msg = region_pipe.run(timeout=300)
        check(msg is not None and msg.kind == "eos", "lstm_region: no EOS")
        region_state = GLOBAL_REPO.get("lstm_region").tensors[0]
        GLOBAL_REPO.remove("lstm_region")
        want = eager(LSTM_STEPS, "cuda")
        want_region = eager(LSTM_REGION_STEPS, "cuda")
        step.cpu()
        cpu = eager(LSTM_STEPS, "cpu")
    finally:
        unregister_torch_model("lstm")
    check(len(arrivals) == LSTM_STEPS, f"lstm: {len(arrivals)} of "
                                       f"{LSTM_STEPS} steps reached the sink")
    check(state.device.type == "cuda", f"lstm: the slot state is on "
                                       f"{state.device}")
    captures = sum(r.captures for r in pipe._regions or ())
    check(captures <= 1, f"lstm: {captures} captures")
    d2h = x1["d2h_events"] - x0["d2h_events"]
    check(d2h == 0, f"lstm: {d2h} device→host copies during the loop")
    check(torch.equal(state, want), "lstm: the loop state differs from "
                                    "800 eager steps on the card")
    err = float((state_host - cpu).abs().max())
    check(err <= LSTM_CPU_ATOL, f"lstm: |card - fp32 CPU| = {err}")
    # the recurrence contracts: after 800 steps |state| is far below the
    # atol, so the error relative to the state's size is reported too
    scale = float(cpu.abs().max())
    rel = err / scale if scale > 0 else None
    (region,) = region_pipe._regions
    check(region.captures == 1 and region.eager_frames == 1 and
          region.replays == LSTM_REGION_STEPS - 1,
          f"lstm_region: {region.captures} captures, "
          f"{region.eager_frames} eager, {region.replays} replays")
    check(torch.equal(region_state, want_region),
          "lstm_region: the fused loop's state differs from eager steps")
    result = {"steps": LSTM_STEPS, "hidden": LSTM_HIDDEN,
              "steps_per_s": steady_fps(arrivals, eos_fetched),
              "wall_s": eos - arrivals[0], "captures": captures,
              "d2h_events_in_loop": d2h,
              "h2d_events_in_loop": x1["h2d_events"] - x0["h2d_events"],
              "bit_identical_to_eager": True, "max_abs_err_vs_cpu": err,
              "max_abs_state": scale, "rel_err_vs_cpu": rel,
              "region_loop": {"steps": LSTM_REGION_STEPS,
                              "captures": region.captures,
                              "replays": region.replays,
                              "bit_identical_to_eager": True},
              "gpu": power}
    emit({"phase": "lstm", **result})
    return result


def seg_desc(n):
    return (f"videotestsrc num-buffers={n} width={SEG_IMAGE} "
            f"height={SEG_IMAGE} pattern=ball ! tensor_converter ! "
            "tensor_transform mode=arithmetic "
            "option=typecast:float32,add:-127.5,div:127.5 ! "
            "tensor_filter framework=jax model=seg name=filter ! "
            "tensor_decoder mode=image_segment ! "
            "queue max-size-buffers=64 materialize-host=true ! "
            "tensor_sink name=sink to-host=true")


def phase_segment(power: str) -> dict:
    """videotestsrc 256×256 ball → B1 → the segmenter (21 classes, base
    32, bf16) → image_segment: 32 frames fused and unfused with
    ``segment_labels`` bit-identical, then a 240-frame fused run timed; B1
    once a frame in both fused runs."""
    import numpy as np
    import torch

    import nnstreamer_tpu_torch as nt
    from nnstreamer_tpu_torch.filters.torch_backend import (
        register_torch_model,
        unregister_torch_model,
    )
    from nnstreamer_tpu_torch.models.segmenter import segmenter
    from nnstreamer_tpu_torch.ops import preprocess as pp
    from nnstreamer_tpu_torch.pipeline.pipeline import Pipeline

    nt.set_device(None)
    module, _, _ = segmenter(num_classes=SEG_CLASSES, base=SEG_BASE,
                             image_size=SEG_IMAGE, dtype=torch.bfloat16,
                             seed=0)
    # stays registered for profile_restarted, which unregisters it
    register_torch_model("seg", module)
    labels = {}
    try:
        for fuse in (True, False):
            pipe = nt.parse_launch(seg_desc(SEG_PARITY_FRAMES),
                                   pipeline=Pipeline(fuse=fuse))
            pp.reset_launches()
            msg = pipe.run(timeout=600)
            check(msg is not None and msg.kind == "eos", "segment: no EOS")
            labels[fuse] = [b.meta["segment_labels"]
                            for b in pipe.get("sink").buffers]
            if fuse:
                parity_launches = pp.LAUNCHES.get("normalize_chain", 0)
        pipe = nt.parse_launch(seg_desc(SEG_FRAMES),
                               pipeline=Pipeline(name="segment"))
        arrivals, t0, eos, launches = _collect_arrivals(pipe)
        region = _region_of(pipe, ["tensor_transform", "tensor_filter",
                                   "tensor_decoder"])
        shapes = {np.asarray(b[0]).shape for b in pipe.get("sink").buffers}
    except BaseException:
        unregister_torch_model("seg")
        raise
    differ = [i for i, (a, b) in enumerate(zip(labels[True], labels[False]))
              if not np.array_equal(a, b)]
    check(len(labels[True]) == len(labels[False]) == SEG_PARITY_FRAMES and
          not differ, f"segment: labels of frames {differ[:10]} differ")
    check(parity_launches == SEG_PARITY_FRAMES and launches == SEG_FRAMES,
          f"segment: B1 {parity_launches} and {launches} for "
          f"{SEG_PARITY_FRAMES} and {SEG_FRAMES} frames")
    check(len(arrivals) == SEG_FRAMES and
          shapes == {(SEG_IMAGE, SEG_IMAGE, 4)},
          f"segment: {len(arrivals)} frames, shapes {shapes}")
    check(region.captures == 1, f"segment: {region.captures} captures")
    classes = int(max(int(np.max(x)) for x in labels[True])) + 1
    result = {"frames": SEG_FRAMES, "fps": steady_fps(arrivals, eos),
              "first_frame_s": arrivals[0] - t0,
              "launches": launches, "captures": region.captures,
              "fused_unfused_bit_identical": SEG_PARITY_FRAMES - len(differ),
              "classes_seen_max": classes, "gpu": power}
    emit({"phase": "segment", **result})
    return result, pipe


def profile_restarted(name: str, pipe, model: str, frames_per_source: int,
                      fps: float, power: str, units: int = 0) -> None:
    """Restart a measured pipeline (its region keeps its graph, A.8b) with
    ``frames_per_source`` buffers from each source under ``torch.profiler``:
    the device's busy time a frame (``units`` sink buffers, else one a
    source buffer) and the kernels that take it, and the idle share at the
    timed run's ``fps``. Emits ``<name>_profile`` and unregisters
    ``model``."""
    from nnstreamer_tpu_torch.filters.torch_backend import (
        unregister_torch_model,
    )

    sources = [el for el in pipe.elements
               if el.ELEMENT_NAME in ("videotestsrc", "audiotestsrc")]
    for el in sources:
        # audiotestsrc does not rewind on a restart, as in the JAX
        # package: it plays on from its last chunk
        done = el.i if el.ELEMENT_NAME == "audiotestsrc" else 0
        el.set_property("num_buffers", done + frames_per_source)
    pipe.get("sink").buffers.clear()
    (region,) = pipe._regions
    captures = region.captures
    frames = units or frames_per_source * len(sources)
    try:
        out = profile_pipeline(pipe, frames)
    finally:
        unregister_torch_model(model)
    check(region.captures == captures, f"{name}: the restart captured")
    if units:
        check(len(pipe.get("sink").buffers) == units,
              f"{name}: the restart delivered "
              f"{len(pipe.get('sink').buffers)} of {units}")
    if out["device_kernels_per_frame"] > 0:
        out["device_idle_share_at_timed_rate"] = \
            1.0 - out["device_busy_ms_per_frame"] * fps / 1e3
    else:  # the trace lost the device's events: nothing was measured
        out.update(device_busy_ms_per_frame=None, device_idle_share=None)
    emit({"phase": f"{name}_profile", **out, "gpu": power})


def device_profile(prof, wall_us: float, units: int, unit: str) -> dict:
    """From a ``torch.profiler`` trace of a run of ``wall_us``: the device's
    busy time (union of its intervals) per unit of work, its idle share,
    and the kernels that take the most device time."""
    import torch

    by_name = {}
    spans = []
    for ev in prof.events():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = ev.time_range.elapsed_us()
        by_name[ev.name] = by_name.get(ev.name, 0.0) + us
        spans.append((ev.time_range.start, ev.time_range.end))
    # launches from the host: the runtime calls that put work on the card
    # (a kernel, a copy, a graph), by name
    host = {}
    for ev in prof.events():
        if ev.device_type != torch.autograd.DeviceType.CUDA and \
                ev.name in HOST_LAUNCH_CALLS:
            host[ev.name] = host.get(ev.name, 0) + 1
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
        f"device_busy_ms_per_{unit}": busy_us / units / 1e3,
        "device_idle_share": 1.0 - busy_us / wall_us,
        f"device_kernels_per_{unit}": len(spans) / units,
        f"host_launches_per_{unit}": sum(host.values()) / units,
        f"host_launches_per_{unit}_by_call": {
            name: n / units for name, n in sorted(host.items())},
        f"top_device_ms_per_{unit}": {
            name[:80]: us / units / 1e3 for name, us in top},
    }


def profile_pipeline(pipe, frames: int = PROFILED_FRAMES) -> dict:
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
    out = {"frames": frames,
           **device_profile(prof, wall_us, frames, "frame")}
    # a fused run: the host's launch calls from its first graph replay on,
    # per replay (one a frame) — the first frame and the capture left out
    calls = sorted((ev.time_range.start, ev.name) for ev in prof.events()
                   if ev.device_type != torch.autograd.DeviceType.CUDA
                   and ev.name in HOST_LAUNCH_CALLS)
    graphs = [t for t, name in calls if name == "cudaGraphLaunch"]
    if graphs:
        out["host_launches_per_replayed_frame"] = sum(
            1 for t, _ in calls if t >= graphs[0]) / len(graphs)
    return out

# -- device memory and serving continuity (ROADMAP A.19, A.20) ----------------
def _labels_file(tag: str) -> str:
    tmp = tempfile.mkdtemp(prefix=f"nns_smoke_{tag}_")
    path = os.path.join(tmp, "labels.txt")
    with open(path, "w") as f:
        f.write("\n".join(f"class_{i}" for i in range(CLASSES)) + "\n")
    return path


def _mem_desc(n, labels, models, staging=""):
    """The batch-8 flagship string; two models behind a ``tee`` (one
    fused region a branch, both run by the staging queue's thread).
    ``staging`` adds properties to the staging queue."""
    src = (f"videotestsrc num-buffers={n} width={IMAGE} height={IMAGE} "
           "pattern=gradient ! tensor_converter ! queue max-size-buffers=16 "
           "! tensor_aggregator frames-in=1 frames-out=8 frames-flush=8 "
           "frames-dim=3 concat=true ! queue max-size-buffers=8 "
           f"prefetch-device=true {staging}! ")

    def branch(i, model):
        return ("tensor_transform mode=arithmetic "
                "option=typecast:float32,add:-127.5,div:127.5 ! "
                f"tensor_filter framework=jax model={model} name=f{i} ! "
                f"tensor_decoder mode=image_labeling option1={labels} "
                "option2=batched ! queue max-size-buffers=64 "
                f"materialize-host=true ! tensor_sink name=out{i} to-host=true")

    if len(models) == 1:
        return src + branch(0, models[0])
    return src + "tee name=t " + " ".join(
        f"t. ! {branch(i, m)}" for i, m in enumerate(models))


def _mem_run(desc, name, n_out, policy=None, env=None):
    """One run with ``env`` set around it; the labelled frames of each
    sink, the regions' counts, the B1 launches, the accountant's snapshot
    (None without one) and the pipeline."""
    import torch

    import nnstreamer_tpu_torch as nt
    from nnstreamer_tpu_torch.ops import preprocess as pp
    from nnstreamer_tpu_torch.pipeline import faults
    from nnstreamer_tpu_torch.pipeline.pipeline import Pipeline
    from nnstreamer_tpu_torch.tensors import memory

    old = {k: os.environ.get(k) for k in (env or {})}
    os.environ.update(env or {})
    try:
        pipe = nt.parse_launch(desc, pipeline=Pipeline(
            name=name, error_policy=policy))
        metas = {i: [] for i in range(n_out)}
        for i in metas:
            pipe.get(f"out{i}").connect(
                lambda buf, i=i: metas[i].append(buf.meta))
        pp.reset_launches()
        t0 = time.monotonic()
        msg = pipe.run(timeout=900)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        check(msg is not None and msg.kind == "eos", f"{name}: {msg}")
        acct = memory.ACTIVE
        snap = acct.snapshot() if acct is not None else None
        fi = faults.ACTIVE
        fired = fi.injected("filter.invoke") if fi is not None else 0
    finally:
        memory.deactivate()
        faults.deactivate()
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    regions = pipe.metrics_snapshot().get("regions", {})
    return {"frames": {i: labelled_frames(m) for i, m in metas.items()},
            "launches": pp.LAUNCHES["normalize_chain"], "memory": snap,
            "regions": {k: {f: r.get(f) for f in ("captures", "replays",
                                                  "eager_frames", "rebinds",
                                                  "unspliced")}
                        for k, r in regions.items()},
            "wall_s": wall, "fired": fired, "pipe": pipe}


def phase_memory(power: str) -> dict:
    """The HBM accountant on the batch-8 flagship (ROADMAP A.19). Two
    MobileNetV2 filters (bf16, 1001 classes, seeds 1 and 2) behind a tee
    run under ``NNSTPU_HBM_BUDGET`` at 3/4 of their summed weights: each
    window evicts the other model and loads its own into new storage, so
    each region drops its graph and captures again (the price of
    time-sharing). Labels, indices and f32 scores are bit-identical to the
    same string with no budget; evictions > 0; B1 once a window a region.
    Then ``NNSTPU_FAULTS=filter.invoke:nth=9,kind=oom`` under ``degrade``
    on one model: it recovers at the ``evict`` rung, loses no frame, puts
    no element on the CPU. Reported beside the accountant's figures: the
    allocator's, and the reserved bytes a live graph's private pool keeps
    through ``torch.cuda.empty_cache()``."""
    import torch

    import nnstreamer_tpu_torch as nt
    from nnstreamer_tpu_torch.filters.torch_backend import (
        register_torch_model,
        unregister_torch_model,
    )
    from nnstreamer_tpu_torch.models.mobilenet_v2 import mobilenet_v2
    from nnstreamer_tpu_torch.obs import get_registry
    from nnstreamer_tpu_torch.tensors import memory

    nt.set_device(None)
    names = ("mem_a", "mem_b")
    weights = {}
    for seed, name in enumerate(names, start=1):
        module, _, _ = mobilenet_v2(num_classes=CLASSES, image_size=IMAGE,
                                    dtype=torch.bfloat16, seed=seed)
        register_torch_model(name, module)
        weights[name] = memory.nbytes_of(module)
    labels = _labels_file("mem")
    budget = int(MEM_BUDGET_SHARE * sum(weights.values()))
    windows = MEM_FRAMES // BATCH

    def rung(r):
        m = get_registry().get("nns_mem_pressure_events_total", rung=r)
        return 0 if m is None else int(m.value)

    try:
        two = _mem_desc(MEM_FRAMES, labels, names)
        base = _mem_run(two, "mem_base", 2)
        shared = _mem_run(two, "mem_budget", 2,
                          env={"NNSTPU_HBM_BUDGET": str(budget)})
        # the graphs of the last windows are live: their private pool
        # keeps its blocks through empty_cache until the regions drop them
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        reserved_with_graphs = torch.cuda.memory_reserved()
        for r in shared["pipe"]._regions or ():
            r.invalidate()
        torch.cuda.empty_cache()
        reserved_without = torch.cuda.memory_reserved()
        # one window a hand-off: a failed drained list would re-chain its
        # failing window once before any policy (as in the JAX package),
        # and a transient fault would never reach the ladder
        one = _mem_desc(MEM_OOM_FRAMES, labels, names[:1], "drain-batch=1 ")
        oom_base = _mem_run(one, "mem_oom_base", 1)
        before = {r: rung(r) for r in memory.PRESSURE_RUNGS}
        oom = _mem_run(one, "mem_oom", 1, policy="degrade", env={
            "NNSTPU_HBM_BUDGET": str(4 * sum(weights.values())),
            "NNSTPU_FAULTS": MEM_OOM_FAULT})
        rungs = {r: rung(r) - before[r] for r in memory.PRESSURE_RUNGS}
        accel = oom["pipe"].get("f0").get_property("accelerator")
    finally:
        for name in names:
            unregister_torch_model(name)
    snap = shared["memory"]
    for i in range(2):
        check(len(base["frames"][i]) == MEM_FRAMES and
              shared["frames"][i] == base["frames"][i],
              f"memory: branch {i} under the budget differs from the "
              "unbudgeted run")
    check(snap is not None and snap["budget_bytes"] == budget,
          f"memory: the accountant did not take NNSTPU_HBM_BUDGET={budget}")
    check(snap["evictions"] > 0 and snap["prefetches"] > 0,
          f"memory: no time-sharing ({snap['evictions']} evictions)")
    captures = sum(r["captures"] for r in shared["regions"].values())
    rebinds = sum(r["rebinds"] for r in shared["regions"].values())
    check(len(shared["regions"]) == 2 and not any(
        r["unspliced"] for r in shared["regions"].values()),
        f"memory: regions {shared['regions']}")
    check(shared["launches"] == 2 * windows,
          f"memory: B1 {shared['launches']} for {windows} windows in two "
          "regions")
    check(oom["fired"] == 1, f"memory: the OOM fault fired {oom['fired']}")
    check(oom["frames"][0] == oom_base["frames"][0] and
          len(oom["frames"][0]) == MEM_OOM_FRAMES,
          f"memory: the OOM run delivered {len(oom['frames'][0])} of "
          f"{MEM_OOM_FRAMES} frames, or other labels")
    check(rungs == {"evict": 1, "pool": 0, "shed": 0} and not accel,
          f"memory: the ladder took {rungs}, accelerator {accel!r}")
    result = {
        "weights_bytes": weights, "budget_bytes": budget,
        "frames": MEM_FRAMES, "windows": windows,
        "evictions": snap["evictions"], "prefetches": snap["prefetches"],
        "pressure_events": snap["pressure_events"],
        "high_water_bytes": snap["high_water_bytes"],
        "allocator": snap.get("allocator"),
        "captures": captures, "rebinds": rebinds,
        "captures_unbudgeted": sum(r["captures"]
                                   for r in base["regions"].values()),
        "b1_launches": shared["launches"],
        "wall_s": shared["wall_s"], "wall_s_unbudgeted": base["wall_s"],
        "labels_bit_identical": True,
        "graph_pool_reserved_bytes": reserved_with_graphs - reserved_without,
        "reserved_bytes_with_graphs": reserved_with_graphs,
        "oom": {"frames": MEM_OOM_FRAMES, "fault": MEM_OOM_FAULT,
                "rungs": rungs, "frames_lost": 0,
                "b1_launches": oom["launches"],
                "captures": sum(r["captures"]
                                for r in oom["regions"].values())},
        "gpu": power}
    emit({"phase": "memory", **result})
    return result


def _cont_desc(labels, model, extra=""):
    return ("appsrc name=src ! tensor_transform mode=arithmetic "
            "option=typecast:float32,add:-127.5,div:127.5 ! "
            f"tensor_filter framework=jax model={model} name=filter {extra}! "
            f"tensor_decoder mode=image_labeling option1={labels} ! "
            "queue max-size-buffers=64 materialize-host=true ! "
            "tensor_sink name=out to-host=true")


def _cont_run(desc, name, frames, swap_to=None, flowing=False):
    """Push ``frames`` through ``desc``; with ``swap_to`` (a state dict)
    the weights are swapped once half of them reached the sink. The
    source holds the second half back until the swap returns, unless
    ``flowing``: then a thread pushes every frame (``appsrc`` blocks
    while its queue is full) and the stream runs on through the swap."""
    import threading

    import torch

    import nnstreamer_tpu_torch as nt
    from nnstreamer_tpu_torch.ops import preprocess as pp
    from nnstreamer_tpu_torch.pipeline.pipeline import Pipeline

    pipe = nt.parse_launch(desc, pipeline=Pipeline(name=name))
    metas = []
    pipe.get("out").connect(lambda buf: metas.append(buf.meta))
    src = pipe.get("src")
    half = len(frames) // 2
    report = captures_at_swap = arrived_at_swap = swap_s = None
    held = swap_to is not None and not flowing
    pp.reset_launches()
    pipe.start()
    pusher = threading.Thread(
        target=lambda: [src.push([f]) for f in frames], daemon=True)
    try:
        if flowing:
            pusher.start()
        else:
            for f in frames[:half] if held else frames:
                src.push([f])
        if swap_to is not None:
            deadline = time.monotonic() + 300
            while len(metas) < half:
                check(time.monotonic() < deadline,
                      f"{name}: {len(metas)} of {half} frames before the "
                      "swap")
                time.sleep(0.002)
            (region,) = pipe._regions
            captures_at_swap = region.captures
            t_swap = time.monotonic()
            report = pipe.swap_model("filter", weights=swap_to)
            swap_s = time.monotonic() - t_swap
            arrived_at_swap = len(metas)
            for f in frames[half:] if held else ():
                src.push([f])
        if flowing:
            pusher.join(timeout=300)
            check(not pusher.is_alive(), f"{name}: the source is stuck")
        src.end_of_stream()
        msg = pipe.wait(timeout=600)
        check(msg is not None and msg.kind == "eos", f"{name}: {msg}")
        torch.cuda.synchronize()
    finally:
        pipe.stop()
    (region,) = pipe._regions
    return {"frames": labelled_frames(metas), "captures": region.captures,
            "replays": region.replays, "captures_at_swap": captures_at_swap,
            "arrived_at_swap": arrived_at_swap, "swap_s": swap_s,
            "report": report, "launches": pp.LAUNCHES["normalize_chain"]}


def phase_continuity(power: str) -> dict:
    """Serving continuity (ROADMAP A.20). A weights-only ``swap_model``
    halfway through 800 frames of the fused batch-1 flagship
    (``is-updatable=true``): the frames before the cutover equal the old
    weights' run bit for bit, those after it the new weights' run, and
    the swap adds no capture (the new values are copied into the
    parameters the graph reads). Then ``checkpoint``/``restore`` of
    bench.py's ``lstm`` loop: 400 steps, a checkpoint, the slot dropped,
    a new pipeline restored from it (the state back on the card) and 400
    more steps: the state equals 800 uninterrupted eager steps bit for
    bit. Last, a second process armed on this run's compile cache builds
    no kernel (hits 3, misses 0)."""
    import numpy as np
    import torch

    import nnstreamer_tpu_torch as nt
    from nnstreamer_tpu_torch.elements.repo import GLOBAL_REPO
    from nnstreamer_tpu_torch.filters.torch_backend import (
        register_torch_model,
        unregister_torch_model,
    )
    from nnstreamer_tpu_torch.models.lstm import lstm_cell
    from nnstreamer_tpu_torch.models.mobilenet_v2 import mobilenet_v2
    from nnstreamer_tpu_torch.pipeline import continuity

    nt.set_device(None)
    mods = {}
    for name, seed in (("cont_a", 3), ("cont_b", 4)):
        mods[name], _, _ = mobilenet_v2(num_classes=CLASSES,
                                        image_size=IMAGE,
                                        dtype=torch.bfloat16, seed=seed)
        register_torch_model(name, mods[name])
    labels = _labels_file("cont")
    rng = np.random.default_rng(0)
    distinct = [rng.integers(0, 256, (1, IMAGE, IMAGE, 3), dtype=np.uint8)
                for _ in range(CONT_DISTINCT)]
    frames = [distinct[i % CONT_DISTINCT] for i in range(CONT_FRAMES)]
    half = CONT_FRAMES // 2
    try:
        ref_a = _cont_run(_cont_desc(labels, "cont_a"), "cont_ref_a",
                          frames)
        ref_b = _cont_run(_cont_desc(labels, "cont_b"), "cont_ref_b",
                          frames)
        swapped = _cont_run(
            _cont_desc(labels, "cont_a", "is-updatable=true "), "cont_swap",
            frames, swap_to=mods["cont_b"].state_dict())
        flowing = _cont_run(
            _cont_desc(labels, "cont_a", "is-updatable=true "),
            "cont_swap_flowing", frames, swap_to=mods["cont_b"].state_dict(),
            flowing=True)
    finally:
        for name in mods:
            unregister_torch_model(name)
    got = swapped["frames"]
    check(len(got) == CONT_FRAMES, f"continuity: {len(got)} of "
                                   f"{CONT_FRAMES} frames")
    before = [i for i in range(half) if got[i] != ref_a["frames"][i]]
    after = [i for i in range(half, CONT_FRAMES)
             if got[i] != ref_b["frames"][i]]
    check(not before and not after,
          f"continuity: frames {before[:5]} before and {after[:5]} after "
          "the cutover differ from the old and new weights' runs")
    check(ref_a["frames"][:half] != ref_b["frames"][:half],
          "continuity: the two weight sets label the frames alike")
    rep = swapped["report"]
    check(swapped["captures"] == swapped["captures_at_swap"] == 1 and
          rep["rebound"] == 0 and rep["invalidations"] == 1,
          f"continuity: {swapped['captures']} captures "
          f"({swapped['captures_at_swap']} at the swap), report {rep}")
    check(swapped["launches"] == CONT_FRAMES,
          f"continuity: B1 {swapped['launches']} for {CONT_FRAMES} frames")
    # the swap with the stream running on: one cutover, wherever the swap
    # took the dispatch lock; every frame before it is the old run's and
    # every frame from it the new run's, bit for bit (a frame that read a
    # half-installed set would match neither)
    got = flowing["frames"]
    check(len(got) == CONT_FRAMES, f"continuity: flowing swap {len(got)} "
                                   f"of {CONT_FRAMES} frames")
    cut = next((i for i in range(CONT_FRAMES)
                if got[i] != ref_a["frames"][i]), CONT_FRAMES)
    mixed = [i for i in range(cut, CONT_FRAMES)
             if got[i] != ref_b["frames"][i]]
    check(half <= cut < CONT_FRAMES and not mixed,
          f"continuity: flowing swap cut over at frame {cut}, frames "
          f"{mixed[:5]} after it differ from the new weights' run")
    # the swap goes ahead of the next dispatch: it cuts over past frame
    # 400 by no more than the frames between the region and the sink (a
    # queue of 64, the window) and the poll's slack
    check(cut - half <= CONT_SWAP_SLACK,
          f"continuity: the flowing swap waited {cut - half} frames")
    check(flowing["captures"] == 1 and flowing["report"]["rebound"] == 0,
          f"continuity: flowing swap {flowing['captures']} captures, "
          f"report {flowing['report']}")

    # checkpoint / restore of the lstm loop
    torch.backends.cuda.matmul.allow_tf32 = False
    cell, _, _ = lstm_cell(input_dim=LSTM_HIDDEN, hidden=LSTM_HIDDEN,
                           batch=1, seed=0)
    step = _lstm_step(cell)
    register_torch_model("lstm_ck", step)
    ckpt = tempfile.mkdtemp(prefix="nns_smoke_ckpt_")
    slot = "lstm_ck"
    first = (f"tensor_reposrc slot={slot} num-buffers={CONT_LSTM_STEPS} "
             f"initial-dim={2 * LSTM_HIDDEN} initial-type=float32 "
             "initial-value=0.01 timeout=30 ! tensor_filter framework=jax "
             "model=lstm_ck name=filter ! tee name=t  t. ! "
             f"tensor_reposink slot={slot}  t. ! tensor_sink name=sink "
             "to-host=false")
    rest = (f"tensor_reposrc slot={slot} num-buffers={CONT_LSTM_STEPS} "
            "timeout=30 ! tensor_filter framework=jax model=lstm_ck "
            f"name=filter input={2 * LSTM_HIDDEN} inputtype=float32 ! "
            f"tee name=t  t. ! tensor_reposink slot={slot}  t. ! "
            "tensor_sink name=sink to-host=false")
    try:
        GLOBAL_REPO.remove(slot)
        pipe = nt.parse_launch(first)
        check(pipe.run(timeout=300).kind == "eos", "continuity: lstm run 1")
        path = pipe.checkpoint(ckpt)
        GLOBAL_REPO.remove(slot)
        resumed = nt.parse_launch(rest)
        resumed.checkpoint_dir = ckpt
        resumed.start()  # restores the slot before its source runs
        msg = resumed.wait(timeout=300)
        resumed.stop()
        check(msg is not None and msg.kind == "eos",
              f"continuity: lstm run 2: {msg}")
        check(resumed._continuity_restored, "continuity: no restore")
        final = GLOBAL_REPO.get(slot).tensors[0]
        GLOBAL_REPO.remove(slot)
        state = torch.full((2 * LSTM_HIDDEN,), 0.01, device="cuda")
        with torch.inference_mode():
            for _ in range(2 * CONT_LSTM_STEPS):
                state = step(state)
    finally:
        unregister_torch_model("lstm_ck")
    with open(path, "rb") as f:
        import pickle

        saved = pickle.load(f)
    check(all(isinstance(a, np.ndarray) for a in saved["repo"][slot]),
          "continuity: the checkpoint holds a device tensor")
    check(final.device.type == "cuda",
          f"continuity: the restored state is on {final.device}")
    check(torch.equal(final, state),
          "continuity: the restored loop differs from uninterrupted steps")

    # a second process on this run's compile cache
    cache = continuity.compile_cache_dir()
    code = ("import json, sys; sys.path.insert(0, sys.argv[1]); "
            "from nnstreamer_tpu_torch.pipeline import continuity as c; "
            "c.enable_compile_cache(sys.argv[2]); "
            "from nnstreamer_tpu_torch.ops import _build; "
            "_build.build_all(); print(json.dumps(c.cache_stats()))")
    t0 = time.monotonic()
    proc = subprocess.run([sys.executable, "-c", code, HERE, cache],
                          capture_output=True, text=True, timeout=600)
    boot_s = time.monotonic() - t0
    check(proc.returncode == 0, f"continuity: second boot: {proc.stderr}")
    second = json.loads(proc.stdout.strip().splitlines()[-1])
    check(second == {"hits": 3, "misses": 0},
          f"continuity: the second boot built kernels: {second}")
    result = {"swap": {"frames": CONT_FRAMES, "cutover": half,
                       "captures": swapped["captures"],
                       "replays": swapped["replays"],
                       "b1_launches": swapped["launches"],
                       "rebound": rep["rebound"],
                       "invalidations": rep["invalidations"],
                       "bit_identical_each_side": True},
              "swap_flowing": {"frames": CONT_FRAMES, "cutover": cut,
                               "arrived_at_swap": flowing["arrived_at_swap"],
                               "swap_s": flowing["swap_s"],
                               "captures": flowing["captures"],
                               "bit_identical_each_side": True},
              "lstm": {"steps": 2 * CONT_LSTM_STEPS,
                       "checkpoint_at": CONT_LSTM_STEPS,
                       "bit_identical_to_uninterrupted": True},
              "compile_cache": {"first_boot": continuity.cache_stats(),
                                "second_boot": second,
                                "second_boot_s": boot_s},
              "gpu": power}
    emit({"phase": "continuity", **result})
    return result


def phase_lm_memory(power: str) -> dict:
    """The LM engine under the HBM accountant (ROADMAP A.19), bench.py's
    LM configuration in bf16: the paged engine (block_tokens 16) registers
    exactly ``BlockPool.nbytes`` under ``kvcache`` and serves the tokens
    of the same engine with no accountant (B2 = layers × cold prefills);
    a prefix-cache engine's entries register as droppable units and its
    account nets to zero after ``close()``; a starved pool counts each
    shed on ``nns_mem_pressure_events_total{rung="shed"}``."""
    import numpy as np
    import torch

    from nnstreamer_tpu_torch.models.transformer import (
        TransformerConfig,
        init_params,
    )
    from nnstreamer_tpu_torch.obs import get_registry
    from nnstreamer_tpu_torch.ops._counts import LAUNCHES, reset_launches
    from nnstreamer_tpu_torch.serving import ContinuousBatchingEngine
    from nnstreamer_tpu_torch.tensors import memory

    cfg = TransformerConfig(**LM, dtype=torch.bfloat16)
    params = init_params(cfg, seed=0)
    rng = np.random.default_rng(4)
    prompts = [rng.integers(1, cfg.vocab, n).tolist()
               for n in rng.integers(8, 48, LM_MEM_PROMPTS)]

    def engine(**kw):
        return ContinuousBatchingEngine(cfg, params, max_streams=LM_SLOTS,
                                        steps_per_dispatch=8, **kw).start()

    def serve(eng, new=LM_MEM_NEW, load=prompts):
        streams = [eng.submit(p, max_new_tokens=new) for p in load]
        return [s.result(timeout=600) for s in streams]

    def shed_count():
        m = get_registry().get("nns_mem_pressure_events_total", rung="shed")
        return 0 if m is None else int(m.value)

    plain = engine(block_tokens=LM_PAGED_BLOCK)
    try:
        want = serve(plain)
    finally:
        plain.close()
    acct = memory.activate(1 << 40)  # accounting only: nothing evicts
    try:
        eng = engine(block_tokens=LM_PAGED_BLOCK)
        try:
            arena = eng._pool.nbytes
            registered = acct.snapshot()["used_by_category"]
            stats0 = dict(eng.stats)
            reset_launches()
            got = serve(eng)
            torch.cuda.synchronize()
            flash = LAUNCHES["flash_attention"]
            b2 = _b2_prefills(eng, stats0)
        finally:
            eng.close()
        after_paged = acct.used_bytes()
        preamble = rng.integers(1, cfg.vocab, LM_PREAMBLE).tolist()
        eng = engine(prefix_cache=LM_PREFIX_ENTRIES)
        try:
            for p in prompts[:4]:
                eng.generate(preamble + p, max_new_tokens=8, timeout=600)
            prefix_bytes = acct.snapshot()["used_by_category"].get(
                "kvcache", 0)
            entries = len(eng._prefix_acct)
        finally:
            eng.close()
        after_prefix = acct.used_bytes()
        shed0 = shed_count()
        eng = engine(block_tokens=LM_PAGED_BLOCK,
                     kv_blocks=LM_STARVED_BLOCKS)
        try:
            serve(eng, LM_PAGED_NEW,
                  [rng.integers(1, cfg.vocab, n).tolist()
                   for n in rng.integers(8, 48, LM_PAGED_STREAMS // 2)])
            sheds = eng.stats["kv_sheds"]
        finally:
            eng.close()
        shed_events = shed_count() - shed0
        high_water = acct.high_water
    finally:
        memory.deactivate()
    check(registered == {"kvcache": arena},
          f"lm_memory: registered {registered}, the arena is {arena}")
    check(got == want, "lm_memory: tokens differ from the engine with no "
                       "accountant")
    check(flash == cfg.n_layers * b2 and b2 > 0,
          f"lm_memory: flash kernel {flash} for {b2} cold prefills")
    check(after_paged == 0 and after_prefix == 0,
          f"lm_memory: {after_paged} / {after_prefix} bytes left after "
          "close()")
    check(entries > 0 and prefix_bytes > 0,
          f"lm_memory: {entries} prefix entries, {prefix_bytes} bytes")
    check(sheds > 0 and shed_events == sheds,
          f"lm_memory: {sheds} sheds, {shed_events} shed rungs counted")
    result = {"kvcache_bytes": arena, "tokens_identical": True,
              "flash_launches": flash, "b2_prefills": b2,
              "prefix_entries": entries, "prefix_kvcache_bytes": prefix_bytes,
              "net_after_close": 0, "starved_sheds": sheds,
              "shed_rung_events": shed_events, "high_water_bytes": high_water,
              "gpu": power}
    emit({"phase": "lm_memory", **result})
    return result


# -- audio keyword spotting, file I/O and the stream algebra (ROADMAP A.17,
#    A.18, A.27) ---------------------------------------------------------------
KWS_HEAD = (f"audiotestsrc num-buffers={KWS_BUFFERS} freq={KWS_FREQ} "
            f"samplesperbuffer={KWS_CHUNK} rate={KWS_RATE} format=S16LE ! "
            "tensor_converter ! tensor_aggregator name=agg "
            f"frames-in={KWS_CHUNK} frames-out={KWS_SAMPLES} "
            f"frames-flush={KWS_HOP} frames-dim=1 concat=true")


def kws_desc(model, tail="tensor_decoder mode=image_labeling ! "):
    """The keyword-spotting string: 100 ms chunks of 16 kHz S16LE audio
    into 1 s windows with a 0.5 s hop, B1's int16 chain, the classifier,
    then ``tail`` (the decoder, or for the logits a sink that leaves them
    on the card: it then records no latency for the window's 16,000
    sample stamps)."""
    sink = "tensor_sink name=sink" + ("" if tail else " to-host=false")
    return (f"{KWS_HEAD} ! tensor_transform mode=arithmetic "
            "option=typecast:float32,div:32768 ! "
            f"tensor_filter framework=jax model={model} name=filter ! "
            f"{tail}{sink}")


def kws_windows():
    """The windows as the aggregator should cut them: the source's own
    int16 samples, 1 s every 0.5 s. [KWS_WINDOWS, KWS_SAMPLES, 1]."""
    import numpy as np

    from nnstreamer_tpu_torch.elements.source import AudioTestSrc

    src = AudioTestSrc(num_buffers=KWS_BUFFERS, samplesperbuffer=KWS_CHUNK,
                       rate=KWS_RATE, format="S16LE", freq=KWS_FREQ)
    samples = np.concatenate([src.create()[0] for _ in range(KWS_BUFFERS)])
    return np.stack([samples[k * KWS_HOP:k * KWS_HOP + KWS_SAMPLES]
                     for k in range(KWS_WINDOWS)])


def kws_windows_check(windows) -> dict:
    """The aggregator's windows (``KWS_HEAD ! tensor_sink``) against
    :func:`kws_windows`, byte for byte and in order: a wrong hop, a
    window out of order or one repeated shows, since the tone makes every
    window differ."""
    import numpy as np

    got = [np.asarray(w) for w in windows]
    want = kws_windows()
    check(len({w.tobytes() for w in want}) == KWS_WINDOWS,
          "audio: two of the expected windows are equal")
    check(len(got) == KWS_WINDOWS,
          f"audio: the aggregator cut {len(got)} windows of "
          f"{KWS_WINDOWS}")
    differ = [i for i, (a, b) in enumerate(zip(got, want))
              if a.dtype != b.dtype or a.shape != b.shape or
              a.tobytes() != b.tobytes()]
    check(not differ, f"audio: windows {differ[:10]} differ from the "
                      "source's samples cut every 0.5 s")
    return {"windows_byte_identical": KWS_WINDOWS - len(differ),
            "windows_distinct": len({w.tobytes() for w in got})}


def phase_audio(power: str) -> dict:
    """Keyword spotting at the model's full width (16000 samples, width
    64, 12 classes, bf16, seed 0): 800 chunks of 1,600 samples through
    ``tensor_aggregator`` into 159 windows, the fused region transform (B1
    on int16) ! filter ! image_labeling. Checks: the aggregator's windows
    = the source's samples cut every 0.5 s, byte for byte and in order
    (the tone makes every window differ); fused = unfused bit for bit
    (labels, indices, scores; the f32 logits of the string without a
    decoder), B1 once a window, 1 capture; the bf16 logits against the
    port's fp32 model on the CPU, relative L2 ≤ 2e-2. Reported: windows a
    second, a window's latency from its last sample's capture, the
    per-sample stamps the aggregator carries and what the aggregator and
    the sink spend a window on the host. Returns (result, the fused
    pipeline, its model still registered for the profiled restart)."""
    import numpy as np
    import torch

    import nnstreamer_tpu_torch as nt
    from nnstreamer_tpu_torch.filters.torch_backend import (
        register_torch_model,
        unregister_torch_model,
    )
    from nnstreamer_tpu_torch.models.audio_classifier import audio_classifier
    from nnstreamer_tpu_torch.pipeline.pipeline import Pipeline

    nt.set_device(None)
    module, in_info, out_info = audio_classifier(
        samples=KWS_SAMPLES, num_classes=KWS_CLASSES, dtype=torch.bfloat16,
        seed=0)
    register_torch_model("kws", module, in_info, out_info)
    window_lat = []
    stamps = []

    def on_window(buf):
        ts = buf.create_stamps()
        stamps.append(len(ts))
        if ts:
            window_lat.append(time.monotonic() - max(ts))

    def labels(rows):
        return [(m["label_index"], m["label"], m["score"]) for _, m in rows]

    try:
        pipe = nt.parse_launch(kws_desc("kws"), pipeline=Pipeline(name="kws"))
        pipe.get("sink").connect(on_window)
        arrivals, t0, eos, launches = _collect_arrivals(pipe)
        region = _region_of(pipe, ["tensor_transform", "tensor_filter",
                                   "tensor_decoder"])
        fused = labels(_sink_rows(pipe))
        sample_lat = pipe.get("sink").latency_percentiles(50.0, 99.0)
        snap = pipe.metrics_snapshot()["elements"]
        host = {el: {k: snap[el].get(k) for k in ("chain_p50_ms",
                                                   "chain_p99_ms")}
                for el in ("agg", "sink")}
        lpipe = nt.parse_launch(kws_desc("kws", tail=""),
                                pipeline=Pipeline(name="kws_logits"))
        _, _, _, logit_launches = _collect_arrivals(lpipe)
        lregion = _region_of(lpipe, ["tensor_transform", "tensor_filter"])
        logits = [b[0].cpu().numpy() for b in lpipe.get("sink").buffers]
        # unfused, the labels and the logits of one run
        upipe = nt.parse_launch(kws_desc("kws", tail=(
            "tee name=t  t. ! tensor_sink name=logits to-host=false  "
            "t. ! tensor_decoder mode=image_labeling ! ")),
            pipeline=Pipeline(name="kws_unfused", fuse=False))
        check(upipe.run(timeout=180).kind == "eos", "audio: unfused run")
        unfused = labels(_sink_rows(upipe))
        logits_unfused = [b[0].cpu().numpy()
                          for b in upipe.get("logits").buffers]
    except BaseException:
        unregister_torch_model("kws")
        raise
    # the aggregator's windows themselves, on the host
    wpipe = nt.parse_launch(f"{KWS_HEAD} ! tensor_sink name=sink",
                            pipeline=Pipeline(name="kws_windows"))
    check(wpipe.run(timeout=180).kind == "eos", "audio: windows run")
    windows = kws_windows_check(b[0] for b in wpipe.get("sink").buffers)
    check(len(fused) == len(unfused) == KWS_WINDOWS,
          f"audio: {len(fused)} fused and {len(unfused)} unfused windows "
          f"of {KWS_WINDOWS}")
    differ = [i for i, (a, b) in enumerate(zip(fused, unfused)) if a != b]
    check(not differ, f"audio: fused labels of windows {differ[:10]} differ "
                      "from the unfused run's")
    check(len(logits) == len(logits_unfused) == KWS_WINDOWS and
          all(a.dtype == np.float32 and a.shape == (1, KWS_CLASSES)
              for a in logits),
          "audio: the logits are not one [1, 12] float32 row a window")
    differ = [i for i, (a, b) in enumerate(zip(logits, logits_unfused))
              if a.tobytes() != b.tobytes()]
    check(not differ, f"audio: fused logits of windows {differ[:10]} differ "
                      "from the unfused run's")
    check([(int(np.argmax(a)), float(a.max())) for a in logits] ==
          [(i, s) for i, _, s in fused],
          "audio: the decoder's labels and scores are not the logits' "
          "argmax and max")
    check(launches == logit_launches == KWS_WINDOWS,
          f"audio: B1 launched {launches} and {logit_launches} times for "
          f"{KWS_WINDOWS} windows")
    check(region.captures == 1 and lregion.captures == 1,
          f"audio: {region.captures} and {lregion.captures} captures")
    # the card's bf16 logits against the port's fp32 model on the CPU
    ref, _, _ = audio_classifier(samples=KWS_SAMPLES, num_classes=KWS_CLASSES,
                                 dtype=torch.float32, seed=0)
    with torch.inference_mode():
        want = ref(torch.from_numpy(
            kws_windows().astype(np.float32) / np.float32(32768.0))).numpy()
    got = np.concatenate(logits)
    rel_l2 = float(np.linalg.norm(got - want) / np.linalg.norm(want))
    check(rel_l2 <= REL_L2_MAX,
          f"audio: bf16 logits vs fp32 on the CPU, relative L2 {rel_l2} > "
          f"{REL_L2_MAX}")
    result = {"windows": len(fused), "launches": launches,
              "windows_per_s": steady_fps(arrivals, eos),
              "first_window_s": arrivals[0] - t0,
              "window_latency_p50_ms":
                  float(np.percentile(window_lat, 50)) * 1e3,
              "window_latency_p99_ms":
                  float(np.percentile(window_lat, 99)) * 1e3,
              "sample_latency_p50_ms": sample_lat[0],
              "sample_latency_p99_ms": sample_lat[1],
              "stamps_per_window": statistics.median(stamps),
              "host_chain_ms": host,
              "captures": region.captures, "replays": region.replays,
              "fused_unfused_bit_identical": KWS_WINDOWS, **windows,
              "rel_l2_bf16_vs_fp32_cpu": rel_l2,
              "labels": sorted(set(i for i, _, _ in fused)), "gpu": power}
    emit({"phase": "audio", **result})
    return result, pipe


def _flagship_tail(model, labels, sink="tensor_sink name=sink"):
    return ("tensor_transform mode=arithmetic "
            "option=typecast:float32,add:-127.5,div:127.5 ! "
            f"tensor_filter framework=jax model={model} name=filter ! "
            f"tensor_decoder mode=image_labeling option1={labels} ! {sink}")


def _label_rows(pipe, sink="sink"):
    return [(b.meta["label_index"], b.meta["label"], b.meta["score"])
            for b in pipe.get(sink).buffers]


def phase_files(power: str) -> dict:
    """The flagship at full width (MobileNetV2 1.0, 224×224×3, 1001
    classes, bf16, batch 1, fused) from files: 240 ``ball`` frames, byte
    for byte as ``videotestsrc`` makes them (the ball moves, so a frame
    read out of order, twice or cut at the wrong offset shows), as
    ``f_%04d.raw`` and as one file. Runs: (i) ``multifilesrc``, (ii)
    ``filesrc blocksize=65536`` (frames straddle the blocks), each through
    ``tensor_converter input-dim=3:224:224:1 input-type=uint8``, against
    ``videotestsrc`` feeding the same string; (iii) the logits through
    ``tensor_decoder mode=octet_stream ! filesink``; (iv) each file source
    ``! tensor_converter ! tensor_decoder mode=direct_video ! filesink``.
    Checks: (i) and (ii) bit-identical to ``videotestsrc`` frame by frame
    (labels, indices, f32 scores), (i)'s pts the file index, B1 240 times
    and 1 capture each; (iii)'s file = the logits a sink beside it
    received, whose argmax and max are (i)'s; (iv)'s files = the frames'
    file."""
    import numpy as np

    import nnstreamer_tpu_torch as nt
    from nnstreamer_tpu_torch.filters.torch_backend import (
        unregister_torch_model,
    )
    from nnstreamer_tpu_torch.pipeline.pipeline import Pipeline

    nt.set_device(None)
    _, labels = _flagship_model("files")
    tmp = tempfile.mkdtemp(prefix="nns_smoke_files_")
    ball = (f"videotestsrc num-buffers={FILES_FRAMES} width={IMAGE} "
            f"height={IMAGE} pattern=ball")
    conv = f"tensor_converter input-dim=3:{IMAGE}:{IMAGE}:1 input-type=uint8"
    result = {}
    try:
        one = nt.parse_launch(f"{ball} ! tensor_converter ! "
                              "tensor_sink name=sink")
        frames = []
        one.get("sink").connect(
            lambda b: frames.append(np.asarray(b[0]).tobytes()))
        one.run(timeout=60)
        check(len(frames) == FILES_FRAMES and
              all(len(f) == IMAGE * IMAGE * 3 for f in frames),
              "files: frame count or size")
        # the ball steps (7, 5) pixels a frame modulo the side, so at a
        # square side its path repeats after that many frames
        check(len(set(frames)) == min(FILES_FRAMES, IMAGE),
              f"files: {len(set(frames))} distinct frames")
        for i, frame in enumerate(frames):
            with open(os.path.join(tmp, f"f_{i:04d}.raw"), "wb") as f:
                f.write(frame)
        with open(os.path.join(tmp, "all.raw"), "wb") as f:
            f.write(b"".join(frames))
        tail = _flagship_tail("files", labels)
        runs = {"videotestsrc": f"{ball} ! tensor_converter ! {tail}",
                "multifilesrc": f"multifilesrc location={tmp}/f_%04d.raw ! "
                                f"{conv} ! {tail}",
                "filesrc": f"filesrc location={tmp}/all.raw "
                           f"blocksize={FILES_BLOCK} ! {conv} ! {tail}"}
        rows = {}
        for name, desc in runs.items():
            pipe = nt.parse_launch(desc, pipeline=Pipeline(
                name=f"files_{name}"))
            arrivals, t0, eos, launches = _collect_arrivals(pipe)
            region = _region_of(pipe, ["tensor_transform", "tensor_filter",
                                       "tensor_decoder"])
            rows[name] = _label_rows(pipe)
            if name == "multifilesrc":
                pts = [b.pts for b in pipe.get("sink").buffers]
                check(pts == list(range(FILES_FRAMES)),
                      "files: multifilesrc's pts are not the file indices")
            result[name] = {"frames": len(rows[name]), "launches": launches,
                            "captures": region.captures,
                            "fps": steady_fps(arrivals, eos)}
            check(len(rows[name]) == FILES_FRAMES,
                  f"files: {name} labelled {len(rows[name])} of "
                  f"{FILES_FRAMES} frames")
            check(launches == FILES_FRAMES and region.captures == 1,
                  f"files: {name}: B1 {launches} times, "
                  f"{region.captures} captures")
        for name in ("multifilesrc", "filesrc"):
            differ = [i for i, (a, b) in enumerate(zip(
                rows[name], rows["videotestsrc"])) if a != b]
            check(not differ, f"files: {name}'s labels of frames "
                              f"{differ[:10]} differ from videotestsrc's")
        result["distinct_label_rows"] = len(set(rows["videotestsrc"]))
        # (iii) the logits as raw bytes, a sink beside the file
        pipe = nt.parse_launch(
            f"multifilesrc location={tmp}/f_%04d.raw ! {conv} ! "
            "tensor_transform mode=arithmetic "
            "option=typecast:float32,add:-127.5,div:127.5 ! "
            "tensor_filter framework=jax model=files ! tee name=t  "
            "t. ! tensor_decoder mode=octet_stream ! "
            f"filesink location={tmp}/logits.raw  t. ! tensor_sink name=sink",
            pipeline=Pipeline(name="files_octet"))
        msg = pipe.run(timeout=180)
        check(msg is not None and msg.kind == "eos", f"files: octet ({msg})")
        logits = [np.asarray(b[0]) for b in pipe.get("sink").buffers]
        with open(os.path.join(tmp, "logits.raw"), "rb") as f:
            dump = f.read()
        check(len(logits) == FILES_FRAMES and
              dump == b"".join(a.tobytes() for a in logits),
              "files: the octet_stream file is not the logits' bytes")
        check([(int(np.argmax(a)), float(a.max())) for a in logits] ==
              [(i, s) for i, _, s in rows["multifilesrc"]],
              "files: the logits' argmax and max are not (i)'s labels")
        # (iv) the frames back through direct_video, from each file source
        for name, src in (("multifilesrc",
                           f"multifilesrc location={tmp}/f_%04d.raw"),
                          ("filesrc", f"filesrc location={tmp}/all.raw "
                                      f"blocksize={FILES_BLOCK}")):
            pipe = nt.parse_launch(
                f"{src} ! {conv} ! tensor_decoder mode=direct_video ! "
                f"filesink location={tmp}/video.raw",
                pipeline=Pipeline(name=f"files_video_{name}"))
            msg = pipe.run(timeout=180)
            check(msg is not None and msg.kind == "eos",
                  f"files: video from {name} ({msg})")
            with open(os.path.join(tmp, "video.raw"), "rb") as f:
                video = f.read()
            check(video == b"".join(frames),
                  f"files: the direct_video file from {name} is not the "
                  "frames' file")
        result.update(octet_bytes=len(dump), video_bytes=len(video))
    finally:
        unregister_torch_model("files")
        shutil.rmtree(tmp, ignore_errors=True)
    emit({"phase": "files", **result, "gpu": power})
    return result


def _pushed_run(name, desc, frames, fuse=True):
    """``desc`` (an ``appsrc name=src``) fed ``frames`` with pts = index,
    run to EOS. Returns (pipeline, B1 launches)."""
    import nnstreamer_tpu_torch as nt
    from nnstreamer_tpu_torch.ops import preprocess as pp
    from nnstreamer_tpu_torch.pipeline.pipeline import Pipeline

    pipe = nt.parse_launch(desc, pipeline=Pipeline(name=name, fuse=fuse))
    src = pipe.get("src")
    for i, f in enumerate(frames):
        src.push([f], pts=i)
    src.end_of_stream()
    pp.reset_launches()
    msg = pipe.run(timeout=180)
    check(msg is not None and msg.kind == "eos", f"{name}: no EOS ({msg})")
    return pipe, pp.LAUNCHES.get("normalize_chain", 0)


def _d2h(x0, x1) -> dict:
    return {k: x1[k] - x0[k] for k in ("d2h_events", "d2h_bytes",
                                       "d2h_syncs")}


def phase_algebra(power: str) -> dict:
    """The stream algebra on device buffers, 64 frames or fewer each:
    (a) a ``tensor_if`` gate (``TENSOR_AVERAGE_VALUE``) before the batch-1
    fused flagship, half of the appsrc frames darkened below it, the else
    branch to a ``fakesink``; (b) SSD (300×300, 91 classes) with
    ``tensor_demux tensorpick=0,1`` after the filter; (c) ``tensor_split``
    of pose4's batch-4 output into 4 streams; (d) ``tensor_crop`` of
    300×300 frames uploaded to the card, by regions a ``custom-easy``
    filter computes; (e) ``join`` of (a)'s two branches into one sink.
    Checks: (a) B1 = frames passed, each label = the ungated run's; (b)
    and (c) no D2H before the sinks (sinks with ``to-host=false``), every
    tensor bit-identical to the model's output and its slice; (d) the
    crops = numpy slices of the frames; (e) every frame, in order."""
    import numpy as np
    import torch

    import nnstreamer_tpu_torch as nt
    from nnstreamer_tpu_torch.filters import register_custom_easy
    from nnstreamer_tpu_torch.filters.custom import unregister_custom_easy
    from nnstreamer_tpu_torch.filters.torch_backend import (
        register_torch_model,
        unregister_torch_model,
    )
    from nnstreamer_tpu_torch.models.posenet import posenet
    from nnstreamer_tpu_torch.models.ssd_mobilenet import ssd_mobilenet
    from nnstreamer_tpu_torch.pipeline.pipeline import Pipeline
    from nnstreamer_tpu_torch.tensors.buffer import transfer_snapshot
    from nnstreamer_tpu_torch.tensors.types import TensorsInfo

    nt.set_device(None)
    rng = np.random.default_rng(0)
    result = {"gpu": power}
    # (a) and (e): the gate and the join
    frames = []
    for i in range(GATE_FRAMES):
        f = rng.integers(0, 256, (1, IMAGE, IMAGE, 3), dtype=np.uint8)
        frames.append(f // 10 if i % 2 else f)
    bright = [i for i, f in enumerate(frames) if f.mean() > GATE_THRESHOLD]
    check(len(bright) == GATE_FRAMES // 2, "algebra: the darkened frames")
    _, labels = _flagship_model("gate")
    tail = _flagship_tail("gate", labels, sink="")
    src = f"appsrc name=src max-buffers={GATE_FRAMES + 1}"
    gate = ("tensor_if name=g compared-value=TENSOR_AVERAGE_VALUE "
            "compared-value-option=0 operator=gt "
            f"supplied-value={GATE_THRESHOLD} then=PASSTHROUGH "
            "else=PASSTHROUGH")
    try:
        ungated, _ = _pushed_run(
            "gate_ref", f"{src} ! {tail} tensor_sink name=sink", frames)
        ref = {b.pts: (b.meta["label_index"], b.meta["score"])
               for b in ungated.get("sink").buffers}
        gated, b1_gate = _pushed_run(
            "gate", f"{src} ! {gate}  g.src_true ! {tail} tensor_sink "
            "name=sink  g.src_false ! fakesink name=dark", frames)
        region = _region_of(gated, ["tensor_transform", "tensor_filter",
                                    "tensor_decoder"])
        passed = [(b.pts, (b.meta["label_index"], b.meta["score"]))
                  for b in gated.get("sink").buffers]
        joined, b1_join = _pushed_run(
            "gate_join", f"{src} ! {gate}  g.src_true ! {tail} j.  "
            "g.src_false ! j.  join name=j ! tensor_sink name=sink", frames)
        jbufs = list(joined.get("sink").buffers)
    finally:
        unregister_torch_model("gate")
    check(len(ref) == GATE_FRAMES, f"algebra: ungated {len(ref)} frames")
    check([p for p, _ in passed] == bright,
          "algebra: the gate passed other frames than the bright ones")
    check(all(ref[p] == row for p, row in passed),
          "algebra: a gated frame's label differs from the ungated run's")
    check(b1_gate == len(bright) and region.captures == 1,
          f"algebra: B1 {b1_gate} times for {len(bright)} frames passed, "
          f"{region.captures} captures")
    check(gated.get("dark").count == GATE_FRAMES - len(bright),
          f"algebra: the fakesink got {gated.get('dark').count} frames")
    check([b.pts for b in jbufs] == list(range(GATE_FRAMES)),
          "algebra: the join's sink did not get every frame in order")
    check(all((b.meta["label_index"], b.meta["score"]) == ref[b.pts]
              if b.pts in bright else
              np.array_equal(np.asarray(b[0]), frames[b.pts])
              for b in jbufs),
          "algebra: a joined frame is neither its label nor its frame")
    check(b1_join == len(bright), f"algebra: join: B1 {b1_join} times")
    result["gate"] = {"frames": GATE_FRAMES, "passed": len(passed),
                      "b1_launches": b1_gate, "captures": region.captures,
                      "dark": gated.get("dark").count}
    result["join"] = {"frames": len(jbufs), "b1_launches": b1_join}

    # (b) SSD's two outputs through tensor_demux, left on the card
    ssd, _, _ = ssd_mobilenet(num_classes=SSD_CLASSES, image_size=SSD_IMAGE,
                              dtype=torch.bfloat16, seed=0)
    register_torch_model("ssd_demux", ssd)
    pre = (f"videotestsrc num-buffers={DEMUX_FRAMES} width={SSD_IMAGE} "
           f"height={SSD_IMAGE} pattern=ball ! tensor_converter ! "
           "tensor_transform mode=arithmetic "
           "option=typecast:float32,add:-127.5,div:127.5 ! "
           "tensor_filter framework=jax model=ssd_demux ! ")
    try:
        plain = nt.parse_launch(pre + "tensor_sink name=sink to-host=false",
                                pipeline=Pipeline(name="demux_ref"))
        check(plain.run(timeout=180).kind == "eos", "algebra: demux ref")
        ref_out = [b.tensors for b in plain.get("sink").buffers]
        pipe = nt.parse_launch(
            pre + "tensor_demux name=d tensorpick=0,1  "
            "d.src_0 ! tensor_sink name=boxes to-host=false  "
            "d.src_1 ! tensor_sink name=scores to-host=false",
            pipeline=Pipeline(name="demux"))
        x0 = transfer_snapshot()
        check(pipe.run(timeout=180).kind == "eos", "algebra: demux")
        x1 = transfer_snapshot()
        dregion = _region_of(pipe, ["tensor_transform", "tensor_filter"])
    finally:
        unregister_torch_model("ssd_demux")
    boxes = [b.tensors for b in pipe.get("boxes").buffers]
    scores = [b.tensors for b in pipe.get("scores").buffers]
    d2h = _d2h(x0, x1)
    check(len(boxes) == len(scores) == len(ref_out) == DEMUX_FRAMES,
          "algebra: demux frame counts")
    check(all(len(b) == len(s) == 1 and b[0].is_cuda and s[0].is_cuda
              for b, s in zip(boxes, scores)),
          "algebra: a demuxed tensor left the card")
    check(all(torch.equal(b[0], r[0]) and torch.equal(s[0], r[1])
              for b, s, r in zip(boxes, scores, ref_out)),
          "algebra: a demuxed tensor differs from the model's output")
    check(d2h["d2h_events"] == 0 and d2h["d2h_bytes"] == 0,
          f"algebra: demux: {d2h} before the sinks")
    result["demux"] = {"frames": DEMUX_FRAMES, **d2h,
                       "captures": dregion.captures}

    # (c) pose4's batched heatmaps split back into 4 streams on the card
    net, _, _ = posenet(image_size=POSE_IMAGE, batch=4, dtype=torch.bfloat16,
                        seed=1)
    register_torch_model("pose4_split", _batched4(net))
    srcs = " ".join(
        f"videotestsrc num-buffers={SPLIT_SETS} width={POSE_IMAGE} "
        f"height={POSE_IMAGE} pattern={p} ! tensor_converter ! mux. "
        for p in ("gradient", "black", "ball", "smpte"))
    sinks = "  ".join(f"s.src_{i} ! tensor_sink name=p{i} to-host=false"
                      for i in range(4))
    try:
        pipe = nt.parse_launch(
            "tensor_mux name=mux sync-mode=slowest ! "
            "tensor_filter framework=jax model=pose4_split ! tee name=t  "
            "t. ! tensor_split name=s tensorseg=1,1,1,1 dimension=3  "
            f"{sinks}  t. ! tensor_sink name=full to-host=false  {srcs}",
            pipeline=Pipeline(name="split"))
        x0 = transfer_snapshot()
        check(pipe.run(timeout=180).kind == "eos", "algebra: split")
        x1 = transfer_snapshot()
    finally:
        unregister_torch_model("pose4_split")
    full = [b[0] for b in pipe.get("full").buffers]
    parts = [[b[0] for b in pipe.get(f"p{i}").buffers] for i in range(4)]
    d2h = _d2h(x0, x1)
    check(len(full) == SPLIT_SETS and
          all(len(p) == SPLIT_SETS for p in parts),
          "algebra: split set counts")
    check(all(p[j].is_cuda and torch.equal(p[j], full[j][i:i + 1]) and
              p[j].untyped_storage().data_ptr() ==
              full[j].untyped_storage().data_ptr()
              for i, p in enumerate(parts) for j in range(SPLIT_SETS)),
          "algebra: a split stream is not a view of its slice on the card")
    check(d2h["d2h_events"] == 0 and d2h["d2h_bytes"] == 0,
          f"algebra: split: {d2h} before the sinks")
    result["split"] = {"sets": SPLIT_SETS, "streams": 4, **d2h}

    # (d) tensor_crop of card frames by a custom-easy filter's regions
    def regions(ins):
        f = ins[0]  # the filter hands a host backend numpy arrays
        x, y = int(f[0, 0, 0, 0]) % 200, int(f[0, 0, 1, 0]) % 200
        w, h = 32 + int(f[0, 0, 2, 0]) % 64, 24 + int(f[0, 0, 3, 0]) % 64
        return [np.array([[x, y, w, h], [y, x, h, w]], np.int32)]

    register_custom_easy(
        "crop_regions", regions,
        TensorsInfo.from_str(f"3:{SSD_IMAGE}:{SSD_IMAGE}:1", "uint8"),
        TensorsInfo.from_str("4:2", "int32"))
    crops_in = [rng.integers(0, 256, (1, SSD_IMAGE, SSD_IMAGE, 3),
                             dtype=np.uint8) for _ in range(CROP_FRAMES)]
    try:
        x0 = transfer_snapshot()
        pipe, _ = _pushed_run(
            "crop", f"appsrc name=src max-buffers={CROP_FRAMES + 1} ! "
            "tee name=t  t. ! c.raw  t. ! tensor_filter "
            "framework=custom-easy model=crop_regions ! c.info  "
            "tensor_crop name=c ! tensor_sink name=sink",
            [torch.from_numpy(f).cuda() for f in crops_in])
        x1 = transfer_snapshot()
    finally:
        unregister_custom_easy("crop_regions")
    bufs = list(pipe.get("sink").buffers)
    check([b.pts for b in bufs] == list(range(CROP_FRAMES)),
          f"algebra: crop: {len(bufs)} of {CROP_FRAMES} frames")
    for b in bufs:
        f = crops_in[b.pts]
        want = [f[0, y:y + h, x:x + w] for x, y, w, h in regions([f])[0]]
        check(len(b.tensors) == 2 and all(
            np.array_equal(np.asarray(c), w) for c, w in zip(b.tensors, want)),
            f"algebra: the crops of frame {b.pts} are not its slices")
    result["crop"] = {"frames": CROP_FRAMES, **_d2h(x0, x1)}
    emit({"phase": "algebra", **result})
    return result


def _wait_for(cond, what: str, timeout: float = 60.0) -> None:
    deadline = time.monotonic() + timeout
    while not cond():
        check(time.monotonic() < deadline, f"timed out waiting for {what}")
        time.sleep(0.005)


def _params_on(module) -> set:
    return {str(p.device) for p in module.parameters()}


def _logit_bytes(pipe, sink="sink"):
    import numpy as np

    return [np.ascontiguousarray(np.asarray(b[0])).tobytes()
            for b in pipe.get(sink).buffers]


def phase_refwire(power: str) -> dict:
    """The reference two-port wire, the sparse codec, ``SingleShot`` and
    the pipeline filter on card paths, with the flagship at full width
    (MobileNetV2 1.0, 224×224×3, 1001 classes, bf16, seed 0) and
    ``videotestsrc pattern=ball`` frames (224 distinct, so an ordering
    fault shows).

    (a) ``tensor_query_serversrc wire=nnstreamer caps=<uint8 frame> !
    transform ! filter ! tensor_query_serversink`` serving an appsrc-fed
    ``tensor_query_client wire=nnstreamer``, one frame in flight: 240 of
    240 float32 logits back in order, bit-identical to an in-process
    ``appsrc ! transform ! filter`` with the same fused region, B1 240
    times on the server, the parameters on cuda:0, a client with other
    caps DENYed; frames a second, round-trip p50/p99 and bytes sent a
    frame. (b1) ``tensor_sparse_enc ! tensor_sparse_dec`` before the
    flagship against the same string without them: labels, indices and
    f32 scores bit-identical; the encoded over the dense bytes. (b2) the
    filter's device logits through ``tensor_sparse_enc layout=reference``
    and ``layout=native`` into ``tensor_sparse_dec``: the logits' bytes
    back, one D2H a buffer. (c) ``SingleShot(framework="jax")`` on the
    card: 16 invokes bit-identical to the unfused filter's logits, no B1.
    (d) ``tensor_filter framework=pipeline`` around transform ! filter:
    labels equal to the flat string's, B1 once a frame.

    ``flatbuffers``, ``protobuf`` and ``tensorflow`` are not installed on
    the card's machine, so the flexbuf, protobuf and flatbuf codecs and
    the TFLite backend are held to the JAX package by the CPU tests only
    (``tests/test_torch_codecs.py``, ``tests/test_torch_filter_backends.py``)."""
    import numpy as np
    import torch

    import nnstreamer_tpu_torch as nt
    from nnstreamer_tpu_torch.filters.torch_backend import (
        unregister_torch_model,
    )
    from nnstreamer_tpu_torch.ops import preprocess as pp
    from nnstreamer_tpu_torch.pipeline.pipeline import Pipeline
    from nnstreamer_tpu_torch.query import refwire as R
    from nnstreamer_tpu_torch.single import SingleShot
    from nnstreamer_tpu_torch.tensors.buffer import transfer_snapshot

    print("refwire: the flexbuf, protobuf and flatbuf codecs and the TFLite "
          "backend are held to the JAX package by the CPU tests only "
          "(no flatbuffers, protobuf or tensorflow on this machine)",
          flush=True)
    nt.set_device(None)
    t0 = time.monotonic()
    module, labels = _flagship_model("refwire")
    frames = _ball_frames(REFWIRE_FRAMES, IMAGE)
    check(len({f.tobytes() for f in frames}) == min(REFWIRE_FRAMES, IMAGE),
          "refwire: the ball frames are not 224 distinct ones")
    caps = (f"other/tensors,format=static,num_tensors=1,"
            f"dimensions=3:{IMAGE}:{IMAGE}:1,types=uint8")
    body = ("tensor_transform mode=arithmetic "
            "option=typecast:float32,add:-127.5,div:127.5 ! "
            "tensor_filter framework=jax model=refwire name=filter")
    appsrc = f"appsrc name=src caps={caps} max-buffers={REFWIRE_FRAMES + 1}"
    result = {"gpu": power}
    try:
        # (a) the flagship behind the reference wire
        server = nt.parse_launch(
            f"tensor_query_serversrc name=ss host=127.0.0.1 port=0 "
            f"wire=nnstreamer caps={caps} ! {body} ! "
            "tensor_query_serversink name=sk",
            pipeline=Pipeline(name="refwire_server"))
        server.start()
        try:
            _wait_for(lambda: server.get("sk").sinkpad.caps is not None,
                      "the server's output caps")
            ss = server.get("ss")

            def serve(n, name):
                client = nt.parse_launch(
                    f"{appsrc} ! tensor_query_client name=c wire=nnstreamer "
                    f"host=127.0.0.1 port={ss.port} "
                    f"sink-port={ss.result_port} ! tensor_sink name=sink",
                    pipeline=Pipeline(name=name))
                src, sink = client.get("src"), client.get("sink")
                arrivals = []

                def next_frame(buf):  # one frame in flight
                    arrivals.append(time.monotonic())
                    if len(arrivals) < n:
                        src.push([frames[len(arrivals)]], pts=len(arrivals))
                    else:
                        src.end_of_stream()

                sink.connect(next_frame)
                src.push([frames[0]], pts=0)
                msg = client.run(timeout=300)
                torch.cuda.synchronize()
                check(msg is not None and msg.kind == "eos",
                      f"refwire: {name}: no EOS ({msg})")
                return client, arrivals

            serve(REFWIRE_WARMUP, "refwire_warm")
            pp.reset_launches()
            client, arrivals = serve(REFWIRE_FRAMES, "refwire_client")
            launches = pp.LAUNCHES.get("normalize_chain", 0)
            got = list(client.get("sink").buffers)
            sent = client.get("c").obs_snapshot()["sent_bytes"]
            lat_ms = sorted(x * 1e3 for x in client.get("sink").latencies)
            server_region = _region_of(server, ["tensor_transform",
                                                "tensor_filter"])
            placed = _params_on(server.get("filter").fw._module)
            denied = None
            try:
                R.RefWireClient("127.0.0.1", ss.port,
                                sink_port=ss.result_port,
                                in_caps=caps.replace(f"{IMAGE}:{IMAGE}",
                                                     "112:112"))
            except R.RefWireError as e:
                denied = str(e)
        finally:
            server.stop()
        local = nt.parse_launch(f"{appsrc} ! {body} ! tensor_sink name=sink",
                                pipeline=Pipeline(name="refwire_local"))
        src = local.get("src")
        for i, f in enumerate(frames):
            src.push([f], pts=i)
        src.end_of_stream()
        msg = local.run(timeout=300)
        check(msg is not None and msg.kind == "eos",
              f"refwire: the in-process run ({msg})")
        _region_of(local, ["tensor_transform", "tensor_filter"])
        want = _logit_bytes(local)
        check(len(got) == REFWIRE_FRAMES,
              f"refwire: {len(got)} of {REFWIRE_FRAMES} results came back")
        check([b.pts for b in got] == list(range(REFWIRE_FRAMES)),
              "refwire: the results came back out of order")
        check(all(np.asarray(b[0]).dtype == np.float32 and
                  np.asarray(b[0]).shape == (1, CLASSES) for b in got),
              "refwire: the results are not float32 [1, 1001] logits")
        differ = [i for i, (a, b) in enumerate(zip(_logit_bytes(client),
                                                   want)) if a != b]
        check(not differ, f"refwire: the logits of frames {differ[:10]} "
                          "differ from the in-process run's")
        check(launches == REFWIRE_FRAMES,
              f"refwire: B1 {launches} times on the server for "
              f"{REFWIRE_FRAMES} frames")
        check(placed == {"cuda:0"}, f"refwire: the parameters on {placed}")
        check(denied is not None and "denied" in denied,
              "refwire: a client with other caps was not DENYed")
        result["wire"] = {
            "frames": len(got), "b1_launches": launches,
            "captures": server_region.captures,
            "fps": steady_fps(arrivals, arrivals[-1]),
            "p50_ms": lat_ms[len(lat_ms) // 2],
            "p99_ms": lat_ms[min(len(lat_ms) - 1,
                                 int(0.99 * len(lat_ms)))],
            "sent_bytes_per_frame": sent / REFWIRE_FRAMES,
            "frame_bytes": IMAGE * IMAGE * 3, "params_on": sorted(placed),
            "denied": denied}
        # (b1) the sparse pair before the flagship, from videotestsrc
        ball = (f"videotestsrc num-buffers={REFWIRE_FRAMES} width={IMAGE} "
                f"height={IMAGE} pattern=ball ! tensor_converter")
        tail = _flagship_tail("refwire", labels)
        rows = {}
        for name, desc in (
                ("dense", f"{ball} ! {tail}"),
                ("sparse", f"{ball} ! tensor_sparse_enc ! tee name=e  "
                           "e. ! tensor_sink name=blobs  "
                           f"e. ! tensor_sparse_dec ! {tail}")):
            pipe = nt.parse_launch(desc, pipeline=Pipeline(
                name=f"refwire_{name}"))
            msg = pipe.run(timeout=300)
            check(msg is not None and msg.kind == "eos",
                  f"refwire: {name} ({msg})")
            rows[name] = labelled_frames(
                [b.meta for b in pipe.get("sink").buffers])
            if name == "sparse":
                encoded = sum(np.asarray(b[0]).nbytes
                              for b in pipe.get("blobs").buffers)
        check(len(rows["dense"]) == REFWIRE_FRAMES and
              rows["sparse"] == rows["dense"],
              "refwire: labels through the sparse pair differ from the "
              "dense run's")
        result["sparse_pair"] = {
            "frames": len(rows["sparse"]),
            "encoded_over_dense": encoded / (REFWIRE_FRAMES * IMAGE * IMAGE
                                             * 3)}
        # (b2) the device logits through both layouts
        sparse = {}
        for layout in ("reference", "native"):
            pipe = nt.parse_launch(
                f"{appsrc} ! {body} ! tensor_sparse_enc layout={layout} ! "
                "tensor_sparse_dec ! tensor_sink name=sink",
                pipeline=Pipeline(name=f"refwire_sparse_{layout}"))
            src = pipe.get("src")
            for i, f in enumerate(frames[:REFWIRE_SPARSE_FRAMES]):
                src.push([f], pts=i)
            src.end_of_stream()
            x0 = transfer_snapshot()
            msg = pipe.run(timeout=300)
            d2h = _d2h(x0, transfer_snapshot())
            check(msg is not None and msg.kind == "eos",
                  f"refwire: sparse {layout} ({msg})")
            back = _logit_bytes(pipe)
            check(back == want[:REFWIRE_SPARSE_FRAMES],
                  f"refwire: the logits through layout={layout} are not "
                  "the logits' bytes")
            check(d2h["d2h_events"] == REFWIRE_SPARSE_FRAMES,
                  f"refwire: layout={layout}: {d2h['d2h_events']} D2H "
                  f"events for {REFWIRE_SPARSE_FRAMES} buffers")
            sparse[layout] = {"frames": len(back), **d2h}
        result["sparse_logits"] = sparse
        # (c) SingleShot on the card against the unfused filter
        n = REFWIRE_SINGLE_FRAMES
        unfused = nt.parse_launch(
            f"{appsrc} ! tensor_transform mode=arithmetic "
            "option=typecast:float32,add:-127.5,div:127.5 ! tee name=t  "
            "t. ! tensor_sink name=x  "
            "t. ! tensor_filter framework=jax model=refwire ! "
            "tensor_sink name=sink",
            pipeline=Pipeline(name="refwire_unfused", fuse=False))
        src = unfused.get("src")
        for i, f in enumerate(frames[:n]):
            src.push([f], pts=i)
        src.end_of_stream()
        msg = unfused.run(timeout=300)
        check(msg is not None and msg.kind == "eos",
              f"refwire: the unfused filter ({msg})")
        inputs = [np.asarray(b[0]) for b in unfused.get("x").buffers]
        with SingleShot(framework="jax", model="refwire") as single:
            pp.reset_launches()
            outs = [single.invoke([x])[0] for x in inputs]
            torch.cuda.synchronize()
            single_b1 = pp.LAUNCHES.get("normalize_chain", 0)
            single_placed = _params_on(single.fw._module)
        check(all(isinstance(o, torch.Tensor) and o.is_cuda for o in outs),
              "refwire: SingleShot's outputs are not on the card")
        single_bytes = [o.detach().float().cpu().numpy().tobytes()
                        for o in outs]
        check(single_bytes == _logit_bytes(unfused),
              "refwire: SingleShot's logits differ from the unfused "
              "filter's")
        check(single_placed == {"cuda:0"} and single_b1 == 0,
              f"refwire: SingleShot on {single_placed}, B1 {single_b1}")
        result["single"] = {"invokes": len(outs), "b1_launches": single_b1,
                            "params_on": sorted(single_placed)}
        # (d) the pipeline filter around transform ! filter
        n = REFWIRE_NESTED_FRAMES
        inner = (f"appsrc name=in ! {body} ! tensor_sink name=out")
        flat, _ = _pushed_run("refwire_flat", f"{appsrc} ! {tail}",
                              frames[:n])
        nested = nt.parse_launch(
            f'{appsrc} ! tensor_filter framework=pipeline model="{inner}" '
            f"name=outer ! tensor_decoder mode=image_labeling "
            f"option1={labels} ! tensor_sink name=sink",
            pipeline=Pipeline(name="refwire_nested"))
        nested.start()
        try:
            # caps come from the appsrc at start: the outer filter probes
            # the inner pipeline with one zero frame (one B1) before the
            # counts are reset
            _wait_for(lambda: getattr(nested.get("outer"), "_out_model_info",
                                      None) is not None,
                      "the pipeline filter's negotiation")
            pp.reset_launches()
            src = nested.get("src")
            for i, f in enumerate(frames[:n]):
                src.push([f], pts=i)
            src.end_of_stream()
            msg = nested.wait(timeout=300)
            torch.cuda.synchronize()
            nested_b1 = pp.LAUNCHES.get("normalize_chain", 0)
        finally:
            nested.stop()
        check(msg is not None and msg.kind == "eos",
              f"refwire: the pipeline filter ({msg})")
        flat_rows = labelled_frames([b.meta for b in flat.get("sink").buffers])
        nested_rows = labelled_frames(
            [b.meta for b in nested.get("sink").buffers])
        check(len(nested_rows) == n and
              [r[:2] for r in nested_rows] == [r[:2] for r in flat_rows],
              "refwire: the pipeline filter's labels differ from the flat "
              "string's")
        check(nested_b1 == n,
              f"refwire: the pipeline filter ran B1 {nested_b1} times for "
              f"{n} frames")
        result["nested"] = {
            "frames": len(nested_rows), "b1_launches": nested_b1,
            "scores_equal": sum(a == b for a, b in zip(nested_rows,
                                                       flat_rows))}
    finally:
        unregister_torch_model("refwire")
    result["seconds"] = time.monotonic() - t0
    emit({"phase": "refwire", **result})
    return result


def _closed_port() -> int:
    """A loopback port with nothing listening on it."""
    import socket

    probe = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    probe.bind(("127.0.0.1", 0))
    port = probe.getsockname()[1]
    probe.close()
    return port


class _MockSntp:
    """A loopback SNTP server whose clock runs ``offset_ns`` ahead of the
    host's; it answers every request until :meth:`close`."""

    def __init__(self, offset_ns: int):
        import socket
        import threading

        self.offset_ns = offset_ns
        self.requests = 0
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self._sock.bind(("127.0.0.1", 0))
        self._sock.settimeout(0.2)
        self.port = self._sock.getsockname()[1]
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self) -> None:
        import socket
        import struct

        from nnstreamer_tpu_torch.query.ntp import _to_ntp

        while not self._stop.is_set():
            try:
                data, addr = self._sock.recvfrom(512)
            except socket.timeout:
                continue
            except OSError:
                return
            recv = _to_ntp(time.time_ns() + self.offset_ns)
            xmit = _to_ntp(time.time_ns() + self.offset_ns)
            self.requests += 1
            # LI=0 VN=4 Mode=4 (server); the originate field echoes the
            # client's transmit stamp
            self._sock.sendto(struct.pack(
                ">B3x11I", 0x24, 0, 0, 0, 0, 0,
                *struct.unpack_from(">2I", data, 40), *recv, *xmit), addr)

    def close(self) -> None:
        self._stop.set()
        self._thread.join(timeout=5)
        self._sock.close()


def _quantiles_ms(values_ms):
    s = sorted(values_ms)
    return s[len(s) // 2], s[min(len(s) - 1, int(0.99 * len(s)))]


def phase_pubsub(power: str) -> dict:
    """Broker discovery and MQTT tensor streams with the flagship at full
    width (MobileNetV2 1.0, 224×224×3, 1001 classes, bf16, seed 0) on
    ``videotestsrc pattern=ball`` frames.

    (a) ``tensor_query_serversrc operation=classify broker-host=
    mqtt://127.0.0.1 ... ! transform ! filter ! tensor_query_serversink``
    advertises itself through an in-process ``MqttBroker`` after a ghost
    ad that names a closed port; an appsrc-fed ``tensor_query_client
    operation=classify`` finds both, walks past the ghost and gets 240 of
    240 float32 logits back in order, one frame in flight, bit-identical to
    an in-process run with the same fused region; B1 240 times on the
    server, the parameters on cuda:0. Again over the shim ``Broker`` with
    32 frames. (b) an int8 camera stream: ``videotestsrc ! tensor_converter
    ! queue prefetch-device=true ! tensor_quant_enc ! mqttsink`` (B3 on the
    card) into ``mqttsrc ! tensor_quant_dec ! transform ! filter !
    image_labeling`` (B1), subscribed first: 240 labels, indices and f32
    scores bit-identical to ``tensor_quant_enc ! tensor_quant_dec`` in one
    process, B3 240 and B1 240, each payload (read by a plain
    ``MqttClient``) a reference ``GstMQTTMessageHdr`` with one memory of
    the blob's length and a caps string, the subscriber's pts the
    publisher's shifted by the difference of the base epochs; frames a
    second, one-way latency from the header's send stamp, bytes a frame;
    the flagship's logits of 16 frames, on the card, into ``mqttsink``:
    fetched once a buffer and published byte for byte. (c) both elements with ``ntp-server=`` on a loopback SNTP server 3 s
    ahead, 16 frames: the offset measured within 200 ms of 3 s, not fallen
    back to the local clock, the pts rebased by (b)'s rule."""
    import struct

    import numpy as np
    import torch

    import nnstreamer_tpu_torch as nt
    from nnstreamer_tpu_torch.filters.torch_backend import (
        unregister_torch_model,
    )
    from nnstreamer_tpu_torch.ops._counts import LAUNCHES, reset_launches
    from nnstreamer_tpu_torch.pipeline.pipeline import Pipeline
    from nnstreamer_tpu_torch.query import mqtt as M
    from nnstreamer_tpu_torch.query import ntp
    from nnstreamer_tpu_torch.query.discovery import (
        ServerAdvertiser,
        ServerDiscovery,
    )
    from nnstreamer_tpu_torch.query.pubsub import Broker
    from nnstreamer_tpu_torch.tensors.buffer import transfer_snapshot
    from nnstreamer_tpu_torch.tensors.meta import HEADER_SIZE

    nt.set_device(None)
    t0 = time.monotonic()
    # the classic serversrc's caps carry no shapes: the model declares them
    _, labels = _flagship_model("pubsub", declare_io=True)
    frames = _ball_frames(PUBSUB_FRAMES, IMAGE)
    caps = (f"other/tensors,format=static,num_tensors=1,"
            f"dimensions=3:{IMAGE}:{IMAGE}:1,types=uint8")
    body = ("tensor_transform mode=arithmetic "
            "option=typecast:float32,add:-127.5,div:127.5 ! "
            "tensor_filter framework=jax model=pubsub name=filter")
    appsrc = f"appsrc name=src caps={caps} max-buffers={PUBSUB_FRAMES + 1}"
    mqtt = M.MqttBroker()
    shim = Broker(port=0).start()
    result = {"gpu": power}
    try:
        local = nt.parse_launch(f"{appsrc} ! {body} ! tensor_sink name=sink",
                                pipeline=Pipeline(name="pubsub_local"))
        src = local.get("src")
        for i, f in enumerate(frames):
            src.push([f], pts=i)
        src.end_of_stream()
        msg = local.run(timeout=300)
        check(msg is not None and msg.kind == "eos",
              f"pubsub: the in-process run ({msg})")
        _region_of(local, ["tensor_transform", "tensor_filter"])
        want = _logit_bytes(local)

        def discovered(broker_host, broker_port, n, name, warm):
            """(a): the flagship found by operation= through a broker."""
            ghost_port = _closed_port()
            ghost = ServerAdvertiser(broker_host, broker_port, "classify",
                                     "127.0.0.1", ghost_port)
            ghost.publish()
            server = nt.parse_launch(
                "tensor_query_serversrc name=ss host=127.0.0.1 port=0 "
                f"operation=classify broker-host={broker_host} "
                f"broker-port={broker_port} ! {body} ! "
                "tensor_query_serversink name=sk",
                pipeline=Pipeline(name=f"{name}_server"))
            server.start()
            try:
                disco = ServerDiscovery(broker_host, broker_port, "classify")
                found = disco.wait_servers(timeout=10)
                disco.close()

                def serve(count, cname):
                    client = nt.parse_launch(
                        f"{appsrc} ! tensor_query_client name=c "
                        f"operation=classify broker-host={broker_host} "
                        f"broker-port={broker_port} timeout=30 max-retry=2 "
                        "! tensor_sink name=sink",
                        pipeline=Pipeline(name=cname))
                    src, sink = client.get("src"), client.get("sink")
                    arrivals = []

                    def next_frame(buf):  # one frame in flight
                        arrivals.append(time.monotonic())
                        if len(arrivals) < count:
                            src.push([frames[len(arrivals)]],
                                     pts=len(arrivals))
                        else:
                            src.end_of_stream()

                    sink.connect(next_frame)
                    src.push([frames[0]], pts=0)
                    msg = client.run(timeout=300)
                    torch.cuda.synchronize()
                    check(msg is not None and msg.kind == "eos",
                          f"pubsub: {cname}: no EOS ({msg})")
                    return client, arrivals

                if warm:
                    serve(warm, f"{name}_warm")
                reset_launches()
                client, arrivals = serve(n, f"{name}_client")
                b1 = LAUNCHES.get("normalize_chain", 0)
                got = list(client.get("sink").buffers)
                lat_ms = [x * 1e3 for x in client.get("sink").latencies]
                region = _region_of(server, ["tensor_transform",
                                             "tensor_filter"])
                placed = _params_on(server.get("filter").fw._module)
                live = ("127.0.0.1", server.get("ss").port)
            finally:
                server.stop()
                ghost.retract()
            check(sorted(found) == sorted([("127.0.0.1", ghost_port), live]),
                  f"pubsub: {name}: discovered {found}")
            check(client.get("c")._server_idx == 1,
                  f"pubsub: {name}: the client did not walk past the ghost "
                  f"ad (server index {client.get('c')._server_idx})")
            check(len(got) == n,
                  f"pubsub: {name}: {len(got)} of {n} results came back")
            check([b.pts for b in got] == list(range(n)),
                  f"pubsub: {name}: the results came back out of order")
            check(all(np.asarray(b[0]).dtype == np.float32 and
                      np.asarray(b[0]).shape == (1, CLASSES) for b in got),
                  f"pubsub: {name}: the results are not float32 [1, 1001] "
                  "logits")
            differ = [i for i, (a, b) in enumerate(zip(_logit_bytes(client),
                                                       want)) if a != b]
            check(not differ, f"pubsub: {name}: the logits of frames "
                              f"{differ[:10]} differ from the in-process "
                              "run's")
            check(b1 == n, f"pubsub: {name}: B1 {b1} times on the server "
                           f"for {n} frames")
            check(placed == {"cuda:0"},
                  f"pubsub: {name}: the parameters on {placed}")
            p50, p99 = _quantiles_ms(lat_ms)
            return {"frames": len(got), "b1_launches": b1,
                    "captures": region.captures, "discovered": len(found),
                    "ghost_skipped": True,
                    "fps": steady_fps(arrivals, arrivals[-1]),
                    "p50_ms": p50, "p99_ms": p99,
                    "params_on": sorted(placed)}

        result["discovery_mqtt"] = discovered(
            "mqtt://127.0.0.1", mqtt.port, PUBSUB_FRAMES, "pubsub_mqtt",
            PUBSUB_WARMUP)
        result["discovery_shim"] = discovered(
            "127.0.0.1", shim.port, PUBSUB_SHIM_FRAMES, "pubsub_shim", 0)

        def stream(topic, n, name, ntp_server=None):
            """(b): the int8 camera stream through the MQTT broker, with a
            plain client tapping the topic; with ``ntp_server`` (c), both
            elements SNTP-corrected by it."""
            ntp_opt = f"ntp-server={ntp_server}" if ntp_server else ""
            tap_rx = []
            tap = M.MqttClient(port=mqtt.port)
            tap.subscribe(topic, lambda t, p: tap_rx.append(
                (time.time_ns(), p)))
            sub = nt.parse_launch(
                f"mqttsrc name=src broker=mqtt://127.0.0.1:{mqtt.port} "
                f"sub-topic={topic} num-buffers={n} {ntp_opt} ! "
                f"tensor_quant_dec ! {_flagship_tail('pubsub', labels)}",
                pipeline=Pipeline(name=f"{name}_sub"))
            sink_rx = []
            sub.get("sink").connect(lambda b: sink_rx.append(time.time_ns()))
            started_ns = time.time_ns()
            sub.start()  # subscribed (SUBACK) before the publisher plays
            try:
                pub = nt.parse_launch(
                    f"videotestsrc num-buffers={n} width={IMAGE} "
                    f"height={IMAGE} pattern=ball ! tensor_converter ! "
                    "queue prefetch-device=true ! tensor_quant_enc ! "
                    f"mqttsink name=snk broker=mqtt://127.0.0.1:{mqtt.port} "
                    f"pub-topic={topic} {ntp_opt}",
                    pipeline=Pipeline(name=f"{name}_pub"))
                reset_launches()
                msg = pub.run(timeout=300)
                check(msg is not None and msg.kind == "eos",
                      f"pubsub: {name}: the publisher ({msg})")
                msg = sub.wait(timeout=300)
                torch.cuda.synchronize()
                launches = dict(LAUNCHES)
                check(msg is not None and msg.kind == "eos",
                      f"pubsub: {name}: the subscriber ({msg})")
                _wait_for(lambda: len(tap_rx) >= n, f"{name}'s tap", 30)
            finally:
                sub.stop()
                tap.close()
            rows = labelled_frames([b.meta for b in sub.get("sink").buffers])
            headers = [M.parse_gst_mqtt_message(p) for _, p in tap_rx]
            check(len(rows) == n and len(headers) == n,
                  f"pubsub: {name}: {len(rows)} labels and {len(headers)} "
                  f"payloads for {n} frames")
            for (_, p), h in zip(tap_rx, headers):
                (num_mems,) = struct.unpack_from("<I", p, 0)
                (size0,) = struct.unpack_from("<Q", p, 8)
                check(num_mems == 1 and len(h["mems"]) == 1 and
                      size0 == len(p) - M.GST_MQTT_LEN_MSG_HDR and
                      h["caps_str"] and
                      h["mems"][0][HEADER_SIZE:HEADER_SIZE + 4] == b"NQT1",
                      f"pubsub: {name}: a payload is not one NQT1 blob "
                      "behind a GstMQTTMessageHdr")
            diff = sub.get("src")._base_epoch - pub.get("snk")._base_epoch
            sub_pts = [b.pts for b in sub.get("sink").buffers]
            check(sub_pts == [h["pts"] - diff for h in headers],
                  f"pubsub: {name}: the subscriber's pts are not the "
                  "publisher's shifted by the difference of the base "
                  "epochs")
            check(launches.get("quantize_int8", 0) == n and
                  launches.get("normalize_chain", 0) == n,
                  f"pubsub: {name}: launches {launches} for {n} frames")
            # the send stamps are on the corrected clock: read the arrivals
            # on it too
            clock = 0
            if ntp_server:
                host, _, port = ntp_server.partition(":")
                clock = ntp._cache.get(((host, int(port)),))
                check(isinstance(clock, int),
                      f"pubsub: {name}: corrected_epoch_ns fell back to "
                      "the local clock")
            hop_ms = [(rx + clock - h["sent_time_epoch"]) / 1e6
                      for (rx, _), h in zip(tap_rx, headers)]
            e2e_ms = [(rx + clock - h["sent_time_epoch"]) / 1e6
                      for rx, h in zip(sink_rx, headers)]
            span_s = (sink_rx[-1] - sink_rx[0]) / 1e9
            return {
                "rows": rows, "started_ns": started_ns,
                "src_base": sub.get("src")._base_epoch,
                "sink_base": pub.get("snk")._base_epoch,
                "out": {
                    "frames": len(rows),
                    "b3_launches": launches.get("quantize_int8", 0),
                    "b1_launches": launches.get("normalize_chain", 0),
                    "fps": (n - 1) / span_s if span_s > 0 else None,
                    "hop_p50_ms": _quantiles_ms(hop_ms)[0],
                    "hop_p99_ms": _quantiles_ms(hop_ms)[1],
                    "e2e_p50_ms": _quantiles_ms(e2e_ms)[0],
                    "e2e_p99_ms": _quantiles_ms(e2e_ms)[1],
                    "payload_bytes": statistics.mean(len(p)
                                                     for _, p in tap_rx),
                    "blob_bytes": len(headers[0]["mems"][0]),
                    "f32_frame_bytes": IMAGE * IMAGE * 3 * 4,
                    "caps_str": headers[0]["caps_str"],
                    "base_epoch_diff_ns": diff}}

        ref = nt.parse_launch(
            f"videotestsrc num-buffers={PUBSUB_FRAMES} width={IMAGE} "
            f"height={IMAGE} pattern=ball ! tensor_converter ! "
            "queue prefetch-device=true ! tensor_quant_enc ! "
            f"tensor_quant_dec ! {_flagship_tail('pubsub', labels)}",
            pipeline=Pipeline(name="pubsub_codec"))
        msg = ref.run(timeout=300)
        check(msg is not None and msg.kind == "eos",
              f"pubsub: the in-process codec run ({msg})")
        want_rows = labelled_frames([b.meta for b in ref.get("sink").buffers])
        cam = stream("cam0", PUBSUB_FRAMES, "pubsub_cam")
        check(len(want_rows) == PUBSUB_FRAMES and cam["rows"] == want_rows,
              "pubsub: the camera stream's labels differ from the "
              "in-process encode/decode's")
        result["stream"] = cam["out"]
        # the flagship's logits, computed on the card, into mqttsink: one
        # fetch a buffer (an uploaded frame would be fetched from its host
        # view, with no copy)
        n = PUBSUB_DEVICE_FRAMES
        dev_rx = []
        tap = M.MqttClient(port=mqtt.port)
        tap.subscribe("dev0", lambda t, p: dev_rx.append(p))
        dev = nt.parse_launch(
            f"{appsrc} ! {body} ! mqttsink "
            f"broker=mqtt://127.0.0.1:{mqtt.port} pub-topic=dev0",
            pipeline=Pipeline(name="pubsub_device"))
        src = dev.get("src")
        for i, f in enumerate(frames[:n]):
            src.push([f], pts=i)
        src.end_of_stream()
        x0 = transfer_snapshot()
        msg = dev.run(timeout=300)
        d2h = _d2h(x0, transfer_snapshot())
        try:
            check(msg is not None and msg.kind == "eos",
                  f"pubsub: the logits into mqttsink ({msg})")
            _wait_for(lambda: len(dev_rx) >= n, "the logits' tap", 30)
        finally:
            tap.close()
        dev_headers = [M.parse_gst_mqtt_message(p) for p in dev_rx]
        check([h["mems"] for h in dev_headers] == [[w] for w in want[:n]]
              and [h["pts"] for h in dev_headers] == list(range(n)),
              "pubsub: mqttsink did not publish the logits' bytes")
        check(d2h["d2h_events"] == n,
              f"pubsub: mqttsink: {d2h['d2h_events']} D2H events for {n} "
              "buffers of logits on the card")
        result["device_sink"] = {"frames": n, **d2h}
        # (c) both sides SNTP-corrected by a server 3 s ahead
        ntp.reset_offset_cache()
        sntp = _MockSntp(PUBSUB_NTP_OFFSET_NS)
        try:
            ntp_cam = stream("cam1", PUBSUB_NTP_FRAMES, "pubsub_ntp",
                             f"127.0.0.1:{sntp.port}")
        finally:
            sntp.close()
        offset = ntp._cache.get((("127.0.0.1", sntp.port),))
        check(offset is not None and offset is not ntp._FAILED,
              "pubsub: ntp: corrected_epoch_ns fell back to the local clock")
        check(abs(offset - PUBSUB_NTP_OFFSET_NS) < PUBSUB_NTP_TOL_NS,
              f"pubsub: ntp: measured offset {offset} ns")
        base_vs_local = ntp_cam["src_base"] - ntp_cam["started_ns"]
        check(abs(base_vs_local - PUBSUB_NTP_OFFSET_NS) < PUBSUB_NTP_TOL_NS,
              f"pubsub: ntp: the subscriber's base epoch is {base_vs_local} "
              "ns ahead of the local clock")
        check(ntp_cam["rows"] == want_rows[:PUBSUB_NTP_FRAMES],
              "pubsub: ntp: the labels differ from the in-process run's")
        ntp.reset_offset_cache()
        result["ntp"] = {"offset_ns": offset, "requests": sntp.requests,
                         "src_base_vs_local_ns": base_vs_local,
                         **ntp_cam["out"]}
    finally:
        shim.stop()
        mqtt.close()
        unregister_torch_model("pubsub")
    result["seconds"] = time.monotonic() - t0
    emit({"phase": "pubsub", **result})
    return result


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
    arm_compile_cache()
    phase_build()
    b1, timed_b1 = phase_normalize()
    b2, timed_b2 = phase_flash_attention()
    b3, timed_b3 = phase_quantize()
    lm, lm_engine, lm_tokens = phase_lm_serving(power)
    _, fp32_engine, fp32_tokens = phase_lm_parity(lm_engine)
    phase_lm_query(power, lm_engine, fp32_engine, lm_tokens)
    lm_slo = phase_lm_slo(power, fp32_tokens)
    lm_graph, lm_eager = phase_lm_graph(power, lm_engine, fp32_engine,
                                        fp32_tokens)
    lm_kv = phase_lm_kv_int8(power, fp32_tokens)
    lm_prefix = phase_lm_prefix_chunk(power)
    lm_paged = phase_lm_paged(power)
    lm_spec = phase_lm_spec(power)
    lm_sampled = phase_lm_sampled(power, lm["K"])
    phase_lm_decode(power)
    phase_beam(power)
    lm_mem = phase_lm_memory(power)
    offload = phase_query_offload(power)
    batched, batched_launch = phase_pipeline_batched(power)
    uncut = phase_pipeline_uncut(power)
    slo = phase_pipeline_slo(power)
    flight = phase_flight(power)
    qos = phase_qos(power)
    ssd, ssd_pipe = phase_ssd(power)
    yolo = phase_yolo(power)
    pose4, pose4_pipe = phase_pose4(power)
    phase_lstm(power)
    seg, seg_pipe = phase_segment(power)
    audio, audio_pipe = phase_audio(power)
    files = phase_files(power)
    algebra = phase_algebra(power)
    refwire = phase_refwire(power)
    pubsub = phase_pubsub(power)
    mem = phase_memory(power)
    cont = phase_continuity(power)
    pipe, _ = phase_pipeline(power)  # profiles the flagship at its end
    profile_pipeline_batched(batched, batched_launch)
    profile_lm(lm_engine, lm_eager)
    profile_restarted("ssd", ssd_pipe, "ssd", PROFILED_FRAMES, ssd["fps"],
                      power)
    profile_restarted("pose4", pose4_pipe, "pose4", PROFILED_FRAMES // 4,
                      pose4["fps"], power)
    profile_restarted("segment", seg_pipe, "seg", PROFILED_FRAMES,
                      seg["fps"], power)
    # the aggregator starts empty: 10 chunks for the first window, then 5
    # (a 0.5 s hop) for each further one
    profile_restarted("audio", audio_pipe, "kws",
                      (KWS_SAMPLES + (PROFILED_FRAMES - 1) * KWS_HOP) //
                      KWS_CHUNK,
                      audio["windows_per_s"], power, units=PROFILED_FRAMES)
    dev_b1 = phase_device_times("normalize_chain", {
        tag: {"": kernel, "plain_": plain}
        for tag, (kernel, plain) in timed_b1.items()})
    dev_b2 = phase_device_times("flash_attention", timed_b2)
    dev_b3 = phase_device_times("quantize_int8", timed_b3)
    frame_tag = "x".join(str(n) for n in QUANT_TIMED[0])
    phase_one_launch()
    # a new process on the card: last, after every profiled run (after it
    # the parent's torch.profiler traces began to lose device events)
    phase_cli(power)
    for mod in ("jax", "nnstreamer_tpu"):
        check(mod not in sys.modules, f"{mod} was imported")
    emit(phase_seconds())
    prefill_tag = "x".join(str(n) for n in FLASH_TIMED[0])
    prefill = b2["timed_bf16_causal"][prefill_tag]
    frame_q = b3["timed_f32"][frame_tag]
    emit({"kernels": [{
        "name": "normalize_chain",
        "route": "cuda",
        "source": "nnstreamer_tpu_torch/csrc/normalize.cu",
        "replaces": "nnstreamer_tpu/ops/preprocess.py:52",
        "launches": pipe["launches"]["normalize_chain"],
        # the batched flagship: once a window of 8 frames
        "launches_batched": batched["launches"]["normalize_chain"],
        # bench.py's string with no cuts: once a window the region took
        "launches_uncut": uncut["bench_string"]["launches"],
        # the same string under the SLO scheduler, the flight recorder's
        # dump run, and the QoS run (once a frame the region ran)
        "launches_slo": slo["scheduled"]["launches"],
        "launches_flight": flight["dump"]["launches"],
        "launches_qos": qos["launches"],
        # bench.py's ssd string (once a frame, 800 frames), the segmenter
        # (240 frames) and YOLO (16 frames), each through its fused region
        "launches_ssd": ssd["launches"],
        "launches_segment": seg["launches"],
        "launches_yolo": yolo["launches"],
        # the two models time-sharing under the HBM budget (once a window
        # a region), the OOM ladder's run, and the weights-only swap
        "launches_memory": mem["b1_launches"],
        "launches_memory_oom": mem["oom"]["b1_launches"],
        "launches_continuity": cont["swap"]["b1_launches"],
        # the audio path (once a window, 159 windows), the file sources
        # (once a frame, 240 frames each) and the tensor_if gate (once a
        # frame it passed)
        "launches_audio": audio["launches"],
        "launches_files": [files[k]["launches"]
                           for k in ("multifilesrc", "filesrc")],
        "launches_gate": algebra["gate"]["b1_launches"],
        # the flagship behind the reference wire (once a frame on the
        # server, 240 frames) and inside the pipeline filter (64 frames)
        "launches_refwire": refwire["wire"]["b1_launches"],
        "launches_refwire_nested": refwire["nested"]["b1_launches"],
        # the flagship found by operation= over MQTT (once a frame on the
        # server, 240 frames) and the subscriber of the int8 camera stream
        # over MQTT (once a frame, 240 frames)
        "launches_pubsub_discovery": pubsub["discovery_mqtt"]["b1_launches"],
        "launches_pubsub_stream": pubsub["stream"]["b1_launches"],
        # B1 at the audio window (int16 [16000, 1] -> float32, / 32768)
        "kws_ms": b1["kws_ms"],
        "kws_device_ms": dev_b1["kws_device_ms"],
        "kws_plain_ms": b1["kws_plain_ms"],
        "kws_plain_device_ms": dev_b1["kws_plain_device_ms"],
        "kws_bound_ms": b1["kws_bound_ms"],
        "kws_bound_by": b1["kws_bound_by"],
        # B1 at the ssd frame (one 300x300x3 uint8 frame -> float32)
        "ssd_ms": b1["ssd_ms"],
        "ssd_plain_ms": b1["ssd_plain_ms"],
        "ssd_bound_ms": b1["ssd_bound_ms"],
        "max_abs_err": b1["max_abs_err"],
        "ms": b1["ms"],
        "device_ms": dev_b1["device_ms"],
        "plain_ms": b1["plain_ms"],
        "bound_ms": b1["bound_ms"],
        "bound_by": b1["bound_by"],
        "library_ms": None,
    }, {
        "name": "flash_attention",
        "route": "cuda",
        "source": "nnstreamer_tpu_torch/csrc/flash_attention.cu",
        "replaces": "nnstreamer_tpu/ops/flash_attention.py:130",
        "launches": lm["launches"]["flash_attention"],
        # the engine under an SLO budget: the first burst's prefills
        "launches_lm_slo": lm_slo["flash_launches"],
        # the captured engine against the eager one, the int8 cache, and
        # the prefix cache with chunked prefill (B2 once a layer of each
        # bucketed prefill; a prefix hit or a chunk runs none)
        "launches_lm_graph": lm_graph["flash_launches"],
        "launches_lm_kv_int8": lm_kv["flash_launches"],
        "launches_lm_prefix": lm_prefix["flash_launches"],
        # the paged cache (bench.py's lm load, fp32 parity, a starved
        # pool) and speculation (the decoder's and the engines' target
        # prefills; the draft's prefill is plain)
        "launches_lm_paged": lm_paged["flash_launches"],
        "launches_lm_spec": lm_spec["flash_launches"],
        # 8 × the cold prefills of the two measured sampled runs (the
        # warm-up prompts come before the counts are reset)
        "launches_lm_sampled": lm_sampled["flash_launches"],
        # the paged engine under the HBM accountant: layers × cold prefills
        "launches_lm_memory": lm_mem["flash_launches"],
        "max_abs_err": b2["max_abs_err"],
        "ms": prefill["ms"],
        "device_ms": dev_b2[f"{prefill_tag}_device_ms"],
        "plain_ms": prefill["plain_ms"],
        "bound_ms": prefill["bound_ms"],
        "bound_by": prefill["bound_by"],
        "library_ms": prefill["library_ms"],
    }, {
        "name": "quantize_int8",
        "route": "cuda",
        "source": "nnstreamer_tpu_torch/csrc/quantize.cu",
        "replaces": "nnstreamer_tpu/ops/quantize.py:84",
        # the offload path runs the kernel's nearest mode (the JAX
        # reference arithmetic, the codec's); dither_ms and dither_plain_ms
        # time dither mode, the counterpart of the TPU kernel bodies
        "mode": "nearest",
        "launches": offload["launches"]["quantize_int8"],
        # the publisher of the int8 camera stream over MQTT (once a frame)
        "launches_pubsub": pubsub["stream"]["b3_launches"],
        "max_abs_err": b3["max_abs_err"],
        "ms": frame_q["ms"],
        "device_ms": dev_b3[f"{frame_tag}_device_ms"],
        "dither_ms": frame_q["dither_ms"],
        "dither_plain_ms": frame_q["dither_plain_ms"],
        "plain_ms": frame_q["plain_ms"],
        "bound_ms": frame_q["bound_ms"],
        "bound_by": frame_q["bound_by"],
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
