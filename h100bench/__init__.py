"""The benchmark of ``nnstreamer_tpu_torch`` on one NVIDIA H100.

One command runs one cell of ``BENCHMARK.json`` once, from the root of a
checkout::

    python3 -m h100bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything the benchmark measures with is here and is found by name:

- ``configs/<config>.json`` (sizes, dtype, source, ``reduced``, limits of
  the output check) and ``configs/<config>.py`` (the port's model with the
  benchmark's weights, its part of the launch string, its answers at the
  sink, its FLOP count a frame);
- ``traffic/<mix>.json``: the parameters that ``traffic.py`` turns into
  a launch string around the model and a stream of frames;
- ``metrics/<metric>.py``: one reader a per-layer metric;
- ``reference/<config>.py``: the plain PyTorch reference, the judge of
  what the sink received, and the lower-precision control;
- ``counts/<kernel>.py``: a kernel's operations and bytes from shapes.

The benchmark imports neither JAX nor the JAX package; the reference
imports nothing of the port.
"""
