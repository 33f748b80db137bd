"""Published peaks of one NVIDIA H100 SXM (80 GB HBM3), dense rates
without sparsity, at the full 700 W power limit (NVIDIA's data sheet). A
card set below 700 W runs slower under load: every result line carries
the card's ``power.limit`` beside these shares."""

#: FLOP/s by compute dtype (tensor cores, except ``float32``: CUDA cores)
FLOPS = {
    "bfloat16": 989e12,
    "float16": 989e12,
    "float8": 1979e12,
    "tf32": 495e12,
    "float32": 67e12,
}

#: HBM bandwidth, bytes/s
HBM_BYTES_PER_S = 3.35e12
