// Kernel B3: per-tensor absmax int8 quantize, nearest or dithered.
//
// Replaces the TPU kernels nnstreamer_tpu/ops/quantize.py::_quant_kernel_prng
// (dither from the TPU core's PRNG, launched by _quantize_2d at :84) and
// ::_quant_kernel_dither (the same rounding with the dither streamed in, :76),
// and the absmax reduction that the JAX wrapper runs outside them (:116).
// Two kernels on one stream, with no host round trip between them:
//
//   1. absmax: each thread keeps the max of |f32(x)| as f32 bits in an
//      unsigned; warp and block reductions, then one atomicMax per block into
//      a device word the entry point zeroes first. Non-negative floats order
//      as their bits, so the max is exact, and a NaN (bits above +inf) wins,
//      as np.max propagates it. A NaN in x makes every q 0, an inf makes the
//      finite elements' q 0, as XLA's and numpy's int8 casts of NaN give.
//   2. quantize: every block forms scale = max(absmax / 127, 1e-30) from the
//      word; block 0 writes it.
//        nearest: q = clamp(rint(x / scale), -127, 127) -- the JAX reference
//                 (quantize.py:29-34) and the tensor_quant_enc codec;
//        dither:  s = clamp(x * (1 / scale), -127, 127),
//                 q = clamp(rint(s + d), -127, 127), d = f32(int32(bits)) * 2^-32
//                 (quantize.py:48-57), the bits from Philox4x32-10 with key
//                 (seed lo, seed hi) and counter (i/4 lo, i/4 hi, 0, 0): word
//                 i%4 for element i. The bits depend on the element's index
//                 only, not on the grid (the TPU seeds its PRNG with seed +
//                 program_id, whose bits no other device reproduces).
//
// Inputs are converted to f32 as numpy's astype(float32) converts them
// (__double2float_rn, __ll2float_rn, __int2float_rn). Round-to-nearest
// intrinsics keep the compiler from contracting into FMAs; do not build this
// file with --use_fast_math. The results are bit-identical to the plain
// PyTorch versions in nnstreamer_tpu_torch/ops/quantize.py.
//
// Bound: memory. The function reads x once and writes q and the scale,
// n*sizeof(T) + n + 4 bytes; the two passes read x twice (the second time
// from L2 when x fits in its 50 MB). A 224x224x3 f32 frame is 0.6 MB, so
// launch latency sets its time. Design: grid-stride loops of 256 threads, at
// most one wave of blocks (132 SMs x 8); 16 elements a thread through 16-byte
// vector loads and one 16-byte int8 store when x and q are 16-byte aligned;
// otherwise, and for the ragged tail, groups of 4 elements with scalar loads
// (one Philox call per group). No padding is needed.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// dtype codes shared with nnstreamer_tpu_torch/ops/quantize.py
enum {
  DT_U8 = 0, DT_I8 = 1, DT_I16 = 2, DT_I32 = 3, DT_I64 = 4,
  DT_F16 = 5, DT_BF16 = 6, DT_F32 = 7, DT_F64 = 8
};

#define NNS_THREADS 256
#define NNS_MAX_BLOCKS 1056  // one wave: 132 SMs x 8 blocks of 256 threads

// -- conversion to f32, as numpy's astype(float32) ---------------------------
__device__ __forceinline__ float to_f32(uint8_t v) { return static_cast<float>(v); }
__device__ __forceinline__ float to_f32(int8_t v) { return static_cast<float>(v); }
__device__ __forceinline__ float to_f32(int16_t v) { return static_cast<float>(v); }
__device__ __forceinline__ float to_f32(int32_t v) { return __int2float_rn(v); }
__device__ __forceinline__ float to_f32(long long v) { return __ll2float_rn(v); }
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(double v) { return __double2float_rn(v); }

// 16 elements of T are sizeof(T) 16-byte vectors
template <typename T>
__device__ __forceinline__ void load16(const T* p, float (&f)[16]) {
  uint4 raw[sizeof(T)];
#pragma unroll
  for (int j = 0; j < static_cast<int>(sizeof(T)); ++j) {
    raw[j] = reinterpret_cast<const uint4*>(p)[j];
  }
  const T* e = reinterpret_cast<const T*>(raw);
#pragma unroll
  for (int i = 0; i < 16; ++i) f[i] = to_f32(e[i]);
}

__device__ __forceinline__ unsigned abs_bits(float v) {
  return __float_as_uint(v) & 0x7fffffffu;
}

__device__ __forceinline__ unsigned max_bits(unsigned a, unsigned b) {
  return a > b ? a : b;
}

// -- pass 1: absmax ----------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(NNS_THREADS)
absmax_kernel(const T* __restrict__ x, long long n, long long nvec,
              unsigned* __restrict__ word) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long tid =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  unsigned m = 0u;
  for (long long v = tid; v < nvec; v += stride) {
    float f[16];
    load16(x + 16 * v, f);
#pragma unroll
    for (int i = 0; i < 16; ++i) m = max_bits(m, abs_bits(f[i]));
  }
  for (long long i = 16 * nvec + tid; i < n; i += stride) {
    m = max_bits(m, abs_bits(to_f32(x[i])));
  }
  m = __reduce_max_sync(0xffffffffu, m);
  __shared__ unsigned warp_max[NNS_THREADS / 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) warp_max[warp] = m;
  __syncthreads();
  if (warp == 0) {
    m = lane < static_cast<int>(blockDim.x >> 5) ? warp_max[lane] : 0u;
    m = __reduce_max_sync(0xffffffffu, m);
    if (lane == 0 && m != 0u) atomicMax(word, m);
  }
}

// -- Philox4x32-10 (Salmon et al., SC'11; the Random123 constants) ---------
__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint2 k) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k.x += 0x9E3779B9u;
      k.y += 0xBB67AE85u;
    }
    const unsigned lo0 = 0xD2511F53u * c.x;
    const unsigned hi0 = __umulhi(0xD2511F53u, c.x);
    const unsigned lo1 = 0xCD9E8D57u * c.z;
    const unsigned hi1 = __umulhi(0xCD9E8D57u, c.z);
    c = make_uint4(hi1 ^ c.y ^ k.x, lo1, hi0 ^ c.w ^ k.y, lo0);
  }
  return c;
}

__device__ __forceinline__ uint4 group_bits(long long g, uint2 key) {
  return philox4x32_10(
      make_uint4(static_cast<unsigned>(g),
                 static_cast<unsigned>(static_cast<unsigned long long>(g) >> 32),
                 0u, 0u),
      key);
}

// -- pass 2: quantize --------------------------------------------------------
// a NaN passes through, as torch.clamp and jnp.clip let it
__device__ __forceinline__ float clamp127(float v) {
  return v < -127.0f ? -127.0f : (v > 127.0f ? 127.0f : v);
}

// the int8 byte of a rounded, clamped value; NaN (x/scale with a NaN or an
// inf in x) becomes 0, as XLA's and numpy's casts to int8 give it
__device__ __forceinline__ unsigned int8_byte(float r) {
  if (isnan(r)) return 0u;
  return static_cast<unsigned>(static_cast<uint8_t>(
      static_cast<int8_t>(__float2int_rn(r))));
}

__device__ __forceinline__ unsigned q_nearest(float x, float scale) {
  return int8_byte(clamp127(rintf(__fdiv_rn(x, scale))));
}

__device__ __forceinline__ unsigned q_dither(float x, float inv,
                                             unsigned bits) {
  const float s = clamp127(__fmul_rn(x, inv));
  // int32 bits x 2^-32: uniform in [-0.5, 0.5], as quantize.py:55-56
  const float d = __fmul_rn(__int2float_rn(static_cast<int>(bits)),
                            2.3283064365386963e-10f);
  return int8_byte(clamp127(rintf(__fadd_rn(s, d))));
}

template <bool kDither>
__device__ __forceinline__ unsigned q_one(float x, float scale, float inv,
                                          unsigned bits) {
  return kDither ? q_dither(x, inv, bits) : q_nearest(x, scale);
}

template <typename T, bool kDither>
__global__ void __launch_bounds__(NNS_THREADS)
quantize_kernel(const T* __restrict__ x, long long n, long long nvec,
                const unsigned* __restrict__ word, int8_t* __restrict__ q,
                float* __restrict__ scale_out, uint2 key) {
  float scale = __fdiv_rn(__uint_as_float(*word), 127.0f);
  scale = (1e-30f > scale) ? 1e-30f : scale;  // Python's max(): NaN stays
  const float inv = __fdiv_rn(1.0f, scale);
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    // a NaN scale is written as the default quiet NaN that numpy's and the
    // host's f32 division give (the card's own NaN is 0x7fffffff)
    *scale_out = isnan(scale) ? __uint_as_float(0x7fc00000u) : scale;
  }
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long tid =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  for (long long v = tid; v < nvec; v += stride) {
    float f[16];
    load16(x + 16 * v, f);
    unsigned w[4];
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      const uint4 b = kDither ? group_bits(4 * v + g, key)
                              : make_uint4(0u, 0u, 0u, 0u);
      w[g] = q_one<kDither>(f[4 * g], scale, inv, b.x) |
             (q_one<kDither>(f[4 * g + 1], scale, inv, b.y) << 8) |
             (q_one<kDither>(f[4 * g + 2], scale, inv, b.z) << 16) |
             (q_one<kDither>(f[4 * g + 3], scale, inv, b.w) << 24);
    }
    reinterpret_cast<uint4*>(q)[v] = make_uint4(w[0], w[1], w[2], w[3]);
  }
  // groups of 4 elements from 16 * nvec on: the ragged tail, or all of x
  const long long groups = (n + 3) / 4;
  for (long long g = 4 * nvec + tid; g < groups; g += stride) {
    const uint4 b = kDither ? group_bits(g, key) : make_uint4(0u, 0u, 0u, 0u);
    const unsigned bits[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const long long i = 4 * g + j;
      if (i < n) {
        q[i] = static_cast<int8_t>(static_cast<uint8_t>(
            q_one<kDither>(to_f32(x[i]), scale, inv, bits[j])));
      }
    }
  }
}

template <typename T>
static int launch(const void* x, long long n, void* q, void* scale,
                  void* word, bool dither, unsigned long long seed, bool vec,
                  cudaStream_t stream) {
  const long long nvec = vec ? n / 16 : 0;
  const long long rest = n - 16 * nvec;
  const long long work = nvec > rest ? nvec : rest;
  long long blocks = (work + NNS_THREADS - 1) / NNS_THREADS;
  if (blocks > NNS_MAX_BLOCKS) blocks = NNS_MAX_BLOCKS;
  if (blocks < 1) blocks = 1;
  unsigned* w = static_cast<unsigned*>(word);
  cudaError_t err = cudaMemsetAsync(w, 0, sizeof(unsigned), stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  const T* xt = static_cast<const T*>(x);
  const unsigned grid = static_cast<unsigned>(blocks);
  absmax_kernel<T><<<grid, NNS_THREADS, 0, stream>>>(xt, n, nvec, w);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const uint2 key = make_uint2(static_cast<unsigned>(seed),
                               static_cast<unsigned>(seed >> 32));
  int8_t* qt = static_cast<int8_t*>(q);
  float* st = static_cast<float*>(scale);
  if (dither) {
    quantize_kernel<T, true><<<grid, NNS_THREADS, 0, stream>>>(
        xt, n, nvec, w, qt, st, key);
  } else {
    quantize_kernel<T, false><<<grid, NNS_THREADS, 0, stream>>>(
        xt, n, nvec, w, qt, st, key);
  }
  return static_cast<int>(cudaGetLastError());
}

// Plain C entry point (loaded with ctypes). x: n elements of in_code's type;
// q: n int8; scale: one f32; word: one 32-bit device scratch word. Returns a
// cudaError_t code: 0 when every launch was accepted, cudaErrorInvalidValue
// for a type code this file does not know.
extern "C" int nns_quantize_int8(const void* x, int in_code, long long n,
                                 void* q, void* scale, void* word, int dither,
                                 unsigned long long seed, int vectorized,
                                 void* stream) {
  if (n <= 0) return 0;
  const bool d = dither != 0;
  const bool v = vectorized != 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (in_code) {
    case DT_U8: return launch<uint8_t>(x, n, q, scale, word, d, seed, v, s);
    case DT_I8: return launch<int8_t>(x, n, q, scale, word, d, seed, v, s);
    case DT_I16: return launch<int16_t>(x, n, q, scale, word, d, seed, v, s);
    case DT_I32: return launch<int32_t>(x, n, q, scale, word, d, seed, v, s);
    case DT_I64: return launch<long long>(x, n, q, scale, word, d, seed, v, s);
    case DT_F16: return launch<__half>(x, n, q, scale, word, d, seed, v, s);
    case DT_BF16: return launch<__nv_bfloat16>(x, n, q, scale, word, d, seed, v, s);
    case DT_F32: return launch<float>(x, n, q, scale, word, d, seed, v, s);
    case DT_F64: return launch<double>(x, n, q, scale, word, d, seed, v, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
