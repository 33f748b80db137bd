// Kernel B1: elementwise normalize chain, uint8 or float32 in, float32,
// bfloat16 or float16 out.
//
// Replaces the TPU kernel nnstreamer_tpu/ops/preprocess.py::_kernel
// ((f32(x) - mean) * scale -> out dtype, over (256, 128) VMEM tiles).
// Here each element goes through a chain of up to 8 (op, f32 value) pairs,
// applied in order in fp32 with round-to-nearest intrinsics, then rounded
// once to the output type. normalize_u8 is the chain (sub mean, mul scale);
// tensor_transform's arithmetic option typecast:float32,add:-127.5,div:127.5
// is the chain (add -127.5, div 127.5). The intrinsics keep the compiler
// from contracting a mul and an add into an FMA and keep div IEEE-correct,
// so the result matches the per-op PyTorch version bit for bit; do not
// build this file with --use_fast_math.
//
// Bound: memory. At 224x224x3 one frame is 150,528 B in and 602,112 B out
// (f32), well under a microsecond of HBM time, so launch latency sets the
// time. Design: each thread loads 16 input elements as 16-byte vectors and
// writes 16 outputs with 16-byte stores, over a grid-stride loop of 256
// threads per block; a scalar loop handles the ragged tail, and the whole
// array when either pointer is not 16-byte aligned. No padding is needed.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define NNS_CHAIN_MAX 8

// opcodes shared with nnstreamer_tpu_torch/ops/preprocess.py
enum { OP_ADD = 0, OP_SUB = 1, OP_MUL = 2, OP_DIV = 3 };
// dtype codes shared with nnstreamer_tpu_torch/ops/preprocess.py
enum { DT_U8 = 0, DT_F32 = 1, DT_BF16 = 2, DT_F16 = 3 };

struct NnsChain {
  int n;
  int op[NNS_CHAIN_MAX];
  float val[NNS_CHAIN_MAX];
};

__device__ __forceinline__ float apply_chain(const NnsChain& c, float v) {
#pragma unroll
  for (int k = 0; k < NNS_CHAIN_MAX; ++k) {
    if (k >= c.n) break;
    const float a = c.val[k];
    switch (c.op[k]) {
      case OP_ADD: v = __fadd_rn(v, a); break;
      case OP_SUB: v = __fsub_rn(v, a); break;
      case OP_MUL: v = __fmul_rn(v, a); break;
      default: v = __fdiv_rn(v, a); break;
    }
  }
  return v;
}

// -- 16-element vector loads --------------------------------------------
__device__ __forceinline__ void load16(const uint8_t* p, float (&f)[16]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    f[i] = static_cast<float>((w[i >> 2] >> (8 * (i & 3))) & 0xffu);
  }
}

__device__ __forceinline__ void load16(const float* p, float (&f)[16]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float4 q = reinterpret_cast<const float4*>(p)[j];
    f[4 * j] = q.x;
    f[4 * j + 1] = q.y;
    f[4 * j + 2] = q.z;
    f[4 * j + 3] = q.w;
  }
}

// -- 16-element vector stores -------------------------------------------
__device__ __forceinline__ void store16(float* p, const float (&f)[16]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    reinterpret_cast<float4*>(p)[j] =
        make_float4(f[4 * j], f[4 * j + 1], f[4 * j + 2], f[4 * j + 3]);
  }
}

__device__ __forceinline__ uint32_t pack2(__nv_bfloat16, float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&h);
}

__device__ __forceinline__ uint32_t pack2(__half, float a, float b) {
  const __half2 h = __floats2half2_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&h);
}

template <typename H>
__device__ __forceinline__ void store16(H* p, const float (&f)[16]) {
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    uint4 o;
    o.x = pack2(H(), f[8 * j], f[8 * j + 1]);
    o.y = pack2(H(), f[8 * j + 2], f[8 * j + 3]);
    o.z = pack2(H(), f[8 * j + 4], f[8 * j + 5]);
    o.w = pack2(H(), f[8 * j + 6], f[8 * j + 7]);
    reinterpret_cast<uint4*>(p)[j] = o;
  }
}

// -- scalar conversions ---------------------------------------------------
__device__ __forceinline__ float to_f32(uint8_t v) {
  return static_cast<float>(v);
}
__device__ __forceinline__ float to_f32(float v) { return v; }

__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}
__device__ __forceinline__ void put(__half* p, float v) {
  *p = __float2half_rn(v);
}

template <typename TIn, typename TOut>
__global__ void __launch_bounds__(256)
normalize_chain_kernel(const TIn* __restrict__ x, TOut* __restrict__ y,
                       long long n, long long nvec, NnsChain chain) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long tid =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  for (long long v = tid; v < nvec; v += stride) {
    float f[16];
    load16(x + 16 * v, f);
#pragma unroll
    for (int i = 0; i < 16; ++i) f[i] = apply_chain(chain, f[i]);
    store16(y + 16 * v, f);
  }
  for (long long i = 16 * nvec + tid; i < n; i += stride) {
    put(y + i, apply_chain(chain, to_f32(x[i])));
  }
}

template <typename TIn, typename TOut>
static void launch(const void* x, void* y, long long n, bool vectorized,
                   const NnsChain& chain, cudaStream_t stream) {
  const int threads = 256;
  const long long nvec = vectorized ? n / 16 : 0;
  const long long tail = n - 16 * nvec;
  const long long work = nvec > tail ? nvec : tail;
  long long blocks = (work + threads - 1) / threads;
  if (blocks > 4096) blocks = 4096;  // grid-stride covers the rest
  if (blocks < 1) blocks = 1;
  normalize_chain_kernel<TIn, TOut>
      <<<static_cast<unsigned>(blocks), threads, 0, stream>>>(
          static_cast<const TIn*>(x), static_cast<TOut*>(y), n, nvec, chain);
}

// Plain C entry point (loaded with ctypes). Returns a cudaError_t code:
// 0 on a launch that was accepted, cudaErrorInvalidValue for codes this
// file does not know.
extern "C" int nns_normalize_chain(const void* x, int in_code, void* y,
                                   int out_code, long long n,
                                   const NnsChain* chain, int vectorized,
                                   void* stream) {
  if (n <= 0) return 0;
  if (chain == nullptr || chain->n < 0 || chain->n > NNS_CHAIN_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const NnsChain c = *chain;
  const bool vec = vectorized != 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_code == DT_U8) {
    if (out_code == DT_F32) launch<uint8_t, float>(x, y, n, vec, c, s);
    else if (out_code == DT_BF16) launch<uint8_t, __nv_bfloat16>(x, y, n, vec, c, s);
    else if (out_code == DT_F16) launch<uint8_t, __half>(x, y, n, vec, c, s);
    else return static_cast<int>(cudaErrorInvalidValue);
  } else if (in_code == DT_F32) {
    if (out_code == DT_F32) launch<float, float>(x, y, n, vec, c, s);
    else if (out_code == DT_BF16) launch<float, __nv_bfloat16>(x, y, n, vec, c, s);
    else if (out_code == DT_F16) launch<float, __half>(x, y, n, vec, c, s);
    else return static_cast<int>(cudaErrorInvalidValue);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
