// Kernel B1: elementwise normalize chain, any numeric type in (bool,
// uint8-64, int8-64, float16, bfloat16, float32, float64), float32,
// bfloat16 or float16 out.
//
// Replaces the TPU kernel nnstreamer_tpu/ops/preprocess.py::_kernel
// ((f32(x) - mean) * scale -> out dtype, over (256, 128) VMEM tiles).
// Here each element goes through a chain of up to 8 (op, f32 value) pairs,
// applied in order in fp32 with round-to-nearest intrinsics, then rounded
// once to the output type. An input is first converted to fp32 as numpy's
// astype(float32) and torch's .to(float32) convert it: exactly where the
// value fits, else rounded to nearest (integers past 2**24, float64).
// normalize_u8 is the chain (sub mean, mul scale);
// tensor_transform's arithmetic option typecast:float32,add:-127.5,div:127.5
// is the chain (add -127.5, div 127.5). The intrinsics keep the compiler
// from contracting a mul and an add into an FMA and keep div IEEE-correct,
// so the result matches the per-op PyTorch version bit for bit; do not
// build this file with --use_fast_math.
//
// Bound: memory. Each byte is read or written once and there is no
// product, so neither TMA nor the tensor cores have anything to do here.
// At 224x224x3 one frame is 150,528 B in and 602,112 B out (f32): 0.000225
// ms at 3.35 TB/s. That much fits in flight at once, so the frame's real
// floor is one launch plus one HBM round trip, a few microseconds.
//
// Design: the wrapper (ops/preprocess.py::normalize_plan) picks the elements
// per thread (EPT) and the grid from n, so that the card is full at every
// size:
//   - EPT = 4 while the n / 4 vectors take at most 1.5 passes of one wave
//     (8 blocks of 256 per SM; PASSES_OF_4_MAX in the wrapper), that is up
//     to 1,622,016 elements on 132 SMs: at the frame 37,632 threads, 147
//     blocks (one 4-byte uint8 load and one 16-byte f32 store, or 8 bytes
//     for bf16/f16); at 8 frames one wave of 1,056 blocks over 1.14 passes;
//   - EPT = 16 above that, in a grid-stride loop over one such wave: each
//     thread keeps a 16-byte load (64 bytes for f32 in) in flight, some
//     4 MB across the card, more than the ~2.3 MB that cover HBM latency
//     (3.35 TB/s x ~0.7 us);
//   - EPT = 1 when x is not 16-byte aligned (a view into a larger buffer):
//     scalar loads and stores over the same grid-stride loop.
// The elements past the last whole vector take the EPT = 1 loop. The op
// switch runs once per op for a thread's EPT elements, outside the element
// loop; each element still sees the same ops in the same order.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define NNS_CHAIN_MAX 8
#define NNS_THREADS 256

// opcodes shared with nnstreamer_tpu_torch/ops/preprocess.py
enum { OP_ADD = 0, OP_SUB = 1, OP_MUL = 2, OP_DIV = 3 };
// dtype codes shared with nnstreamer_tpu_torch/ops/preprocess.py: the
// first four in and out, the rest in only
enum {
  DT_U8 = 0, DT_F32 = 1, DT_BF16 = 2, DT_F16 = 3, DT_I8 = 4, DT_I16 = 5,
  DT_I32 = 6, DT_I64 = 7, DT_U16 = 8, DT_U32 = 9, DT_U64 = 10, DT_F64 = 11,
  DT_BOOL = 12
};

struct NnsChain {
  int n;
  int op[NNS_CHAIN_MAX];
  float val[NNS_CHAIN_MAX];
};

template <int EPT>
__device__ __forceinline__ void apply_chain(const NnsChain& c,
                                            float (&f)[EPT]) {
  for (int k = 0; k < c.n; ++k) {
    const float a = c.val[k];
    switch (c.op[k]) {
      case OP_ADD:
#pragma unroll
        for (int i = 0; i < EPT; ++i) f[i] = __fadd_rn(f[i], a);
        break;
      case OP_SUB:
#pragma unroll
        for (int i = 0; i < EPT; ++i) f[i] = __fsub_rn(f[i], a);
        break;
      case OP_MUL:
#pragma unroll
        for (int i = 0; i < EPT; ++i) f[i] = __fmul_rn(f[i], a);
        break;
      default:
#pragma unroll
        for (int i = 0; i < EPT; ++i) f[i] = __fdiv_rn(f[i], a);
        break;
    }
  }
}

// -- EPT elements as whole words: B bytes as `count` words of `type` --------
template <int B> struct Word { using type = uint4; static constexpr int count = B / 16; };
template <> struct Word<8> { using type = uint2; static constexpr int count = 1; };
template <> struct Word<4> { using type = unsigned; static constexpr int count = 1; };
template <> struct Word<2> { using type = unsigned short; static constexpr int count = 1; };
template <> struct Word<1> { using type = unsigned char; static constexpr int count = 1; };

// round-to-nearest conversions (a bool is its byte, 0 or 1)
__device__ __forceinline__ float to_f32(uint8_t v) { return static_cast<float>(v); }
__device__ __forceinline__ float to_f32(int8_t v) { return static_cast<float>(v); }
__device__ __forceinline__ float to_f32(int16_t v) { return static_cast<float>(v); }
__device__ __forceinline__ float to_f32(uint16_t v) { return static_cast<float>(v); }
__device__ __forceinline__ float to_f32(int v) { return __int2float_rn(v); }
__device__ __forceinline__ float to_f32(unsigned v) { return __uint2float_rn(v); }
__device__ __forceinline__ float to_f32(long long v) { return __ll2float_rn(v); }
__device__ __forceinline__ float to_f32(unsigned long long v) { return __ull2float_rn(v); }
__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(double v) { return __double2float_rn(v); }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }

__device__ __forceinline__ void from_f32(float v, float* o) { *o = v; }
__device__ __forceinline__ void from_f32(float v, __nv_bfloat16* o) {
  *o = __float2bfloat16_rn(v);
}
__device__ __forceinline__ void from_f32(float v, __half* o) {
  *o = __float2half_rn(v);
}

template <int EPT, typename T>
__device__ __forceinline__ void load(const T* p, float (&f)[EPT]) {
  using W = Word<EPT * sizeof(T)>;
  alignas(16) T e[EPT];
  auto* w = reinterpret_cast<typename W::type*>(e);
#pragma unroll
  for (int j = 0; j < W::count; ++j) {
    w[j] = reinterpret_cast<const typename W::type*>(p)[j];
  }
#pragma unroll
  for (int i = 0; i < EPT; ++i) f[i] = to_f32(e[i]);
}

template <int EPT, typename T>
__device__ __forceinline__ void store(T* p, const float (&f)[EPT]) {
  using W = Word<EPT * sizeof(T)>;
  alignas(16) T e[EPT];
#pragma unroll
  for (int i = 0; i < EPT; ++i) from_f32(f[i], &e[i]);
  const auto* w = reinterpret_cast<const typename W::type*>(e);
#pragma unroll
  for (int j = 0; j < W::count; ++j) {
    reinterpret_cast<typename W::type*>(p)[j] = w[j];
  }
}

template <typename TIn, typename TOut, int EPT>
__global__ void __launch_bounds__(NNS_THREADS)
normalize_chain_kernel(const TIn* __restrict__ x, TOut* __restrict__ y,
                       long long n, NnsChain chain) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long tid =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long nvec = n / EPT;
  for (long long v = tid; v < nvec; v += stride) {
    float f[EPT];
    load<EPT>(x + EPT * v, f);
    apply_chain<EPT>(chain, f);
    store<EPT>(y + EPT * v, f);
  }
  if (EPT > 1) {
    for (long long i = EPT * nvec + tid; i < n; i += stride) {
      float f[1];
      load<1>(x + i, f);
      apply_chain<1>(chain, f);
      store<1>(y + i, f);
    }
  }
}

template <typename TIn, typename TOut>
static int launch(const void* x, void* y, long long n, int ept, int blocks,
                  const NnsChain& chain, cudaStream_t stream) {
  const TIn* xt = static_cast<const TIn*>(x);
  TOut* yt = static_cast<TOut*>(y);
  const dim3 grid(static_cast<unsigned>(blocks));
  switch (ept) {
    case 1:
      normalize_chain_kernel<TIn, TOut, 1><<<grid, NNS_THREADS, 0, stream>>>(
          xt, yt, n, chain);
      break;
    case 4:
      normalize_chain_kernel<TIn, TOut, 4><<<grid, NNS_THREADS, 0, stream>>>(
          xt, yt, n, chain);
      break;
    case 16:
      normalize_chain_kernel<TIn, TOut, 16><<<grid, NNS_THREADS, 0, stream>>>(
          xt, yt, n, chain);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename TIn>
static int launch_in(const void* x, void* y, int out_code, long long n,
                     int ept, int blocks, const NnsChain& chain,
                     cudaStream_t stream) {
  switch (out_code) {
    case DT_F32: return launch<TIn, float>(x, y, n, ept, blocks, chain, stream);
    case DT_BF16: return launch<TIn, __nv_bfloat16>(x, y, n, ept, blocks, chain, stream);
    case DT_F16: return launch<TIn, __half>(x, y, n, ept, blocks, chain, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Plain C entry point (loaded with ctypes). ept and blocks are the launch
// plan (elements per thread: 1, or 4 or 16 with x and y 16-byte aligned;
// blocks of 256 threads). Returns a cudaError_t code: 0 on a launch that was
// accepted, cudaErrorInvalidValue for codes or a plan this file does not
// take.
extern "C" int nns_normalize_chain(const void* x, int in_code, void* y,
                                   int out_code, long long n,
                                   const NnsChain* chain, int ept, int blocks,
                                   void* stream) {
  if (n <= 0) return 0;
  if (chain == nullptr || chain->n < 0 || chain->n > NNS_CHAIN_MAX ||
      blocks < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const NnsChain& c = *chain;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (in_code) {
    case DT_U8:
    case DT_BOOL: return launch_in<uint8_t>(x, y, out_code, n, ept, blocks, c, s);
    case DT_F32: return launch_in<float>(x, y, out_code, n, ept, blocks, c, s);
    case DT_BF16: return launch_in<__nv_bfloat16>(x, y, out_code, n, ept, blocks, c, s);
    case DT_F16: return launch_in<__half>(x, y, out_code, n, ept, blocks, c, s);
    case DT_I8: return launch_in<int8_t>(x, y, out_code, n, ept, blocks, c, s);
    case DT_I16: return launch_in<int16_t>(x, y, out_code, n, ept, blocks, c, s);
    case DT_I32: return launch_in<int>(x, y, out_code, n, ept, blocks, c, s);
    case DT_I64: return launch_in<long long>(x, y, out_code, n, ept, blocks, c, s);
    case DT_U16: return launch_in<uint16_t>(x, y, out_code, n, ept, blocks, c, s);
    case DT_U32: return launch_in<unsigned>(x, y, out_code, n, ept, blocks, c, s);
    case DT_U64: return launch_in<unsigned long long>(x, y, out_code, n, ept, blocks, c, s);
    case DT_F64: return launch_in<double>(x, y, out_code, n, ept, blocks, c, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
