// Kernel B3: per-tensor absmax int8 quantize, nearest or dithered, in one
// launch.
//
// Replaces the TPU kernels nnstreamer_tpu/ops/quantize.py::_quant_kernel_prng
// (dither from the TPU core's PRNG, launched by _quantize_2d at :84) and
// ::_quant_kernel_dither (the same rounding with the dither streamed in, :76),
// and the absmax reduction that the JAX wrapper runs outside them (:116).
//
// Arithmetic (unchanged from the two-kernel version):
//   absmax: the max of |f32(x)| as f32 bits in an unsigned. Non-negative
//     floats order as their bits, so the max is exact in any order, and a
//     NaN (bits above +inf) wins, as np.max propagates it. A NaN in x makes
//     every q 0, an inf makes the finite elements' q 0, as XLA's and
//     numpy's int8 casts of NaN give.
//   scale = max(absmax / 127, 1e-30); block 0 writes it (a NaN scale as
//     0x7fc00000, the quiet NaN numpy and the host give).
//   nearest: q = clamp(rint(x / scale), -127, 127) -- the JAX reference
//            (quantize.py:29-34) and the tensor_quant_enc codec; a
//            reciprocal multiply would change bits, so each element divides;
//   dither:  s = clamp(x * (1 / scale), -127, 127),
//            q = clamp(rint(s + d), -127, 127), d = f32(int32(bits)) * 2^-32
//            (quantize.py:48-57), the bits from Philox4x32-10 with key
//            (seed lo, seed hi) and counter (i/4 lo, i/4 hi, 0, 0): word
//            i%4 for element i. The bits depend on the element's index only,
//            not on the grid (the TPU seeds its PRNG with seed + program_id,
//            whose bits no other device reproduces).
// Inputs are converted to f32 as numpy's astype(float32) converts them
// (__double2float_rn, __ll2float_rn, __int2float_rn). Round-to-nearest
// intrinsics keep the compiler from contracting into FMAs; do not build this
// file with --use_fast_math. The results are bit-identical to the plain
// PyTorch versions in nnstreamer_tpu_torch/ops/quantize.py.
//
// Bound: memory. The function reads x once and writes q and the scale,
// n*sizeof(T) + n + 4 bytes. The absmax has to be complete before the first
// q is written, so a kernel that does not keep x on chip reads it twice.
//
// Design: one launch a call, no memset and no scratch word: a cooperative
// launch of one block per SM (at most the occupancy calculator's blocks an
// SM times the SMs). Each block owns one slice of x (whole 16-element
// granules, so 16-byte aligned for every type when x is), stages what the
// plan says of it in shared memory with one 1-D bulk async copy
// (cp.async.bulk onto an mbarrier; the bytes before the first and after
// the last 16-byte boundary of the slice, as in a misaligned view or the
// ragged tail, take scalar loads) and reads the rest from HBM, reduces its
// absmax, writes it into a word of the output buffer behind q, and meets
// the other blocks at cg::this_grid().sync(). It then quantizes the part it
// did not keep first, in the reverse of its first pass's order, so that
// those reads meet the 50 MB L2 where the first pass left them, and the
// kept part last. A thread takes 4 elements at a time (one Philox call), so
// its shared-memory reads stay free of bank conflicts, each warp stores 128
// contiguous bytes of q, and a thread has 4 such groups in flight. Each
// element costs an IEEE division, so spreading x over every SM matters as
// much as the bytes. The plan (ops/quantize.py::quantize_plan) keeps whole
// slices while they fit in 224 KB (x up to 29 MB in f32: read from HBM
// once) and none past that (read twice).
// No block ever waits on a global counter under a plain launch: the grid
// barrier is one the cooperative launch guarantees co-resident blocks for,
// and a launch the card refuses returns its error to the wrapper, which
// raises.
// The bulk copy's wait is bounded (about 2^32 clocks, then __trap), so a
// fault in the byte count fails the launch rather than hanging the card.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

// dtype codes shared with nnstreamer_tpu_torch/ops/quantize.py
enum {
  DT_U8 = 0, DT_I8 = 1, DT_I16 = 2, DT_I32 = 3, DT_I64 = 4,
  DT_F16 = 5, DT_BF16 = 6, DT_F32 = 7, DT_F64 = 8
};
#define NNS_THREADS 1024     // the most threads a block
// dynamic shared memory a block may ask for: 224 KB of the SM's 227 KB,
// the rest for the static words below (shared with ops/quantize.py)
#define NNS_SMEM_MAX (224 * 1024)

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

// 4 elements of T, as whole words when `vec` (p aligned to 4 * sizeof(T),
// or to 16 for f64), else one by one
template <int B> struct Word { using type = uint4; static constexpr int count = B / 16; };
template <> struct Word<8> { using type = uint2; static constexpr int count = 1; };
template <> struct Word<4> { using type = unsigned; static constexpr int count = 1; };

template <typename T>
__device__ __forceinline__ void load4(const T* p, bool vec, float (&f)[4]) {
  using W = Word<4 * sizeof(T)>;
  alignas(16) T e[4];
  if (vec) {
    auto* w = reinterpret_cast<typename W::type*>(e);
#pragma unroll
    for (int j = 0; j < W::count; ++j) {
      w[j] = reinterpret_cast<const typename W::type*>(p)[j];
    }
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) e[i] = p[i];
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) f[i] = to_f32(e[i]);
}

__device__ __forceinline__ unsigned abs_bits(float v) {
  return __float_as_uint(v) & 0x7fffffffu;
}

__device__ __forceinline__ unsigned max_bits(unsigned a, unsigned b) {
  return a > b ? a : b;
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

// -- quantize one element ----------------------------------------------------
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

// the 4 int8 bytes of group g (elements 4g..4g+3) packed little-endian
template <bool kDither>
__device__ __forceinline__ unsigned q_group(const float (&f)[4], long long g,
                                            float scale, float inv,
                                            uint2 key) {
  if (kDither) {
    const uint4 b = group_bits(g, key);
    return q_dither(f[0], inv, b.x) | (q_dither(f[1], inv, b.y) << 8) |
           (q_dither(f[2], inv, b.z) << 16) | (q_dither(f[3], inv, b.w) << 24);
  }
  return q_nearest(f[0], scale) | (q_nearest(f[1], scale) << 8) |
         (q_nearest(f[2], scale) << 16) | (q_nearest(f[3], scale) << 24);
}

// -- shared memory: mbarrier, bounded wait, 1-D bulk copy --------------------
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(bar), "r"(bytes) : "memory");
}

// wait for phase 0 of `bar`; a wait of about 2^32 clocks (2 s) traps, so
// that a byte count that never arrives fails the launch
__device__ __forceinline__ void mbar_wait0(uint32_t bar) {
  const long long t0 = clock64();
  uint32_t done;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done) : "r"(bar) : "memory");
    if (!done && clock64() - t0 > (1ll << 32)) __trap();
  } while (!done);
}

__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];"
      :: "r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

struct Shared {
  unsigned long long bar;         // the bulk copy's mbarrier
  unsigned warp_max[NNS_THREADS / 32];
  unsigned all_max;               // every block's
};

// Stage elements [s, e) of x into `slice` (slice[i - s] = x[i]), where
// slice = dynamic shared memory + (address of x[s] mod 16), so that global
// and shared addresses agree mod 16: the 16-byte-aligned middle goes by one
// bulk copy onto sh.bar (thread 0), the rest by scalar loads. Returns
// whether a bulk copy was issued (then the caller waits on sh.bar).
template <typename T>
__device__ __forceinline__ bool stage(const T* __restrict__ x, long long s,
                                      long long e, T* slice, Shared& sh) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(x + s);
  const uintptr_t b = reinterpret_cast<uintptr_t>(x + e);
  const uintptr_t a16 = (a + 15) & ~static_cast<uintptr_t>(15);
  const uintptr_t b16 = b & ~static_cast<uintptr_t>(15);
  const bool bulk = b16 > a16;
  const long long head_end = bulk ? s + static_cast<long long>((a16 - a) / sizeof(T)) : e;
  const long long tail_start = bulk ? s + static_cast<long long>((b16 - a) / sizeof(T)) : e;
  if (bulk && threadIdx.x == 0) {
    const uint32_t bytes = static_cast<uint32_t>(b16 - a16);
    const uint32_t bar = smem_u32(&sh.bar);
    mbar_expect_tx(bar, bytes);
    bulk_load(smem_u32(slice + (head_end - s)),
              reinterpret_cast<const void*>(a16), bytes, bar);
  }
  for (long long i = s + threadIdx.x; i < head_end; i += blockDim.x) {
    slice[i - s] = x[i];
  }
  for (long long i = tail_start + threadIdx.x; i < e; i += blockDim.x) {
    slice[i - s] = x[i];
  }
  return bulk;
}

// group g of the slice p (n_local elements): 4 elements, zeros past the end
template <typename T>
__device__ __forceinline__ void load_group(const T* p, long long n_local,
                                           long long g, bool vec,
                                           float (&f)[4]) {
  const long long i = 4 * g;
  if (i + 4 <= n_local) {
    load4(p + i, vec, f);
  } else {  // the ragged tail of x
#pragma unroll
    for (int j = 0; j < 4; ++j) f[j] = i + j < n_local ? to_f32(p[i + j]) : 0.0f;
  }
}

// UNROLL groups a thread at once, a block's width apart: their loads are
// all in flight before the first is used
#define NNS_UNROLL 4

// absmax bits of the 4-element groups [g0, g1) of the slice p (n_local
// elements from x[s], s a multiple of 16)
template <typename T>
__device__ __forceinline__ unsigned groups_absmax(const T* p, long long n_local,
                                                  long long g0, long long g1,
                                                  bool vec) {
  unsigned m = 0u;
  const long long width = blockDim.x;
  for (long long g = g0 + threadIdx.x; g < g1; g += NNS_UNROLL * width) {
    float f[NNS_UNROLL][4];
#pragma unroll
    for (int u = 0; u < NNS_UNROLL; ++u) {
      if (g + u * width < g1) load_group(p, n_local, g + u * width, vec, f[u]);
    }
#pragma unroll
    for (int u = 0; u < NNS_UNROLL; ++u) {
      if (g + u * width < g1) {
#pragma unroll
        for (int j = 0; j < 4; ++j) m = max_bits(m, abs_bits(f[u][j]));
      }
    }
  }
  return m;
}

// quantize groups [g0, g1) of the slice p (elements s + 4g ...) into q;
// reverse walks the groups from the last
template <typename T, bool kDither>
__device__ __forceinline__ void groups_quantize(
    const T* p, long long s, long long n_local, long long g0, long long g1,
    bool vec, bool reverse, int8_t* __restrict__ q, float scale, float inv,
    uint2 key) {
  const long long count = g1 - g0;
  const long long width = blockDim.x;
  for (long long t = threadIdx.x; t < count; t += NNS_UNROLL * width) {
    float f[NNS_UNROLL][4];
#pragma unroll
    for (int u = 0; u < NNS_UNROLL; ++u) {
      const long long tu = t + u * width;
      if (tu < count) {
        load_group(p, n_local, reverse ? g1 - 1 - tu : g0 + tu, vec, f[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < NNS_UNROLL; ++u) {
      const long long tu = t + u * width;
      if (tu >= count) continue;
      const long long i = 4 * (reverse ? g1 - 1 - tu : g0 + tu);
      const unsigned w = q_group<kDither>(f[u], (s + i) / 4, scale, inv, key);
      if (i + 4 <= n_local) {
        *reinterpret_cast<unsigned*>(q + s + i) = w;
      } else {  // the ragged tail of x
        for (long long k = i; k < n_local; ++k) {
          q[s + k] = static_cast<int8_t>(static_cast<uint8_t>(w >> (8 * (k - i))));
        }
      }
    }
  }
}

__device__ __forceinline__ unsigned block_reduce_max(unsigned m, Shared& sh) {
  m = __reduce_max_sync(0xffffffffu, m);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) sh.warp_max[warp] = m;
  __syncthreads();
  if (warp == 0) {
    m = lane < static_cast<int>(blockDim.x >> 5) ? sh.warp_max[lane] : 0u;
    m = __reduce_max_sync(0xffffffffu, m);
  }
  return m;  // valid in warp 0
}

__device__ __forceinline__ float scale_of(unsigned bits) {
  float scale = __fdiv_rn(__uint_as_float(bits), 127.0f);
  return (1e-30f > scale) ? 1e-30f : scale;  // Python's max(): NaN stays
}

__device__ __forceinline__ void write_scale(float scale, float* scale_out) {
  // a NaN scale is written as the default quiet NaN that numpy's and the
  // host's f32 division give (the card's own NaN is 0x7fffffff)
  *scale_out = isnan(scale) ? __uint_as_float(0x7fc00000u) : scale;
}

struct Params {
  long long n;      // elements of x
  long long chunk;  // elements a block owns (a multiple of 16)
  long long kept;   // elements a block keeps in shared memory (<= chunk)
  int8_t* q;
  float* scale;
  unsigned* block_max;  // one word a block
  uint2 key;
};

// -- the kernel ------------------------------------------------------------------
template <typename T, bool kDither>
__global__ void __launch_bounds__(NNS_THREADS, 1)
quantize_int8_kernel(const T* __restrict__ x, Params prm) {
  extern __shared__ __align__(128) unsigned char dyn[];
  __shared__ Shared sh;
  cg::grid_group grid = cg::this_grid();
  const long long s = blockIdx.x * prm.chunk;
  long long e = s + prm.chunk < prm.n ? s + prm.chunk : prm.n;
  if (e < s) e = s;  // a block past the end owns nothing
  const long long n_local = e - s;
  const long long kept = n_local < prm.kept ? n_local : prm.kept;
  const uintptr_t shift = reinterpret_cast<uintptr_t>(x + s) & 15;
  T* slice = reinterpret_cast<T*>(dyn + shift);
  const bool vec = shift == 0;
  if (threadIdx.x == 0) {
    mbar_init(smem_u32(&sh.bar), 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  const bool bulk = stage(x, s, s + kept, slice, sh);

  // the part not kept (kept is a multiple of 16 elements when it is short
  // of the slice), from HBM while the bulk copy lands
  const long long kept_groups = (kept + 3) / 4;
  const long long groups = (n_local + 3) / 4;
  unsigned m = groups_absmax(x + s, n_local, kept_groups, groups, vec);
  if (bulk) mbar_wait0(smem_u32(&sh.bar));
  __syncthreads();
  m = max_bits(m, groups_absmax(slice, kept, 0, kept_groups, vec));
  m = block_reduce_max(m, sh);
  if (threadIdx.x == 0) prm.block_max[blockIdx.x] = m;
  grid.sync();
  if (threadIdx.x < 32) {
    unsigned a = 0u;
    for (unsigned b = threadIdx.x; b < gridDim.x; b += 32) {
      a = max_bits(a, __ldcg(prm.block_max + b));
    }
    a = __reduce_max_sync(0xffffffffu, a);
    if (threadIdx.x == 0) sh.all_max = a;
  }
  __syncthreads();
  const float scale = scale_of(sh.all_max);
  const float inv = __fdiv_rn(1.0f, scale);
  if (blockIdx.x == 0 && threadIdx.x == 0) write_scale(scale, prm.scale);
  // not kept: the groups read last come first, while they are in L2
  groups_quantize<T, kDither>(x + s, s, n_local, kept_groups, groups, vec,
                              true, prm.q, scale, inv, prm.key);
  groups_quantize<T, kDither>(slice, s, kept, 0, kept_groups, vec, false,
                              prm.q, scale, inv, prm.key);
}

// -- launch ----------------------------------------------------------------------
template <typename T>
static const void* kernel_for(bool dither) {
  return dither ? reinterpret_cast<const void*>(quantize_int8_kernel<T, true>)
                : reinterpret_cast<const void*>(quantize_int8_kernel<T, false>);
}

static const void* kernel_by_code(int in_code, bool dither) {
  switch (in_code) {
    case DT_U8: return kernel_for<uint8_t>(dither);
    case DT_I8: return kernel_for<int8_t>(dither);
    case DT_I16: return kernel_for<int16_t>(dither);
    case DT_I32: return kernel_for<int32_t>(dither);
    case DT_I64: return kernel_for<long long>(dither);
    case DT_F16: return kernel_for<__half>(dither);
    case DT_BF16: return kernel_for<__nv_bfloat16>(dither);
    case DT_F32: return kernel_for<float>(dither);
    case DT_F64: return kernel_for<double>(dither);
    default: return nullptr;
  }
}

// Plain C entry point, called once per launch plan (loaded with ctypes):
// lets the kernel of (in_code, dither) take NNS_SMEM_MAX bytes of dynamic
// shared memory and writes to *fit the blocks of `threads` threads and
// `smem` bytes an SM can hold at once. Returns a cudaError_t code.
extern "C" int nns_quantize_prepare(int in_code, int dither, int threads,
                                    int smem, int* fit) {
  const void* k = kernel_by_code(in_code, dither != 0);
  if (k == nullptr || smem < 0 || smem > NNS_SMEM_MAX || fit == nullptr ||
      threads < 32 || threads > NNS_THREADS || threads % 32) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaFuncSetAttribute(
      k, cudaFuncAttributeMaxDynamicSharedMemorySize, NNS_SMEM_MAX);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      fit, k, threads, smem));
}

// Plain C entry point (loaded with ctypes). x: n elements of in_code's type;
// q: n int8, 16-byte aligned; scale: one f32; block_max: one 32-bit word a
// block. The plan (blocks, threads, chunk, kept, smem) comes from
// ops/quantize.py::quantize_plan. Returns a cudaError_t code: 0 when the
// launch was accepted, the launch's error when the card refused it (a
// cooperative grid it cannot hold), and cudaErrorInvalidValue for codes
// this file does not know.
extern "C" int nns_quantize_int8(const void* x, int in_code, long long n,
                                 void* q, void* scale, void* block_max,
                                 int dither, unsigned long long seed,
                                 int blocks, int threads, long long chunk,
                                 long long kept, int smem, void* stream) {
  if (n <= 0) return 0;
  const void* k = kernel_by_code(in_code, dither != 0);
  if (k == nullptr || blocks < 1 || chunk < 16 || chunk % 16 || kept > chunk ||
      smem > NNS_SMEM_MAX || threads < 32 || threads > NNS_THREADS ||
      threads % 32) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params prm;
  prm.n = n;
  prm.chunk = chunk;
  prm.kept = kept;
  prm.q = static_cast<int8_t*>(q);
  prm.scale = static_cast<float*>(scale);
  prm.block_max = static_cast<unsigned*>(block_max);
  prm.key = make_uint2(static_cast<unsigned>(seed),
                       static_cast<unsigned>(seed >> 32));
  void* args[] = {const_cast<void**>(&x), &prm};
  const cudaError_t err = cudaLaunchCooperativeKernel(
      k, dim3(blocks), dim3(threads), args, smem,
      static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
