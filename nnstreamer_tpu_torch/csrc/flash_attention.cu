// Kernel B2: flash attention forward, causal or not, on [b, s, h, d]
// tensors read through their strides; float32, bfloat16 or float16 in and
// out, fp32 softmax state and accumulator.
//
// Replaces the TPU kernel nnstreamer_tpu/ops/flash_attention.py::_kernel
// (launched by _flash_bhsd): a (b, h, q-block, k-block) grid whose k axis
// runs in order on one core and carries the running max m, running sum l
// and output accumulator acc in VMEM scratch. Here one CTA of 256 threads
// owns one (b, h, 64-row q tile) and walks the k tiles in a loop, so the
// online-softmax state never leaves the CTA. It computes what the Pallas
// kernel computes:
//   - q is cast to fp32 and multiplied by scale = d**-0.5 before QK;
//   - scores, m, l and acc are fp32; P.V multiplies fp32 p by fp32 v;
//   - masked scores are -1e30; causal masking is top-left aligned
//     (q_pos >= k_pos); keys at or past sk (a ragged tail) are masked the
//     same way, so any sq and sk work without padding;
//   - k tiles that are causally dead for the whole q tile are skipped;
//   - l is clamped at 1e-30 and acc / l is rounded once to the output type.
// expf, not __expf; do not build with --use_fast_math.
//
// Layout. Thread t owns q row r = t / 4 of the tile; the four threads of a
// quad split that row's 64 keys (key 4i + c for lane c of the quad) for
// the scores and its d columns (pairs 2c + 8m) for the accumulator. The
// quad exchanges p by warp shuffles, so P never goes to shared memory.
// Shared memory holds the scaled q tile in fp32 and one K and one V tile in
// the input type, each row padded by 16 bytes so that the four keys a warp
// reads at once fall in different banks. The head dimension is padded to
// DPAD (32, 64, 128 or 256) with zeros; d is any multiple of 8 up to 256.
//
// Bound. At the LM prefill shape [4, 512, 8, 64], causal, the function
// moves 8.4 MB and does 1.07 GFLOP: bytes bound it on this card (2.5 us of
// HBM time against 1.1 us of bf16 tensor-core time). This first design
// does the arithmetic on CUDA cores in fp32 and loads each K/V tile with
// plain 16-byte loads between two barriers; wgmma, TMA and a bf16 P.V are
// a later redesign (ROADMAP B2).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// dtype codes shared with nnstreamer_tpu_torch/ops/flash_attention.py
enum { DT_F32 = 1, DT_BF16 = 2, DT_F16 = 3 };

// Arguments, shared with ops/flash_attention.py (_Args). Strides are in
// elements; the last (d) stride of q, k and v is 1, and o is a contiguous
// [b, sq, h, d] tensor.
struct NnsAttnArgs {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  int b, h, sq, sk, d;
  int causal;
  float scale;
};

namespace {

constexpr int BQ = 64;        // q rows per CTA
constexpr int BK = 64;        // keys per k tile
constexpr int THREADS = 256;  // 4 threads per q row
constexpr int NK = BK / 4;    // keys per thread per tile
constexpr float NEG_BIG = -1e30f;

// -- 8 elements from 16-byte-aligned global memory, as fp32 -------------
__device__ __forceinline__ void load8(const float* p, float (&f)[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
  f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&f)[8]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

__device__ __forceinline__ void load8(const __half* p, float (&f)[8]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __half22float2(*reinterpret_cast<const __half2*>(&w[i]));
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

// -- copy 8 raw elements (16 or 32 bytes), aligned, or zero them ----------
template <typename T>
__device__ __forceinline__ void copy8(T* dst, const T* src, bool valid) {
  constexpr int N = 8 * sizeof(T) / 16;  // uint4 per 8 elements
  if (valid) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      reinterpret_cast<uint4*>(dst)[i] = reinterpret_cast<const uint4*>(src)[i];
    }
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      reinterpret_cast<uint4*>(dst)[i] = make_uint4(0, 0, 0, 0);
    }
  }
}

// -- two neighbouring elements as fp32, and back --------------------------
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ float2 load2(const __half* p) {
  return __half22float2(*reinterpret_cast<const __half2*>(p));
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void store2(__half* p, float a, float b) {
  *reinterpret_cast<__half2*>(p) = __floats2half2_rn(a, b);
}

template <typename T, int DPAD>
struct Smem {
  static constexpr int QS = DPAD + 4;                // floats per q row
  static constexpr int KS = DPAD + 16 / sizeof(T);   // elements per k/v row
  static constexpr size_t bytes =
      sizeof(float) * BQ * QS + 2 * sizeof(T) * BK * KS;
};

template <typename T, int DPAD>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const NnsAttnArgs a) {
  using S = Smem<T, DPAD>;
  constexpr int QS = S::QS;
  constexpr int KS = S::KS;
  constexpr int CH = DPAD / 8;  // 8-element chunks per row
  extern __shared__ __align__(16) unsigned char smem[];
  float* sQ = reinterpret_cast<float*>(smem);
  T* sK = reinterpret_cast<T*>(smem + sizeof(float) * BQ * QS);
  T* sV = sK + BK * KS;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int r = tid >> 2;  // q row of this thread within the tile
  const int c = tid & 3;   // lane within the quad
  const int quad = lane & ~3;
  const int q0 = blockIdx.x * BQ;
  const int hh = blockIdx.y;
  const int bb = blockIdx.z;
  const int d = a.d;

  const T* qg = static_cast<const T*>(a.q) + bb * a.q_sb + hh * a.q_sh;
  const T* kg = static_cast<const T*>(a.k) + bb * a.k_sb + hh * a.k_sh;
  const T* vg = static_cast<const T*>(a.v) + bb * a.v_sb + hh * a.v_sh;

  // q tile -> fp32, times scale, zero-padded rows and columns
  for (int idx = tid; idx < BQ * CH; idx += THREADS) {
    const int row = idx / CH;
    const int dd = (idx % CH) * 8;
    float f[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (q0 + row < a.sq && dd < d) {
      load8(qg + (long long)(q0 + row) * a.q_ss + dd, f);
    }
    float4* dst = reinterpret_cast<float4*>(sQ + row * QS + dd);
    dst[0] = make_float4(f[0] * a.scale, f[1] * a.scale, f[2] * a.scale,
                         f[3] * a.scale);
    dst[1] = make_float4(f[4] * a.scale, f[5] * a.scale, f[6] * a.scale,
                         f[7] * a.scale);
  }

  // k tiles to visit: all of them, or up to the last one a query of this
  // tile can see (later ones are causally dead for every row)
  const int q_last = min(q0 + BQ, a.sq) - 1;
  int n_tiles = (a.sk + BK - 1) / BK;
  if (a.causal) n_tiles = min(n_tiles, q_last / BK + 1);

  const int q_pos = q0 + r;
  float m_i = NEG_BIG;
  float l_i = 0.f;
  float acc[DPAD / 4];
#pragma unroll
  for (int m = 0; m < DPAD / 4; ++m) acc[m] = 0.f;

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // every read of the previous tile is done
    for (int idx = tid; idx < BK * CH; idx += THREADS) {
      const int row = idx / CH;
      const int dd = (idx % CH) * 8;
      const bool ok = k0 + row < a.sk && dd < d;
      const long long key = k0 + row;
      copy8(sK + row * KS + dd, kg + key * a.k_ss + dd, ok);
      copy8(sV + row * KS + dd, vg + key * a.v_ss + dd, ok);
    }
    __syncthreads();

    // scores of row r against keys 4i + c
    float s[NK];
#pragma unroll
    for (int i = 0; i < NK; ++i) s[i] = 0.f;
    const float* qrow = sQ + r * QS;
#pragma unroll 4
    for (int dd = 0; dd < DPAD; dd += 2) {
      const float2 qv = *reinterpret_cast<const float2*>(qrow + dd);
#pragma unroll
      for (int i = 0; i < NK; ++i) {
        const float2 kv = load2(sK + (4 * i + c) * KS + dd);
        s[i] = fmaf(qv.x, kv.x, s[i]);
        s[i] = fmaf(qv.y, kv.y, s[i]);
      }
    }

    // mask, then the online softmax update (the quad agrees on m and l)
    float m_cur = NEG_BIG;
#pragma unroll
    for (int i = 0; i < NK; ++i) {
      const int k_pos = k0 + 4 * i + c;
      const bool live = k_pos < a.sk && (!a.causal || q_pos >= k_pos);
      s[i] = live ? s[i] : NEG_BIG;
      m_cur = fmaxf(m_cur, s[i]);
    }
    m_cur = fmaxf(m_cur, __shfl_xor_sync(0xffffffffu, m_cur, 1));
    m_cur = fmaxf(m_cur, __shfl_xor_sync(0xffffffffu, m_cur, 2));
    const float m_new = fmaxf(m_i, m_cur);
    const float corr = expf(m_i - m_new);
    float l_cur = 0.f;
#pragma unroll
    for (int i = 0; i < NK; ++i) {
      s[i] = expf(s[i] - m_new);
      l_cur += s[i];
    }
    l_cur += __shfl_xor_sync(0xffffffffu, l_cur, 1);
    l_cur += __shfl_xor_sync(0xffffffffu, l_cur, 2);
    l_i = l_i * corr + l_cur;
    m_i = m_new;

    // acc = acc * corr + p . v over this tile's keys
#pragma unroll
    for (int m = 0; m < DPAD / 4; ++m) acc[m] *= corr;
#pragma unroll
    for (int i = 0; i < NK; ++i) {
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        const float p = __shfl_sync(0xffffffffu, s[i], quad | cc);
        const T* vrow = sV + (4 * i + cc) * KS + 2 * c;
#pragma unroll
        for (int m = 0; m < DPAD / 8; ++m) {
          const float2 vv = load2(vrow + 8 * m);
          acc[2 * m] = fmaf(p, vv.x, acc[2 * m]);
          acc[2 * m + 1] = fmaf(p, vv.y, acc[2 * m + 1]);
        }
      }
    }
  }

  if (q_pos < a.sq) {
    const float l = fmaxf(l_i, 1e-30f);
    T* og = static_cast<T*>(a.o) +
            ((long long)bb * a.sq + q_pos) * a.h * d + (long long)hh * d;
#pragma unroll
    for (int m = 0; m < DPAD / 8; ++m) {
      const int col = 2 * c + 8 * m;
      if (col < d) store2(og + col, acc[2 * m] / l, acc[2 * m + 1] / l);
    }
  }
}

template <typename T, int DPAD>
int launch(const NnsAttnArgs& a, cudaStream_t stream) {
  const size_t smem = Smem<T, DPAD>::bytes;
  auto kernel = flash_fwd_kernel<T, DPAD>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid((a.sq + BQ - 1) / BQ, a.h, a.b);
  kernel<<<grid, THREADS, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_d(const NnsAttnArgs& a, cudaStream_t stream) {
  if (a.d <= 32) return launch<T, 32>(a, stream);
  if (a.d <= 64) return launch<T, 64>(a, stream);
  if (a.d <= 128) return launch<T, 128>(a, stream);
  return launch<T, 256>(a, stream);
}

}  // namespace

// Plain C entry point (loaded with ctypes). Returns a cudaError_t code: 0
// when the launch was accepted, cudaErrorInvalidValue for arguments this
// file does not take (the wrapper checks them first).
extern "C" int nns_flash_attention(const NnsAttnArgs* args, int dtype_code,
                                   void* stream) {
  if (args == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const NnsAttnArgs a = *args;
  if (a.b <= 0 || a.h <= 0 || a.sq <= 0) return 0;
  if (a.sk <= 0 || a.d <= 0 || a.d > 256 || a.d % 8 != 0 ||
      a.b > 65535 || a.h > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype_code) {
    case DT_F32: return dispatch_d<float>(a, s);
    case DT_BF16: return dispatch_d<__nv_bfloat16>(a, s);
    case DT_F16: return dispatch_d<__half>(a, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
