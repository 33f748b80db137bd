// Kernel B2: flash attention forward, causal or not, on [b, s, h, d]
// tensors read through their strides; float32, bfloat16 or float16 in and
// out, fp32 softmax state and accumulator.
//
// Replaces the TPU kernel nnstreamer_tpu/ops/flash_attention.py::_kernel
// (launched by _flash_bhsd): a (b, h, q-block, k-block) grid whose k axis
// runs in order on one core and carries the running max m, running sum l
// and output accumulator acc in VMEM scratch. Here one CTA owns one (b, h,
// q tile) and walks the k tiles in a loop, so the online-softmax state
// never leaves the CTA. Both bodies below compute what the Pallas kernel
// computes:
//   - scores, m, l and acc are fp32;
//   - masked scores are -1e30; causal masking is top-left aligned
//     (q_pos >= k_pos); keys at or past sk (a ragged tail) are masked the
//     same way, so any sq and sk work without padding;
//   - k tiles that are causally dead for the whole q tile are skipped;
//   - l is clamped at 1e-30 and acc / l is rounded once to the output type.
// expf, not __expf; do not build with --use_fast_math.
//
// Two bodies, picked by dtype in nns_flash_attention:
//
// * bf16 and f16 (flash_fwd_wgmma): Hopper tensor cores, fed by TMA.
//   - CTA: one producer warpgroup, of which one thread issues every TMA
//     load, and 2 consumer warpgroups of 64 q rows each (BQ = 128) for
//     d <= 128, 1 (BQ = 64) for d = 256. setmaxnreg gives the producer 24
//     (56) registers a thread and the consumers 240 (256).
//   - Loads: TMA reads the q tile once and K and V tiles of 64 keys into a
//     ring of 4 stages (2 for d = 256) in shared memory; full/empty
//     mbarriers hand the stages between producer and consumers. The tensor
//     maps are 4-D [b, s, h, d] with each tensor's own strides, so the
//     LM's q/k/v views of one projection are read in place. Every tile is
//     stored as 64-column chunks of 128-byte rows with the 128-byte
//     swizzle the wgmma descriptors name; d is padded to 64, 128 or 256
//     by TMA's zero fill past d (d = 24 or 32 runs the d = 64 body), and
//     rows past sq and sk are zero-filled too (their scores are masked).
//   - S = Q.K^T: wgmma m64n64k16 from shared memory into fp32; the fp32
//     scores are multiplied by d**-0.5 (attention_reference's order) and
//     masked only on diagonal and ragged tiles.
//   - Online softmax in registers on the wgmma accumulator layout: each
//     row lives on the 4 threads of a quad (two __shfl_xor_sync).
//   - O += P.V with P split: P_hi = bf16(P), P_lo = bf16(P - P_hi) (f16
//     for f16 inputs), both from registers as the A operand of wgmma
//     m64n64k16 against the same V tile, into one fp32 accumulator. l is
//     summed from the unsplit fp32 P. Why split: modelled on the CPU at
//     the shapes chip_smoke holds, P rounded once to bf16 (the usual
//     FA2/FA3 choice) leaves 6.5e-2 to 1.1e-1 of the bf16 outputs more
//     than one ulp from plain attention; f16 or TF32 P 1.1e-2 to 1.4e-2;
//     the split 0 to 1.7e-4, under the 1e-3 that chip_smoke holds
//     (ops/flash_attention.py::attention_tiled_reference is that model).
//     It costs a second P.V product: 1.5x the tensor-core work. For f16,
//     P is split as 2^15 P (exact) and the output divided back, so that
//     small P and P_lo stay out of f16's subnormals (below 2^-14).
//   - Each tile's P.V is summed by the tensor cores from zero and added to
//     the running accumulator by fp32 adds: the tensor cores' fp32 sums
//     do not round to nearest, and summed straight into the accumulator
//     over thousands of keys they drift further from plain attention.
//   - Pipelined for d <= 128: QK of tile j and P.V of tile j - 1 are
//     issued together, and the two consumer warpgroups take turns to issue
//     their GEMMs (named barriers), so one's softmax overlaps the other's
//     GEMMs. (ptxas places the wait for P.V of tile j - 1 at the top of
//     the softmax of tile j, so a warpgroup's softmax does not overlap its
//     own P.V.) In a last q tile of at most 64 rows warpgroup 1 has no
//     rows: it neither takes turns nor releases stages, and the empty
//     barriers count only warpgroup 0's warps. d = 256 has no registers
//     for a second accumulator and runs its P.V one 64-column chunk at a
//     time through the score registers.
//   - Grid: one block per (q tile, b, h), numbered so that the longest
//     (causal) q tile of every (b, h) starts first; numbered head by head,
//     the long tiles of the last heads waited for a late wave.
//   - Epilogue: acc / max(l, 1e-30), rounded once, staged through the
//     warpgroup's own q rows in shared memory and written with 16-byte
//     stores into the contiguous o.
//
// * float32 (flash_fwd_kernel): wgmma has no full-fp32 mode and TF32
//   rounds to 10 bits, so f32 keeps the CUDA-core body: thread t owns q
//   row t / 4 of a 64-row tile, the quad splits the row's 64 keys for the
//   scores and its d columns for the accumulator and exchanges p by warp
//   shuffles. q is cast to fp32 and scaled before QK; P.V multiplies fp32
//   p by fp32 v. K and V tiles are loaded with 16-byte loads between two
//   barriers.
//
// Bound (bf16, causal; chip_smoke computes it per call): [4, 512, 8, 64]
// moves 8.4 MB and does 1.07 GFLOP, so bytes bound it (0.00250 ms at
// 3.35 TB/s); [1, 4096, 8, 128] does 34.4 GFLOP, so operations bound it
// (0.0348 ms at 989 TFLOP/s, 0.052 ms with the split P.V); the LM's
// prompt buckets ([1, 16..64, 8, 64]) are a few launches' worth of work
// (0.0000783 ms at [1, 64, 8, 64]). chip_smoke times the body at
// [1, 4096, 8, 64] and [1, 4096, 8, 128]: halving d halves the GEMMs but
// not the per-score CUDA-core work (an expf on every score, the split,
// the fp32 tile add), which PERF.md weighs against the tensor cores.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>

#include <type_traits>

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

constexpr float NEG_BIG = -1e30f;

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void store2(__half* p, float a, float b) {
  *reinterpret_cast<__half2*>(p) = __floats2half2_rn(a, b);
}

// ===========================================================================
// float32: the CUDA-core body
// ===========================================================================
constexpr int BQ = 64;        // q rows per CTA
constexpr int BK = 64;        // keys per k tile
constexpr int THREADS = 256;  // 4 threads per q row
constexpr int NK = BK / 4;    // keys per thread per tile

// -- 8 elements from 16-byte-aligned global memory, as fp32 -------------
__device__ __forceinline__ void load8(const float* p, float (&f)[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
  f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
}

// -- copy 8 raw elements (32 bytes), aligned, or zero them ----------------
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

__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
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

// ===========================================================================
// bfloat16 and float16: the Hopper body (TMA, mbarriers, wgmma)
// ===========================================================================
namespace hopper {

constexpr int BK = 64;       // keys per tile
constexpr int CHUNK = 64;    // d columns per 128-byte swizzled row
constexpr int ROW = 128;     // bytes per row of a chunk

template <int DPAD>
struct Cfg {
  static constexpr int NWG = DPAD == 256 ? 1 : 2;  // consumer warpgroups
  static constexpr int BQ = 64 * NWG;
  static constexpr int THREADS = 128 * (NWG + 1);
  static constexpr int STAGES = DPAD == 256 ? 2 : 4;
  static constexpr int NCH = DPAD / CHUNK;         // chunks per row
  static constexpr int PRODUCER_REGS = NWG == 1 ? 56 : 24;
  static constexpr int CONSUMER_REGS = NWG == 1 ? 256 : 240;
  static constexpr int Q_BYTES = BQ * DPAD * 2;
  static constexpr int KV_BYTES = BK * DPAD * 2;   // one K or one V tile
  // [q tile][K stages][V stages][full, empty barriers][q barrier]; every
  // tile starts 1024-byte aligned (the 128-byte swizzle's 8-row atom)
  static constexpr int K_OFF = Q_BYTES;
  static constexpr int V_OFF = K_OFF + STAGES * KV_BYTES;
  static constexpr int BAR_OFF = V_OFF + STAGES * KV_BYTES;
  static constexpr int SMEM = BAR_OFF + (2 * STAGES + 1) * 8 + 1024;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// -- mbarriers --------------------------------------------------------------
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(bar), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];"
               :: "r"(bar) : "memory");
}
// wait until the phase of parity `parity` has completed (no timeout: a
// trap or clock in this loop makes ptxas give up the per-role register
// counts of setmaxnreg, and the d = 128 body spills)
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

// -- TMA: one [rows, 64] box of a 4-D {d, s, h, b} map into shared memory --
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int col, int row,
                                         int head, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar),
         "r"(col), "r"(row), "r"(head), "r"(batch)
      : "memory");
}

// -- wgmma ------------------------------------------------------------------
// Shared-memory matrix descriptor for the 128-byte swizzle: start address,
// leading byte offset (unused for K-major and for an N of one 64-column
// chunk), stride byte offset 1024 (one 8-row atom to the next).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFFu) >> 4) |
         (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
// wait until at most N committed groups are pending (groups complete in
// order)
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" :: "n"(N) : "memory");
}
// keep reads of the accumulators after the wait that completes them
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

#define NNS_D32                                                             \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}"
#define NNS_D32_OPS(d)                                                     \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),  \
  "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),             \
  "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),         \
  "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),         \
  "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),         \
  "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),         \
  "+f"(d[31])

// D[64x64] (+)= A[64x16] . B[16x64], A and B K-major in shared memory;
// scale_d = 0 overwrites D
#define NNS_WGMMA_SS(TY)                                                    \
  asm volatile("{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %34, 0;\n\t"           \
               "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " "  \
               NNS_D32 ", %32, %33, p, 1, 1, 0, 0;\n\t}"                    \
               : NNS_D32_OPS(d)                                             \
               : "l"(da), "l"(db), "r"(scale_d))
// D[64x64] (+)= A[64x16] . B[16x64], A in registers, B MN-major
// (transposed) in shared memory; scale_d = 0 overwrites D
#define NNS_WGMMA_RS(TY)                                                    \
  asm volatile("{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %37, 0;\n\t"           \
               "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " "  \
               NNS_D32 ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n\t}"      \
               : NNS_D32_OPS(d)                                             \
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),       \
                 "r"(scale_d))

template <typename T>
__device__ __forceinline__ void mma_ss(float (&d)[32], uint64_t da,
                                       uint64_t db, int scale_d) {
  if constexpr (std::is_same<T, __half>::value) {
    NNS_WGMMA_SS("f16");
  } else {
    NNS_WGMMA_SS("bf16");
  }
}

template <typename T>
__device__ __forceinline__ void mma_rs(float (&d)[32], const uint32_t (&a)[4],
                                       uint64_t db, int scale_d) {
  if constexpr (std::is_same<T, __half>::value) {
    NNS_WGMMA_RS("f16");
  } else {
    NNS_WGMMA_RS("bf16");
  }
}

#undef NNS_WGMMA_RS
#undef NNS_WGMMA_SS
#undef NNS_D32_OPS
#undef NNS_D32

// P is multiplied by this before the split and the output divided by it
// (both exact): f16's exponent range would make small P and most P_lo
// subnormal (f16 is normal from 2^-14); P <= 1, so 2^15 P fits f16
template <typename T>
struct PScale {
  static constexpr float value = std::is_same<T, __half>::value ? 32768.f : 1.f;
};

// a / b correctly rounded, given rb = 1 / b correctly rounded (Markstein:
// one exact residual by FMA and one correction). The per-element IEEE
// division ('/') costs a range check and a slow-path branch each.
__device__ __forceinline__ float div_rn(float a, float b, float rb) {
  const float q = __fmul_rn(a, rb);
  return fmaf(fmaf(-b, q, a), rb, q);
}

// two fp32 values rounded to a packed pair of T, and back
template <typename T>
__device__ __forceinline__ uint32_t pack2(float x, float y) {
  uint32_t w;
  if constexpr (std::is_same<T, __half>::value) {
    const __half2 v = __floats2half2_rn(x, y);
    w = *reinterpret_cast<const uint32_t*>(&v);
  } else {
    const __nv_bfloat162 v = __floats2bfloat162_rn(x, y);
    w = *reinterpret_cast<const uint32_t*>(&v);
  }
  return w;
}
template <typename T>
__device__ __forceinline__ float2 unpack2(uint32_t w) {
  if constexpr (std::is_same<T, __half>::value) {
    return __half22float2(*reinterpret_cast<const __half2*>(&w));
  } else {
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w));
  }
}

template <typename T, int DPAD>
__global__ void __launch_bounds__(Cfg<DPAD>::THREADS, 1)
flash_fwd_wgmma(const NnsAttnArgs a, const __grid_constant__ CUtensorMap qmap,
                const __grid_constant__ CUtensorMap kmap,
                const __grid_constant__ CUtensorMap vmap) {
  using C = Cfg<DPAD>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t s_q = smem_u32(smem);
  const uint32_t s_k = s_q + C::K_OFF;
  const uint32_t s_v = s_q + C::V_OFF;
  const uint32_t bar_full = s_q + C::BAR_OFF;          // + 8 * stage
  const uint32_t bar_empty = bar_full + 8 * C::STAGES;  // + 8 * stage
  const uint32_t bar_q = bar_empty + 8 * C::STAGES;

  // blocks start in the order of their index: every (b, h) of one q tile,
  // then the next q tile, longest (causal) first, so that the last wave
  // holds the shortest tiles of every head
  const int bh = blockIdx.x % (a.b * a.h);
  const int hh = bh % a.h;
  const int bb = bh / a.h;
  const int q0 = ((a.sq + C::BQ - 1) / C::BQ - 1 - blockIdx.x / (a.b * a.h)) *
                 C::BQ;
  const int q_last = min(q0 + C::BQ, a.sq) - 1;
  int n_tiles = (a.sk + BK - 1) / BK;
  if (a.causal) n_tiles = min(n_tiles, q_last / BK + 1);
  // consumer warpgroups with q rows: in a last q tile of at most 64 rows,
  // warpgroup 1 has none and sits out (no stage releases, no turns)
  const int live_wg = min(C::NWG, (a.sq - q0 + 63) / 64);

  if (threadIdx.x == 0) {
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, 4 * live_wg);  // one arrival a live warp
    }
    mbar_init(bar_q, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // warp-uniform to the compiler (a shuffle), so that it allocates each
  // role's registers by its setmaxnreg count
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (wg == C::NWG) {
    // ---- producer: one thread issues every load ----------------------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" :: "n"(C::PRODUCER_REGS));
    if (threadIdx.x == 128 * C::NWG) {
      mbar_expect_tx(bar_q, C::Q_BYTES);
      for (int c = 0; c < C::NCH; ++c) {
        tma_load(s_q + c * C::BQ * ROW, &qmap, bar_q, c * CHUNK, q0, hh, bb);
      }
      for (int kt = 0; kt < n_tiles; ++kt) {
        const int s = kt % C::STAGES;
        const uint32_t parity = (kt / C::STAGES) & 1;
        mbar_wait(bar_empty + 8 * s, parity ^ 1);  // the first round passes
        mbar_expect_tx(bar_full + 8 * s, 2 * C::KV_BYTES);
        for (int c = 0; c < C::NCH; ++c) {
          const uint32_t off = s * C::KV_BYTES + c * BK * ROW;
          tma_load(s_k + off, &kmap, bar_full + 8 * s, c * CHUNK, kt * BK, hh,
                   bb);
          tma_load(s_v + off, &vmap, bar_full + 8 * s, c * CHUNK, kt * BK, hh,
                   bb);
        }
      }
    }
  } else {
    // ---- consumers: 64 q rows per warpgroup --------------------------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" :: "n"(C::CONSUMER_REGS));
    const int t = threadIdx.x % 128;
    const int warp = t / 32;
    const int lane = t % 32;
    const int c4 = lane & 3;
    // wgmma accumulator layout: this thread holds rows r0 and r0 + 8 of the
    // warpgroup's 64, and columns 8j + 2*c4 + {0, 1} of every 8-column block
    const int r0 = 16 * warp + lane / 4;
    const int qw0 = q0 + 64 * wg;
    const int qp0 = qw0 + r0;
    const int qp1 = qp0 + 8;
    int n_mine = n_tiles;  // k tiles this warpgroup computes
    if (qw0 >= a.sq) {
      n_mine = 0;
    } else if (a.causal) {
      n_mine = min(n_tiles, min(qw0 + 63, a.sq - 1) / BK + 1);
    }

    float acc[C::NCH][32];
#pragma unroll
    for (int n = 0; n < C::NCH; ++n) {
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[n][i] = 0.f;
    }
    float sc[32];  // scores, then fp32 P, of one k tile
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = 0.f;
    uint32_t p_hi[4][4], p_lo[4][4];  // P split, as four k16 A operands
    float m0 = NEG_BIG, m1 = NEG_BIG, l0 = 0.f, l1 = 0.f;
    float corr0 = 1.f, corr1 = 1.f;

    const auto wait_full = [&](int kt) {
      mbar_wait(bar_full + 8 * (kt % C::STAGES), (kt / C::STAGES) & 1);
    };
    // every wgmma of the warp that read the stage has completed
    const auto release = [&](int kt) {
      if (lane == 0) mbar_arrive(bar_empty + 8 * (kt % C::STAGES));
    };
    // S = Q . K^T over DPAD / 16 steps of 16 columns, as one wgmma group
    const auto issue_qk = [&](int kt) {
      const uint32_t k_tile = s_k + (kt % C::STAGES) * C::KV_BYTES;
#pragma unroll
      for (int kk = 0; kk < DPAD / 16; ++kk) {
        const uint32_t col = (kk % 4) * 32;  // bytes into the 128-byte row
        const uint32_t qa = s_q + (kk / 4) * C::BQ * ROW + wg * 64 * ROW + col;
        const uint32_t kb = k_tile + (kk / 4) * BK * ROW + col;
        mma_ss<T>(sc, sw128_desc(qa), sw128_desc(kb), kk > 0);
      }
      wgmma_commit();
    };
    // tile = P_hi . V_n + P_lo . V_n for 64-column chunk n of V, summed by
    // the tensor cores from zero (then added to acc by fp32 adds)
    const auto mma_pv = [&](int kt, int n, float (&tile)[32]) {
      const uint32_t v_tile = s_v + (kt % C::STAGES) * C::KV_BYTES;
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        const uint64_t vb = sw128_desc(v_tile + n * BK * ROW + ks * 16 * ROW);
        mma_rs<T>(tile, p_hi[ks], vb, ks > 0);
        mma_rs<T>(tile, p_lo[ks], vb, 1);
      }
    };
    // scale, mask (diagonal and ragged tiles only) and the online softmax
    // update of tile kt: sc becomes fp32 P, corr the accumulator's factor
    const auto softmax = [&](int kt) {
      const int k0 = kt * BK;
#pragma unroll
      for (int i = 0; i < 32; ++i) sc[i] *= a.scale;
      if (k0 + BK > a.sk || (a.causal && k0 + BK - 1 > qw0)) {
        // keys at or past each row's limit are masked
        const int lim0 = a.causal ? min(a.sk, qp0 + 1) : a.sk;
        const int lim1 = a.causal ? min(a.sk, qp1 + 1) : a.sk;
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int key = k0 + 8 * (i / 4) + 2 * c4 + (i & 1);
          if (key >= ((i & 2) ? lim1 : lim0)) sc[i] = NEG_BIG;
        }
      }
      float mx0 = NEG_BIG, mx1 = NEG_BIG;
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        if (i & 2) {
          mx1 = fmaxf(mx1, sc[i]);
        } else {
          mx0 = fmaxf(mx0, sc[i]);
        }
      }
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
      const float mn0 = fmaxf(m0, mx0);
      const float mn1 = fmaxf(m1, mx1);
      corr0 = expf(m0 - mn0);
      corr1 = expf(m1 - mn1);
      float ls0 = 0.f, ls1 = 0.f;
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        sc[i] = expf(sc[i] - ((i & 2) ? mn1 : mn0));
        if (i & 2) {
          ls1 += sc[i];
        } else {
          ls0 += sc[i];
        }
      }
      ls0 += __shfl_xor_sync(0xffffffffu, ls0, 1);
      ls0 += __shfl_xor_sync(0xffffffffu, ls0, 2);
      ls1 += __shfl_xor_sync(0xffffffffu, ls1, 1);
      ls1 += __shfl_xor_sync(0xffffffffu, ls1, 2);
      l0 = l0 * corr0 + ls0;
      l1 = l1 * corr1 + ls1;
      m0 = mn0;
      m1 = mn1;
    };
    // split P (times PScale) into hi and lo: the accumulator's (row,
    // 16ks + 2*c4 + {0,1}, +8) pairs are exactly the A fragment's registers
    const auto split = [&]() {
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float x = sc[8 * ks + 2 * i] * PScale<T>::value;
          const float y = sc[8 * ks + 2 * i + 1] * PScale<T>::value;
          p_hi[ks][i] = pack2<T>(x, y);
          const float2 h = unpack2<T>(p_hi[ks][i]);
          p_lo[ks][i] = pack2<T>(x - h.x, y - h.y);
        }
      }
    };

    mbar_wait(bar_q, 0);
    if constexpr (C::NCH <= 2) {
      // Software pipeline: QK of tile kt is committed before P.V of tile
      // kt - 1, so waiting for all but the newest group gives the scores.
      static_assert(C::NWG == 2, "the turn-taking below is for two");
      float tile[C::NCH][32];
      const auto issue_pv = [&](int kt) {
#pragma unroll
        for (int n = 0; n < C::NCH; ++n) mma_pv(kt, n, tile[n]);
        wgmma_commit();
      };
      // acc (relative to the previous max) += tile, then rescaled to the
      // new max
      const auto add_tile = [&](bool rescale) {
#pragma unroll
        for (int n = 0; n < C::NCH; ++n) {
          fence_regs(tile[n]);
#pragma unroll
          for (int i = 0; i < 32; ++i) {
            acc[n][i] += tile[n][i];
            if (rescale) acc[n][i] *= (i & 2) ? corr1 : corr0;
          }
        }
      };
      // The two warpgroups take turns to issue their GEMMs (named barriers
      // 3 and 4, warpgroup 0 first), so that one's softmax runs while the
      // other's GEMMs hold the tensor cores. Both take n_tiles + 1 turns:
      // one a k tile and one for the last P.V. A warpgroup alone (the
      // other has no q rows) takes no turns.
      const bool pair = live_wg == 2;
      const auto my_turn = [&]() {
        if (pair) asm volatile("bar.sync %0, 256;" :: "r"(3 + wg) : "memory");
      };
      const auto their_turn = [&]() {
        if (pair) asm volatile("bar.arrive %0, 256;" :: "r"(4 - wg) : "memory");
      };
      // warpgroup 0 always has q rows; warpgroup 1 without any skips the
      // loop, as the empty barriers do not count it
      if (n_mine > 0) {
        if (wg == 1) their_turn();
        wait_full(0);
        my_turn();
        wgmma_fence();
        issue_qk(0);
        their_turn();
        wgmma_wait<0>();
        fence_regs(sc);
        softmax(0);
        split();
        for (int kt = 1; kt < n_mine; ++kt) {
          wait_full(kt);
          my_turn();
          wgmma_fence();
          issue_qk(kt);
          issue_pv(kt - 1);
          their_turn();
          wgmma_wait<1>();
          fence_regs(sc);
          softmax(kt);
          wgmma_wait<0>();
          release(kt - 1);
          add_tile(true);
          split();
        }
        my_turn();
        wgmma_fence();
        issue_pv(n_mine - 1);
        their_turn();
        wgmma_wait<0>();
        release(n_mine - 1);
        add_tile(false);
        // k tiles causally dead for this warpgroup (not for the other one:
        // only warpgroup 0's last tile), and the turns it does not take
        for (int kt = n_mine; kt < n_tiles; ++kt) {
          wait_full(kt);
          release(kt);
        }
        for (int turn = n_mine + 1; turn <= n_tiles; ++turn) {
          my_turn();
          their_turn();
        }
        if (wg == 0) my_turn();  // warpgroup 1's last turn
      }
    } else {
      // d = 256: registers hold no second accumulator of 64 x 256, so each
      // 64-column chunk's tile goes through sc (free once P is split), one
      // wgmma group at a time
      for (int kt = 0; kt < n_mine; ++kt) {
        wait_full(kt);
        wgmma_fence();
        issue_qk(kt);
        wgmma_wait<0>();
        fence_regs(sc);
        softmax(kt);
        split();
#pragma unroll
        for (int n = 0; n < C::NCH; ++n) {
          wgmma_fence();
          mma_pv(kt, n, sc);
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs(sc);
#pragma unroll
          for (int i = 0; i < 32; ++i) {
            acc[n][i] = acc[n][i] * ((i & 2) ? corr1 : corr0) + sc[i];
          }
        }
        release(kt);
      }
      // k tiles causally dead for this warpgroup (not for the other one)
      for (int kt = n_mine; kt < n_tiles; ++kt) {
        wait_full(kt);
        release(kt);
      }
    }

    // ---- epilogue: through this warpgroup's q rows, 16-byte stores ------
    const float lc0 = fmaxf(l0, 1e-30f);
    const float lc1 = fmaxf(l1, 1e-30f);
    const float rc0 = 1.f / lc0;
    const float rc1 = 1.f / lc1;
    constexpr float unscale = 1.f / PScale<T>::value;
    asm volatile("bar.sync %0, 128;" :: "r"(1 + wg) : "memory");
#pragma unroll
    for (int n = 0; n < C::NCH; ++n) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = r0 + 8 * half;  // r % 8 == lane / 4 % 8
          const float l = half ? lc1 : lc0;
          const float rl = half ? rc1 : rc0;
          T* dst = reinterpret_cast<T*>(
              smem + n * C::BQ * ROW + (64 * wg + r) * ROW +
              ((j ^ (r & 7)) * 16) + c4 * 4);
          store2(dst, div_rn(acc[n][4 * j + 2 * half] * unscale, l, rl),
                 div_rn(acc[n][4 * j + 2 * half + 1] * unscale, l, rl));
        }
      }
    }
    asm volatile("bar.sync %0, 128;" :: "r"(1 + wg) : "memory");
    constexpr int UNITS = DPAD / 8;  // 16-byte units per row
    T* og = static_cast<T*>(a.o);
    for (int idx = t; idx < 64 * UNITS; idx += 128) {
      const int r = idx / UNITS;
      const int u = idx % UNITS;
      const int qp = qw0 + r;
      if (qp < a.sq && 8 * u < a.d) {
        const uint4 val = *reinterpret_cast<const uint4*>(
            smem + (u / 8) * C::BQ * ROW + (64 * wg + r) * ROW +
            (((u % 8) ^ (r & 7)) * 16));
        *reinterpret_cast<uint4*>(
            og + (((long long)bb * a.sq + qp) * a.h + hh) * a.d + 8 * u) = val;
      }
    }
  }
}

// -- host side: tensor maps through the driver's cuTensorMapEncodeTiled ------
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// The runtime library links no libcuda; the process has it loaded (the
// runtime opened it), so take the entry point from it.
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = []() -> EncodeTiled {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (lib == nullptr) lib = dlopen("libcuda.so.1", RTLD_NOW);
    if (lib == nullptr) return nullptr;
    return reinterpret_cast<EncodeTiled>(
        dlsym(lib, "cuTensorMapEncodeTiled"));
  }();
  return fn;
}

// A 4-D map {d, s, h, b} of a [b, s, h, d] tensor with element strides
// sb, ss, sh (d stride 1), read in boxes of 64 columns by `rows` rows with
// the 128-byte swizzle; reads past d and s are zero-filled. A dimension of
// size 1 is never stepped, so it takes the packed stride.
bool encode(CUtensorMap* map, CUtensorMapDataType dt, const void* ptr,
            int b, int s, int h, int d, long long sb, long long ss,
            long long sh, int rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  if (s == 1) ss = (long long)h * d;
  if (h == 1) sh = d;
  if (b == 1) sb = (long long)s * h * d;
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)s, (cuuint64_t)h,
                              (cuuint64_t)b};
  const cuuint64_t strides[3] = {(cuuint64_t)ss * 2, (cuuint64_t)sh * 2,
                                 (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {(cuuint32_t)CHUNK, (cuuint32_t)rows, 1, 1};
  const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
  return fn(map, dt, 4, const_cast<void*>(ptr), dims, strides, box,
            elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename T, int DPAD>
int launch(const NnsAttnArgs& a, cudaStream_t stream) {
  using C = Cfg<DPAD>;
  const CUtensorMapDataType dt = std::is_same<T, __half>::value
                                     ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                     : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  CUtensorMap qmap, kmap, vmap;
  if (!encode(&qmap, dt, a.q, a.b, a.sq, a.h, a.d, a.q_sb, a.q_ss, a.q_sh,
              C::BQ) ||
      !encode(&kmap, dt, a.k, a.b, a.sk, a.h, a.d, a.k_sb, a.k_ss, a.k_sh,
              BK) ||
      !encode(&vmap, dt, a.v, a.b, a.sk, a.h, a.d, a.v_sb, a.v_ss, a.v_sh,
              BK)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto kernel = flash_fwd_wgmma<T, DPAD>;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long blocks =
      (long long)((a.sq + C::BQ - 1) / C::BQ) * a.b * a.h;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(blocks));
  kernel<<<grid, C::THREADS, C::SMEM, stream>>>(a, qmap, kmap, vmap);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_d(const NnsAttnArgs& a, cudaStream_t stream) {
  if (a.d <= 64) return launch<T, 64>(a, stream);
  if (a.d <= 128) return launch<T, 128>(a, stream);
  return launch<T, 256>(a, stream);
}

}  // namespace hopper

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
    case DT_BF16: return hopper::dispatch_d<__nv_bfloat16>(a, s);
    case DT_F16: return hopper::dispatch_d<__half>(a, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
