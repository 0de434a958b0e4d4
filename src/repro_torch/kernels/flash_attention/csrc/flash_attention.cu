// Flash-attention prefill forward for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel of the JAX package:
//   src/repro/kernels/flash_attention/flash_attention.py
//   flash_attention_pallas (kernel body _kernel).
// Same function: GQA online-softmax attention at the (B, S, H, D) layout,
// causal and optional sliding-window masks with q and k positions both
// starting at 0, KV head h / (H / KV) without repeating K/V, fp32 m/l/acc,
// masked scores filled with -1e30, masked probabilities set to 0 and the
// normaliser floored at 1e-30 (a fully-masked row gives 0).
//
// Bound on the card.  FLOPs = 4*B*H*D*(unmasked (q, k) pairs), about
// 2*B*H*Sq*Skv*D when causal; bytes = q, k, v and o once; bound =
// max(FLOPs / 989e12, bytes / 3.35e12) with the H100 data-sheet peaks.
//   * qwen1.5-0.5B's prefill (B=1, H=KV=16, D=64, Sq=Skv in 128..1024,
//     causal, bf16): bytes bound every served shape (causal FLOPs grow as
//     S^2 and overtake the bytes only past S of about 1200).  At these
//     sizes the kernel runs for microseconds, so the launch, the first
//     tile's load and the longest q tile (the causal tail) are what cost.
//   * recurrentgemma-9b's local attention (B=1, H=16 over KV=1, D=256,
//     window 2048, S up to 2560, bf16): the FLOPs bound it.  At S=2048,
//     3.44e10 FLOPs take 34.8 us at 989e12, the 35.7 MB of q, k, v and o
//     10.6 us.  P is kept as two bf16 halves (below), so the P.V product
//     is issued twice and the tensor cores see 1.5x those FLOPs.
//
// Design of the bf16 instances (head_dim 64, 128, 256): the tensor cores.
//   * One block per (128-row q tile, head, batch), 384 threads: two
//     consumer warpgroups of 64 query rows each and one producer
//     warpgroup.  Blocks are launched heaviest q tile first (the q-tile
//     index is reversed), so the causal tail does not straggle.
//   * The producer (one thread; its warpgroup gives up registers with
//     setmaxnreg) loads the Q tile once and K/V tiles of 64 keys into a
//     ring of shared-memory stages with TMA, each completing on an
//     mbarrier; the consumers hand a stage back with an arrive on its
//     "empty" barrier.  The tensor maps describe (B, S, heads, D) as it
//     is (heads x D is the row stride); a box is 64 elements (128 B) of
//     one head's row, so D=128 and 256 are 2 and 4 boxes; the 128-byte
//     swizzle is the layout the wgmma descriptors read; TMA's zero fill
//     covers rows past Sq or Skv, and keys past Skv are also masked.
//   * S = Q.K^T: wgmma m64n64k16 with both operands in shared memory
//     (K-major), bf16 in, fp32 accumulate.  Products of bf16 values are
//     exact in fp32, so S differs from an fp32 dot product only in the
//     order of the sum.
//   * Online softmax in fp32 registers (log2 domain, exp2f): KV tiles past
//     the causal limit or wholly before the window are not loaded; the
//     mask arithmetic runs only on tiles that cross the diagonal, the
//     window's edge or Skv, and a warpgroup skips the products of a tile
//     that is wholly masked for its rows.
//   * O += P.V: wgmma m64n64k16 with P from registers (the accumulator
//     layout of S is the A-operand layout) and V read from its [key][d]
//     tile through the transposed-B bit, so V is never transposed.  P
//     rounded once to bf16 would miss the check of half a bf16 ulp
//     against fp32, so P = P_hi + P_lo (P_hi = bf16(P), P_lo = bf16(P -
//     P_hi), about 16 bits of P) and both halves go through the tensor
//     cores into the same fp32 accumulator.
//   * The row max, row sum and O rescale are per thread (two rows each)
//     with quad shuffles; O is divided by max(l, 1e-30) and stored as
//     bf16 straight from registers.
//   * Shared memory: Q 16 KB per 64 columns of D, K and V 8 KB each per
//     64 columns and stage; 4 stages at D=64 and 128, 2 at D=256
//     (197,704 B with the alignment slack and the barriers).  Registers:
//     the consumers take 240 a thread, the producer 24; at D=256 the O
//     accumulator alone is 128 of them.
//
// fp32 instances: the SIMT kernel flash_fwd<D> (fp32 FMAs outside
// the tensor cores, so fp32 inputs match the plain version to rounding).
// One block per (64-row q tile, head, batch), 256 threads in 16 groups of
// 16 lanes, each group owning 4 query rows; Q, K and V tiles converted to
// fp32 in shared memory with padded rows; P through shared memory to the
// P.V product.  The dtype picks the instance; a bf16 call never runs it.

#include <cuda.h>  // CUtensorMap and its enums only: nothing links libcuda
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr float kNegInf = -1e30f;

// ---------------------------------------------------------------------------
// fp32: the SIMT kernel.

constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 64;        // keys per KV tile
constexpr int kThreads = 256;  // 16 row groups x 16 lanes
constexpr int kRows = 4;       // query rows per row group

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (kBQ * (D + 1) + kBK * (D + 1) + kBK * D + kBQ * (kBK + 1));
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ o, int Sq,
              int Skv, int H, int KV, int causal, int window, float scale) {
  constexpr int DP = D + 1;      // padded row stride of sQ / sK
  constexpr int PP = kBK + 1;    // padded row stride of sP
  constexpr int CPT = kBK / 16;  // score columns per lane
  constexpr int DPT = D / 16;    // output columns per lane

  extern __shared__ float smem[];
  float* sQ = smem;            // kBQ x DP
  float* sK = sQ + kBQ * DP;   // kBK x DP
  float* sV = sK + kBK * DP;   // kBK x D
  float* sP = sV + kBK * D;    // kBQ x PP

  const int tid = threadIdx.x;
  const int ty = tid >> 4;  // row group
  const int tx = tid & 15;  // lane in the row group
  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);

  const long q_row = (long)H * D;    // elements between sequence positions
  const long kv_row = (long)KV * D;
  const float* qb = q + (long)b * Sq * q_row + (long)h * D;
  const float* kb = k + (long)b * Skv * kv_row + (long)kvh * D;
  const float* vb = v + (long)b * Skv * kv_row + (long)kvh * D;
  float* ob = o + (long)b * Sq * q_row + (long)h * D;

  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int r = i / D, d = i - r * D;
    const int qp = q0 + r;
    sQ[r * DP + d] = qp < Sq ? qb[qp * q_row + d] : 0.f;
  }

  float m[kRows], l[kRows], acc[kRows][DPT];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DPT; ++c) acc[i][c] = 0.f;
  }

  // KV tiles this q tile can see.
  const int q_last = min(q0 + kBQ, Sq) - 1;
  int kt_end = (Skv + kBK - 1) / kBK;
  if (causal) kt_end = min(kt_end, q_last / kBK + 1);
  int kt_begin = 0;
  if (window >= 0) {
    const int first = q0 - window + 1;  // first key row q0 may see
    if (first > 0) kt_begin = first / kBK;
  }

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // the previous tile is consumed (and sQ is filled)
    for (int i = tid; i < kBK * D; i += kThreads) {
      const int r = i / D, d = i - r * D;
      const int kp = k0 + r;
      const bool ok = kp < Skv;
      sK[r * DP + d] = ok ? kb[kp * kv_row + d] : 0.f;
      sV[r * D + d] = ok ? vb[kp * kv_row + d] : 0.f;
    }
    __syncthreads();

    float s[kRows][CPT];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int c = 0; c < CPT; ++c) s[i][c] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[kRows], kv[CPT];
#pragma unroll
      for (int i = 0; i < kRows; ++i) qv[i] = sQ[(ty * kRows + i) * DP + d];
#pragma unroll
      for (int c = 0; c < CPT; ++c) kv[c] = sK[(tx + 16 * c) * DP + d];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int c = 0; c < CPT; ++c) s[i][c] = fmaf(qv[i], kv[c], s[i][c]);
    }

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int r = ty * kRows + i;
      const int qp = q0 + r;
      bool ok[CPT];
      float mx = kNegInf;
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const int kp = k0 + tx + 16 * c;
        ok[c] = kp < Skv && (!causal || kp <= qp) &&
                (window < 0 || kp > qp - window);
        s[i][c] = ok[c] ? s[i][c] * scale : kNegInf;
        mx = fmaxf(mx, s[i][c]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      float rs = 0.f;
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const float p = ok[c] ? expf(s[i][c] - m_new) : 0.f;
        sP[r * PP + tx + 16 * c] = p;
        rs += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DPT; ++c) acc[i][c] *= corr;
    }
    __syncwarp();  // sP rows of this row group are written by its lanes

#pragma unroll 4
    for (int j = 0; j < kBK; ++j) {
      float pv[kRows], vv[DPT];
#pragma unroll
      for (int i = 0; i < kRows; ++i) pv[i] = sP[(ty * kRows + i) * PP + j];
#pragma unroll
      for (int c = 0; c < DPT; ++c) vv[c] = sV[j * D + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int c = 0; c < DPT; ++c) acc[i][c] = fmaf(pv[i], vv[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int qp = q0 + ty * kRows + i;
    if (qp < Sq) {
      const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
      for (int c = 0; c < DPT; ++c)
        ob[qp * q_row + tx + 16 * c] = acc[i][c] / den;
    }
  }
}

template <int D>
cudaError_t launch_fp32(const void* q, const void* k, const void* v, void* o,
                        int B, int Sq, int Skv, int H, int KV, int causal,
                        int window, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  flash_fwd<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), Sq, Skv, H, KV,
      causal, window, scale);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16: the tensor-core kernel (wgmma, TMA, mbarriers).

constexpr int kTcRows = 128;           // query rows per block (2 x 64)
constexpr int kTcKeys = 64;            // keys per KV tile
constexpr int kConsumers = 256;        // two consumer warpgroups
constexpr int kTcThreads = kConsumers + 128;  // + the producer warpgroup

template <int D>
struct Tc {
  static constexpr int kChunks = D / 64;  // 64-column (128-byte) boxes
  static constexpr int kStages = D == 256 ? 2 : 4;
  static constexpr int kQChunk = kTcRows * 128;  // bytes of one Q box
  static constexpr int kKVChunk = kTcKeys * 128;  // bytes of one K/V box
  static constexpr int kQBytes = kChunks * kQChunk;
  static constexpr int kKVBytes = kChunks * kKVChunk;  // one K or V tile
  static constexpr int kBars = 1 + 4 * kStages;
  // 1024 B of slack to align the tiles to the 128-byte swizzle's atom
  static constexpr int kSmem =
      1024 + kQBytes + 2 * kStages * kKVBytes + 8 * kBars;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Wait until the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// One TMA box of a (D, heads, S, B) tensor map into shared memory.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int d, int head,
                                         int row, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(d), "r"(head),
      "r"(row), "r"(batch)
      : "memory");
}

// wgmma matrix descriptor of a tile in the 128-byte swizzle: start address,
// leading and stride byte offsets (16-byte units), layout 1 = SWIZZLE_128B.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keep the compiler from moving register reads and writes across the
// asynchronous wgmma (its operands are live until wgmma_wait_all).
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// d (64x64 fp32, accumulator layout) = (accumulate ? d : 0) + A.B^T with A
// (64x16) and B (64x16) bf16 K-major tiles in shared memory, at OffA and
// OffB 16-byte units past the descriptors da and db.  The offsets are added
// inside the asm, so the compiler cannot hoist one descriptor per k-step
// out of the KV loop and hold them all in registers.
template <int OffA, int OffB>
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      ".reg .b64 a, b;\n"
      "add.s64 a, %32, %35;\n"
      "add.s64 b, %33, %36;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, a, b, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate), "n"(OffA), "n"(OffB));
}

// d (64x64 fp32) += A.B with A (64x16 bf16) in registers (four 32-bit words
// a thread, the A-fragment layout) and B (16 keys x 64 columns) a bf16
// tile in shared memory stored [key][column], read through the transposed
// bit (MN-major), OffB 16-byte units past the descriptor db.
template <int OffB>
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      ".reg .b64 b;\n"
      "add.s64 b, %36, %37;\n"
      "setp.ne.b32 p, %38, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, {%32, %33, %34, %35}, b, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "n"(OffB),
        "r"(1));
}

// S = Q.K^T over D / 16 k-steps: k-step KK is 16 columns (32 bytes) into
// the 128-byte box KK / 4 of each tile.
template <int D, int KK = 0>
__device__ __forceinline__ void qk_product(float (&s)[32], uint64_t dq,
                                           uint64_t dk) {
  if constexpr (KK < D / 16) {
    constexpr int col = (KK & 3) * 32;
    constexpr int off_q = ((KK >> 2) * kTcRows * 128 + col) / 16;
    constexpr int off_k = ((KK >> 2) * kTcKeys * 128 + col) / 16;
    wgmma_ss<off_q, off_k>(s, dq, dk, KK > 0);
    qk_product<D, KK + 1>(s, dq, dk);
  }
}

// O += P.V, P as its bf16 halves: box C of V holds columns 64 C .. 64 C +
// 63; k-step KK is keys 16 KK .. 16 KK + 15 (2048 bytes into the box).
template <int kChunks, int I = 0>
__device__ __forceinline__ void pv_product(float (&o)[kChunks][32],
                                           const uint32_t (&hi)[4][4],
                                           const uint32_t (&lo)[4][4],
                                           uint64_t dv) {
  if constexpr (I < kChunks * 4) {
    constexpr int c = I / 4, kk = I % 4;
    constexpr int off = (c * kTcKeys * 128 + kk * 16 * 128) / 16;
    wgmma_rs<off>(o[c], hi[kk], dv);
    wgmma_rs<off>(o[c], lo[kk], dv);
    pv_product<kChunks, I + 1>(o, hi, lo, dv);
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The online-softmax step of one KV tile on this thread's scores s (the
// 64x64 accumulator layout: s[i] is row r0 + 8 * ((i >> 1) & 1), column
// 8 * (i >> 2) + cq + (i & 1)).  Leaves P split into bf16 halves in the
// A-fragment layout (hi/lo[kk] covers keys 16 kk .. 16 kk + 15) and
// rescales o.  kMask: the tile crosses the diagonal, the window's edge or
// Skv.
template <bool kMask, int kChunks>
__device__ __forceinline__ void softmax_step(
    float (&s)[32], float (&o)[kChunks][32], float (&m)[2], float (&l)[2],
    uint32_t (&hi)[4][4], uint32_t (&lo)[4][4], float scale_log2, int k0,
    int qr0, int cq, int Skv, int causal, int window) {
  uint32_t ok = 0xffffffffu;
  if (kMask) {
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int kp = k0 + 8 * (i >> 2) + cq + (i & 1);
      const int qp = qr0 + 8 * ((i >> 1) & 1);
      const bool keep = kp < Skv && (!causal || kp <= qp) &&
                        (window < 0 || kp > qp - window);
      if (!keep) ok &= ~(1u << i);
    }
  }
  float mx[2] = {kNegInf, kNegInf};
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const float x = (!kMask || ((ok >> i) & 1u)) ? s[i] * scale_log2 : kNegInf;
    s[i] = x;
    mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], x);
  }
  float m_new[2], rs[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    m_new[r] = fmaxf(m[r], mx[r]);
  }
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int r = (i >> 1) & 1;
    const float p =
        (!kMask || ((ok >> i) & 1u)) ? exp2f(s[i] - m_new[r]) : 0.f;
    s[i] = p;
    rs[r] += p;
  }
  float corr[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 1);
    rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 2);
    corr[r] = exp2f(m[r] - m_new[r]);
    l[r] = l[r] * corr[r] + rs[r];
    m[r] = m_new[r];
  }
#pragma unroll
  for (int c = 0; c < kChunks; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[c][i] *= corr[(i >> 1) & 1];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float a = s[8 * kk + 2 * j], b = s[8 * kk + 2 * j + 1];
      const __nv_bfloat162 h2 = __floats2bfloat162_rn(a, b);
      const float2 hf = __bfloat1622float2(h2);
      hi[kk][j] = *reinterpret_cast<const uint32_t*>(&h2);
      lo[kk][j] = pack_bf16(a - hf.x, b - hf.y);
    }
}

template <int D>
__global__ void __launch_bounds__(kTcThreads, 1)
    flash_fwd_tc(const __grid_constant__ CUtensorMap tm_q,
                 const __grid_constant__ CUtensorMap tm_k,
                 const __grid_constant__ CUtensorMap tm_v,
                 __nv_bfloat16* __restrict__ o, int Sq, int Skv, int H,
                 int KV, int causal, int window, float scale_log2) {
  using C = Tc<D>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t sQ = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sK = sQ + C::kQBytes;  // stage s at sK + s * kKVBytes
  const uint32_t sV = sK + C::kStages * C::kKVBytes;
  const uint32_t bars = sV + C::kStages * C::kKVBytes;
  // barriers: Q, then full K, full V, empty K, empty V for each stage
  const uint32_t bar_q = bars;
  const uint32_t full_k = bars + 8;
  const uint32_t full_v = full_k + 8 * C::kStages;
  const uint32_t empty_k = full_v + 8 * C::kStages;
  const uint32_t empty_v = empty_k + 8 * C::kStages;

  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTcRows;  // heaviest first
  const int h = blockIdx.x % H;
  const int b = blockIdx.x / H;
  const int kvh = h / (H / KV);

  // KV tiles this q tile can see.
  const int q_last = min(q0 + kTcRows, Sq) - 1;
  int kt_end = (Skv + kTcKeys - 1) / kTcKeys;
  if (causal) kt_end = min(kt_end, q_last / kTcKeys + 1);
  int kt_begin = 0;
  if (window >= 0 && q0 - window + 1 > 0)
    kt_begin = (q0 - window + 1) / kTcKeys;
  const int n_tiles = max(kt_end - kt_begin, 0);

  const int tid = threadIdx.x;
  if (tid == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < C::kStages; ++s) {
      mbar_init(full_k + 8 * s, 1);
      mbar_init(full_v + 8 * s, 1);
      mbar_init(empty_k + 8 * s, kConsumers);
      mbar_init(empty_v + 8 * s, kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= kConsumers) {
    // Producer warpgroup: one thread issues every TMA load.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (tid == kConsumers) {
      mbar_expect_tx(bar_q, C::kQBytes);
      for (int c = 0; c < C::kChunks; ++c)
        tma_load(sQ + c * C::kQChunk, &tm_q, bar_q, 64 * c, h, q0, b);
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % C::kStages;
        const uint32_t parity = ((it / C::kStages) & 1) ^ 1;
        const int k0 = (kt_begin + it) * kTcKeys;
        const uint32_t st = s * C::kKVBytes;
        mbar_wait(empty_k + 8 * s, parity);
        mbar_expect_tx(full_k + 8 * s, C::kKVBytes);
        for (int c = 0; c < C::kChunks; ++c)
          tma_load(sK + st + c * C::kKVChunk, &tm_k, full_k + 8 * s, 64 * c,
                   kvh, k0, b);
        mbar_wait(empty_v + 8 * s, parity);
        mbar_expect_tx(full_v + 8 * s, C::kKVBytes);
        for (int c = 0; c < C::kChunks; ++c)
          tma_load(sV + st + c * C::kKVChunk, &tm_v, full_v + 8 * s, 64 * c,
                   kvh, k0, b);
      }
    }
  } else {
    // Consumer warpgroups: 64 query rows each.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int wg = tid >> 7;
    const int lane = tid & 31;
    const int qa = q0 + 64 * wg;  // this warpgroup's first row
    const int qr0 = qa + 16 * ((tid >> 5) & 3) + (lane >> 2);  // and qr0 + 8
    const int cq = 2 * (lane & 3);
    const uint32_t sQw = sQ + wg * 64 * 128;

    float o_acc[C::kChunks][32];
#pragma unroll
    for (int c = 0; c < C::kChunks; ++c)
#pragma unroll
      for (int i = 0; i < 32; ++i) o_acc[c][i] = 0.f;
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

    mbar_wait(bar_q, 0);
    for (int it = 0; it < n_tiles; ++it) {
      const int s = it % C::kStages;
      const uint32_t parity = (it / C::kStages) & 1;
      const int k0 = (kt_begin + it) * kTcKeys;
      const uint32_t st = s * C::kKVBytes;
      // wholly masked for this warpgroup's rows / crossing a mask edge
      const bool skip = (causal && k0 > qa + 63) ||
                        (window >= 0 && k0 + kTcKeys - 1 <= qa - window);
      const bool edge = k0 + kTcKeys > Skv ||
                        (causal && k0 + kTcKeys - 1 > qa) ||
                        (window >= 0 && k0 <= qa + 63 - window);

      float sc[32];
      uint32_t hi[4][4], lo[4][4];
      mbar_wait(full_k + 8 * s, parity);
      if (!skip) {
#pragma unroll
        for (int i = 0; i < 32; ++i) sc[i] = 0.f;
        fence_regs(sc);
        wgmma_fence();
        qk_product<D>(sc, desc_sw128(sQw, 16, 1024),
                      desc_sw128(sK + st, 16, 1024));
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(sc);
      }
      mbar_arrive(empty_k + 8 * s);
      if (!skip) {
        if (edge)
          softmax_step<true>(sc, o_acc, m, l, hi, lo, scale_log2, k0, qr0, cq,
                             Skv, causal, window);
        else
          softmax_step<false>(sc, o_acc, m, l, hi, lo, scale_log2, k0, qr0,
                              cq, Skv, causal, window);
      }
      mbar_wait(full_v + 8 * s, parity);
      if (!skip) {
#pragma unroll
        for (int c = 0; c < C::kChunks; ++c) fence_regs(o_acc[c]);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          fence_regs(hi[kk]);
          fence_regs(lo[kk]);
        }
        wgmma_fence();
        pv_product(o_acc, hi, lo, desc_sw128(sV + st, C::kKVChunk, 1024));
        wgmma_commit();
        wgmma_wait_all();
#pragma unroll
        for (int c = 0; c < C::kChunks; ++c) fence_regs(o_acc[c]);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          fence_regs(hi[kk]);
          fence_regs(lo[kk]);
        }
      }
      mbar_arrive(empty_v + 8 * s);
    }

    const float den[2] = {fmaxf(l[0], 1e-30f), fmaxf(l[1], 1e-30f)};
    const long row = (long)H * D;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qp = qr0 + 8 * r;
      if (qp < Sq) {
        __nv_bfloat16* orow = o + ((long)b * Sq + qp) * row + (long)h * D;
#pragma unroll
        for (int c = 0; c < C::kChunks; ++c)
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int i = 4 * j + 2 * r;
            *reinterpret_cast<uint32_t*>(orow + 64 * c + 8 * j + cq) =
                pack_bf16(o_acc[c][i] / den[r], o_acc[c][i + 1] / den[r]);
          }
      }
    }
  }
}

// cuTensorMapEncodeTiled, from the CUDA driver API through the runtime's
// entry-point query, so the library needs no -lcuda.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = []() -> EncodeTiled {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess)
      return nullptr;
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// The (B, S, heads, D) bf16 tensor as a 4-d tensor map (D innermost) whose
// box is 64 columns of `rows` rows of one head, in the 128-byte swizzle.
bool make_map(CUtensorMap* map, const void* ptr, int B, int S, int heads,
              int D, int rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t s = S > 0 ? S : 1;  // an empty K/V is never read
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)heads, s,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {2ull * D, 2ull * heads * D,
                                 2ull * heads * D * s};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(ptr), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* o,
                        int B, int Sq, int Skv, int H, int KV, int causal,
                        int window, float scale, cudaStream_t stream) {
  CUtensorMap tm_q, tm_k, tm_v;
  if (!make_map(&tm_q, q, B, Sq, H, D, kTcRows) ||
      !make_map(&tm_k, k, B, Skv, KV, D, kTcKeys) ||
      !make_map(&tm_v, v, B, Skv, KV, D, kTcKeys))
    return cudaErrorInvalidValue;
  const int smem = Tc<D>::kSmem;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_tc<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(H * B, (Sq + kTcRows - 1) / kTcRows);
  flash_fwd_tc<D><<<grid, kTcThreads, smem, stream>>>(
      tm_q, tm_k, tm_v, static_cast<__nv_bfloat16*>(o), Sq, Skv, H, KV,
      causal, window, scale * 1.4426950408889634f);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32 (SIMT kernel), 1 = bfloat16 (tensor-core kernel; q, k,
// v 16-byte aligned).  window < 0 means no window.  Returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* o, int B, int Sq,
                                   int Skv, int H, int KV, int D, int causal,
                                   int window, float scale, int dtype,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    if (D == 64)
      return launch_fp32<64>(q, k, v, o, B, Sq, Skv, H, KV, causal, window,
                             scale, s);
    if (D == 128)
      return launch_fp32<128>(q, k, v, o, B, Sq, Skv, H, KV, causal, window,
                              scale, s);
    if (D == 256)
      return launch_fp32<256>(q, k, v, o, B, Sq, Skv, H, KV, causal, window,
                              scale, s);
  } else if (dtype == 1) {
    if (D == 64)
      return launch_bf16<64>(q, k, v, o, B, Sq, Skv, H, KV, causal, window,
                             scale, s);
    if (D == 128)
      return launch_bf16<128>(q, k, v, o, B, Sq, Skv, H, KV, causal, window,
                              scale, s);
    if (D == 256)
      return launch_bf16<256>(q, k, v, o, B, Sq, Skv, H, KV, causal, window,
                              scale, s);
  }
  return (int)cudaErrorInvalidValue;
}
