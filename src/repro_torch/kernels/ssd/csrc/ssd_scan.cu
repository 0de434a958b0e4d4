// Mamba-2 SSD chunked scan for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel of the JAX package:
//   src/repro/kernels/ssd/ssd.py  ssd_scan_pallas (kernel body _kernel).
// Same function: x (B, S, H, P) with dt folded in, a (B, S, H) fp32 decay,
// Bm and C (B, S, G, N) with group h / (H / G) for head h.  Chunks of
// length Q (the wrapper checks Q = min(chunk, S) and S % Q == 0); per
// chunk, with la = cumsum(log(max(a, 1e-37))) over the chunk:
//   y = (C B^T * exp(la_i - la_j) * [j <= i]) x + exp(la) * (C S)
//   S <- exp(la_last) S + (B * exp(la_last - la))^T x
// with the (N, P) state S in fp32, starting at 0.  Inputs go to fp32 and
// the output is rounded to x's dtype once.
//
// Bound on the card.  Bytes: x and y once each, a, Bm and C once.  FLOPs,
// the least work: per (b, h, chunk) the causal half of C B^T (2 N per
// pair j <= i) and of W x (2 P per pair), plus C S and the state update
// (2 Q N P each).  At the serve shape (B=1, H=32, P=64, G=1, N=128,
// Q=128, S=1024, bf16) that is 9.04 MB (2.70 us at 3.35 TB/s) against
// 1.89 GFLOP (1.9 us at the bf16 tensor peak): the bytes bound it.
//
// bf16: the chunks in parallel, the state path on the tensor cores.  Three
// launches (two when S == Q):
//   (a) ssd_chunk_state.  One block per (chunk, head and 64-column P
//       tile, batch): la summed by one thread in sequence order (the
//       reference's order: within a chunk |la| reaches thousands on
//       fast-decaying heads, where a tree scan's other rounding moves
//       exp(la_i - la_j) by ~1e-4), written to a (B, H, S) workspace;
//       u = exp(la_last - la); the chunk's own state contribution
//       cs = (B u)^T x, (N, 64) fp32, on the tensor cores.  No chunk reads
//       the last chunk's cs, so its blocks compute la alone.  The first
//       G * kCbParts blocks in y compute C B^T once per (batch, group,
//       chunk) for all the group's heads, in fp32 FMAs (chunk_cb).
//   (b) ssd_state_carry, elementwise over (b, head, P tile) slabs: the
//       only sequential part, S_prev,1 = cs_0, S_prev,n+1 =
//       exp(la_last,n) S_prev,n + cs_n in fp32, a float4 a thread; writes
//       S_prev of chunks 1..nc-1 as bf16 pieces.  Not launched when S == Q.
//   (c) ssd_chunk_out, one block per (chunk, head and P tile, batch):
//       y = y_diag + y_off, rounded to bf16 once.  y_off = exp(la_i)
//       (C S_prev) on the tensor cores (chunk 0 has none); y_diag =
//       sum_{j <= i} W_ij x_j with W_ij = cb_ij exp(la_i - la_j), in fp32
//       FMAs.
// Why the intra-chunk path is not on the tensor cores.  C B^T, W and W x
// in fp32 FMAs, one chain per output in order (n = 0, 1, ... for C B^T;
// j = 0, 1, ..., i for W x), are the plain version's sums term for term,
// so its bf16 outputs come out bit for bit.  On the tensor cores the same
// products are summed in another order: with W split in bf16 pieces the
// outputs met the kernel check (within half a bf16 ulp of fp32 plus
// 3e-4) but differed from the plain version's bf16 in 6e-5 to 6e-4 of
// mamba2-370m's layer outputs, and its 48 bf16 layers carry that into
// 2.2-2.9% of the prefill logits, past chip_smoke.py's 2% check.  With
// the state path alone on the cores the share is 3e-6 to 6e-6 and the
// logits agree exactly (PERF.md, PR 21).  At G = 1 all 32 heads share
// C B^T, so computing it once per group costs little.
// The tensor cores: mma.sync.m16n8k16 bf16 with fp32 accumulation, one
// warp per 16 rows.  mma.sync and not wgmma: the tiles are small (16-row
// pieces of 128 x 64), and zero-filling Q, N and P to the 16 x 8 tile is
// free in shared memory; wgmma's 64-row warpgroup tiles would waste most
// of a tile at Q = 100 or N = 8.  The fp32 operands B u and S_prev go in
// as two bf16 pieces, hi = bf16(v) and lo = bf16(v - hi), into the same
// fp32 accumulator (rounded once to bf16 each would miss the kernel check:
// tests/test_torch_ssd.py emulates it, excess 7e-4 to 2.5e-3); x and C
// are bf16 inputs, exact.  Tensor work at the serve shape: (B u)^T x and
// C S_prev, 2 Q N P each, twice (two pieces) per (b, h, chunk), less the
// first chunk's C S_prev and the last chunk's cs: 1.88 GFLOP, 1.9 us at
// the bf16 peak.  fp32 FMA work: C B^T once per group and chunk (17 MFLOP)
// and W x per head (0.27 GFLOP), 4.3 us at the 67 TFLOP/s fp32 rate.
//   * Loads are cp.async (16 bytes) into padded rows (stride = 16 bytes
//     past a multiple of 128, so ldmatrix reads are conflict-free), with
//     Q, N and P zero-filled to the tile; when N or P is not a multiple
//     of 8 or a pointer is not 16-byte aligned, the same kernels load
//     element by element instead (the wrapper passes `vec`).  In (c)
//     every load is issued at the start: the state pieces and C (into the
//     x area, free until y_diag) as one cp.async group, C B^T as another,
//     x into registers; C S_prev runs while C B^T lands.  Shared memory at
//     Q = N = 128: (a) 68 KB, (c) 104 KB, so two or more blocks share an
//     SM and one block's loads overlap another's products.
//   * W stays a packed triangle (transposed, row j holding i >= j & ~3)
//     and is 0 past each row's diagonal, so an output's chain may run past
//     its diagonal adding exact zeros; no anti-causal exp is evaluated (it
//     may overflow, and inf * 0 is NaN here, where the TPU kernel's
//     where() hides it).  A thread owns 4 rows from the top of the chunk
//     and the 4 mirrored from the bottom (equal work) and 4 columns.
//   * Workspaces (the wrapper allocates them with torch.empty): la
//     (B, H, S) fp32, cs (B, nc, H, PT, Nw, 64) fp32, S_prev
//     (B, nc, H, PT, 2, Nw, 64) bf16 and C B^T (B, G, nc, tri_row(Qp))
//     fp32, Nw and Qp = N and Q rounded up to 16, PT = ceil(P / 64); the
//     padding is written as zeros.
//
// fp32: the SIMT kernel of the first port (ssd_scan_fp32), kept for fp32
// alone: every product an fp32 FMA, since TF32 tensor cores would miss the
// reference's 3e-4 check on fp32 inputs.  One block per (16 columns of P,
// head, batch) loops over the chunks and carries its (N, 16) slice of the
// state in shared memory (about 168 KB at Q = N = 128); la is summed by
// one thread in sequence order.  The dtype picks the kernels; a bf16 call
// never runs it.
//
// Q and N up to 128 and any P are taken; the wrapper refuses larger Q or
// N.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

typedef __nv_bfloat16 bf16;

// ---------------------------------------------------------------------------
// fp32: the SIMT kernel.

constexpr int kThreads = 256;
constexpr int kTP = 16;      // state / output columns per block
constexpr int kRT = 32;      // rows of the weight tile
constexpr int kMaxQ = 128;
constexpr int kMaxN = 128;

// Row strides of the (Q, N) tiles, N rounded up to N4 = 4k (the tail
// zero-filled): sC rows are read 4 at a time (16-byte aligned, stride
// N4 + 4, so 4 consecutive rows start on 4 different banks), sB rows down
// a column (odd stride N4 + 1, so 32 rows hit 32 different banks).
__host__ __device__ __forceinline__ int round4(int n) { return (n + 3) & ~3; }

__host__ __device__ __forceinline__ size_t smem_floats(int Q, int N) {
  const int N4 = round4(N);
  return (size_t)Q * (N4 + 4)         // sC
         + (size_t)Q * (N4 + 1)       // sB
         + (size_t)kRT * (kMaxQ + 1)  // sW
         + (size_t)Q * kTP            // sX
         + (size_t)N * kTP            // sS
         + 2 * (size_t)Q;             // sLa, sU
}

// One kRT-row tile of W = (C B^T) * exp(la_i - la_j) * [j <= i], for its
// NC 32-column blocks at or left of the diagonal (the y rows of the tile
// never read the others).  The thread owns rows i_base + r (r < 4) and
// columns wc + 32 c (c < NC); entries with j > i are 0 and exp is not
// evaluated for them.
template <int NC>
__device__ __forceinline__ void weight_tile(
    const float* sC, const float* sB, const float* sLa, float* sW, int NPC,
    int NPB, int N4, int Q, int i_base, int wr, int wc) {
  constexpr int WP = kMaxQ + 1;
  float acc[4][NC];
  int ci[4], bj[NC];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    ci[r] = min(i_base + r, Q - 1) * NPC;  // rows past Q are never stored
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[r][c] = 0.f;
  }
#pragma unroll
  for (int c = 0; c < NC; ++c) bj[c] = min(wc + 32 * c, Q - 1) * NPB;
#pragma unroll 2
  for (int n = 0; n < N4; n += 4) {
    float4 cv[4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
      cv[r] = *reinterpret_cast<const float4*>(sC + ci[r] + n);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const float* bp = sB + bj[c] + n;
      const float b0 = bp[0], b1 = bp[1], b2 = bp[2], b3 = bp[3];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        acc[r][c] = fmaf(cv[r].x, b0, acc[r][c]);
        acc[r][c] = fmaf(cv[r].y, b1, acc[r][c]);
        acc[r][c] = fmaf(cv[r].z, b2, acc[r][c]);
        acc[r][c] = fmaf(cv[r].w, b3, acc[r][c]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = i_base + r;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int j = wc + 32 * c;
      float w = 0.f;
      if (i < Q && j <= i) w = acc[r][c] * expf(sLa[i] - sLa[j]);
      sW[(wr + r) * WP + j] = w;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
    ssd_scan_fp32(const float* __restrict__ x, const float* __restrict__ a,
                  const float* __restrict__ bm, const float* __restrict__ cm,
                  float* __restrict__ y, int S, int H, int P, int G, int N,
                  int Q) {
  extern __shared__ float4 smem4[];  // 16-byte aligned
  float* smem = reinterpret_cast<float*>(smem4);
  const int N4 = round4(N);
  const int NPC = N4 + 4, NPB = N4 + 1;
  constexpr int WP = kMaxQ + 1;
  float* sC = smem;              // Q x NPC
  float* sB = sC + Q * NPC;      // Q x NPB
  float* sW = sB + Q * NPB;      // kRT x WP
  float* sX = sW + kRT * WP;     // Q x kTP
  float* sS = sX + Q * kTP;      // N x kTP, the carried state
  float* sLa = sS + N * kTP;     // Q
  float* sU = sLa + Q;           // Q: exp(la_last - la_j)

  const int tid = threadIdx.x;
  const int p0 = blockIdx.x * kTP;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int g = h / (H / G);

  const long x_row = (long)H * P;  // elements between sequence positions
  const long bc_row = (long)G * N;
  const float* xb = x + (long)b * S * x_row + (long)h * P + p0;
  float* yb = y + (long)b * S * x_row + (long)h * P + p0;
  const float* ab = a + (long)b * S * H + h;
  const float* bb = bm + (long)b * S * bc_row + (long)g * N;
  const float* cb = cm + (long)b * S * bc_row + (long)g * N;

  for (int i = tid; i < N * kTP; i += kThreads) sS[i] = 0.f;

  // y and the state: thread owns rows ty_y (+ 32 per row tile) and
  // columns px, px + 8 of the P tile
  const int ty_y = tid >> 3;
  const int px = tid & 7;
  // the weight tile: rows 4 * (tid / 32) + r, columns tid % 32 + 32 c
  const int wr = (tid >> 5) * 4;
  const int wc = tid & 31;
  // the state update: n = 4 * (tid / 8) + r, columns px, px + 8
  const int sn = (tid >> 3) * 4;

  const int n_chunks = S / Q;
  for (int ch = 0; ch < n_chunks; ++ch) {
    const int s0 = ch * Q;
    __syncthreads();  // the previous chunk's tiles are consumed
    // unrolled so that several global loads are in flight per thread:
    // one block per SM leaves few warps to hide their latency
#pragma unroll 8
    for (int i = tid; i < Q * N4; i += kThreads) {
      const int r = i / N4, n = i - r * N4;
      const bool in = n < N;
      sB[r * NPB + n] = in ? bb[(s0 + r) * bc_row + n] : 0.f;
      sC[r * NPC + n] = in ? cb[(s0 + r) * bc_row + n] : 0.f;
    }
#pragma unroll 8
    for (int i = tid; i < Q * kTP; i += kThreads) {
      const int r = i / kTP, p = i - r * kTP;
      sX[i] = (p0 + p < P) ? xb[(s0 + r) * x_row + p] : 0.f;
    }
    for (int i = tid; i < Q; i += kThreads)
      sLa[i] = logf(fmaxf(ab[(long)(s0 + i) * H], 1e-37f));
    __syncthreads();

    if (tid < 32) {
      // la: a sequential sum in sequence order, the reference's order
      if (tid == 0) {
        float run = 0.f;
        for (int i = 0; i < Q; ++i) {
          run += sLa[i];
          sLa[i] = run;
        }
      }
      __syncwarp();
      const float last = sLa[Q - 1];
      for (int i = tid; i < Q; i += 32) sU[i] = expf(last - sLa[i]);
    }
    __syncthreads();

    for (int r0 = 0; r0 < Q; r0 += kRT) {
      const int i_base = r0 + wr;
      switch (min(r0 / kRT + 1, (Q + 31) / 32)) {  // 32-column blocks
        case 1:
          weight_tile<1>(sC, sB, sLa, sW, NPC, NPB, N4, Q, i_base, wr, wc);
          break;
        case 2:
          weight_tile<2>(sC, sB, sLa, sW, NPC, NPB, N4, Q, i_base, wr, wc);
          break;
        case 3:
          weight_tile<3>(sC, sB, sLa, sW, NPC, NPB, N4, Q, i_base, wr, wc);
          break;
        default:
          weight_tile<4>(sC, sB, sLa, sW, NPC, NPB, N4, Q, i_base, wr, wc);
      }
      __syncthreads();

      // y rows of this tile: W x + exp(la_i) (C_i . S)
      const int i = r0 + ty_y;
      if (i < Q) {
        float yd[2] = {0.f, 0.f}, yo[2] = {0.f, 0.f};
        const int j_end = min(i + 1, Q);
#pragma unroll 8
        for (int j = 0; j < j_end; ++j) {
          const float w = sW[ty_y * WP + j];
          yd[0] = fmaf(w, sX[j * kTP + px], yd[0]);
          yd[1] = fmaf(w, sX[j * kTP + px + 8], yd[1]);
        }
#pragma unroll 8
        for (int n = 0; n < N; ++n) {
          const float c = sC[i * NPC + n];
          yo[0] = fmaf(c, sS[n * kTP + px], yo[0]);
          yo[1] = fmaf(c, sS[n * kTP + px + 8], yo[1]);
        }
        const float e = expf(sLa[i]);
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          const int p = px + 8 * k;
          if (p0 + p < P) yb[(s0 + i) * x_row + p] = fmaf(e, yo[k], yd[k]);
        }
      }
      __syncthreads();  // sW is rebuilt by the next row tile
    }

    // S <- exp(la_last) S + sum_j (B_j exp(la_last - la_j)) x_j^T; every
    // read of the old state is done (the barrier above)
    const float dec = expf(sLa[Q - 1]);
    float st[4][2];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int k = 0; k < 2; ++k) st[r][k] = 0.f;
#pragma unroll 8
    for (int j = 0; j < Q; ++j) {
      const float u = sU[j];
      const float x0 = sX[j * kTP + px], x1 = sX[j * kTP + px + 8];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int n = sn + r;
        const float bu = (n < N) ? sB[j * NPB + n] * u : 0.f;
        st[r][0] = fmaf(bu, x0, st[r][0]);
        st[r][1] = fmaf(bu, x1, st[r][1]);
      }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int n = sn + r;
      if (n < N) {
        sS[n * kTP + px] = fmaf(dec, sS[n * kTP + px], st[r][0]);
        sS[n * kTP + px + 8] = fmaf(dec, sS[n * kTP + px + 8], st[r][1]);
      }
    }
  }
}

cudaError_t launch_fp32(const void* x, const float* a, const void* bm,
                        const void* cm, void* y, int B, int S, int H, int P,
                        int G, int N, int Q, cudaStream_t stream) {
  const size_t smem = smem_floats(Q, N) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_fp32, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((P + kTP - 1) / kTP, H, B);
  ssd_scan_fp32<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(x), a, static_cast<const float*>(bm),
      static_cast<const float*>(cm), static_cast<float*>(y), S, H, P, G, N,
      Q);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16: the tensor-core kernels.

constexpr int kTcThreads = 256;  // 8 warps of 16 rows
constexpr int kPW = 64;          // P columns per block (one P tile)
constexpr int kXS = kPW + 8;     // padded row stride of x and state tiles

__host__ __device__ __forceinline__ int round16(int n) {
  return (n + 15) & ~15;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8x8 bf16 matrices; matrix m's rows at the addresses of lanes
// 8m..8m+7.  Lane l receives (row l / 4, columns 2 (l % 4), +1) of each,
// or with .trans (rows 2 (l % 4), +1, column l / 4).
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

// d (16x8 fp32) += A (16x16 bf16, row) . B (16x8 bf16, col).  Fragments,
// g = lane / 4, t = lane % 4: a[0] (g, 2t..2t+1), a[1] (g + 8, 2t..),
// a[2] (g, 2t + 8..), a[3] (g + 8, 2t + 8..); b0 (k 2t..2t+1, n g), b1
// (k 2t + 8.., n g); d[0..1] (g, 2t..2t+1), d[2..3] (g + 8, 2t..).
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The fp32 operands B u and S_prev go to the tensor cores as kPieces
// bf16 pieces: p[0] = bf16(v), p[1] = bf16(v - p[0]) (each difference is
// exact in fp32), about 16 bits of v.
constexpr int kPieces = 2;

// (v0, v1) as kPieces bf16 pieces, packed as fragments (v0 in the low
// half).
__device__ __forceinline__ void split(float v0, float v1,
                                      uint32_t (&p)[kPieces]) {
#pragma unroll
  for (int k = 0; k < kPieces; ++k) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
    const float2 hf = __bfloat1622float2(h);
    p[k] = bits(h);
    v0 -= hf.x;
    v1 -= hf.y;
  }
}

// d += A . B for A given as its pieces (fragments a[k][0..3]).
__device__ __forceinline__ void mma_pieces(float (&d)[4],
                                           const uint32_t (&a)[kPieces][4],
                                           uint32_t b0, uint32_t b1) {
#pragma unroll
  for (int k = 0; k < kPieces; ++k) mma_bf16(d, a[k], b0, b1);
}

// rows x cols bf16 from global (row stride ld) into shared memory (row
// stride sld), zero-filled to rows_pad x cols_pad.  vec: cols % 8 == 0 and
// 16-byte aligned rows, copied 16 bytes at a time with cp.async (the
// caller commits and waits); otherwise element by element.
__device__ __forceinline__ void load_tile(bf16* dst, int sld,
                                          const bf16* __restrict__ src,
                                          long ld, int rows, int cols,
                                          int rows_pad, int cols_pad,
                                          bool vec) {
  if (vec) {
    const int cpr = cols_pad / 8;
    for (int i = threadIdx.x; i < rows_pad * cpr; i += kTcThreads) {
      const int r = i / cpr, c = (i - r * cpr) * 8;
      bf16* d = dst + r * sld + c;
      if (r < rows && c < cols)
        cp_async16(d, src + r * ld + c);
      else
        *reinterpret_cast<uint4*>(d) = make_uint4(0, 0, 0, 0);
    }
  } else {
    for (int i = threadIdx.x; i < rows_pad * cols_pad; i += kTcThreads) {
      const int r = i / cols_pad, c = i - r * cols_pad;
      dst[r * sld + c] =
          (r < rows && c < cols) ? src[r * ld + c] : __float2bfloat16(0.f);
    }
  }
}

// C B^T and W are kept transposed (row j, column i) as a packed triangle:
// row j holds i = (j & ~3) .. Qp - 1 (whole 16-byte pieces from the
// diagonal on) and starts at tri_row(j); tri_row(Qp) is the size.  Every
// row starts on a 16-byte boundary.
__host__ __device__ __forceinline__ int tri_row(int j, int Qp) {
  const int q = j >> 2, r = j & 3;
  return j * Qp - 8 * q * (q - 1) - 4 * q * r;
}

struct TcShape {
  int S, H, P, G, N, Q;
  __device__ int nc() const { return S / Q; }
  __device__ int PT() const { return (P + kPW - 1) / kPW; }
  __device__ int Qp() const { return round16(Q); }
  __device__ int Nw() const { return round16(N); }
};

constexpr int kCbParts = 8;  // blocks per (batch, group, chunk) for C B^T

// Four consecutive bf16 from shared memory (8-byte aligned) as floats.
__device__ __forceinline__ float4 ld4(const bf16* p) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&v.x));
  const float2 hi = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&v.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

// cb[i][j] = sum_n C[i][n] B[j][n] for j <= i of one (batch, group,
// chunk), stored transposed in the packed triangle: one fp32 FMA chain per
// entry in order n = 0, 1, ..., the plain version's order, so every entry
// is the plain version's bit for bit.  A warp takes an item of 4 rows i
// and 64 columns j (lane: j = 2 lane, 2 lane + 1), 8 chains a lane; C's
// rows are read as broadcasts and B transposed in shared memory, so the
// lanes read consecutive words.  Entries above the diagonal are computed
// and never read.
__device__ void chunk_cb(const bf16* __restrict__ bm,
                         const bf16* __restrict__ cm, float* __restrict__ ws_cb,
                         const TcShape& sh, int vec, int ch, int g, int part,
                         int b, bf16* smem) {
  const int Q = sh.Q, Qp = sh.Qp(), N = sh.N, Nw = sh.Nw();
  const int bld = Nw + 8, tld = Qp + 8;
  const long s0 = (long)ch * Q;
  bf16* sC = smem;           // Qp x bld
  bf16* sBt = sC + Qp * bld;  // Nw x tld, B transposed
  const long off = ((b * (long)sh.S + s0) * sh.G + g) * N;
  load_tile(sC, bld, cm + off, (long)sh.G * N, Q, N, Qp, Nw, vec);
  cp_async_commit();
  const bf16 zero = __float2bfloat16(0.f);
  const long brow = (long)sh.G * N;
  if (vec) {  // 16-byte loads, all issued before the scatter
    // consecutive threads take consecutive rows j, so the transposed
    // stores hit consecutive halves of a row of sBt
    constexpr int kBLoads = kMaxQ * kMaxN / 8 / kTcThreads;
    uint4 raw[kBLoads];
#pragma unroll
    for (int u = 0; u < kBLoads; ++u) {
      const int k = threadIdx.x + u * kTcThreads;
      const int n = 8 * (k / Qp), j = k - (n / 8) * Qp;
      raw[u] = make_uint4(0u, 0u, 0u, 0u);
      if (j < Q && n < N)
        raw[u] = __ldg(reinterpret_cast<const uint4*>(bm + off + j * brow + n));
    }
#pragma unroll
    for (int u = 0; u < kBLoads; ++u) {
      const int k = threadIdx.x + u * kTcThreads;
      const int n = 8 * (k / Qp), j = k - (n / 8) * Qp;
      if (n < Nw) {
        const bf16* v = reinterpret_cast<const bf16*>(&raw[u]);
#pragma unroll
        for (int e = 0; e < 8; ++e) sBt[(n + e) * tld + j] = v[e];
      }
    }
  } else {
    for (int k = threadIdx.x; k < Qp * Nw; k += kTcThreads) {
      const int j = k / Nw, n = k - j * Nw;  // reads along B's rows
      sBt[n * tld + j] = (j < Q && n < N) ? bm[off + j * brow + n] : zero;
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  float* out = ws_cb + ((b * (long)sh.G + g) * sh.nc() + ch) *
                         (long)tri_row(Qp, Qp);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nb = (Qp + 63) / 64, items = (Qp / 4) * nb;
  for (int it = part * (kTcThreads / 32) + warp; it < items;
       it += kCbParts * (kTcThreads / 32)) {
    const int iq = it / nb, jb = it - iq * nb;
    const int i0 = 4 * iq, j = 64 * jb + 2 * lane;
    if (64 * jb > i0 + 3) continue;  // wholly above the diagonal
    if (j >= Qp) continue;
    float acc[4][2];
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[r][0] = acc[r][1] = 0.f;
    for (int n = 0; n < Nw; n += 4) {  // zero padding adds exact zeros
      float4 cv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) cv[r] = ld4(sC + (i0 + r) * bld + n);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float2 bv = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(sBt + (n + q) * tld + j));
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float c = q == 0 ? cv[r].x : q == 1 ? cv[r].y
                        : q == 2 ? cv[r].z : cv[r].w;
          acc[r][0] = fmaf(c, bv.x, acc[r][0]);
          acc[r][1] = fmaf(c, bv.y, acc[r][1]);
        }
      }
    }
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int jj = j + c;
      if ((jj & ~3) <= i0)  // inside the packed triangle
        *reinterpret_cast<float4*>(out + tri_row(jj, Qp) + i0 - (jj & ~3)) =
            make_float4(acc[0][c], acc[1][c], acc[2][c], acc[3][c]);
    }
  }
}

// (a) The chunk's state contribution cs = (B u)^T x and la; the first
// G * kCbParts blocks in y compute C B^T (chunk_cb) instead, so they start
// first.
__global__ void __launch_bounds__(kTcThreads)
    ssd_chunk_state(const bf16* __restrict__ x, const float* __restrict__ a,
                    const bf16* __restrict__ bm, const bf16* __restrict__ cm,
                    float* __restrict__ ws_la, float* __restrict__ ws_cs,
                    float* __restrict__ ws_cb, TcShape sh, int vec) {
  extern __shared__ uint4 smem_v[];
  const int ncb = sh.G * kCbParts;
  if (blockIdx.y < ncb) {
    chunk_cb(bm, cm, ws_cb, sh, vec, blockIdx.x, blockIdx.y / kCbParts,
             blockIdx.y % kCbParts, blockIdx.z,
             reinterpret_cast<bf16*>(smem_v));
    return;
  }
  const int ch = blockIdx.x, PT = sh.PT();
  const int hp = blockIdx.y - ncb;
  const int h = hp / PT, pt = hp - h * PT, b = blockIdx.z;
  const int g = h / (sh.H / sh.G);
  const int Q = sh.Q, Qp = sh.Qp(), N = sh.N, Nw = sh.Nw(), S = sh.S;
  const int bld = Nw + 8;
  const int pw = min(sh.P - pt * kPW, kPW);  // P columns of this tile
  const long s0 = (long)ch * Q;
  // no chunk reads the last chunk's contribution: there only la
  const bool last_chunk = ch + 1 == sh.nc();

  bf16* sB = reinterpret_cast<bf16*>(smem_v);  // Qp x bld
  bf16* sX = sB + Qp * bld;                    // Qp x kXS
  float* sLa = reinterpret_cast<float*>(sX + Qp * kXS);  // Qp
  float* sU = sLa + Qp;                                  // Qp

  if (!last_chunk) {
    load_tile(sB, bld, bm + ((b * (long)S + s0) * sh.G + g) * N,
              (long)sh.G * N, Q, N, Qp, Nw, vec);
    load_tile(sX, kXS,
              x + ((b * (long)S + s0) * sh.H + h) * sh.P + pt * kPW,
              (long)sh.H * sh.P, Q, pw, Qp, kPW, vec);
  }
  cp_async_commit();

  const int tid = threadIdx.x;
  for (int i = tid; i < Qp; i += kTcThreads)
    sLa[i] = i < Q ? logf(fmaxf(a[(b * (long)S + s0 + i) * sh.H + h], 1e-37f))
                   : 0.f;
  __syncthreads();
  if (tid == 0) {  // la: one register, in sequence order
    float run = 0.f;
    int i = 0;
    for (; i + 8 <= Q; i += 8) {
      float v[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) v[k] = sLa[i + k];
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        run += v[k];
        sLa[i + k] = run;
      }
    }
    for (; i < Q; ++i) {
      run += sLa[i];
      sLa[i] = run;
    }
  }
  __syncthreads();
  const float last = sLa[Q - 1];
  for (int i = tid; i < Qp; i += kTcThreads) {
    sU[i] = i < Q ? expf(last - sLa[i]) : 0.f;
    if (pt == 0 && i < Q) ws_la[(b * (long)sh.H + h) * S + s0 + i] = sLa[i];
  }
  cp_async_wait<0>();
  __syncthreads();

  const int warp = tid >> 5, lane = tid & 31;
  const int n0 = 16 * warp;  // this warp's 16 state rows
  if (n0 >= Nw || last_chunk) return;
  const int mi = lane >> 3, lr = lane & 7, gq = lane >> 2, tq = lane & 3;
  const int pw16 = round16(pw);
  float acc[kPW / 8][4];
#pragma unroll
  for (int t = 0; t < kPW / 8; ++t)
#pragma unroll
    for (int k = 0; k < 4; ++k) acc[t][k] = 0.f;

#pragma unroll 2
  for (int j0 = 0; j0 < Qp; j0 += 16) {
    // A = (B u)^T: B's [j][n] tile read transposed, matrices (j0, n0),
    // (j0, n0 + 8), (j0 + 8, n0), (j0 + 8, n0 + 8)
    uint32_t raw[4], ap[kPieces][4];
    ldsm_x4_t(raw, sB + (j0 + (mi >> 1) * 8 + lr) * bld + n0 + (mi & 1) * 8);
    const float2 u0 = *reinterpret_cast<const float2*>(sU + j0 + 2 * tq);
    const float2 u1 = *reinterpret_cast<const float2*>(sU + j0 + 8 + 2 * tq);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 u = k < 2 ? u0 : u1;
      const float2 v = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&raw[k]));
      uint32_t pc[kPieces];
      split(v.x * u.x, v.y * u.y, pc);
#pragma unroll
      for (int q = 0; q < kPieces; ++q) ap[q][k] = pc[q];
    }
#pragma unroll
    for (int p0 = 0; p0 < kPW; p0 += 16) {
      if (p0 < pw16) {
        // x's [j][p] tile read transposed: matrices (j0, p0), (j0 + 8, p0),
        // (j0, p0 + 8), (j0 + 8, p0 + 8)
        uint32_t xb[4];
        ldsm_x4_t(xb, sX + (j0 + (mi & 1) * 8 + lr) * kXS + p0 + (mi >> 1) * 8);
        mma_pieces(acc[p0 / 8], ap, xb[0], xb[1]);
        mma_pieces(acc[p0 / 8 + 1], ap, xb[2], xb[3]);
      }
    }
  }

  float* out = ws_cs +
               (((b * (long)sh.nc() + ch) * sh.H + h) * PT + pt) * Nw * kPW;
#pragma unroll
  for (int t = 0; t < kPW / 8; ++t) {
    const int p = 8 * t + 2 * tq;
    *reinterpret_cast<float2*>(out + (n0 + gq) * kPW + p) =
        make_float2(acc[t][0], acc[t][1]);
    *reinterpret_cast<float2*>(out + (n0 + gq + 8) * kPW + p) =
        make_float2(acc[t][2], acc[t][3]);
  }
}

// (b) The carry over the chunks, four state elements a thread: writes
// S_prev of chunks 1..nc-1 as its kPieces bf16 pieces (one slab each);
// chunk 0's is 0 and never read.  Launched only when nc > 1.
__global__ void __launch_bounds__(256)
    ssd_state_carry(const float* __restrict__ ws_la,
                    const float* __restrict__ ws_cs, bf16* __restrict__ ws_s,
                    TcShape sh) {
  const int PT = sh.PT(), nc = sh.nc(), Q = sh.Q;
  const int slab = sh.Nw() * kPW;
  const int e = (blockIdx.x * 256 + threadIdx.x) * 4;
  if (e >= slab) return;
  const int h = blockIdx.y / PT, pt = blockIdx.y - h * PT, b = blockIdx.z;
  const float* la = ws_la + (b * (long)sh.H + h) * sh.S;
  const long step = (long)sh.H * PT * slab;  // between chunks
  const long first = ((b * (long)nc * sh.H + h) * PT + pt) * slab + e;
  const float* cs = ws_cs + first;
  bf16* out = ws_s + kPieces * (first - e);  // chunk 0's slabs

  // S_prev_1 = exp(la_last,0) 0 + cs_0 = cs_0; S_prev_{n+1} =
  // exp(la_last,n) S_prev_n + cs_n
  float4 st = *reinterpret_cast<const float4*>(cs);
  float4 nxt = make_float4(0.f, 0.f, 0.f, 0.f);
  if (nc > 2) nxt = *reinterpret_cast<const float4*>(cs + step);
  for (int n = 1; n < nc; ++n) {
    uint32_t p01[kPieces], p23[kPieces];
    split(st.x, st.y, p01);
    split(st.z, st.w, p23);
    bf16* o = out + kPieces * n * step + e;
#pragma unroll
    for (int k = 0; k < kPieces; ++k)
      *reinterpret_cast<uint2*>(o + k * slab) = make_uint2(p01[k], p23[k]);
    if (n + 1 < nc) {
      const float4 cur = nxt;
      if (n + 2 < nc)
        nxt = *reinterpret_cast<const float4*>(cs + (n + 1) * step);
      const float dec = expf(la[(long)n * Q + Q - 1]);
      st.x = fmaf(st.x, dec, cur.x);
      st.y = fmaf(st.y, dec, cur.y);
      st.z = fmaf(st.z, dec, cur.z);
      st.w = fmaf(st.w, dec, cur.w);
    }
  }
}

// (c) y = y_diag + y_off for one chunk, rounded to bf16 once: y_off =
// exp(la_i) (C S_prev) on the tensor cores (S_prev in bf16 pieces),
// y_diag = sum_{j <= i} W_ij x_j with W_ij = cb_ij exp(la_i - la_j) in
// fp32 FMAs, one chain per output in order j = 0, 1, ..., i (the plain
// version's order and form).
// Shared memory: the S_prev pieces (then y_diag), C B^T as the packed
// triangle (then W in place), C (then x in fp32) and la, so that every
// load is issued at the start.
constexpr int kYS = kPW + 4;  // row stride of the fp32 x and y_diag tiles

__host__ __device__ __forceinline__ size_t out_region_bytes(int Qp, int Nw) {
  const size_t st = sizeof(bf16) * kPieces * (size_t)Nw * kXS;
  const size_t yd = sizeof(float) * (size_t)Qp * kYS;
  return st > yd ? st : yd;
}

__host__ __device__ __forceinline__ size_t out_smem_bytes(int Qp, int Nw) {
  return out_region_bytes(Qp, Nw) +
         sizeof(float) * ((size_t)tri_row(Qp, Qp) + (size_t)Qp * kYS + Qp);
}

__global__ void __launch_bounds__(kTcThreads, 2)
    ssd_chunk_out(const bf16* __restrict__ x, const bf16* __restrict__ cm,
                  const float* __restrict__ ws_la,
                  const float* __restrict__ ws_cb,
                  const bf16* __restrict__ ws_s, bf16* __restrict__ y,
                  TcShape sh, int vec) {
  const int ch = blockIdx.x, PT = sh.PT();
  const int h = blockIdx.y / PT, pt = blockIdx.y - h * PT, b = blockIdx.z;
  const int g = h / (sh.H / sh.G);
  const int Q = sh.Q, Qp = sh.Qp(), N = sh.N, Nw = sh.Nw(), S = sh.S;
  const int pw = min(sh.P - pt * kPW, kPW);
  const long s0 = (long)ch * Q;
  const int tid = threadIdx.x;

  extern __shared__ uint4 smem_v[];
  unsigned char* region = reinterpret_cast<unsigned char*>(smem_v);
  bf16* sS = reinterpret_cast<bf16*>(region);  // kPieces x Nw x kXS
  float* sY = reinterpret_cast<float*>(region);  // Qp x kYS, after C S_prev
  float* sW = reinterpret_cast<float*>(region + out_region_bytes(Qp, Nw));
  const int tri = tri_row(Qp, Qp);
  float* sX = sW + tri;        // Qp x kYS
  float* sLa = sX + Qp * kYS;  // Qp

  const long slab = (long)Nw * kPW;
  const bf16* st =
      ws_s + (((b * (long)sh.nc() + ch) * sh.H + h) * PT + pt) * kPieces *
                 slab;
  if (ch > 0) {  // chunk 0 starts from the zero state
    for (int k = 0; k < kPieces; ++k)
      load_tile(sS + k * Nw * kXS, kXS, st + k * slab, kPW, Nw, kPW, Nw, kPW,
                true);
  }
  // C's rows into the x area (free until y_diag), with the state pieces
  const int cld = Nw + 8;
  bf16* sC = reinterpret_cast<bf16*>(sX);  // Qp x cld, until C S_prev is done
  if (ch > 0)
    load_tile(sC, cld, cm + ((b * (long)S + s0) * sh.G + g) * N,
              (long)sh.G * N, Q, N, Qp, Nw, vec);
  cp_async_commit();  // group: state pieces and C
  const float* cbt =
      ws_cb + ((b * (long)sh.G + g) * sh.nc() + ch) * (long)tri;
  for (int i = 4 * tid; i < tri; i += 4 * kTcThreads)
    cp_async16(sW + i, cbt + i);
  cp_async_commit();  // group: C B^T

  // x, zero-filled to Qp x 64, into registers now and into the x area (in
  // fp32) once C is read
  const long xrow = (long)sh.H * sh.P;
  const long xoff = (b * (long)S + s0) * xrow + (long)h * sh.P + pt * kPW;
  constexpr int kXLoads = kMaxQ * (kPW / 4) / kTcThreads;
  uint2 xraw[kXLoads];
#pragma unroll
  for (int u = 0; u < kXLoads; ++u) {
    const int i = tid + u * kTcThreads;
    const int r = i / (kPW / 4), c = 4 * (i % (kPW / 4));
    xraw[u] = make_uint2(0u, 0u);
    if (r < Q && c < pw) {
      const bf16* src = x + xoff + r * xrow + c;
      if (vec) {
        xraw[u] = __ldg(reinterpret_cast<const uint2*>(src));
      } else {
        const bf16 z = __float2bfloat16(0.f);
        xraw[u].x = bits(__halves2bfloat162(src[0], c + 1 < pw ? src[1] : z));
        xraw[u].y = bits(__halves2bfloat162(c + 2 < pw ? src[2] : z,
                                            c + 3 < pw ? src[3] : z));
      }
    }
  }
  for (int i = tid; i < Qp; i += kTcThreads)
    sLa[i] = i < Q ? ws_la[(b * (long)sh.H + h) * S + s0 + i] : 0.f;

  const int warp = tid >> 5, lane = tid & 31;
  const int mi = lane >> 3, lr = lane & 7, gq = lane >> 2, tq = lane & 3;
  const int i0 = 16 * warp;  // this warp's 16 rows in the tensor-core part
  const bool active = i0 < Qp;
  const int nk = Nw / 16;
  const int pw16 = round16(pw);
  const int ra = i0 + gq, rb = ra + 8;

  float acc[kPW / 8][4];  // y_off, accumulator layout
#pragma unroll
  for (int t = 0; t < kPW / 8; ++t)
#pragma unroll
    for (int k = 0; k < 4; ++k) acc[t][k] = 0.f;

  cp_async_wait<1>();  // the state pieces and C; C B^T may still be in flight
  __syncthreads();
  if (active && ch > 0) {
    // C S_prev: C's [i][n] tile as A fragments, S_prev's [n][p] tiles read
    // transposed as B fragments
    for (int kk = 0; kk < nk; ++kk) {
      uint32_t cf[4];
      ldsm_x4(cf, sC + (i0 + (mi & 1) * 8 + lr) * cld + 16 * kk +
                      (mi >> 1) * 8);
#pragma unroll
      for (int p0 = 0; p0 < kPW; p0 += 16) {
        if (p0 < pw16) {
          const int off =
              (16 * kk + (mi & 1) * 8 + lr) * kXS + p0 + (mi >> 1) * 8;
#pragma unroll
          for (int k = 0; k < kPieces; ++k) {
            uint32_t sb[4];
            ldsm_x4_t(sb, sS + k * Nw * kXS + off);
            mma_bf16(acc[p0 / 8], cf, sb[0], sb[1]);
            mma_bf16(acc[p0 / 8 + 1], cf, sb[2], sb[3]);
          }
        }
      }
    }
    const float ea = expf(sLa[ra]), eb = expf(sLa[rb]);
#pragma unroll
    for (int t = 0; t < kPW / 8; ++t) {
      acc[t][0] *= ea;
      acc[t][1] *= ea;
      acc[t][2] *= eb;
      acc[t][3] *= eb;
    }
  }
  cp_async_wait<0>();  // C B^T
  __syncthreads();  // and C is read

#pragma unroll
  for (int u = 0; u < kXLoads; ++u) {
    const int i = tid + u * kTcThreads;
    const int r = i / (kPW / 4), c = 4 * (i % (kPW / 4));
    if (r < Qp) {
      const float2 lo = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&xraw[u].x));
      const float2 hi = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&xraw[u].y));
      *reinterpret_cast<float4*>(sX + r * kYS + c) =
          make_float4(lo.x, lo.y, hi.x, hi.y);
    }
  }

  // W (transposed, packed) = cb_ij exp(la_i - la_j) for j <= i < Q, in
  // place, and 0 elsewhere (no anti-causal exp is evaluated): a row's
  // chain may then run past its diagonal, adding exact zeros
  for (int j = warp; j < Qp; j += kTcThreads / 32) {
    const float laj = sLa[j];
    float* wj = sW + tri_row(j, Qp) - (j & ~3);
    for (int i = (j & ~3) + lane; i < Qp; i += 32)
      wj[i] = (j <= i && i < Q) ? wj[i] * expf(sLa[i] - laj) : 0.f;
  }
  __syncthreads();

  // y_diag: a thread owns 4 rows from the top (4 rg ..) and the 4 mirrored
  // from the bottom (equal work) and 4 columns; per j it reads two float4
  // of W and one of x for 32 FMAs.  Each output is one chain over j in
  // order; past its row's diagonal W is 0.
  const int rg = tid >> 4, cx = 4 * (tid & 15);
  const int it = 4 * rg, ib = Qp - 4 - 4 * rg;
  const bool simt = rg < Qp / 8;
  float yt[4][4], yb[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) yt[r][c] = yb[r][c] = 0.f;
  if (simt) {
    const int top_end = min(it + 4, Q), bot_end = min(ib + 4, Q);
    int j = 0, row = 0;  // row = tri_row(j) - (j & ~3): W[j][i] = sW[row + i]
#pragma unroll 4
    for (; j < top_end; ++j) {
      const float4 wt = *reinterpret_cast<const float4*>(sW + row + it);
      const float4 wb = *reinterpret_cast<const float4*>(sW + row + ib);
      row += Qp - ((j + 1) & ~3);
      const float4 v = *reinterpret_cast<const float4*>(sX + j * kYS + cx);
      const float wtr[4] = {wt.x, wt.y, wt.z, wt.w};
      const float wbr[4] = {wb.x, wb.y, wb.z, wb.w};
      const float vr[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          yt[r][c] = fmaf(wtr[r], vr[c], yt[r][c]);
          yb[r][c] = fmaf(wbr[r], vr[c], yb[r][c]);
        }
    }
#pragma unroll 4
    for (; j < bot_end; ++j) {
      const float4 wb = *reinterpret_cast<const float4*>(sW + row + ib);
      row += Qp - ((j + 1) & ~3);
      const float4 v = *reinterpret_cast<const float4*>(sX + j * kYS + cx);
      const float wbr[4] = {wb.x, wb.y, wb.z, wb.w};
      const float vr[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) yb[r][c] = fmaf(wbr[r], vr[c], yb[r][c]);
    }
  }
  if (simt) {  // the state pieces were read before the last barrier
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      *reinterpret_cast<float4*>(sY + (it + r) * kYS + cx) =
          make_float4(yt[r][0], yt[r][1], yt[r][2], yt[r][3]);
      *reinterpret_cast<float4*>(sY + (ib + r) * kYS + cx) =
          make_float4(yb[r][0], yb[r][1], yb[r][2], yb[r][3]);
    }
  }
  __syncthreads();
  if (!active) return;

  // y = y_diag + y_off (the plain version's sum), rounded to bf16 once
  bf16* yout = y + xoff;
#pragma unroll
  for (int t = 0; t < kPW / 8; ++t) {
    const int p = 8 * t + 2 * tq;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int i = half ? rb : ra;
      if (i >= Q || p >= pw) continue;
      const float2 d = *reinterpret_cast<const float2*>(sY + i * kYS + p);
      const __nv_bfloat162 v = __floats2bfloat162_rn(
          d.x + acc[t][2 * half], d.y + acc[t][2 * half + 1]);
      bf16* o = yout + i * xrow + p;
      if (vec && p + 1 < pw) {
        *reinterpret_cast<__nv_bfloat162*>(o) = v;
      } else {
        o[0] = v.x;
        if (p + 1 < pw) o[1] = v.y;
      }
    }
  }
}

size_t state_smem(int Q, int N) {
  const size_t Qp = round16(Q), Nw = round16(N);
  const size_t state = sizeof(bf16) * Qp * (Nw + 8 + kXS) + 2 * 4 * Qp;
  const size_t cb = sizeof(bf16) * (Qp * (Nw + 8) + Nw * (Qp + 8));
  return state > cb ? state : cb;
}

size_t out_smem(int Q, int N) {
  return out_smem_bytes(round16(Q), round16(N));
}

cudaError_t launch_bf16(const void* x, const float* a, const void* bm,
                        const void* cm, void* y, void* ws_la, void* ws_cs,
                        void* ws_s, void* ws_cb, int B, int S, int H, int P,
                        int G, int N, int Q, int vec, cudaStream_t stream) {
  const TcShape sh{S, H, P, G, N, Q};
  const int nc = S / Q, PT = (P + kPW - 1) / kPW;
  const size_t smem_a = state_smem(Q, N), smem_c = out_smem(Q, N);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_chunk_state, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem_a);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(ssd_chunk_out,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_c);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(ssd_chunk_out,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;

  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* bb = static_cast<const bf16*>(bm);
  const bf16* cb = static_cast<const bf16*>(cm);
  float* la = static_cast<float*>(ws_la);
  float* cs = static_cast<float*>(ws_cs);
  bf16* st = static_cast<bf16*>(ws_s);
  float* cbw = static_cast<float*>(ws_cb);
  const dim3 grid(nc, H * PT, B);
  ssd_chunk_state<<<dim3(nc, G * kCbParts + H * PT, B), kTcThreads, smem_a,
                    stream>>>(xb, a, bb, cb, la, cs, cbw, sh, vec);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if (nc > 1) {
    const int slab = round16(N) * kPW;
    ssd_state_carry<<<dim3((slab / 4 + 255) / 256, H * PT, B), 256, 0,
                      stream>>>(la, cs, st, sh);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  ssd_chunk_out<<<grid, kTcThreads, smem_c, stream>>>(
      xb, cb, la, cbw, st, static_cast<bf16*>(y), sh, vec);
  return cudaGetLastError();
}

}  // namespace

// dtype of x, Bm, C and y: 0 = float32 (the SIMT kernel, one launch; the
// workspaces are not read), 1 = bfloat16 (the tensor-core kernels, three
// launches, two when S == Q).  vec: N and P multiples of 8 and x, Bm, C, y 16-byte aligned.
// ws_la (B, H, S) fp32, ws_cs (B, S / Q, H, ceil(P / 64), round16(N), 64)
// fp32, ws_s (B, S / Q, H, ceil(P / 64), 2, round16(N), 64) bf16 and ws_cb
// (B, G, S / Q, round16(Q), round16(Q)) fp32, all
// 16-byte aligned.  Returns the first cudaGetLastError() that is not 0
// after a launch (0 on success).
extern "C" int ssd_scan_fwd(const void* x, const void* a, const void* bm,
                            const void* cm, void* y, void* ws_la, void* ws_cs,
                            void* ws_s, void* ws_cb, int B, int S, int H,
                            int P, int G, int N, int Q, int dtype, int vec,
                            void* stream) {
  if (Q < 1 || Q > kMaxQ || N < 1 || N > kMaxN || S % Q || G < 1 ||
      H % G || P < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* af = static_cast<const float*>(a);
  if (dtype == 0) return launch_fp32(x, af, bm, cm, y, B, S, H, P, G, N, Q, s);
  if (dtype == 1)
    return launch_bf16(x, af, bm, cm, y, ws_la, ws_cs, ws_s, ws_cb, B, S, H, P,
                       G, N, Q, vec, s);
  return (int)cudaErrorInvalidValue;
}
