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
// counting what the TPU kernel computes (the full Q x Q products):
// per (b, h, chunk) 2*Q*Q*N (C B^T) + 2*Q*Q*P (W x) + 2*Q*N*P (C S)
// + 2*Q*N*P (the state).  At the serve shape (B=1, H=32, P=64, G=1,
// N=128, Q=128, S=1024, bf16) that is 9.04 MB (2.70 us at 3.35 TB/s) and
// 2.68 GFLOP (2.71 us at the bf16 tensor peak, 40.1 us at the 67 TFLOP/s
// fp32 rate outside the tensor cores, which is what this design uses).
//
// Design (a first, simple and correct kernel; wgmma/TMA come later):
//   * one block per (P tile of 16 columns, head, batch); the TPU's
//     sequential chunk axis becomes a loop over chunks inside the block,
//     which carries its (N, 16) slice of the state in shared memory.  The
//     state's P columns are independent, so splitting P shrinks x and the
//     state and, at B = 1, puts 128 blocks on the card's 132 SMs instead
//     of 32; each block recomputes C B^T for its tile.
//   * per chunk the x tile, a, Bm and C are loaded once, converted to
//     fp32, into shared memory (row strides chosen against bank
//     conflicts, see round4): about 168 KB at Q = N = 128, above the
//     48 KB default, so the launch opts in with cudaFuncSetAttribute and
//     returns its error.
//   * the Q x Q weight matrix is never materialised: it is built 32 rows
//     at a time (32 x Q in shared memory), consumed by the W x product of
//     those rows, and overwritten.  Column blocks wholly above the
//     diagonal are not computed (a template per block count), and
//     entries with j > i are set to 0 without evaluating exp (an
//     anti-causal exp may overflow, and inf * 0 is NaN here, where the
//     TPU kernel's where() hides it).
//   * the products are bound by shared-memory loads: C rows are read 4
//     floats at a time (one broadcast load), and with one block of 8
//     warps per SM there are too few warps to hide load latency, so the
//     inner loops are unrolled for independent loads (PERF.md has the
//     times before and after);
//   * every product is an fp32 FMA (TF32 tensor cores would miss the
//     reference's 3e-4 check on fp32 inputs); la is summed by one thread
//     in sequence order, as the reference sums it.
//   * Q and N up to 128 and any P are taken at run time; the wrapper
//     refuses larger Q or N.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTP = 16;      // state / output columns per block
constexpr int kRT = 32;      // rows of the weight tile
constexpr int kMaxQ = 128;
constexpr int kMaxN = 128;

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

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

template <typename T>
__global__ void __launch_bounds__(kThreads)
    ssd_scan_kernel(const T* __restrict__ x, const float* __restrict__ a,
                    const T* __restrict__ bm, const T* __restrict__ cm,
                    T* __restrict__ y, int S, int H, int P, int G, int N,
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
  const T* xb = x + (long)b * S * x_row + (long)h * P + p0;
  T* yb = y + (long)b * S * x_row + (long)h * P + p0;
  const float* ab = a + (long)b * S * H + h;
  const T* bb = bm + (long)b * S * bc_row + (long)g * N;
  const T* cb = cm + (long)b * S * bc_row + (long)g * N;

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
      sB[r * NPB + n] = in ? load_f(bb + (s0 + r) * bc_row + n) : 0.f;
      sC[r * NPC + n] = in ? load_f(cb + (s0 + r) * bc_row + n) : 0.f;
    }
#pragma unroll 8
    for (int i = tid; i < Q * kTP; i += kThreads) {
      const int r = i / kTP, p = i - r * kTP;
      sX[i] = (p0 + p < P) ? load_f(xb + (s0 + r) * x_row + p) : 0.f;
    }
    for (int i = tid; i < Q; i += kThreads)
      sLa[i] = logf(fmaxf(ab[(long)(s0 + i) * H], 1e-37f));
    __syncthreads();

    if (tid < 32) {
      // la: a sequential sum in sequence order, the reference's order.
      // Within a chunk |la| reaches thousands on fast-decaying heads, where
      // a tree scan's other rounding moves exp(la_i - la_j) by ~1e-4.
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
          if (p0 + p < P)
            store_f(yb + (s0 + i) * x_row + p, fmaf(e, yo[k], yd[k]));
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

template <typename T>
cudaError_t launch(const void* x, const float* a, const void* bm,
                   const void* cm, void* y, int B, int S, int H, int P,
                   int G, int N, int Q, cudaStream_t stream) {
  const size_t smem = smem_floats(Q, N) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((P + kTP - 1) / kTP, H, B);
  ssd_scan_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), a, static_cast<const T*>(bm),
      static_cast<const T*>(cm), static_cast<T*>(y), S, H, P, G, N, Q);
  return cudaGetLastError();
}

}  // namespace

// dtype of x, Bm, C and y: 0 = float32, 1 = bfloat16; a is float32.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int ssd_scan_fwd(const void* x, const void* a, const void* bm,
                            const void* cm, void* y, int B, int S, int H,
                            int P, int G, int N, int Q, int dtype,
                            void* stream) {
  if (Q < 1 || Q > kMaxQ || N < 1 || N > kMaxN || S % Q || G < 1 ||
      H % G || P < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* af = static_cast<const float*>(a);
  if (dtype == 0)
    return launch<float>(x, af, bm, cm, y, B, S, H, P, G, N, Q, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, af, bm, cm, y, B, S, H, P, G, N, Q, s);
  return (int)cudaErrorInvalidValue;
}
