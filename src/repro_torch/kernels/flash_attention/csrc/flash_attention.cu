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
// 2*B*H*Sq*Skv*D when causal; bytes = q, k, v and o once.  At the serve
// shapes (B=1, H=KV=16, D=64, Sq=Skv in 128..1024, bf16) the bound is
// max(FLOPs / 989e12, bytes / 3.35e12) with the H100 data-sheet peaks;
// the bytes term is the larger at every serve shape (causal FLOPs grow
// as S^2 and overtake the bytes only past S of about 1200).  This design
// runs fp32 FMAs outside the tensor cores, so its own ceiling is the
// 67e12 fp32 rate; PERF.md holds its measured time beside the bound.
// At recurrentgemma-9b's local attention (B=1, S=2048, H=16 over KV=1,
// D=256, window 2048, bf16) the FLOPs term is the larger: 3.44e10 FLOPs
// take 34.8 us at 989e12, the 35.7 MB of q, k, v and o 10.6 us.
//
// Design (a first, simple and correct kernel; wgmma/TMA come later):
//   * one block per (64-row q tile, head, batch); the TPU's sequential KV
//     grid axis becomes a loop over 64-key tiles inside the block;
//   * KV tiles past the causal limit or wholly before the window are
//     skipped (they would contribute exactly nothing);
//   * Q, K and V tiles are converted to fp32 in shared memory (rows padded
//     to D+1 floats so the column reads do not collide on banks); scores,
//     softmax and the output accumulator are fp32 in registers, with fp32
//     FMAs, so fp32 inputs match the plain version to rounding;
//   * 256 threads: 16 groups of 16 lanes, each group owning 4 query rows;
//     row max and row sum are 16-lane shuffles, so no score tile needs a
//     block-wide barrier; P goes through shared memory to the P.V product.
//   * head_dim 64, 128 and 256 are template instances; other sizes are
//     refused.  At 256 the same 64-row tile takes 213,760 B of shared
//     memory, under the 232,448 B a block may opt into, and ptxas keeps
//     acc[4][16] and the scores in 128 registers without spilling, so the
//     tile is the same at every head_dim.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 64;        // keys per KV tile
constexpr int kThreads = 256;  // 16 row groups x 16 lanes
constexpr int kRows = 4;       // query rows per row group
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (kBQ * (D + 1) + kBK * (D + 1) + kBK * D + kBQ * (kBK + 1));
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, T* __restrict__ o, int Sq, int Skv,
              int H, int KV, int causal, int window, float scale) {
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
  const T* qb = q + (long)b * Sq * q_row + (long)h * D;
  const T* kb = k + (long)b * Skv * kv_row + (long)kvh * D;
  const T* vb = v + (long)b * Skv * kv_row + (long)kvh * D;
  T* ob = o + (long)b * Sq * q_row + (long)h * D;

  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int r = i / D, d = i - r * D;
    const int qp = q0 + r;
    sQ[r * DP + d] = qp < Sq ? load_f(qb + qp * q_row + d) : 0.f;
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
      sK[r * DP + d] = ok ? load_f(kb + kp * kv_row + d) : 0.f;
      sV[r * D + d] = ok ? load_f(vb + kp * kv_row + d) : 0.f;
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
        store_f(ob + qp * q_row + tx + 16 * c, acc[i][c] / den);
    }
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int Sq, int Skv, int H, int KV, int causal,
                   int window, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  flash_fwd<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), Sq, Skv, H, KV, causal,
      window, scale);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  window < 0 means no window.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* o, int B, int Sq,
                                   int Skv, int H, int KV, int D, int causal,
                                   int window, float scale, int dtype,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64 && dtype == 0)
    return launch<float, 64>(q, k, v, o, B, Sq, Skv, H, KV, causal, window,
                             scale, s);
  if (D == 64 && dtype == 1)
    return launch<__nv_bfloat16, 64>(q, k, v, o, B, Sq, Skv, H, KV, causal,
                                     window, scale, s);
  if (D == 128 && dtype == 0)
    return launch<float, 128>(q, k, v, o, B, Sq, Skv, H, KV, causal, window,
                              scale, s);
  if (D == 128 && dtype == 1)
    return launch<__nv_bfloat16, 128>(q, k, v, o, B, Sq, Skv, H, KV, causal,
                                      window, scale, s);
  if (D == 256 && dtype == 0)
    return launch<float, 256>(q, k, v, o, B, Sq, Skv, H, KV, causal, window,
                              scale, s);
  if (D == 256 && dtype == 1)
    return launch<__nv_bfloat16, 256>(q, k, v, o, B, Sq, Skv, H, KV, causal,
                                      window, scale, s);
  return (int)cudaErrorInvalidValue;
}
