// RG-LRU linear-recurrence scan for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel of the JAX package:
//   src/repro/kernels/rg_lru/rg_lru.py  lru_scan_pallas (body _kernel).
// Same function: h_t = a_t * h_{t-1} + b_t with h_0 = 0, elementwise over
// the C channels and sequential over the S time steps, a, b and h all
// (B, S, C) fp32.  Unlike the Pallas kernel (which asserts S % block_t
// == 0 and C % block_c == 0) any S and any C are taken, ragged tails
// included.
//
// Bound on the card.  The work is one FMA and one multiply per element,
// so bytes bound it: a and b read once and h written once, 12 B S C
// bytes over 3.35e12 B/s (30.0 us at B = 1, S = 2048, C = 4096).
//
// Design (a first, simple and correct kernel).  The TPU walks time in a
// sequential grid axis with a VMEM carry; blocks on the card run in no
// order, and at the serve shape (B = 1, C = 4096) one thread per channel
// would give 4096 threads, a few percent of the card, each walking
// thousands of dependent steps.  So time is cut into chunks of T steps,
// and every (channel, chunk) gets its own thread, in three passes:
//   1. summary: each (channel, chunk) but the last walks its chunk from
//      h = 0 and writes the chunk's affine map (prod a, local h);
//   2. carry: one thread per channel folds the maps in time order,
//      carry_k = A_k * carry_{k-1} + H_k, and writes the carry that
//      enters each chunk over the local h (nchunks - 1 steps);
//   3. apply: each (channel, chunk) walks its chunk again from the carry
//      that enters it, h = a * h + b, and writes h.
// Inside a chunk the arithmetic is the sequential loop's, so only the
// carries round differently from lru_sequential_ref.  Neighbouring
// threads take neighbouring channels, so every load and store of a
// warp is one 128-byte line; loads of a and b are batched 8 time steps
// ahead of the dependent FMA chain.  Passes 1 and 3 read a and b twice,
// so the traffic is 20 B S C bytes against the bound's 12.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;  // channels per block
constexpr int kBatch = 8;      // time steps loaded ahead of the chain

// Walk time steps [t0, t1) of channel c from h, optionally writing h.
// Returns the final h; *prod (when given) gets the product of the a's.
template <bool kWrite, bool kProd>
__device__ __forceinline__ float walk(const float* __restrict__ a,
                                      const float* __restrict__ b,
                                      float* __restrict__ out, long base,
                                      int C, int t0, int t1, float h,
                                      float* prod) {
  float p = 1.f;
  int t = t0;
  for (; t + kBatch <= t1; t += kBatch) {
    float av[kBatch], bv[kBatch];
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      const long idx = base + (long)(t + i) * C;
      av[i] = __ldg(a + idx);
      bv[i] = __ldg(b + idx);
    }
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      h = fmaf(av[i], h, bv[i]);
      if (kProd) p *= av[i];
      if (kWrite) out[base + (long)(t + i) * C] = h;
    }
  }
  for (; t < t1; ++t) {
    const long idx = base + (long)t * C;
    const float av = __ldg(a + idx);
    h = fmaf(av, h, __ldg(b + idx));
    if (kProd) p *= av;
    if (kWrite) out[idx] = h;
  }
  if (kProd) *prod = p;
  return h;
}

// grid (ceil(C / kThreads), nchunks - 1, B)
__global__ void __launch_bounds__(kThreads)
    lru_summary(const float* __restrict__ a, const float* __restrict__ b,
                float* __restrict__ sum_a, float* __restrict__ sum_h, int S,
                int C, int T, int nsum) {
  const int c = blockIdx.x * kThreads + threadIdx.x;
  if (c >= C) return;
  const int k = blockIdx.y, bb = blockIdx.z;
  const int t0 = k * T, t1 = min(t0 + T, S);
  float prod;
  const float h = walk<false, true>(a, b, nullptr, (long)bb * S * C + c, C,
                                    t0, t1, 0.f, &prod);
  const long s = ((long)bb * nsum + k) * C + c;
  sum_a[s] = prod;
  sum_h[s] = h;
}

// grid (ceil(C / kThreads), B): sum_h[k] becomes the carry entering
// chunk k + 1.
__global__ void __launch_bounds__(kThreads)
    lru_carry(const float* __restrict__ sum_a, float* __restrict__ sum_h,
              int C, int nsum) {
  const int c = blockIdx.x * kThreads + threadIdx.x;
  if (c >= C) return;
  const long base = (long)blockIdx.y * nsum * C + c;
  float carry = 0.f;
  for (int k = 0; k < nsum; ++k) {
    const long s = base + (long)k * C;
    carry = fmaf(sum_a[s], carry, sum_h[s]);
    sum_h[s] = carry;
  }
}

// grid (ceil(C / kThreads), nchunks, B)
__global__ void __launch_bounds__(kThreads)
    lru_apply(const float* __restrict__ a, const float* __restrict__ b,
              const float* __restrict__ carry, float* __restrict__ h, int S,
              int C, int T, int nsum) {
  const int c = blockIdx.x * kThreads + threadIdx.x;
  if (c >= C) return;
  const int k = blockIdx.y, bb = blockIdx.z;
  const int t0 = k * T, t1 = min(t0 + T, S);
  const float h0 =
      k == 0 ? 0.f : carry[((long)bb * nsum + (k - 1)) * C + c];
  walk<true, false>(a, b, h, (long)bb * S * C + c, C, t0, t1, h0, nullptr);
}

}  // namespace

// a, b, h: (B, S, C) fp32, contiguous.  sum_a, sum_h: scratch of
// (B, nchunks - 1, C) fp32 each, nchunks = ceil(S / T) (unused when
// nchunks == 1).  Returns cudaGetLastError() after the launches (0 on
// success).
extern "C" int lru_scan_fwd(const float* a, const float* b, float* h,
                            float* sum_a, float* sum_h, int B, int S, int C,
                            int T, void* stream) {
  if (B <= 0 || S <= 0 || C <= 0) return 0;
  if (T <= 0 || B > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nchunks = (S + T - 1) / T;
  const int nsum = nchunks - 1;
  if (nchunks > 65535) return (int)cudaErrorInvalidValue;
  const int cblocks = (C + kThreads - 1) / kThreads;
  if (nsum > 0) {
    lru_summary<<<dim3(cblocks, nsum, B), kThreads, 0, st>>>(
        a, b, sum_a, sum_h, S, C, T, nsum);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    lru_carry<<<dim3(cblocks, B), kThreads, 0, st>>>(sum_a, sum_h, C, nsum);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  lru_apply<<<dim3(cblocks, nchunks, B), kThreads, 0, st>>>(
      a, b, sum_h, h, S, C, T, nsum);
  return (int)cudaGetLastError();
}
