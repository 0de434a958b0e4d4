// RG-LRU linear-recurrence scan for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel of the JAX package:
//   src/repro/kernels/rg_lru/rg_lru.py:59 lru_scan_pallas (body _kernel
//   at :25).
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
// Design: one pass with a decoupled look-back carry (Merrill and
// Garland, "Single-pass Parallel Prefix Scan with Decoupled Look-back",
// 2016).  Each element of a and b is read from device memory once, into
// shared memory, and h is written once.  The TPU keeps the carry in VMEM
// across a sequential time grid; blocks on the card run in no order, so
// the carry crosses blocks through device memory.  One block (one warp)
// takes a tile of (batch, chunk of T steps, kTile = 32 channels), one
// thread a channel; a tile is 16 KB of shared memory at T = 64, so 13
// blocks fit an SM, and tiles in flight keep the loads going while
// look-backs wait (32 was the fastest of 32, 64, 96 and 128 channels at
// every serve shape on the H100, PERF.md):
//   1. Its tile id comes from a global atomic counter, not from
//      blockIdx, in chunk-major order: the predecessors of a tile (same
//      batch and channels, earlier chunks) have lower ids.  A block thus
//      only ever waits on blocks that took their ids before it did, and
//      so are running already; by induction on the id every wait ends
//      (forward progress without co-residency of the whole grid).
//   2. The tile's a and b are copied into shared memory (cp.async,
//      16-byte copies of 4 neighbouring channels when `vec`, else one
//      element each).  From here every thread runs on its own channel.
//   3. It walks its channel from h = 0 to the chunk's map, A = prod a in
//      time order and H = the walk with fmaf, and publishes it as the
//      chunk's "aggregate".
//   4. Look back: it reads its channel's words for the kWindow chunks
//      before its own at once, takes the nearest one whose "inclusive"
//      carry is published with every aggregate after it published, and
//      folds those aggregates in time order, carry = fmaf(A_k, carry,
//      H_k); a window with none is read again.  It publishes its own
//      inclusive carry, fmaf(A, carry, H).  Wherever the look-back stops,
//      the carry is the same sequence of fmafs from 0 over every earlier
//      chunk's map, so h is bitwise the same from run to run; only T
//      changes it.
//   5. Apply: it walks its chunk again from the carry entering it, out
//      of shared memory, h = fmaf(a, h, b), and writes h (neighbouring
//      threads, neighbouring channels: one 128-byte line a warp).
// Status and value share one word, as in Merrill and Garland's kernel
// when both fit a machine word: an aggregate is one 64-bit word {A, H}, an
// inclusive carry one 32-bit word, each written with one relaxed store
// and read with one relaxed load at GPU scope (L2; single-copy atomic),
// and all ones means "not yet published": the card's arithmetic gives no
// such float (its NaN is 0x7fffffff, and `word` maps any input NaN of
// that pattern to it).  So publishing needs no flag, fence or barrier,
// and a look-back is one read of a window.  Every spin is bounded by
// %globaltimer and ends in __trap(), so a hang becomes an error.  The
// last chunk publishes nothing; chunk 0 publishes no aggregate.
//
// Workspace (the wrapper's, per call): the aggregates, the inclusive
// carries and the tile counter, set to all ones by one cudaMemsetAsync
// (so a replayed CUDA graph starts from none published); the counter
// counts from all ones.  A call is two CUDA launches: the memset and the
// kernel.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 32;     // channels (threads) per block
constexpr int kWindow = 8;     // predecessors one look-back read covers
constexpr unsigned kUnset = ~0u;  // a word not yet published
constexpr uint64_t kSpinNs = 2000000000ull;  // a wait past 2 s is a hang

__device__ __forceinline__ unsigned ld_word(const unsigned* p) {
  unsigned v;
  asm volatile("ld.relaxed.gpu.global.u32 %0, [%1];"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}
__device__ __forceinline__ uint64_t ld_pair(const uint64_t* p) {
  uint64_t v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];"
               : "=l"(v) : "l"(p) : "memory");
  return v;
}
__device__ __forceinline__ void st_word(unsigned* p, unsigned v) {
  asm volatile("st.relaxed.gpu.global.u32 [%0], %1;"
               :: "l"(p), "r"(v) : "memory");
}
__device__ __forceinline__ void st_pair(uint64_t* p, uint64_t v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;"
               :: "l"(p), "l"(v) : "memory");
}
__device__ __forceinline__ uint64_t now_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
__device__ __forceinline__ void cp_async16(float* s, const float* g) {
  const unsigned sa = static_cast<unsigned>(__cvta_generic_to_shared(s));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;"
               :: "r"(sa), "l"(g) : "memory");
}
__device__ __forceinline__ void cp_async4(float* s, const float* g) {
  const unsigned sa = static_cast<unsigned>(__cvta_generic_to_shared(s));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;"
               :: "r"(sa), "l"(g) : "memory");
}

// A published float: its bits, never kUnset (a NaN keeps its value as
// the canonical NaN; the card's arithmetic makes no other).
__device__ __forceinline__ unsigned word(float v) {
  const unsigned u = __float_as_uint(v);
  return u == kUnset ? 0x7fffffffu : u;
}

struct Args {
  const float* a;
  const float* b;
  float* h;
  uint64_t* agg;   // (nchunks - 1, B, C): {A, H} of each chunk but the last
  unsigned* inc;   // (nchunks - 1, B, C): the carry leaving each chunk
  unsigned* counter;  // the tile counter, from kUnset
  int B, S, C, T, nchunks, nct;
};

// The carry entering chunk k > 0 of this thread's channel.  `slot` is
// chunk k's index into the workspace, `step` one chunk's stride.  One
// read of the window of kWindow predecessors; the nearest one with its
// inclusive carry published, with every aggregate after it published,
// gives the carry: that inclusive carry, then the aggregates after it
// folded in time order.  A window that has none is read again (chunk 0
// publishes its inclusive carry first, and every chunk's waits are on
// lower ones, so this ends) until %globaltimer says the wait is a hang.
__device__ __forceinline__ float look_back(const Args& p, int k, long slot,
                                           long step) {
  uint64_t deadline = 0;
  unsigned backoff = 32;
  for (;;) {
    unsigned inc[kWindow];
    uint64_t agg[kWindow];
#pragma unroll
    for (int i = 0; i < kWindow; ++i) {
      const long s = slot - (i + 1) * step;
      inc[i] = i < k ? ld_word(p.inc + s) : kUnset;
      agg[i] = i < k ? ld_pair(p.agg + s) : ~0ull;
    }
    int from = -1;  // window index of the inclusive carry
    bool open = false;  // an aggregate not yet published before it
#pragma unroll
    for (int i = 0; i < kWindow; ++i) {
      if (from < 0 && !open) {
        if (inc[i] != kUnset)
          from = i;
        else if (agg[i] == ~0ull)
          open = true;
      }
    }
    if (from >= 0) {
      float carry = 0.f;
#pragma unroll
      for (int i = 0; i < kWindow; ++i)
        if (i == from) carry = __uint_as_float(inc[i]);
#pragma unroll
      for (int i = kWindow - 1; i >= 0; --i)
        if (i < from)
          carry = fmaf(__uint_as_float((unsigned)(agg[i] >> 32)), carry,
                       __uint_as_float((unsigned)agg[i]));
      return carry;
    }
    if (deadline == 0) deadline = now_ns() + kSpinNs;
    if (now_ns() > deadline) __trap();
    __nanosleep(backoff);
    backoff = min(2 * backoff, 1024u);
  }
}

constexpr int kBatch = 8;  // time steps read from shared memory ahead

// This thread's chunk map from h = 0: *A = prod a, *H = the walk.
__device__ __forceinline__ void walk_map(const float* __restrict__ sa,
                                         const float* __restrict__ sb,
                                         int stride, int rows, float* A,
                                         float* H) {
  float p = 1.f, h = 0.f;
  int r = 0;
  for (; r + kBatch <= rows; r += kBatch) {
    float av[kBatch], bv[kBatch];
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      av[i] = sa[(r + i) * stride];
      bv[i] = sb[(r + i) * stride];
    }
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      h = fmaf(av[i], h, bv[i]);
      p *= av[i];
    }
  }
  for (; r < rows; ++r) {
    h = fmaf(sa[r * stride], h, sb[r * stride]);
    p *= sa[r * stride];
  }
  *A = p;
  *H = h;
}

// Walk this thread's chunk from h and write every step's h.
__device__ __forceinline__ void walk_out(const float* __restrict__ sa,
                                         const float* __restrict__ sb,
                                         int stride, int rows, float h,
                                         float* __restrict__ out, int C) {
  int r = 0;
  for (; r + kBatch <= rows; r += kBatch) {
    float av[kBatch], bv[kBatch];
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      av[i] = sa[(r + i) * stride];
      bv[i] = sb[(r + i) * stride];
    }
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      h = fmaf(av[i], h, bv[i]);
      out[(long)(r + i) * C] = h;
    }
  }
  for (; r < rows; ++r) {
    h = fmaf(sa[r * stride], h, sb[r * stride]);
    out[(long)r * C] = h;
  }
}

// One block, one tile: copy in, aggregate, look back, apply.
template <bool kVec>
__device__ __forceinline__ void scan_tile(const Args& p) {
  extern __shared__ __align__(16) float smem[];  // a, then b: T x kTile
  __shared__ int s_id;
  const int x = threadIdx.x;
  if (x == 0) s_id = (int)(atomicAdd(p.counter, 1u) + 1u);
  __syncthreads();
  const int id = s_id;
  const int bb = id % p.B, rest = id / p.B;  // id = (k nct + ct) B + bb
  const int ct = rest % p.nct, k = rest / p.nct;
  const int t0 = k * p.T, rows = min(p.T, p.S - t0);
  const int c0 = ct * kTile, cols = min(kTile, p.C - c0);
  const long base = ((long)bb * p.S + t0) * p.C + c0;
  float* sa = smem;
  float* sb = smem + p.T * kTile;
  if (kVec) {  // C % 4 == 0 and 16-byte aligned a, b: whole quads
    const int q = cols / 4;
    for (int i = x; i < rows * q; i += kTile) {
      const int r = i / q, j = 4 * (i - r * q);
      const long g = base + (long)r * p.C + j;
      cp_async16(sa + r * kTile + j, p.a + g);
      cp_async16(sb + r * kTile + j, p.b + g);
    }
  } else {
    for (int i = x; i < rows * cols; i += kTile) {
      const int r = i / cols, j = i - r * cols;
      const long g = base + (long)r * p.C + j;
      cp_async4(sa + r * kTile + j, p.a + g);
      cp_async4(sb + r * kTile + j, p.b + g);
    }
  }
  asm volatile("cp.async.commit_group;\n\tcp.async.wait_group 0;"
               ::: "memory");
  __syncthreads();
  if (x >= cols) return;

  // From here each thread is on its own channel: nothing waits on the
  // rest of the block.
  const bool last = k == p.nchunks - 1;
  const long step = (long)p.B * p.C;
  const long slot = k * step + (long)bb * p.C + c0 + x;
  float A = 1.f, H = 0.f, carry = 0.f;
  if (!last) walk_map(sa + x, sb + x, kTile, rows, &A, &H);
  if (k > 0) {
    if (!last)
      st_pair(p.agg + slot, (uint64_t)word(A) << 32 | word(H));
    carry = look_back(p, k, slot, step);
  }
  if (!last) st_word(p.inc + slot, word(fmaf(A, carry, H)));
  walk_out(sa + x, sb + x, kTile, rows, carry, p.h + base + x, p.C);
}

__global__ void __launch_bounds__(kTile) lru_scan_vec(const Args p) {
  scan_tile<true>(p);
}
__global__ void __launch_bounds__(kTile) lru_scan_elem(const Args p) {
  scan_tile<false>(p);
}

}  // namespace

// a, b, h: (B, S, C) fp32, contiguous.  T: time steps a chunk, at most
// 192 (a tile's a and b within the 48 KB of shared memory a launch gets
// without opting in).  vec: 16-byte copies (C % 4 == 0, a and b 16-byte
// aligned).  ws: 12 (nchunks - 1) B C + 4 bytes, 8-byte aligned (the
// aggregates, the inclusive carries, the tile counter), set to all ones
// here.  One block a tile of kTile channels.  Returns cudaGetLastError()
// after the launches (0 on success).
extern "C" int lru_scan_fwd(const float* a, const float* b, float* h,
                            void* ws, int B, int S, int C, int T, int vec,
                            void* stream) {
  if (B <= 0 || S <= 0 || C <= 0) return 0;
  if (T <= 0 || reinterpret_cast<uintptr_t>(ws) % 8 != 0)
    return (int)cudaErrorInvalidValue;
  if (vec && (C % 4 != 0 || reinterpret_cast<uintptr_t>(a) % 16 != 0 ||
              reinterpret_cast<uintptr_t>(b) % 16 != 0))
    return (int)cudaErrorInvalidValue;
  const int nchunks = (S + T - 1) / T;
  const int nct = (C + kTile - 1) / kTile;
  const long long ntiles = (long long)B * nchunks * nct;
  const size_t smem = 2 * sizeof(float) * (size_t)T * kTile;
  if (ntiles >= (1ll << 31) - 1 || smem > 48 * 1024)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t nsum = (size_t)(nchunks - 1) * B * C;
  uint64_t* agg = static_cast<uint64_t*>(ws);
  unsigned* inc = reinterpret_cast<unsigned*>(agg + nsum);
  const Args args{a, b, h, agg, inc, inc + nsum,
                  B, S, C, T, nchunks, nct};
  const cudaError_t err = cudaMemsetAsync(ws, 0xff, 12 * nsum + 4, st);
  if (err != cudaSuccess) return (int)err;
  (vec ? lru_scan_vec : lru_scan_elem)<<<(unsigned)ntiles, kTile, smem,
                                         st>>>(args);
  return (int)cudaGetLastError();
}
