// Per-device ring collectives (B8) for ranks that share one Hopper card
// (sm_90a): each rank is a thread of one process with its own stream, and
// each call is ONE launch per rank on that stream.  The ring (neighbour
// barrier, p - 1 steps, pushes into the right neighbour's memory, arrival
// and credit semaphores) runs inside the kernel; the host only exchanges
// pointers before the launch.
//
//  B8a device_ring_allgather  replaces src/repro/kernels/collectives/
//     collectives.py:238 device_ring_allgather (kernel :214).  This rank's
//     chunk x (m elements) becomes out (p, m).  Step s = 0..p-2 pushes slot
//     (me - s) mod p into the right neighbour's out at the same slot: at
//     s = 0 the own chunk (also copied to out[me]), after that the chunk
//     that arrived from the left at step s - 1.  Pure data movement, so it
//     moves bytes: 16 at a time where the chunk and the buffers allow it.
//  B8b device_ring_reduce_scatter  replaces collectives.py:294
//     device_ring_reduce_scatter (kernel :262).  This rank's x (p, m) by
//     destination becomes its reduced chunk out (m).  Step 0 sends chunk
//     (me - 1) mod p to the right neighbour's receive slot 0; step s =
//     1..p-1 adds chunk (me - 1 - s) mod p to the partial that arrived in
//     slot (s - 1) % 2 and sends the sum to the right neighbour's slot
//     s % 2, the last step writing it to out.  Chunk j thus folds sources
//     j+1, ..., j, each add rounded to the storage type (bf16/fp16: widen,
//     add, round to nearest even; integers wrap), so B8b equals B1
//     (ring_collectives.cu) bit for bit.
//
// Bound: bytes.  On one card every rank's traffic shares one HBM, so the
// bound of a call over p ranks is that of B2 (B8a) or B1 (B8b) on the
// stacked payload: p*m + p*p*m elements read and written, over 3.35 TB/s.
// The adds of B8b are under 1% of that at the fp32 peak.
//
// Design:
//  * Blocks.  The chunk is split into `gridDim.x` contiguous tiles and
//    block b only ever touches tile b of every chunk and slot, so blocks
//    never wait for each other, and each (step, block) has its own counter
//    in the receiver's semaphore area.
//  * Neighbour barrier (the TPU kernel's _neighbor_barrier, :202).  Each
//    block stores the call's epoch into a flag of each neighbour, then
//    waits for both neighbours' flags.  A neighbour's block running proves
//    that all earlier work on the neighbour's stream has finished, so its
//    freshly allocated buffers may be written: the caching allocator may
//    have handed out memory that such work still used.
//  * Push.  The block stores its tile into the neighbour's buffer
//    (st.global.cg), __syncthreads(), then one thread runs
//    __threadfence_system() and a release store of the epoch into the
//    neighbour's arrival counter for (step, block).  Receive: one thread
//    spins on an acquire load of its own counter, then __syncthreads();
//    data that arrived is read with ld.global.cg, past the SM's L1.
//  * Flow control (B8b).  The receive buffer has two slots, so a sender two
//    steps ahead would overwrite a slot its right neighbour has not read
//    yet.  The TPU kernel's DMA semaphores do not prevent it: the send
//    semaphore only tells the sender its own copy has read its source and
//    the receive semaphore tells the receiver data arrived; nothing tells
//    the sender the receiver is done with a slot.  Here the receiver hands
//    the slot back after its add (a credit: release store into the left
//    neighbour's credit counter for the step it consumed), and the sender
//    of step s >= 2 waits for the credit of step s - 2.
//  * Load width.  The 16-byte path cuts tiles in vectors, the scalar path
//    in elements, so ranks that chose differently would cover different
//    ranges in block b.  The choice is therefore the host's (`vec`): the
//    AND over all ranks of "my buffers are 16-byte aligned", exchanged
//    before the launch, so every rank cuts the same tiles.
//  * Epochs.  Every call carries a new epoch (1, 2, ...), and every flag
//    and counter is a store of it, never reset: a value of an earlier
//    call is always below the current epoch.
//  * Co-residency.  Every spin assumes the neighbours' kernels run at the
//    same time.  The wrapper gives each rank at most floor(SMs / p) blocks
//    of kThreads threads, which fit one to an SM, and the host makes all
//    ranks launch before any of them goes on (so no thread makes a
//    device-wide synchronising call between two ranks' launches).  With
//    lazy module loading the first launch of a kernel could synchronise
//    the context, so device_ring_preload() loads every kernel before the
//    first call.
//  * Every spin is bounded by %globaltimer (`timeout_ns` from the block's
//    start).  A spin that runs out writes a status code into the last word
//    of its rank's semaphore area and the block returns: the caller reads
//    the status after synchronising and raises.
//
// Semaphore area of one rank, 32-bit words, nb = the block stride:
//   [0, nb)                        barrier flag stored by the left neighbour
//   [nb, 2nb)                      barrier flag stored by the right neighbour
//   2nb + s*nb + b                 arrival of step s, block b (from the left)
//   2nb + (p-1)*nb + s*nb + b      credit for step s, block b (from the right)
//   last word                      status (0 ok, 1 barrier, 2 arrival,
//                                  3 credit timed out)
//
// Each C entry point launches on the given stream and returns
// cudaGetLastError(); the Python wrapper raises on anything but 0.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <initializer_list>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kThreads = 512;
constexpr int kUnroll = 4;

enum Status : unsigned { kOk = 0, kBarrier = 1, kArrival = 2, kCredit = 3 };

template <typename T>
struct Add {
  __device__ __forceinline__ static T apply(T a, T b) { return a + b; }
};
template <>
struct Add<__nv_bfloat16> {
  __device__ __forceinline__ static __nv_bfloat16 apply(__nv_bfloat16 a,
                                                        __nv_bfloat16 b) {
    return __float2bfloat16_rn(__bfloat162float(a) + __bfloat162float(b));
  }
};
template <>
struct Add<__half> {
  __device__ __forceinline__ static __half apply(__half a, __half b) {
    return __float2half_rn(__half2float(a) + __half2float(b));
  }
};
template <>
struct Add<int32_t> {
  __device__ __forceinline__ static int32_t apply(int32_t a, int32_t b) {
    return static_cast<int32_t>(static_cast<uint32_t>(a) +
                                static_cast<uint32_t>(b));
  }
};
template <>
struct Add<int64_t> {
  __device__ __forceinline__ static int64_t apply(int64_t a, int64_t b) {
    return static_cast<int64_t>(static_cast<uint64_t>(a) +
                                static_cast<uint64_t>(b));
  }
};

// N elements moved as one load/store (16 bytes when N = 16 / sizeof(T)).
template <typename T, int N>
struct alignas(sizeof(T) * N) Vec {
  T v[N];
};

// The unsigned type of B bytes that __ldcg / __stcg take.
template <int B> struct Raw;
template <> struct Raw<1> { using type = unsigned char; };
template <> struct Raw<2> { using type = unsigned short; };
template <> struct Raw<4> { using type = unsigned int; };
template <> struct Raw<8> { using type = unsigned long long; };
template <> struct Raw<16> { using type = uint4; };

// Loads and stores at L2 (".cg"): data written by another SM is never
// read from a stale line of this SM's L1.
template <typename V>
__device__ __forceinline__ V load_cg(const V* p) {
  using R = typename Raw<sizeof(V)>::type;
  const R r = __ldcg(reinterpret_cast<const R*>(p));
  V v;
  memcpy(&v, &r, sizeof(V));
  return v;
}
template <typename V>
__device__ __forceinline__ void store_cg(V* p, const V& v) {
  using R = typename Raw<sizeof(V)>::type;
  R r;
  memcpy(&r, &v, sizeof(V));
  __stcg(reinterpret_cast<R*>(p), r);
}

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.sys.global.u32 %0, [%1];"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}
__device__ __forceinline__ void st_release(unsigned* p, unsigned v) {
  asm volatile("st.release.sys.global.u32 [%0], %1;"
               :: "l"(p), "r"(v) : "memory");
}
__device__ __forceinline__ uint64_t now_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// What one block of one rank needs to reach its semaphores.
struct Ring {
  unsigned* me;     // this rank's semaphore area
  unsigned* left;   // the left neighbour's
  unsigned* right;  // the right neighbour's
  int64_t nb;       // block stride of the layout
  int p;
  unsigned epoch;
  uint64_t deadline;

  __device__ unsigned* bar_from_left(unsigned* a, int b) const {
    return a + b;
  }
  __device__ unsigned* bar_from_right(unsigned* a, int b) const {
    return a + nb + b;
  }
  __device__ unsigned* arrival(unsigned* a, int s, int b) const {
    return a + 2 * nb + s * nb + b;
  }
  __device__ unsigned* credit(unsigned* a, int s, int b) const {
    return a + 2 * nb + static_cast<int64_t>(p - 1) * nb + s * nb + b;
  }
  __device__ unsigned* status() const {
    return me + 2 * nb + 2 * static_cast<int64_t>(p - 1) * nb;
  }

  // Thread 0 spins until *flag has reached the epoch; the block learns
  // the outcome.  False: the spin ran out and the status is written.
  __device__ bool wait(const unsigned* flag, unsigned code) const {
    __shared__ int ok;
    if (threadIdx.x == 0) {
      int good = 1;
      while (static_cast<int>(ld_acquire(flag) - epoch) < 0) {
        if (now_ns() > deadline) {
          atomicCAS(status(), static_cast<unsigned>(kOk), code);
          good = 0;
          break;
        }
        __nanosleep(64);
      }
      ok = good;
    }
    __syncthreads();
    const bool good = ok != 0;
    __syncthreads();  // `ok` is reused by the next wait
    return good;
  }

  // Every thread's stores so far are visible before *flag holds the epoch.
  __device__ void signal(unsigned* flag) const {
    __syncthreads();
    if (threadIdx.x == 0) {
      __threadfence_system();
      st_release(flag, epoch);
    }
  }

  // The neighbour barrier of block b.
  __device__ bool barrier(int b) const {
    if (threadIdx.x == 0) {
      st_release(bar_from_left(right, b), epoch);
      st_release(bar_from_right(left, b), epoch);
    }
    return wait(bar_from_left(me, b), kBarrier) &&
           wait(bar_from_right(me, b), kBarrier);
  }
};

// Block b's tile [lo, hi) of n units.
__device__ __forceinline__ void tile(int64_t n, int64_t& lo, int64_t& hi) {
  const int64_t per = (n + gridDim.x - 1) / gridDim.x;
  lo = static_cast<int64_t>(blockIdx.x) * per;
  hi = lo + per < n ? lo + per : n;
}

// B8a over units V (uint4 or bytes); n units per chunk.
template <typename V>
__global__ void __launch_bounds__(kThreads)
allgather_kernel(const V* __restrict__ x, V* out, V* right_out, int64_t n,
                 int me, Ring ring) {
  const int b = blockIdx.x;
  const int p = ring.p;
  ring.deadline = now_ns() + ring.deadline;  // deadline holds the timeout
  int64_t lo, hi;
  tile(n, lo, hi);
  if (!ring.barrier(b)) return;
  for (int s = 0; s < p - 1; ++s) {
    const int src = (me - s + p) % p;
    if (s > 0 && !ring.wait(ring.arrival(ring.me, s - 1, b), kArrival)) {
      return;
    }
    const V* from = s == 0 ? x : out + src * n;
    V* to = right_out + src * n;
    for (int64_t base = lo + threadIdx.x; base < hi;
         base += kThreads * kUnroll) {
      V v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int64_t i = base + u * kThreads;
        if (i < hi) v[u] = s == 0 ? from[i] : load_cg(from + i);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int64_t i = base + u * kThreads;
        if (i < hi) {
          store_cg(to + i, v[u]);
          if (s == 0) out[me * n + i] = v[u];
        }
      }
    }
    ring.signal(ring.arrival(ring.right, s, b));
  }
  // the last chunk to arrive (from the right neighbour, via the ring)
  ring.wait(ring.arrival(ring.me, p - 2, b), kArrival);
}

// B8b over N-element vectors of T; nv vectors per chunk.
template <typename T, int N>
__global__ void __launch_bounds__(kThreads)
reduce_scatter_kernel(const T* __restrict__ xs, T* out, const T* buf,
                      T* right_buf, int64_t nv, int me, Ring ring) {
  using V = Vec<T, N>;
  const V* x = reinterpret_cast<const V*>(xs);
  const V* mine = reinterpret_cast<const V*>(buf);
  V* right = reinterpret_cast<V*>(right_buf);
  V* o = reinterpret_cast<V*>(out);
  const int b = blockIdx.x;
  const int p = ring.p;
  ring.deadline = now_ns() + ring.deadline;  // deadline holds the timeout
  int64_t lo, hi;
  tile(nv, lo, hi);
  if (!ring.barrier(b)) return;
  // step 0: the own contribution to chunk (me - 1) seeds its partial
  const int seed = (me - 1 + p) % p;
  for (int64_t base = lo + threadIdx.x; base < hi;
       base += kThreads * kUnroll) {
    V v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t i = base + u * kThreads;
      if (i < hi) v[u] = x[seed * nv + i];
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t i = base + u * kThreads;
      if (i < hi) store_cg(right + i, v[u]);
    }
  }
  ring.signal(ring.arrival(ring.right, 0, b));
  for (int s = 1; s < p; ++s) {
    const bool last = s == p - 1;
    if (!ring.wait(ring.arrival(ring.me, s - 1, b), kArrival)) return;
    if (!last && s >= 2 &&
        !ring.wait(ring.credit(ring.me, s - 2, b), kCredit)) {
      return;
    }
    const int own = (me - 1 - s + 2 * p) % p;
    const V* in = mine + ((s - 1) % 2) * nv;
    V* to = last ? o : right + (s % 2) * nv;
    for (int64_t base = lo + threadIdx.x; base < hi;
         base += kThreads * kUnroll) {
      V v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int64_t i = base + u * kThreads;
        if (i < hi) {
          V a = load_cg(in + i);
          const V c = x[own * nv + i];
#pragma unroll
          for (int e = 0; e < N; ++e) a.v[e] = Add<T>::apply(a.v[e], c.v[e]);
          v[u] = a;
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int64_t i = base + u * kThreads;
        if (i < hi) {
          if (last) {
            to[i] = v[u];
          } else {
            store_cg(to + i, v[u]);
          }
        }
      }
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      __threadfence_system();
      if (!last) st_release(ring.arrival(ring.right, s, b), ring.epoch);
      st_release(ring.credit(ring.left, s - 1, b), ring.epoch);  // slot free
    }
  }
}

bool aligned16(const void* ptr) {
  return (reinterpret_cast<uintptr_t>(ptr) & 15) == 0;
}

int blocks_for(int64_t units, int cap) {
  int64_t want = (units + kThreads - 1) / kThreads;
  if (want < 1) want = 1;
  return static_cast<int>(want < cap ? want : cap);
}

Ring make_ring(void* sem_me, void* sem_left, void* sem_right, int64_t nb,
               int p, unsigned epoch, int64_t timeout_ns) {
  Ring r;
  r.me = static_cast<unsigned*>(sem_me);
  r.left = static_cast<unsigned*>(sem_left);
  r.right = static_cast<unsigned*>(sem_right);
  r.nb = nb;
  r.p = p;
  r.epoch = epoch;
  r.deadline = static_cast<uint64_t>(timeout_ns);  // made absolute on card
  return r;
}

template <typename T>
void launch_rs(const void* xs, void* out, const void* buf, void* right_buf,
               int64_t m, bool vec, int me, int cap, const Ring& ring,
               cudaStream_t stream) {
  constexpr int N = 16 / sizeof(T);
  const T* x = static_cast<const T*>(xs);
  T* o = static_cast<T*>(out);
  const T* mine = static_cast<const T*>(buf);
  T* right = static_cast<T*>(right_buf);
  if (vec && m % N == 0) {
    const int blocks = blocks_for(m / N, cap);
    reduce_scatter_kernel<T, N><<<blocks, kThreads, 0, stream>>>(
        x, o, mine, right, m / N, me, ring);
  } else {
    const int blocks = blocks_for(m, cap);
    reduce_scatter_kernel<T, 1><<<blocks, kThreads, 0, stream>>>(
        x, o, mine, right, m, me, ring);
  }
}

template <typename T>
cudaError_t preload_rs() {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(
      &attr, reduce_scatter_kernel<T, 16 / sizeof(T)>);
  if (err != cudaSuccess) return err;
  return cudaFuncGetAttributes(&attr, reduce_scatter_kernel<T, 1>);
}

bool bad_ring(int p, int me, int cap, int64_t nb) {
  return p < 2 || me < 0 || me >= p || cap < 1 || nb < cap;
}

// `vec` claims every rank's buffers 16-byte aligned; it must hold here.
bool bad_vec(int vec, std::initializer_list<const void*> ptrs) {
  if (!vec) return false;
  for (const void* ptr : ptrs) {
    if (!aligned16(ptr)) return true;
  }
  return false;
}

}  // namespace

extern "C" {

// Load every kernel of this file now (lazy module loading would load it
// at its first launch, which may synchronise the context while another
// rank's kernel spins).
int device_ring_preload() {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, allgather_kernel<uint4>);
  if (err == cudaSuccess) {
    err = cudaFuncGetAttributes(&attr, allgather_kernel<unsigned char>);
  }
  if (err == cudaSuccess) err = preload_rs<float>();
  if (err == cudaSuccess) err = preload_rs<double>();
  if (err == cudaSuccess) err = preload_rs<__nv_bfloat16>();
  if (err == cudaSuccess) err = preload_rs<__half>();
  if (err == cudaSuccess) err = preload_rs<int32_t>();
  if (err == cudaSuccess) err = preload_rs<int64_t>();
  return static_cast<int>(err);
}

// x: nbytes of this rank's chunk -> out: (p, nbytes); right_out is the
// right neighbour's out.  vec: every rank's x and out are 16-byte aligned
// (the same on every rank, so all cut the same tiles).
int device_ring_allgather(const void* x, void* out, void* right_out,
                          int64_t nbytes, int vec, int p, int me, int cap,
                          void* sem_me, void* sem_left, void* sem_right,
                          int64_t nb, unsigned epoch, int64_t timeout_ns,
                          void* stream) {
  if (bad_ring(p, me, cap, nb) || nbytes < 1 ||
      bad_vec(vec, {x, out, right_out})) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaGetLastError();  // report this launch's error, not an earlier one
  const Ring ring = make_ring(sem_me, sem_left, sem_right, nb, p, epoch,
                              timeout_ns);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec && nbytes % 16 == 0) {
    const int64_t n = nbytes / 16;
    allgather_kernel<uint4><<<blocks_for(n, cap), kThreads, 0, s>>>(
        static_cast<const uint4*>(x), static_cast<uint4*>(out),
        static_cast<uint4*>(right_out), n, me, ring);
  } else {
    allgather_kernel<unsigned char><<<blocks_for(nbytes, cap), kThreads, 0,
                                      s>>>(
        static_cast<const unsigned char*>(x), static_cast<unsigned char*>(out),
        static_cast<unsigned char*>(right_out), nbytes, me, ring);
  }
  return static_cast<int>(cudaGetLastError());
}

// xs: (p, m) -> out: (m); buf: this rank's (2, m) receive slots,
// right_buf the right neighbour's.  vec as for the allgather, over xs, out
// and buf.
int device_ring_reduce_scatter(const void* xs, void* out, void* buf,
                               void* right_buf, int64_t m, int dtype,
                               int vec, int p, int me, int cap,
                               void* sem_me, void* sem_left,
                               void* sem_right, int64_t nb, unsigned epoch,
                               int64_t timeout_ns, void* stream) {
  if (bad_ring(p, me, cap, nb) || m < 1 ||
      bad_vec(vec, {xs, out, buf, right_buf})) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaGetLastError();
  const Ring ring = make_ring(sem_me, sem_left, sem_right, nb, p, epoch,
                              timeout_ns);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using Launch = void (*)(const void*, void*, const void*, void*, int64_t,
                          bool, int, int, const Ring&, cudaStream_t);
  static const Launch kLaunch[] = {
      launch_rs<float>, launch_rs<double>, launch_rs<__nv_bfloat16>,
      launch_rs<__half>, launch_rs<int32_t>, launch_rs<int64_t>};
  if (dtype < 0 || dtype >= 6) return static_cast<int>(cudaErrorInvalidValue);
  kLaunch[dtype](xs, out, buf, right_buf, m, vec, me, cap, ring, s);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
