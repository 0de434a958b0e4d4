// Ring collectives over emulated ranks on one Hopper card (sm_90a).
//
// One card has no peers, so the ranks of a ring are the leading rows of one
// stacked tensor in device memory.  A ring step on a TPU is a DMA from a
// neighbour; here it is a read of that neighbour's row.  What the kernels
// keep from the TPU kernels is the function and, for the reduce-scatter,
// the order in which each output element sums its sources: that order is
// the only part of the ring schedule a result can show.
//
// Layout: `rings` independent rings of `p` ranks each, rank (b, r) at
// stacked row b*p + r (a split_by(block=p) communicator), and `m` elements
// per (source, destination) chunk.  All indexing is 64-bit: the gradient
// allreduce's padded blocks hold 4 x 4 x 154,892,544 elements, more than
// 2^31 - 1.
//
// Kernels (each a simple memory-bound copy or fold: one 16-byte vector per
// thread where every chunk row is 16-byte aligned, else one element):
//
//  B1 ring_reduce_scatter  replaces src/repro/kernels/collectives/
//     collectives.py:117 ring_reduce_scatter_pallas.
//     out[b,r,i] = left fold of xs[b,(r+1+k)%p,r,i] for k = 0..p-1, rounded
//     to the storage type after every add (bf16/fp16: widen, add, round to
//     nearest even), as the Pallas kernel's accumulator in the payload's
//     dtype does.  Bound: reads p*p*m and writes p*m elements per ring,
//     bytes / 3.35e12 s on an H100 SXM.
//  B2 ring_allgather       replaces collectives.py:69 ring_allgather_pallas.
//     out[b,r,j,i] = xs[b,j,i]: each input element is read once and
//     written p times.  Bound: reads p*m, writes p*p*m elements per ring.
//  B4 ring_alltoall        replaces collectives.py:176 ring_alltoall_pallas.
//     out[b,r,j,i] = xs[b,j,r,i], destination r reading its sources in the
//     offset order j = r, r-1, ... (mod p).  Bound: reads and writes p*p*m
//     elements per ring.
//
// Types: float32, float64, bfloat16, float16, int32, int64.  Integer adds
// run in the unsigned type of the same width and are cast back, so they
// wrap as XLA and numpy do (signed overflow is undefined in C++).
//
// Each C entry point launches on the given stream and returns
// cudaGetLastError(); the Python wrapper raises on anything but 0.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocksX = 65535;  // grid-stride beyond this

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

// B1.  grid: (element tiles, destination rank r, ring b).
template <typename T, int N>
__global__ void reduce_scatter_kernel(const T* __restrict__ xs,
                                      T* __restrict__ out, int64_t p,
                                      int64_t nv) {
  using V = Vec<T, N>;
  const V* in = reinterpret_cast<const V*>(xs);
  V* o = reinterpret_cast<V*>(out);
  const int64_t r = blockIdx.y;
  const int64_t b = blockIdx.z;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t v = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       v < nv; v += stride) {
    int64_t src = (r + 1 == p) ? 0 : r + 1;  // chunk r starts at r + 1
    V acc = in[((b * p + src) * p + r) * nv + v];
    for (int64_t k = 1; k < p; ++k) {
      src = (src + 1 == p) ? 0 : src + 1;
      const V x = in[((b * p + src) * p + r) * nv + v];
#pragma unroll
      for (int e = 0; e < N; ++e) acc.v[e] = Add<T>::apply(acc.v[e], x.v[e]);
    }
    o[(b * p + r) * nv + v] = acc;
  }
}

// B2.  grid: (element tiles, source rank j, ring b).
template <typename T, int N>
__global__ void allgather_kernel(const T* __restrict__ xs, T* __restrict__ out,
                                 int64_t p, int64_t nv) {
  using V = Vec<T, N>;
  const V* in = reinterpret_cast<const V*>(xs);
  V* o = reinterpret_cast<V*>(out);
  const int64_t j = blockIdx.y;
  const int64_t b = blockIdx.z;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t v = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       v < nv; v += stride) {
    const V x = in[(b * p + j) * nv + v];
    for (int64_t r = 0; r < p; ++r) o[((b * p + r) * p + j) * nv + v] = x;
  }
}

// B4.  grid: (element tiles, destination rank r, ring b).
template <typename T, int N>
__global__ void alltoall_kernel(const T* __restrict__ xs, T* __restrict__ out,
                                int64_t p, int64_t nv) {
  using V = Vec<T, N>;
  const V* in = reinterpret_cast<const V*>(xs);
  V* o = reinterpret_cast<V*>(out);
  const int64_t r = blockIdx.y;
  const int64_t b = blockIdx.z;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t v = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       v < nv; v += stride) {
    int64_t j = r;  // offset s = 0: the own bucket, then left neighbours
    for (int64_t s = 0; s < p; ++s) {
      o[((b * p + r) * p + j) * nv + v] = in[((b * p + j) * p + r) * nv + v];
      j = (j == 0) ? p - 1 : j - 1;
    }
  }
}

enum Op { kReduceScatter, kAllgather, kAlltoall };

bool aligned16(const void* ptr) {
  return (reinterpret_cast<uintptr_t>(ptr) & 15) == 0;
}

template <typename T, int N>
void launch_n(Op op, const void* xs, void* out, int64_t rings, int64_t p,
              int64_t nv, cudaStream_t stream) {
  int64_t blocks = (nv + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocksX) blocks = kMaxBlocksX;
  const dim3 grid(static_cast<unsigned>(blocks), static_cast<unsigned>(p),
                  static_cast<unsigned>(rings));
  const T* in = static_cast<const T*>(xs);
  T* o = static_cast<T*>(out);
  switch (op) {
    case kReduceScatter:
      reduce_scatter_kernel<T, N><<<grid, kThreads, 0, stream>>>(in, o, p, nv);
      break;
    case kAllgather:
      allgather_kernel<T, N><<<grid, kThreads, 0, stream>>>(in, o, p, nv);
      break;
    case kAlltoall:
      alltoall_kernel<T, N><<<grid, kThreads, 0, stream>>>(in, o, p, nv);
      break;
  }
}

template <typename T>
void launch(Op op, const void* xs, void* out, int64_t rings, int64_t p,
            int64_t m, cudaStream_t stream) {
  constexpr int N = 16 / sizeof(T);
  if (m % N == 0 && aligned16(xs) && aligned16(out)) {
    launch_n<T, N>(op, xs, out, rings, p, m / N, stream);
  } else {
    launch_n<T, 1>(op, xs, out, rings, p, m, stream);
  }
}

int dispatch(Op op, const void* xs, void* out, int64_t rings, int64_t p,
             int64_t m, int dtype, void* stream) {
  if (rings < 1 || rings > 65535 || p < 1 || p > 65535 || m < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaGetLastError();  // report this launch's error, not an earlier one
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: launch<float>(op, xs, out, rings, p, m, s); break;
    case 1: launch<double>(op, xs, out, rings, p, m, s); break;
    case 2: launch<__nv_bfloat16>(op, xs, out, rings, p, m, s); break;
    case 3: launch<__half>(op, xs, out, rings, p, m, s); break;
    case 4: launch<int32_t>(op, xs, out, rings, p, m, s); break;
    case 5: launch<int64_t>(op, xs, out, rings, p, m, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// xs: (rings, p, p, m) -> out: (rings, p, m).
int ring_reduce_scatter(const void* xs, void* out, int64_t rings, int64_t p,
                        int64_t m, int dtype, void* stream) {
  return dispatch(kReduceScatter, xs, out, rings, p, m, dtype, stream);
}

// xs: (rings, p, m) -> out: (rings, p, p, m).
int ring_allgather(const void* xs, void* out, int64_t rings, int64_t p,
                   int64_t m, int dtype, void* stream) {
  return dispatch(kAllgather, xs, out, rings, p, m, dtype, stream);
}

// xs: (rings, p, p, m) -> out: (rings, p, p, m).
int ring_alltoall(const void* xs, void* out, int64_t rings, int64_t p,
                  int64_t m, int dtype, void* stream) {
  return dispatch(kAlltoall, xs, out, rings, p, m, dtype, stream);
}

}  // extern "C"
