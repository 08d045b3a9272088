// Per-code candidate reduction on Hopper (sm_90a), K7:
//
//   for each query row q and code c in [0, k):
//     key[q][c] = min over the positions n with seg[n] == c of
//                 (order(dist[q][n]) << 32) | n
//
// then decoded into the engine's (mins, args, matched): the least distance
// of each code, its *first* position in scan order (the reference's strict-<
// update, GestureKNN.py:686-689) and whether the code occurs. order() maps a
// float32's bits to an unsigned int of the same order (negative distances
// included: 1 - sim dips below 0 on the cosine side), -0.0 to +0.0 first so
// that the two zeros tie as == has them tie, and NaN below every number (the
// plain version's amin keeps a NaN, which then matches no position); an
// int32's order is its bits with the sign flipped. So the least key holds
// the least distance at its first position.
//
// Replaces no TPU kernel: the JAX package reduces with two
// jax.ops.segment_min passes (qpgesture_tpu/match/engine.py:89-109), and the
// port's plain version, ops/segmin_cuda.py, with two scatter_reduce passes,
// a gather and a where over the (Q, N) matrix, whose atomics all contend for
// k addresses a row. The wrapper, build and ctypes binding are
// ops/segmin_cuda.py.
//
// What bounds it on an H100: bytes. The (Q, N) matrix is read once, 4 B a
// distance, and the N codes (int64) with it; per distance there is a key to
// make, a shared-memory compare and, rarely, an atomic.
//
// Design: two kernels, no global atomics, so the same input gives the same
// bits.
//   * segmin_pass_kernel<T>: grid (splits, ceil(Q / R)). Each block holds R
//     rows x k 64-bit keys in shared memory and reads the R rows over its
//     chunk of columns with 16-byte loads, R in flight a thread; the four
//     codes of a thread's columns are loaded once and serve all R rows. A key
//     goes to its bin only if it is below the bin's current key (a plain
//     shared load; atomicMin on 64-bit shared words when it is), so after the
//     first few positions of a code almost no atomics are issued. The block
//     then writes all its R x k keys (empty bins as ~0) to the partials
//     (Q, splits, k). The wrapper derives splits from Q, N and the card's
//     resident blocks, so that one wave fills every SM.
//   * segmin_decode_kernel<T>: one thread a (q, c): the min over the splits'
//     partials (the same value in any order), then mins, args and matched.
//     The min's value is read back from dist at its position, so a -0.0 at
//     the first position comes back as -0.0, as the plain version has it.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;       // threads a block
constexpr int R = 8;          // query rows a block holds
constexpr unsigned long long EMPTY = ~0ull;

template <typename T>
struct Vec4;
template <>
struct Vec4<float> {
  using type = float4;
};
template <>
struct Vec4<int> {
  using type = int4;
};

__device__ __forceinline__ uint32_t order_bits(float x) {
  if (x != x) return 0u;                  // NaN: below every number
  uint32_t u = __float_as_uint(x);
  if (x == 0.f) u = 0u;                   // -0.0 ties with +0.0
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ uint32_t order_bits(int x) {
  return static_cast<uint32_t>(x) ^ 0x80000000u;
}

// Whether the key's high word is the NaN of a float32 matrix (never, for
// int32).
__device__ __forceinline__ bool is_nan_key(uint32_t hi, float) {
  return hi == 0u;
}
__device__ __forceinline__ bool is_nan_key(uint32_t, int) { return false; }

// Codes outside [0, k) are skipped.
__device__ __forceinline__ void offer(unsigned long long* bins, int k,
                                      long long code, uint32_t hi,
                                      uint32_t n) {
  if (static_cast<unsigned long long>(code) >=
      static_cast<unsigned long long>(k))
    return;
  unsigned long long* bin = bins + code;
  const unsigned long long key =
      (static_cast<unsigned long long>(hi) << 32) | n;
  if (key < *bin) atomicMin(bin, key);
}

// Row group blockIdx.y (rows R blockIdx.y ..., the last clamped to Q - 1:
// its bins are never written out), columns [blockIdx.x chunk, + chunk) of N.
// vec: N and chunk are multiples of 4 and dist and seg start on 16 bytes.
template <typename T>
__global__ void __launch_bounds__(NT)
segmin_pass_kernel(const T* __restrict__ dist,
                   const long long* __restrict__ seg,
                   unsigned long long* __restrict__ partials, int Q,
                   long long N, int k, long long chunk, int vec) {
  extern __shared__ unsigned long long bins[];   // R x k
  for (int i = threadIdx.x; i < R * k; i += NT) bins[i] = EMPTY;
  __syncthreads();
  const int row0 = blockIdx.y * R;
  const int rows = min(R, Q - row0);
  const T* base = dist + static_cast<long long>(row0) * N;
  long long off[R];
#pragma unroll
  for (int r = 0; r < R; ++r)
    off[r] = static_cast<long long>(min(r, rows - 1)) * N;
  const long long n0 = blockIdx.x * chunk;
  const long long n1 = min(n0 + chunk, N);
  if (vec) {
    using V = typename Vec4<T>::type;
    for (long long n = n0 + 4 * threadIdx.x; n < n1; n += 4 * NT) {
      const longlong2 s01 = __ldg(reinterpret_cast<const longlong2*>(seg + n));
      const longlong2 s23 =
          __ldg(reinterpret_cast<const longlong2*>(seg + n + 2));
      V v[R];
#pragma unroll
      for (int r = 0; r < R; ++r)
        v[r] = __ldg(reinterpret_cast<const V*>(base + off[r] + n));
      const uint32_t p = static_cast<uint32_t>(n);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        unsigned long long* b = bins + r * k;
        offer(b, k, s01.x, order_bits(v[r].x), p);
        offer(b, k, s01.y, order_bits(v[r].y), p + 1);
        offer(b, k, s23.x, order_bits(v[r].z), p + 2);
        offer(b, k, s23.y, order_bits(v[r].w), p + 3);
      }
    }
  } else {
    for (long long n = n0 + threadIdx.x; n < n1; n += NT) {
      const long long code = __ldg(seg + n);
      T v[R];
#pragma unroll
      for (int r = 0; r < R; ++r) v[r] = __ldg(base + off[r] + n);
#pragma unroll
      for (int r = 0; r < R; ++r)
        offer(bins + r * k, k, code, order_bits(v[r]),
              static_cast<uint32_t>(n));
    }
  }
  __syncthreads();
  const int splits = gridDim.x;
  for (int i = threadIdx.x; i < rows * k; i += NT) {
    const int r = i / k, c = i - r * k;
    partials[(static_cast<long long>(row0 + r) * splits + blockIdx.x) * k +
             c] = bins[i];
  }
}

template <typename T>
__global__ void __launch_bounds__(NT)
segmin_decode_kernel(const unsigned long long* __restrict__ partials,
                     const T* __restrict__ dist, float* __restrict__ mins,
                     long long* __restrict__ args, bool* __restrict__ matched,
                     int Q, long long N, int k, int splits, float unmatched) {
  const long long i = static_cast<long long>(blockIdx.x) * NT + threadIdx.x;
  if (i >= static_cast<long long>(Q) * k) return;
  const long long q = i / k;
  const int c = static_cast<int>(i - q * k);
  const unsigned long long* p = partials + q * splits * k + c;
  unsigned long long m = EMPTY;
  for (int s = 0; s < splits; ++s)
    m = min(m, p[static_cast<long long>(s) * k]);
  float v = unmatched;
  long long a = 0;
  bool ok = false;
  if (m != EMPTY && !is_nan_key(static_cast<uint32_t>(m >> 32), T())) {
    a = static_cast<long long>(m & 0xffffffffull);
    const float d = static_cast<float>(dist[q * N + a]);
    ok = isfinite(d);
    if (ok) v = d;
  }
  mins[i] = v;
  args[i] = a;
  matched[i] = ok;
}

size_t smem_bytes(int k) { return sizeof(unsigned long long) * R * k; }

template <typename T>
cudaError_t allow_smem(size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(segmin_pass_kernel<T>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <typename T>
int launch(const void* dist, const void* seg, void* partials, void* mins,
           void* args, void* matched, int Q, long long N, int k, int splits,
           long long chunk, float unmatched, cudaStream_t s) {
  const size_t smem = smem_bytes(k);
  cudaError_t err = allow_smem<T>(smem);
  if (err != cudaSuccess) return err;
  const auto d = static_cast<const T*>(dist);
  const auto sg = static_cast<const long long*>(seg);
  const auto part = static_cast<unsigned long long*>(partials);
  const int vec = N % 4 == 0 && chunk % 4 == 0 &&
                  reinterpret_cast<uintptr_t>(dist) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(seg) % 16 == 0;
  const dim3 grid(splits, (Q + R - 1) / R);
  segmin_pass_kernel<T><<<grid, NT, smem, s>>>(d, sg, part, Q, N, k, chunk,
                                               vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long cells = static_cast<long long>(Q) * k;
  segmin_decode_kernel<T><<<static_cast<unsigned>((cells + NT - 1) / NT), NT,
                            0, s>>>(
      part, d, static_cast<float*>(mins), static_cast<long long*>(args),
      static_cast<bool*>(matched), Q, N, k, splits, unmatched);
  return cudaGetLastError();
}

}  // namespace

// Resident pass blocks an SM holds for codebook size k and input type
// (is_int: int32, else float32), written to *out; returns the cudaError_t.
extern "C" int qpg_segmin_blocks_per_sm(int k, int is_int, int* out) {
  const size_t smem = smem_bytes(k);
  cudaError_t err = is_int ? allow_smem<int>(smem) : allow_smem<float>(smem);
  if (err != cudaSuccess) return err;
  return is_int ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                      out, segmin_pass_kernel<int>, NT, smem)
                : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                      out, segmin_pass_kernel<float>, NT, smem);
}

// dist: contiguous (Q, N) float32 or int32 (is_int); seg: contiguous (N,)
// int64 codes; partials: scratch of Q x splits x k 64-bit words; mins
// (Q, k) float32, args (Q, k) int64, matched (Q, k) bool, all contiguous.
// The N columns are cut into splits chunks of `chunk` (the last may be
// short, none empty). Launches the pass, then the decode, on `stream`;
// returns the cudaError_t of the launches (0 on success).
extern "C" int qpg_segmin_cuda(const void* dist, int is_int, const void* seg,
                               void* partials, void* mins, void* args,
                               void* matched, int Q, long long N, int k,
                               int splits, long long chunk, float unmatched,
                               void* stream) {
  if (Q <= 0 || N <= 0 || k <= 0 || splits <= 0 || chunk <= 0 ||
      (splits - 1) * chunk >= N || splits * chunk < N || N >= (1LL << 31) ||
      (Q + R - 1) / R >= (1 << 16) || smem_bytes(k) > 227 * 1024)
    return cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  return is_int ? launch<int>(dist, seg, partials, mins, args, matched, Q, N,
                              k, splits, chunk, unmatched, s)
                : launch<float>(dist, seg, partials, mins, args, matched, Q,
                                N, k, splits, chunk, unmatched, s);
}
