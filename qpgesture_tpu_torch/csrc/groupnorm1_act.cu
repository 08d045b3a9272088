// One-group GroupNorm, its per-channel affine and the activation on Hopper
// (sm_90a), K5:
//
//     y[b, c, t] = act((x[b, c, t] - mean_b) * rstd_b * w[c] + b[c])
//
// with mean_b and the biased var_b over all C T elements of window b
// (rstd_b = rsqrt(var_b + eps)) and act the exact erf GELU or ReLU: what
// vq-wav2vec's blocks (Conv1d -> GroupNorm(1, C) -> GELU) do after each
// convolution. Replaces no TPU kernel: the JAX package normalises with jnp
// (qpgesture_tpu/models/vq_wav2vec.py:77-79). It was added because
// PyTorch's one-group moments give each window one block, so a clip's 6
// windows of 512 x 12 799 floats are reduced on 6 of the card's 132 SMs.
// The plain PyTorch version and the wrapper, build and ctypes binding are
// ops/groupnorm_cuda.py.
//
// What bounds it on an H100: bytes. An element is read once and written
// once (8 B) for a handful of operations, far below the card's ~300 FLOP a
// byte; the moments read it a second time (12 B an element in all unless
// the row is still in the 50 MB L2).
//
// Design: two kernels, no atomics, so the same input gives the same bits.
//   * groupnorm1_moments_kernel: grid (tiles, B). Each block reduces one
//     contiguous chunk of its window with 16-byte loads, four in flight a
//     thread; each group of 16 values is folded into the thread's (count,
//     mean, M2) by Chan's formula (mean and M2 of the 16 taken in
//     registers, two passes); the block merges its threads in a fixed tree
//     (warp shuffles, then shared memory) and writes one partial. The
//     wrapper picks the tile count from B and C T, so B x tiles fills the
//     card several times over.
//   * groupnorm1_apply_kernel<ACT>: the same grid. Each block merges its
//     window's partials in the same fixed order (every block of a window
//     gets the same mean and rstd), then writes act((x - mean) * (rstd w[c])
//     + b[c]) over its chunk with 16-byte loads and stores; the channel of
//     the first element of a float4 takes one division, the next three a
//     compare.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;      // threads a block
constexpr int U = 4;         // float4 loads in flight a thread
constexpr int WARPS = NT / 32;
constexpr int ACT_GELU = 0;
constexpr int ACT_RELU = 1;

struct Stats {
  float n, mean, m2;
};

// Chan's merge of two (count, mean, M2); a.n == 0 gives b, b.n == 0 gives a.
__device__ __forceinline__ Stats merge(const Stats& a, const Stats& b) {
  const float n = a.n + b.n;
  if (n == 0.f) return a;
  const float d = b.mean - a.mean;
  const float r = b.n / n;
  return {n, fmaf(d, r, a.mean), a.m2 + b.m2 + d * d * a.n * r};
}

__device__ __forceinline__ Stats shfl_xor(const Stats& s, int lane_mask) {
  return {__shfl_xor_sync(0xffffffffu, s.n, lane_mask),
          __shfl_xor_sync(0xffffffffu, s.mean, lane_mask),
          __shfl_xor_sync(0xffffffffu, s.m2, lane_mask)};
}

__device__ __forceinline__ Stats warp_reduce(Stats s) {
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) s = merge(s, shfl_xor(s, m));
  return s;
}

// The block's merged stats, valid in thread 0.
__device__ __forceinline__ Stats block_reduce(Stats s, Stats* shared) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  s = warp_reduce(s);
  if (lane == 0) shared[warp] = s;
  __syncthreads();
  if (warp == 0) {
    s = lane < WARPS ? shared[lane] : Stats{0.f, 0.f, 0.f};
    s = warp_reduce(s);
  }
  return s;
}

// The 4 U values of v as a Stats: mean first, then M2 about it.
__device__ __forceinline__ Stats group_stats(const float4 (&v)[U]) {
  float s = 0.f;
#pragma unroll
  for (int u = 0; u < U; ++u) s += (v[u].x + v[u].y) + (v[u].z + v[u].w);
  const float mean = s * (1.f / (4 * U));
  float m2 = 0.f;
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const float a = v[u].x - mean, b = v[u].y - mean, c = v[u].z - mean,
                d = v[u].w - mean;
    m2 += (a * a + b * b) + (c * c + d * d);
  }
  return {4.f * U, mean, m2};
}

// Window `blockIdx.y`, elements [blockIdx.x chunk, + chunk) of n; vec: the
// window's rows start on 16-byte boundaries and chunk and n are multiples
// of 4.
__global__ void __launch_bounds__(NT)
groupnorm1_moments_kernel(const float* __restrict__ x,
                          float* __restrict__ partials, long long n,
                          long long chunk, int vec) {
  __shared__ Stats shared[WARPS];
  const long long start = blockIdx.x * chunk;
  const long long end = min(start + chunk, n);
  const float* row = x + blockIdx.y * n;
  Stats s{0.f, 0.f, 0.f};
  if (vec) {
    const float4* p = reinterpret_cast<const float4*>(row + start);
    const int n4 = static_cast<int>((end - start) / 4);
    int i = threadIdx.x;
    for (; i + (U - 1) * NT < n4; i += U * NT) {
      float4 v[U];
#pragma unroll
      for (int u = 0; u < U; ++u) v[u] = __ldg(p + i + u * NT);
      s = merge(s, group_stats(v));
    }
    for (; i < n4; i += NT) {
      const float4 v = __ldg(p + i);
      const float mean = ((v.x + v.y) + (v.z + v.w)) * 0.25f;
      const float a = v.x - mean, b = v.y - mean, c = v.z - mean,
                  d = v.w - mean;
      s = merge(s, Stats{4.f, mean, (a * a + b * b) + (c * c + d * d)});
    }
  } else {
    for (long long e = start + threadIdx.x; e < end; e += NT)
      s = merge(s, Stats{1.f, __ldg(row + e), 0.f});
  }
  s = block_reduce(s, shared);
  if (threadIdx.x == 0) {
    float* out = partials + 3 * (static_cast<long long>(blockIdx.y) *
                                 gridDim.x + blockIdx.x);
    out[0] = s.n;
    out[1] = s.mean;
    out[2] = s.m2;
  }
}

template <int ACT>
__device__ __forceinline__ float activate(float v) {
  if (ACT == ACT_GELU)   // nn.GELU(): x / 2 (1 + erf(x / sqrt 2))
    return v * 0.5f * (1.f + erff(v * 0.70710678118654752440f));
  return v > 0.f ? v : 0.f;
}

template <int ACT>
__global__ void __launch_bounds__(NT)
groupnorm1_apply_kernel(const float* __restrict__ x, float* __restrict__ y,
                        const float* __restrict__ partials,
                        const float* __restrict__ w,
                        const float* __restrict__ b, long long n, int T_len,
                        long long chunk, int vec, float eps) {
  __shared__ Stats shared[WARPS];
  __shared__ float mean_rstd[2];
  // the window's partials, in the moments kernel's tile order
  const float* part = partials + 3LL * blockIdx.y * gridDim.x;
  Stats s{0.f, 0.f, 0.f};
  for (int t = threadIdx.x; t < static_cast<int>(gridDim.x); t += NT)
    s = merge(s, Stats{part[3 * t], part[3 * t + 1], part[3 * t + 2]});
  s = block_reduce(s, shared);
  if (threadIdx.x == 0) {
    mean_rstd[0] = s.mean;
    mean_rstd[1] = rsqrtf(s.m2 / static_cast<float>(n) + eps);
  }
  __syncthreads();
  const float mean = mean_rstd[0], rstd = mean_rstd[1];
  const unsigned T = static_cast<unsigned>(T_len);

  const long long start = blockIdx.x * chunk;
  const long long end = min(start + chunk, n);
  const long long base = blockIdx.y * n;
  if (vec) {
    const float4* p = reinterpret_cast<const float4*>(x + base + start);
    float4* q = reinterpret_cast<float4*>(y + base + start);
    const int n4 = static_cast<int>((end - start) / 4);
    // element e of the window, at float4 k of the chunk
    auto transform = [&](float4 v, int k) {
      const unsigned e = static_cast<unsigned>(start) + 4u * k;
      unsigned c = e / T, r = e - c * T;
      float o[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        o[j] = activate<ACT>(
            fmaf(o[j] - mean, rstd * __ldg(w + c), __ldg(b + c)));
        if (++r == T) {
          r = 0;
          ++c;
        }
      }
      return make_float4(o[0], o[1], o[2], o[3]);
    };
    int i = threadIdx.x;
    for (; i + (U - 1) * NT < n4; i += U * NT) {
      float4 v[U];
#pragma unroll
      for (int u = 0; u < U; ++u) v[u] = __ldg(p + i + u * NT);
#pragma unroll
      for (int u = 0; u < U; ++u) q[i + u * NT] = transform(v[u], i + u * NT);
    }
    for (; i < n4; i += NT) q[i] = transform(__ldg(p + i), i);
  } else {
    for (long long e = start + threadIdx.x; e < end; e += NT) {
      const unsigned c = static_cast<unsigned>(e) / T;
      y[base + e] = activate<ACT>(
          fmaf(x[base + e] - mean, rstd * __ldg(w + c), __ldg(b + c)));
    }
  }
}

}  // namespace

// x, y: contiguous float32 (B, C, T) (y may not alias x); partials: float32
// scratch of B x tiles x 3; w, b: float32 (C,). Each window's n = C T
// elements are cut into tiles chunks of `chunk` (the last may be short,
// none empty), chunk a multiple of 4. act: 0 GELU (exact erf), 1 ReLU.
// Launches the moments kernel, then the apply kernel, on `stream`; returns
// the cudaError_t of the launches (0 on success).
extern "C" int qpg_groupnorm1_act_cuda(const void* x, void* y, void* partials,
                                       const void* w, const void* b, int B,
                                       long long n, int T_len, int tiles,
                                       long long chunk, float eps, int act,
                                       void* stream) {
  if (B <= 0 || T_len <= 0 || tiles <= 0 || chunk <= 0 || chunk % 4 ||
      n <= 0 || n % T_len || (tiles - 1) * chunk >= n ||
      tiles * chunk < n || n >= (1LL << 31) || B >= (1 << 16) ||
      (act != ACT_GELU && act != ACT_RELU))
    return cudaErrorInvalidValue;
  const int vec = n % 4 == 0 &&
                  reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(y) % 16 == 0;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto xf = static_cast<const float*>(x);
  const auto pf = static_cast<float*>(partials);
  const dim3 grid(tiles, B);
  groupnorm1_moments_kernel<<<grid, NT, 0, s>>>(xf, pf, n, chunk, vec);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const auto yf = static_cast<float*>(y);
  const auto wf = static_cast<const float*>(w);
  const auto bf = static_cast<const float*>(b);
  if (act == ACT_GELU)
    groupnorm1_apply_kernel<ACT_GELU><<<grid, NT, 0, s>>>(
        xf, yf, pf, wf, bf, n, T_len, chunk, vec, eps);
  else
    groupnorm1_apply_kernel<ACT_RELU><<<grid, NT, 0, s>>>(
        xf, yf, pf, wf, bf, n, T_len, chunk, vec, eps);
  return cudaGetLastError();
}
