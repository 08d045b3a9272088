// WavLM's positional convolution, its bias, GELU and the residual on Hopper
// (sm_90a), K6, channels last:
//
//     y[b, t, c] = x[b, t, c] + gelu(bias[c] + sum_{j<k} sum_{i<CG}
//                  x[b, t + j - k/2, g CG + i] W[c, i, j]),   g = c / CG
//
// for 0 <= t < T, frames outside [0, T) read as zero and gelu the exact erf
// GELU: WavLM's pos_conv (a grouped Conv1d of kernel k and padding k/2 under
// weight normalisation, SamePad's trim of an even kernel's extra frame, GELU)
// and the residual after it, T frames in and T out. Replaces no TPU kernel:
// the JAX package leaves this convolution to XLA
// (qpgesture_tpu/models/wavlm.py:288-295). It was added because PyTorch's
// grouped float32 conv1d went to cuDNN's implicit_convolve_sgemm, which ran
// WavLM-Large's (1024 channels, 16 groups of CG = 64, k = 128) at 2-3
// TFLOP/s, 3-4.5 % of the card's float32 FMA rate, between two transposing
// copies and a separate GELU and residual add. The plain PyTorch version and
// the wrapper, build and ctypes binding are ops/posconv_cuda.py.
//
// What bounds it on an H100: operations. With TF32 off the products are
// float32 FMAs on the CUDA cores (67 TFLOP/s): 2 B T C CG k FLOPs, 53.4
// GFLOP for a tick of 16 windows of T = 199 frames, 0.80 ms at that peak;
// x read for the products and again for the residual, y written and the
// 33.5 MB of weights come to ~73 MB, 0.02 ms at 3.35 TB/s.
//
// Design: per (window b, group g) the work is a GEMM of M = T frames, N = CG
// output channels and K = CG input channels x k taps whose A operand is a
// sliding window of x (a Toeplitz matrix), so A is never unfolded.
//   * A block owns one tile of `tile` frames x the CG output channels of one
//     (b, g): grid (ceil(T / tile), G, B). It stages its input window once:
//     the tile + k frames around it, the group's CG channels, transposed to
//     xs[channel][frame] (zeros outside [0, T)), from 16-byte reads of the
//     channels-last rows.
//   * The group's weights, packed [g][j][i][o] (o fastest, by the wrapper),
//     stream through a ring of NSTAGE shared stages of JC taps x IC input
//     channels x CG outputs with 16-byte cp.async, two stages in flight
//     while one computes (one block barrier a stage). A group's 2.1 MB is
//     read by every block of that group and stays in the 50 MB L2.
//   * Each thread accumulates an 8 x 8 register tile: RF = 8 consecutive
//     frames x 8 output channels (oc 4 .. oc 4 + 3 and CG/2 + oc 4 .. + 3, so
//     the NOC = CG / 8 threads of a row of the block read 16 contiguous
//     bytes each: no bank conflicts). Because A slides by one frame a tap,
//     JC = 8 taps of one input channel need only 15 of its frames: four
//     float4 shared loads feed 8 taps x 64 FMAs, and two float4 weight loads
//     feed each tap's 64 FMAs (threads of a row read one frame window: a
//     broadcast). That is 20 shared loads a 512 FMAs, under the shared
//     memory's rate, so the FMA pipes set the pace.
//   * The epilogue adds the bias, applies the GELU, adds x[b, t, c] (read
//     from global) and writes y once, 16 bytes a thread and row.
//   * The wrapper picks `tile` (a multiple of 32 frames, so every warp is
//     full, at most MAX_TILE) from B, T, G and the SM count: the tile that
//     gives the busiest SM the fewest rounds of its four schedulers
//     (ops/posconv_cuda.py frame_tile): 224 at WavLM's 199 frames, one
//     tile a window. At most two blocks of MAX_TILE frames fit an SM's
//     shared memory at k = 128.
// No atomics: the same input gives the same bits. Inference only.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int JC = 8;            // taps a stage and a thread's frame window
constexpr int IC = 4;            // input channels a stage
constexpr int NSTAGE = 3;        // weight stages in the ring
constexpr int RF = 8;            // frames a thread
constexpr int MAX_TILE = 224;    // frames a block
constexpr int MAX_SMEM = 232448; // bytes of shared memory a block may use
constexpr int MAX_DEVICES = 64;

// 16-byte asynchronous copy global -> shared, around L1.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Wait until at most N committed groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

template <int CG>
struct Layout {
  static constexpr int NOC = CG / RF;          // threads across the outputs
  static constexpr int STAGE = JC * IC * CG;   // floats a weight stage
  static constexpr int MAX_THREADS = MAX_TILE / RF * NOC;
  // frames of a block's input window (a multiple of 8: float4 rows)
  static __host__ __device__ int ldx(int tile, int taps) {
    return tile + taps;
  }
  static __host__ __device__ size_t smem(int tile, int taps) {
    return sizeof(float) *
           ((size_t)CG * ldx(tile, taps) + (size_t)NSTAGE * STAGE);
  }
};

__device__ __forceinline__ float gelu(float v) {  // nn.GELU(), exact
  return v * 0.5f * (1.f + erff(v * 0.70710678118654752440f));
}

template <int CG>
__global__ void __launch_bounds__(Layout<CG>::MAX_THREADS, 2)
posconv_gelu_residual_kernel(const float* __restrict__ x,
                             const float* __restrict__ w,
                             const float* __restrict__ bias,
                             float* __restrict__ y, int T_len, int C,
                             int taps, int tile) {
  using L = Layout<CG>;
  constexpr int NOC = L::NOC;
  constexpr int HALF = CG / 2;
  constexpr int PER_TAP = IC * CG / 4;   // float4s of one tap in a stage
  extern __shared__ __align__(16) float smem[];
  const int ldx = L::ldx(tile, taps);
  float* xs = smem;                      // CG x ldx
  float* ws = smem + CG * ldx;           // NSTAGE x STAGE, [jj][ii][o]
  const int nt = blockDim.x, tid = threadIdx.x;
  const int oc = tid % NOC, tr = tid / NOC;
  const int g = blockIdx.y, b = blockIdx.z;
  const int t0 = blockIdx.x * tile;
  const int n_ic = CG / IC;
  const int n_stages = taps / JC * n_ic;
  const float* wg = w + (size_t)g * taps * CG * CG;

  // stage s: taps (s / n_ic) JC + [0, JC), input channels (s % n_ic) IC +
  // [0, IC); each tap's IC x CG weights are one contiguous run
  auto load_stage = [&](int s) {
    float* dst = ws + (s % NSTAGE) * L::STAGE;
    const int j0 = s / n_ic * JC, i0 = s % n_ic * IC;
    for (int e = tid; e < JC * PER_TAP; e += nt) {
      const int jj = e / PER_TAP, q = e % PER_TAP;
      cp_async16(dst + jj * IC * CG + 4 * q,
                 wg + ((size_t)(j0 + jj) * CG + i0) * CG + 4 * q);
    }
  };
#pragma unroll
  for (int s = 0; s < NSTAGE - 1; ++s) {
    if (s < n_stages) load_stage(s);
    cp_async_commit();
  }

  // the input window, transposed: xs[i ldx + u] = x[b, t0 - k/2 + u, g CG + i]
  const float* xb = x + (size_t)b * T_len * C + g * CG;
  for (int e = tid; e < ldx * (CG / 4); e += nt) {
    const int u = e % ldx, q = e / ldx;
    const int t = t0 - taps / 2 + u;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (t >= 0 && t < T_len)
      v = __ldg(reinterpret_cast<const float4*>(xb + (size_t)t * C) + q);
    float* d = xs + 4 * q * ldx + u;
    d[0] = v.x;
    d[ldx] = v.y;
    d[2 * ldx] = v.z;
    d[3 * ldx] = v.w;
  }

  float acc[RF][8];
#pragma unroll
  for (int r = 0; r < RF; ++r)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[r][c] = 0.f;

  for (int s = 0; s < n_stages; ++s) {
    cp_async_wait<NSTAGE - 2>();
    __syncthreads();   // stage s (and, at s = 0, the window) is in place
    if (s + NSTAGE - 1 < n_stages) load_stage(s + NSTAGE - 1);
    cp_async_commit();
    const float* wsb = ws + (s % NSTAGE) * L::STAGE;
    const int j0 = s / n_ic * JC, i0 = s % n_ic * IC;
#pragma unroll
    for (int ii = 0; ii < IC; ++ii) {
      // frames tr RF + j0 + [0, 16) of input channel i0 + ii: thread frame
      // r at tap j0 + jj reads a[r + jj]
      const float* xr = xs + (i0 + ii) * ldx + tr * RF + j0;
      float a[16];
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const float4 f = *reinterpret_cast<const float4*>(xr + 4 * v);
        a[4 * v] = f.x;
        a[4 * v + 1] = f.y;
        a[4 * v + 2] = f.z;
        a[4 * v + 3] = f.w;
      }
#pragma unroll
      for (int jj = 0; jj < JC; ++jj) {
        const float* wr = wsb + (jj * IC + ii) * CG + 4 * oc;
        const float4 b0 = *reinterpret_cast<const float4*>(wr);
        const float4 b1 = *reinterpret_cast<const float4*>(wr + HALF);
        const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int r = 0; r < RF; ++r)
#pragma unroll
          for (int c = 0; c < 8; ++c)
            acc[r][c] = fmaf(a[r + jj], bv[c], acc[r][c]);
      }
    }
  }

  const float* bg = bias + g * CG + 4 * oc;
  const float4 bb0 = __ldg(reinterpret_cast<const float4*>(bg));
  const float4 bb1 = __ldg(reinterpret_cast<const float4*>(bg + HALF));
#pragma unroll
  for (int r = 0; r < RF; ++r) {
    const int t = t0 + tr * RF + r;
    if (t >= T_len) break;
    const size_t row = ((size_t)b * T_len + t) * C + g * CG + 4 * oc;
    const float4 x0 = __ldg(reinterpret_cast<const float4*>(x + row));
    const float4 x1 = __ldg(reinterpret_cast<const float4*>(x + row + HALF));
    *reinterpret_cast<float4*>(y + row) = make_float4(
        x0.x + gelu(acc[r][0] + bb0.x), x0.y + gelu(acc[r][1] + bb0.y),
        x0.z + gelu(acc[r][2] + bb0.z), x0.w + gelu(acc[r][3] + bb0.w));
    *reinterpret_cast<float4*>(y + row + HALF) = make_float4(
        x1.x + gelu(acc[r][4] + bb1.x), x1.y + gelu(acc[r][5] + bb1.y),
        x1.z + gelu(acc[r][6] + bb1.z), x1.w + gelu(acc[r][7] + bb1.w));
  }
}

struct Args {
  const float *x, *w, *bias;
  float* y;
  int B, T_len, C, groups, taps, tile;
  cudaStream_t stream;
};

template <int CG>
cudaError_t launch(const Args& a) {
  using L = Layout<CG>;
  static bool done[MAX_DEVICES] = {};
  auto kernel = posconv_gelu_residual_kernel<CG>;
  const size_t smem = L::smem(a.tile, a.taps);
  if (smem > MAX_SMEM) return cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (!done[dev]) {   // the largest window once per device
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return err;
    done[dev] = true;
  }
  const dim3 grid((a.T_len + a.tile - 1) / a.tile, a.groups, a.B);
  kernel<<<grid, a.tile / RF * L::NOC, smem, a.stream>>>(
      a.x, a.w, a.bias, a.y, a.T_len, a.C, a.taps, a.tile);
  return cudaGetLastError();
}

}  // namespace

// x, y: contiguous float32 (B, T, C), 16-byte aligned, y not aliasing x;
// w: contiguous float32 (groups, taps, CG, CG), w[g][j][i][o] = W[g CG + o,
// i, j] with CG = C / groups, 48 or 64; bias: float32 (C,), 16-byte
// aligned. taps: a multiple of JC (the conv's padding is taps / 2); tile:
// frames a block, a multiple of 32 in [32, MAX_TILE]. Launches the kernel
// on `stream`; returns the cudaError_t of the launch (0 on success).
extern "C" int qpg_posconv_cuda(const void* x, const void* w,
                                const void* bias, void* y, int B, int T_len,
                                int C, int groups, int taps, int tile,
                                void* stream) {
  if (B <= 0 || B >= (1 << 16) || T_len <= 0 || groups <= 0 ||
      groups >= (1 << 16) || C % groups || taps <= 0 || taps % JC ||
      tile < 32 || tile > MAX_TILE || tile % 32)
    return cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w) |
       reinterpret_cast<uintptr_t>(bias) | reinterpret_cast<uintptr_t>(y)) %
      16)
    return cudaErrorInvalidValue;
  const Args a{static_cast<const float*>(x), static_cast<const float*>(w),
               static_cast<const float*>(bias), static_cast<float*>(y),
               B, T_len, C, groups, taps, tile,
               static_cast<cudaStream_t>(stream)};
  switch (C / groups) {
    case 48: return launch<48>(a);
    case 64: return launch<64>(a);
  }
  return cudaErrorInvalidValue;
}
