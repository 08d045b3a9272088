// Gated flash attention for WavLM on Hopper (sm_90a):
//
//     out = softmax(q @ k^T * sm_scale + gate * bias) @ v
//
// Replaces the TPU kernel qpgesture_tpu/ops/flash_attention.py ::
// gated_flash_attention (body _flash_kernel). The plain PyTorch version is
// qpgesture_tpu_torch/ops/flash_attention.py :: gated_attention_plain; the
// wrapper, build and ctypes binding are ops/flash_attention_cuda.py.
//
// What it computes, rounding included (as the TPU kernel and its wrapper):
//   * q, k, v, bias and gate arrive in the element type T (float or bf16);
//     q is scaled by sm_scale (already rounded to T) and rounded to T;
//   * s = q . k^T in float32, then s += gate[row] * bias[row, col] (product
//     and sum each rounded, as two separate float32 operations); without a
//     gate, s += bias;
//   * key columns >= T are masked to -1e30 (T is not padded in memory);
//   * the running max m, row sum l and the accumulator are float32; the
//     weights p = exp(s - m) are rounded to T before p @ v, l sums the
//     unrounded p; out = acc / l in float32.
//
// What bounds it on an H100: with TF32 off, the float32 products run on
// the CUDA cores (67 TFLOP/s) and 4*B*H*T^2*hd operations outweigh the
// bytes (q, k, v, out, one read of the bias) at WavLM's T ~ 200-1200, so
// the bound is operations. The design keeps every (T, T) intermediate out
// of device memory: one block owns 64 query rows of one (batch, head) and
// walks the key axis in 64-row tiles staged in shared memory, with the
// online softmax between the two products. 256 threads hold a 4 x 4 tile
// of the logits and a 4 x (hd/16) tile of the accumulator in registers;
// rows are strided by 16 so that a row's 16 column owners are 16 lanes of
// one warp and its max and sum reduce with shuffles. Shared rows are padded
// by one float so that the column walks are free of bank conflicts.
// A simple first design: no tensor cores (wgmma), no TMA, no pipelining of
// the tile loads; the bf16 instantiation widens its tiles to float32 in
// shared memory.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64;          // query rows per block
constexpr int BK = 64;          // key rows per tile
constexpr int TX = 16;          // threads along the key / head-dim axis
constexpr int TY = 16;          // threads along the query axis
constexpr int NT = TX * TY;     // 256 threads
constexpr int RQ = BQ / TY;     // query rows per thread
constexpr int RK = BK / TX;     // key columns per thread
constexpr float NEG = -1e30f;   // the TPU kernel's mask value

template <typename T> __device__ __forceinline__ float to_f(T x);
template <> __device__ __forceinline__ float to_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(
    __nv_bfloat16 x) {
  return __bfloat162float(x);
}

// x rounded to T (round to nearest even) and widened back to float.
template <typename T> __device__ __forceinline__ float round_as(float x);
template <> __device__ __forceinline__ float round_as<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ float round_as<__nv_bfloat16>(
    float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// Element strides of a (B, H, T, hd) view whose hd axis is contiguous.
struct Strides {
  long long b, h, t;
};

template <typename T, int HD>
__global__ void __launch_bounds__(NT)
gated_flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const T* __restrict__ bias,
                   const T* __restrict__ gate, float* __restrict__ out,
                   Strides sq, Strides sk, Strides sv, Strides so,
                   int T_len, float scale) {
  constexpr int LD = HD + 1;    // padded shared row
  constexpr int LP = BK + 1;
  constexpr int RD = HD / TX;   // accumulator columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;             // BQ x LD
  float* Ks = Qs + BQ * LD;     // BK x LD
  float* Vs = Ks + BK * LD;     // BK x LD
  float* Ps = Vs + BK * LD;     // BQ x LP

  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int H = gridDim.y;

  const T* qb = q + b * sq.b + h * sq.h;
  const T* kb = k + b * sk.b + h * sk.h;
  const T* vb = v + b * sv.b + h * sv.h;
  const T* bias_h = bias + (long long)h * T_len * T_len;

  for (int i = tid; i < BQ * HD; i += NT) {
    const int r = i / HD, d = i % HD;
    float x = 0.f;
    if (q0 + r < T_len) x = round_as<T>(to_f(qb[(q0 + r) * sq.t + d]) * scale);
    Qs[r * LD + d] = x;
  }

  float g[RQ], m[RQ], l[RQ], acc[RQ][RD];
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int row = q0 + ty + TY * i;
    g[i] = 1.f;
    if (gate != nullptr && row < T_len)
      g[i] = to_f(gate[((long long)b * H + h) * T_len + row]);
    m[i] = NEG;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < RD; ++c) acc[i][c] = 0.f;
  }

  for (int k0 = 0; k0 < T_len; k0 += BK) {
    __syncthreads();            // the previous tile's readers are done
    for (int i = tid; i < BK * HD; i += NT) {
      const int r = i / HD, d = i % HD;
      const bool ok = k0 + r < T_len;
      Ks[r * LD + d] = ok ? to_f(kb[(k0 + r) * sk.t + d]) : 0.f;
      Vs[r * LD + d] = ok ? to_f(vb[(k0 + r) * sv.t + d]) : 0.f;
    }
    __syncthreads();

    float s[RQ][RK];
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int j = 0; j < RK; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      float a[RQ], c[RK];
#pragma unroll
      for (int i = 0; i < RQ; ++i) a[i] = Qs[(ty + TY * i) * LD + d];
#pragma unroll
      for (int j = 0; j < RK; ++j) c[j] = Ks[(tx + TX * j) * LD + d];
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int j = 0; j < RK; ++j) s[i][j] = fmaf(a[i], c[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      const int row = q0 + ty + TY * i;
      float mx = NEG;
#pragma unroll
      for (int j = 0; j < RK; ++j) {
        const int col = k0 + tx + TX * j;
        if (col < T_len) {
          const float bv =
              row < T_len ? to_f(bias_h[(long long)row * T_len + col]) : 0.f;
          s[i][j] = __fadd_rn(s[i][j], __fmul_rn(g[i], bv));
        } else {
          s[i][j] = NEG;
        }
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = TX / 2; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < RK; ++j) {
        const float p = expf(s[i][j] - m_new);
        sum += p;
        Ps[(ty + TY * i) * LP + tx + TX * j] = round_as<T>(p);
      }
#pragma unroll
      for (int off = TX / 2; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = alpha * l[i] + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < RD; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 8
    for (int kk = 0; kk < BK; ++kk) {
      float p[RQ], w[RD];
#pragma unroll
      for (int i = 0; i < RQ; ++i) p[i] = Ps[(ty + TY * i) * LP + kk];
#pragma unroll
      for (int c = 0; c < RD; ++c) w[c] = Vs[kk * LD + tx + TX * c];
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int c = 0; c < RD; ++c) acc[i][c] = fmaf(p[i], w[c], acc[i][c]);
    }
  }

  float* ob = out + b * so.b + h * so.h;
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int row = q0 + ty + TY * i;
    if (row < T_len) {
#pragma unroll
      for (int c = 0; c < RD; ++c)
        ob[row * so.t + tx + TX * c] = acc[i][c] / l[i];
    }
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* bias, const void* gate, void* out,
                   const long long* strides, int B, int H, int T_len,
                   float scale, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (size_t)(BQ * (HD + 1) + 2 * BK * (HD + 1) +
                               BQ * (BK + 1));
  auto kernel = gated_flash_kernel<T, HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const Strides sq{strides[0], strides[1], strides[2]};
  const Strides sk{strides[3], strides[4], strides[5]};
  const Strides sv{strides[6], strides[7], strides[8]};
  const Strides so{strides[9], strides[10], strides[11]};
  const dim3 grid((T_len + BQ - 1) / BQ, H, B);
  kernel<<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(bias),
      static_cast<const T*>(gate), static_cast<float*>(out), sq, sk, sv, so,
      T_len, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_hd(int hd, const void* q, const void* k, const void* v,
                        const void* bias, const void* gate, void* out,
                        const long long* strides, int B, int H, int T_len,
                        float scale, cudaStream_t stream) {
  switch (hd) {
    case 16:
      return launch<T, 16>(q, k, v, bias, gate, out, strides, B, H, T_len,
                           scale, stream);
    case 32:
      return launch<T, 32>(q, k, v, bias, gate, out, strides, B, H, T_len,
                           scale, stream);
    case 64:
      return launch<T, 64>(q, k, v, bias, gate, out, strides, B, H, T_len,
                           scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q, k, v: (B, H, T, hd) views with a contiguous hd axis, element type
// `dtype` (0 = float32, 1 = bfloat16); bias: contiguous (H, T, T); gate:
// contiguous (B, H, T) or null; out: a float32 (B, H, T, hd) view with a
// contiguous hd axis. strides: 12 element strides, (b, h, t) of q, k, v
// and out. Returns the cudaError_t of the launch (0 on success).
extern "C" int qpg_gated_flash_attention_cuda(
    const void* q, const void* k, const void* v, const void* bias,
    const void* gate, void* out, const long long* strides, int B, int H,
    int T_len, int hd, int dtype, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_hd<float>(hd, q, k, v, bias, gate, out, strides, B, H,
                              T_len, scale, s);
  if (dtype == 1)
    return dispatch_hd<__nv_bfloat16>(hd, q, k, v, bias, gate, out, strides,
                                      B, H, T_len, scale, s);
  return cudaErrorInvalidValue;
}
