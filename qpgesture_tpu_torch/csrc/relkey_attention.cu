// Relative-key flash attention for w2v-BERT 2.0 on Hopper (sm_90a), K4:
//
//     s_ij  = (q_i . k_j + q_i . E[clamp(j - i, -left, right) + left]) * scale
//     out_i = sum_j softmax_j(s_ij) v_j
//
// Replaces no TPU kernel: the JAX package has no w2v-BERT. It was added for
// the w2v-BERT 2.0 encoder (models/w2v_bert.py), whose relative-key term
// depends on the query, so it is a (B, H, T, T) array that K2 (the gated
// attention of csrc/flash_attention.cu, which takes one (H, T, T) bias for
// the whole batch) cannot take, and materialising it costs B H T^2 floats a
// layer and a second pass. The plain PyTorch version and the wrapper, build
// and ctypes binding are ops/relkey_attention_cuda.py.
//
// What it computes, rounding included (as relkey_attention_plain):
//   * q is scaled by `scale` first (exact for the power-of-two 1/8 of
//     w2v-BERT's 64-wide heads);
//   * the relative term of each query row against every distance, R = q E^T
//     (E is the (left + right + 1, hd) table of distance embeddings, one for
//     all heads), then s = q . k + R[row][clamp(key - row) + left], each a
//     float32 sum; key columns >= T are masked to -1e30;
//   * an online softmax over 32-key tiles in float32, out = acc / l.
//
// What bounds it on an H100: with TF32 off the products are float32 FMAs
// on the CUDA cores (67 TFLOP/s): 4 B H T^2 hd for q k^T and p v plus
// 2 B H T n_rel hd for q E^T; the bytes (q, k, v read and the output
// written once, E) are ~1/30 of the FMA time at T = 199. The benchmark
// holds it to the larger of its operations at the TF32 rate and its bytes
// at 3.35 TB/s, as it holds K2 (benchmark/models/w2v_bert.py relkey_work).
//
// Design: K2's float32 tiling (csrc/flash_attention.cu's header says why):
// a block of four warps owns 64 query rows of one (batch, head), 16 rows a
// warp, each thread a 4 x 4 tile of logits (rows ty + 4i, keys tx + 8j),
// and walks the key axis in 32-row tiles whose K and V are copied into a
// second shared buffer with 16-byte cp.async while the current tile
// computes. What K4 adds: the block copies E (73 x 64 floats for w2v-BERT)
// into shared memory and forms R = q_tile E^T (64 x 73) once, before the key
// walk, so the relative term costs one shared load per logit; tiles far from
// the diagonal read one clamped column. R's row stride is 9 mod 32, so the
// 32 lanes of a warp (4 rows x 8 keys, column key - row) fall in 32 banks.
// R is 73 / 224 = a third of q k^T's FMAs at T = 199; its (B, H, T, T)
// equivalent is never written. P goes through a shared tile of its own
// (each warp owns its rows: a __syncwarp, not a block barrier).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;          // query rows per block
constexpr int BK = 32;          // key rows per tile
constexpr float NEG = -1e30f;   // the mask value
constexpr int MAX_REL = 128;    // distances E may hold (the wrapper checks)
constexpr int MAX_DEVICES = 64;

// Element strides of a (B, H, T, hd) view whose hd axis is contiguous.
struct Strides {
  long long b, h, t;
};

// 16-byte asynchronous copy global -> shared; ok == false fills zeros.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = ok ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(n)
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

// R's row stride: at least n_rel, and 9 mod 32.
__host__ __device__ __forceinline__ int r_stride(int n_rel) {
  return n_rel + ((9 - n_rel) % 32 + 32) % 32;
}

template <int HD>
struct Tiles {
  static constexpr int NT = 128;         // 4 warps x 16 query rows
  static constexpr int RQ = 4;           // query rows per thread
  static constexpr int NSTAGE = 2;       // K / V buffers
  static constexpr int LDK = HD + 4;     // K rows; keys tx + 8j: no conflicts
  static constexpr int LDE = HD + 4;     // E rows
  static constexpr int LDP = BK + 8;     // P rows; rows ty + 4i
  static constexpr int VW = HD >= 32 ? 4 : 2;  // accumulator vector width
  static constexpr int NC = HD / (8 * VW);     // vectors per row per thread
  static constexpr int RD = NC * VW;           // accumulator columns
  // floats before E, then E (n_rel x LDE) and R (BQ x r_stride(n_rel))
  static constexpr int FIXED =
      BQ * HD + NSTAGE * (BK * LDK + BK * HD) + BQ * LDP;
  static __host__ __device__ size_t smem(int n_rel) {
    return sizeof(float) *
           (FIXED + (size_t)n_rel * LDE + (size_t)BQ * r_stride(n_rel));
  }
};

template <int VW> struct VecF;
template <> struct VecF<4> {
  static __device__ __forceinline__ void get(const float* p, float* x) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
  }
  static __device__ __forceinline__ void put(float* p, const float* x) {
    *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  }
};
template <> struct VecF<2> {
  static __device__ __forceinline__ void get(const float* p, float* x) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    x[0] = v.x; x[1] = v.y;
  }
  static __device__ __forceinline__ void put(float* p, const float* x) {
    *reinterpret_cast<float2*>(p) = make_float2(x[0], x[1]);
  }
};

template <int HD>
__global__ void __launch_bounds__(128)
relkey_flash_kernel_f32(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v,
                        const float* __restrict__ emb,
                        float* __restrict__ out, Strides sq, Strides sk,
                        Strides sv, Strides so, int T_len, int left,
                        int right, float scale) {
  typedef Tiles<HD> C;
  constexpr int VW = C::VW, NC = C::NC, RD = C::RD, RQ = C::RQ;
  constexpr int NSTAGE = C::NSTAGE;
  const int n_rel = left + right + 1;
  const int LDR = r_stride(n_rel);
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                       // BQ x HD, scaled
  float* Ks = Qs + BQ * HD;               // NSTAGE x BK x LDK
  float* Vs = Ks + NSTAGE * BK * C::LDK;  // NSTAGE x BK x HD
  float* Ps = Vs + NSTAGE * BK * HD;      // BQ x LDP
  float* Es = Ps + BQ * C::LDP;           // n_rel x LDE
  float* Rs = Es + n_rel * C::LDE;        // BQ x LDR

  const int tid = threadIdx.x;
  const int lane = tid & 31, w = tid >> 5;
  const int ty = lane >> 3, tx = lane & 7;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const float* qb = q + b * sq.b + h * sq.h;
  const float* kb = k + b * sk.b + h * sk.h;
  const float* vb = v + b * sv.b + h * sv.h;
  const int n_tiles = (T_len + BK - 1) / BK;

  auto load_tile = [&](int t, int buf) {
    const int k0 = t * BK;
    float* kd = Ks + buf * BK * C::LDK;
    float* vd = Vs + buf * BK * HD;
    for (int c = tid; c < BK * HD / 4; c += C::NT) {
      const int r = c / (HD / 4), d = (c % (HD / 4)) * 4;
      const bool ok = k0 + r < T_len;
      const long long row = ok ? k0 + r : 0;
      cp_async16(kd + r * C::LDK + d, kb + row * sk.t + d, ok);
      cp_async16(vd + r * HD + d, vb + row * sv.t + d, ok);
    }
  };

  for (int st = 0; st < NSTAGE - 1; ++st) {
    if (st < n_tiles) load_tile(st, st);
    cp_async_commit();
  }

  for (int c = tid; c < BQ * HD / 4; c += C::NT) {
    const int r = c / (HD / 4), d = (c % (HD / 4)) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q0 + r < T_len) {
      x = *reinterpret_cast<const float4*>(qb + (q0 + r) * sq.t + d);
      x.x *= scale; x.y *= scale; x.z *= scale; x.w *= scale;
    }
    *reinterpret_cast<float4*>(Qs + r * HD + d) = x;
  }
  for (int c = tid; c < n_rel * HD / 4; c += C::NT) {
    const int r = c / (HD / 4), d = (c % (HD / 4)) * 4;
    *reinterpret_cast<float4*>(Es + r * C::LDE + d) =
        *reinterpret_cast<const float4*>(emb + r * HD + d);
  }
  __syncthreads();

  // R = Q E^T: consecutive threads take consecutive distances of one row,
  // so Q's row is a broadcast and E's rows fall in distinct banks.
  for (int c = tid; c < BQ * n_rel; c += C::NT) {
    const int r = c / n_rel, e = c % n_rel;
    float acc = 0.f;
#pragma unroll
    for (int d = 0; d < HD; d += 4) {
      float a[4], x[4];
      VecF<4>::get(Qs + r * HD + d, a);
      VecF<4>::get(Es + e * C::LDE + d, x);
#pragma unroll
      for (int u = 0; u < 4; ++u) acc = fmaf(a[u], x[u], acc);
    }
    Rs[r * LDR + e] = acc;
  }
  // (the key walk's first barrier makes R visible to every warp)

  const int rw = w * 16 + ty;             // first local row; rows rw + 4i
  const bool active = q0 + w * 16 < T_len;
  float m[RQ], l[RQ], acc[RQ][RD];
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    m[i] = NEG;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < RD; ++c) acc[i][c] = 0.f;
  }

  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<NSTAGE - 2>();  // tile t has landed
    __syncthreads();              // and every warp is done with tile t - 1
    if (t + NSTAGE - 1 < n_tiles)
      load_tile(t + NSTAGE - 1, (t + NSTAGE - 1) % NSTAGE);
    cp_async_commit();
    const int buf = t % NSTAGE;
    if (active) {
      const float* Kt = Ks + buf * BK * C::LDK;
      const float* Vt = Vs + buf * BK * HD;
      const int k0 = t * BK;

      float s[RQ][4];
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
      for (int d = 0; d < HD; d += 4) {
        float a[RQ][4], c[4][4];
#pragma unroll
        for (int i = 0; i < RQ; ++i)
          VecF<4>::get(Qs + (rw + 4 * i) * HD + d, a[i]);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          VecF<4>::get(Kt + (tx + 8 * j) * C::LDK + d, c[j]);
#pragma unroll
        for (int e = 0; e < 4; ++e)
#pragma unroll
          for (int i = 0; i < RQ; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j)
              s[i][j] = fmaf(a[i][e], c[j][e], s[i][j]);
      }

#pragma unroll
      for (int i = 0; i < RQ; ++i) {
        const int r = rw + 4 * i;
        const float* rrow = Rs + r * LDR;
        float* prow = Ps + r * C::LDP;
        float mx = NEG;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int key = k0 + tx + 8 * j;
          if (key < T_len) {
            const int dist = min(max(key - (q0 + r), -left), right) + left;
            s[i][j] += rrow[dist];
          } else {
            s[i][j] = NEG;
          }
          mx = fmaxf(mx, s[i][j]);
        }
#pragma unroll
        for (int off = 4; off > 0; off >>= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
        const float m_new = fmaxf(m[i], mx);
        const float alpha = expf(m[i] - m_new);
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float p = expf(s[i][j] - m_new);
          sum += p;
          prow[tx + 8 * j] = p;
        }
#pragma unroll
        for (int off = 4; off > 0; off >>= 1)
          sum += __shfl_xor_sync(0xffffffffu, sum, off);
        l[i] = alpha * l[i] + sum;
        m[i] = m_new;
#pragma unroll
        for (int c = 0; c < RD; ++c) acc[i][c] *= alpha;
      }
      __syncwarp();

#pragma unroll 4
      for (int kk = 0; kk < BK; kk += 4) {
        float p[RQ][4];
#pragma unroll
        for (int i = 0; i < RQ; ++i)
          VecF<4>::get(Ps + (rw + 4 * i) * C::LDP + kk, p[i]);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float wv[RD];
#pragma unroll
          for (int c = 0; c < NC; ++c)
            VecF<VW>::get(Vt + (kk + e) * HD + c * 8 * VW + tx * VW,
                          wv + c * VW);
#pragma unroll
          for (int i = 0; i < RQ; ++i)
#pragma unroll
            for (int c = 0; c < RD; ++c)
              acc[i][c] = fmaf(p[i][e], wv[c], acc[i][c]);
        }
      }
    }
  }

  if (active) {
    float* ob = out + b * so.b + h * so.h;
#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      const int row = q0 + rw + 4 * i;
      if (row < T_len) {
        float y[RD];
#pragma unroll
        for (int c = 0; c < RD; ++c) y[c] = acc[i][c] / l[i];
#pragma unroll
        for (int c = 0; c < NC; ++c)
          VecF<VW>::put(ob + row * so.t + c * 8 * VW + tx * VW, y + c * VW);
      }
    }
  }
}

// ---- launch ---------------------------------------------------------------

struct Args {
  const float *q, *k, *v, *emb;
  float* out;
  Strides sq, sk, sv, so;
  int B, H, T_len, left, right;
  float scale;
  cudaStream_t stream;
};

template <int HD>
cudaError_t launch(const Args& a) {
  static bool done[MAX_DEVICES] = {};
  auto kernel = relkey_flash_kernel_f32<HD>;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (!done[dev]) {   // the largest E once per device
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)Tiles<HD>::smem(MAX_REL));
    if (err != cudaSuccess) return err;
    done[dev] = true;
  }
  const dim3 grid((a.T_len + BQ - 1) / BQ, a.H, a.B);
  kernel<<<grid, Tiles<HD>::NT, Tiles<HD>::smem(a.left + a.right + 1),
           a.stream>>>(a.q, a.k, a.v, a.emb, a.out, a.sq, a.sk, a.sv, a.so,
                       a.T_len, a.left, a.right, a.scale);
  return cudaGetLastError();
}

}  // namespace

// q, k, v: float32 (B, H, T, hd) views with a contiguous hd axis, rows and
// base 16-byte aligned; emb: contiguous float32 (left + right + 1, hd),
// at most MAX_REL rows; out: a float32 (B, H, T, hd) view with a contiguous
// hd axis and 16-byte aligned rows. The (b, h, t) element strides of q, k,
// v and out follow. Returns the cudaError_t of the launch (0 on success).
extern "C" int qpg_relkey_attention_cuda(
    const void* q, const void* k, const void* v, const void* emb, void* out,
    long long qb, long long qh, long long qt, long long kb, long long kh,
    long long kt, long long vb, long long vh, long long vt, long long ob,
    long long oh, long long ot, int B, int H, int T_len, int hd, int left,
    int right, float scale, void* stream) {
  if (left < 0 || right < 0 || left + right + 1 > MAX_REL)
    return cudaErrorInvalidValue;
  const Args a{static_cast<const float*>(q), static_cast<const float*>(k),
               static_cast<const float*>(v), static_cast<const float*>(emb),
               static_cast<float*>(out), {qb, qh, qt}, {kb, kh, kt},
               {vb, vh, vt}, {ob, oh, ot}, B, H, T_len, left, right, scale,
               static_cast<cudaStream_t>(stream)};
  switch (hd) {
    case 16: return launch<16>(a);
    case 64: return launch<64>(a);
  }
  return cudaErrorInvalidValue;
}
