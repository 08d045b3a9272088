// Gated flash attention for WavLM on Hopper (sm_90a):
//
//     out = softmax(q @ k^T * sm_scale + gate * bias) @ v
//
// and, bias-free, the plain softmax(q @ k^T * sm_scale) @ v of Whisper.
//
// Replaces the TPU kernel qpgesture_tpu/ops/flash_attention.py ::
// gated_flash_attention (body _flash_kernel). The plain PyTorch version is
// qpgesture_tpu_torch/ops/flash_attention.py :: gated_attention_plain; the
// wrapper, build and ctypes binding are ops/flash_attention_cuda.py.
//
// What it computes, rounding included (as the TPU kernel and its wrapper):
//   * q, k, v, bias and gate arrive in the element type (float or bf16);
//     q is scaled by sm_scale (already rounded to that type) and rounded to
//     it;
//   * s = q . k^T in float32, then s += gate[row] * bias[row, col] (product
//     and sum each rounded, as two separate float32 operations); without a
//     gate, s += bias;
//   * key columns >= T are masked to -1e30 (T is not padded in memory);
//   * the running max m, row sum l and the accumulator are float32; the
//     weights p = expf(s - m) are rounded to the element type before p @ v,
//     l sums the unrounded p; out = acc / l in float32.
//
// Both instantiations keep every (T, T) intermediate out of device memory:
// a block of four warps owns 64 query rows of one (batch, head), 16 rows a
// warp, and walks the key axis in 32-row tiles. The K, V and bias tiles of
// step t+1 are copied into a second shared-memory buffer with 16-byte
// cp.async while step t computes (one block barrier per tile). Key tiles of
// 32 pad T = 199 to 224; a warp whose query rows all lie past T skips the
// arithmetic, so queries pad to 208 and the work is 1.18x of T^2 (64x64
// tiles did 1.65x). The bias must have 16-byte aligned rows (the wrapper
// pads its row stride once, see prepare_bias); q, k, v rows too (WavLM's
// (B, T, H, hd) projections are).
//
// float32 (the "highest" encoder): with TF32 off the products are float32
// FMAs on the CUDA cores (67 TFLOP/s) and 4*B*H*T^2*hd operations bound it.
// Each thread holds a 4 x 4 tile of the logits (rows ty + 4i, keys tx + 8j)
// and a 4 x hd/8 tile of the accumulator, fed by float4 shared loads. K rows
// are padded by 4 floats and bias/P rows by 8, so the loads are free of
// bank conflicts. P is written over the bias tile it came from (each warp
// owns its rows: a __syncwarp, not a block barrier). What holds it back:
// shared memory hands an SM 128 bytes a clock, one float per FMA at the
// FMA rate, and an a x b register tile needs 4(a + b) / (a b) bytes per
// FMA: 2 for 4 x 4, 1 only from 8 x 8. But at T = 199 the grid gives a
// scheduler only 3 warps, and larger tiles cost registers and warps: two
// warps of 8 x 4 logits and 8 x hd/8 accumulators (240 registers), and
// four warps of 8 x 4 logits over half of d with 8 x 8 accumulators over
// half of each key tile (168 registers, a quarter less shared traffic per
// FMA), both measured slower than these 4 x 4 tiles.
//
// float32 without bias or gate (nobias_flash_kernel_f32<HD, NW>, Whisper's
// encoder at T = 1500, one utterance of 20 heads): the same body with the
// bias and gate compiled out (a template flag, so that WavLM's gated kernel
// compiles as before), P in one buffer instead of two, and 8 warps a block:
// no (H, T, T) bias is read, which at T = 1500 would be 180 MB a layer. It
// is bound as the gated kernel is, by shared memory feeding the 4 x 4 tiles
// (half the FMA peak at best). At (1, 20, 1500, 64), blocks of 4 warps make
// 480 blocks, 1.2 waves of three an SM; 8 warps make 240, one wave of two
// an SM: 0.400 ms (28.8 TFLOP/s) against 0.525 ms on an H100, 128
// registers and no spills either way.
//
// bfloat16 (the "default" encoder): tensor cores, FlashAttention-2's
// register layout. Four warps own 16 query rows each; S = Q.K^T is
// mma.sync m16n8k16 (bf16 in, float32 accumulate) with Q's fragments in
// registers for the whole key walk and K through ldmatrix; gate*bias, the
// mask and the online softmax work on the S fragment (quad shuffles for the
// row max); P is rounded to bf16 and packed from the S registers straight
// into the A operand of P.V, with V through ldmatrix.trans. At T ~ 200 the
// work is small and latency, not the mma rate, bounds it; wgmma and TMA
// (the warpgroup products and bulk copies of Hopper) are the next step if a
// profile shows this kernel issue-bound.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int BQ = 64;          // query rows per block
constexpr int BK = 32;          // key rows per tile
constexpr float NEG = -1e30f;   // the TPU kernel's mask value
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

// ---- float32: register-tiled FMAs on the CUDA cores ----------------------

// NW warps of 16 query rows each; BIASED reads an (H, T, T) bias and a
// gate, whose tiles take a second buffer each; without them P needs one.
template <int HD, int NW = 4, bool BIASED = true>
struct F32Tiles {
  static constexpr int BQ = 16 * NW;     // query rows per block
  static constexpr int NT = 32 * NW;     // threads
  static constexpr int RQ = 4;           // query rows per thread
  static constexpr int NSTAGE = 2;       // K / V / bias buffers
  static constexpr int NP = BIASED ? NSTAGE : 1;  // bias / P buffers
  static constexpr int LDK = HD + 4;     // K rows; keys tx + 8j: no conflicts
  static constexpr int LDB = BK + 8;     // bias / P rows; rows ty + 4i
  static constexpr int VW = HD >= 32 ? 4 : 2;  // accumulator vector width
  static constexpr int NC = HD / (8 * VW);     // vectors per row per thread
  static constexpr int RD = NC * VW;           // accumulator columns
  static constexpr size_t SMEM =
      sizeof(float) * (BQ * HD + NSTAGE * (BK * LDK + BK * HD) +
                       NP * BQ * LDB);
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

// The float32 kernels' body. BIASED = false is plain attention (no bias,
// no gate: whisper's); its P tile has one buffer, and the loads and adds of
// the bias and the gate are compiled out.
template <int HD, int NW, bool BIASED>
__device__ __forceinline__ void f32_attention(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ bias,
    const float* __restrict__ gate, float* __restrict__ out, Strides sq,
    Strides sk, Strides sv, Strides so, long long bias_h, long long bias_t,
    int T_len, float scale, float* smem) {
  typedef F32Tiles<HD, NW, BIASED> C;
  constexpr int VW = C::VW, NC = C::NC, RD = C::RD, RQ = C::RQ;
  constexpr int NSTAGE = C::NSTAGE, BQ = C::BQ;
  float* Qs = smem;                       // BQ x HD, scaled
  float* Ks = Qs + BQ * HD;               // NSTAGE x BK x LDK
  float* Vs = Ks + NSTAGE * BK * C::LDK;  // NSTAGE x BK x HD
  float* Bs = Vs + NSTAGE * BK * HD;      // NP x BQ x LDB; P overwrites

  const int tid = threadIdx.x;
  const int lane = tid & 31, w = tid >> 5;
  const int ty = lane >> 3, tx = lane & 7;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y, b = blockIdx.z, H = gridDim.y;
  const float* qb = q + b * sq.b + h * sq.h;
  const float* kb = k + b * sk.b + h * sk.h;
  const float* vb = v + b * sv.b + h * sv.h;
  const float* bh = BIASED ? bias + h * bias_h : nullptr;
  const int n_tiles = (T_len + BK - 1) / BK;

  auto load_tile = [&](int t, int buf) {
    const int k0 = t * BK;
    float* kd = Ks + buf * BK * C::LDK;
    float* vd = Vs + buf * BK * HD;
    float* bd = Bs + buf * BQ * C::LDB;
    for (int c = tid; c < BK * HD / 4; c += C::NT) {
      const int r = c / (HD / 4), d = (c % (HD / 4)) * 4;
      const bool ok = k0 + r < T_len;
      const long long row = ok ? k0 + r : 0;
      cp_async16(kd + r * C::LDK + d, kb + row * sk.t + d, ok);
      cp_async16(vd + r * HD + d, vb + row * sv.t + d, ok);
    }
    if (BIASED)
      for (int c = tid; c < BQ * BK / 4; c += C::NT) {
        const int r = c / (BK / 4), col = (c % (BK / 4)) * 4;
        const bool ok = q0 + r < T_len && k0 + col < T_len;
        cp_async16(bd + r * C::LDB + col,
                   bh + (ok ? (q0 + r) * bias_t + k0 + col : 0), ok);
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

  const int rw = w * 16 + ty;             // first local row; rows rw + 4i
  const bool active = q0 + w * 16 < T_len;
  float g[RQ], m[RQ], l[RQ], acc[RQ][RD];
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int row = q0 + rw + 4 * i;
    g[i] = 1.f;
    if (BIASED && gate != nullptr && row < T_len)
      g[i] = gate[((long long)b * H + h) * T_len + row];
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
      float* Bt = Bs + (BIASED ? buf : 0) * BQ * C::LDB;
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
        float* brow = Bt + (rw + 4 * i) * C::LDB;
        float mx = NEG;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (k0 + tx + 8 * j < T_len) {
            if (BIASED)
              s[i][j] = __fadd_rn(s[i][j], __fmul_rn(g[i], brow[tx + 8 * j]));
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
          brow[tx + 8 * j] = p;
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
          VecF<4>::get(Bt + (rw + 4 * i) * C::LDB + kk, p[i]);
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

template <int HD>
__global__ void __launch_bounds__(128)
gated_flash_kernel_f32(const float* __restrict__ q,
                       const float* __restrict__ k,
                       const float* __restrict__ v,
                       const float* __restrict__ bias,
                       const float* __restrict__ gate,
                       float* __restrict__ out, Strides sq, Strides sk,
                       Strides sv, Strides so, long long bias_h,
                       long long bias_t, int T_len, float scale) {
  extern __shared__ __align__(16) float smem[];
  f32_attention<HD, 4, true>(q, k, v, bias, gate, out, sq, sk, sv, so,
                             bias_h, bias_t, T_len, scale, smem);
}

// Plain attention, softmax(q k^T scale) v, for whisper's encoder.
template <int HD, int NW>
__global__ void __launch_bounds__(32 * NW)
nobias_flash_kernel_f32(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v,
                        float* __restrict__ out, Strides sq, Strides sk,
                        Strides sv, Strides so, int T_len, float scale) {
  extern __shared__ __align__(16) float smem[];
  f32_attention<HD, NW, false>(q, k, v, nullptr, nullptr, out, sq, sk, sv,
                               so, 0, 0, T_len, scale, smem);
}

// ---- bfloat16: mma.sync on the tensor cores ------------------------------

template <int HD>
struct Bf16Tiles {
  static constexpr int NT = 128;         // 4 warps x 16 query rows
  static constexpr int NSTAGE = 2;       // K / V / bias buffers
  static constexpr int LDK = HD + 8;     // K / V rows: conflict-free ldmatrix
  static constexpr int LDB = BK + 8;     // bias rows
  static constexpr size_t SMEM =
      sizeof(bf16) * NSTAGE * (2 * BK * LDK + BQ * LDB);
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 x = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&x);
}

__device__ __forceinline__ void ldsm_x4(uint32_t* r, const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a)
      : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t* r, const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a)
      : "memory");
}

// c += a (16x16, row) . b (16x8, col), bf16 in, float32 accumulate.
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int HD>
__global__ void __launch_bounds__(128)
gated_flash_kernel_bf16(const bf16* __restrict__ q,
                        const bf16* __restrict__ k,
                        const bf16* __restrict__ v,
                        const bf16* __restrict__ bias,
                        const bf16* __restrict__ gate,
                        float* __restrict__ out, Strides sq, Strides sk,
                        Strides sv, Strides so, long long bias_h,
                        long long bias_t, int T_len, float scale) {
  typedef Bf16Tiles<HD> C;
  constexpr int LDK = C::LDK, LDB = C::LDB;
  constexpr int KS = HD / 16;   // k-steps of Q.K^T
  constexpr int NS = BK / 8;    // n-tiles of S (keys)
  constexpr int NO = HD / 8;    // n-tiles of the output
  constexpr int NSTAGE = C::NSTAGE;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);   // NSTAGE x BK x LDK
  bf16* Vs = Ks + NSTAGE * BK * LDK;              // NSTAGE x BK x LDK
  bf16* Bs = Vs + NSTAGE * BK * LDK;              // NSTAGE x BQ x LDB

  const int tid = threadIdx.x;
  const int lane = tid & 31, w = tid >> 5;
  const int gq = lane >> 2, t4 = lane & 3;        // mma group, thread in it
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y, b = blockIdx.z, H = gridDim.y;
  const bf16* qb = q + b * sq.b + h * sq.h;
  const bf16* kb = k + b * sk.b + h * sk.h;
  const bf16* vb = v + b * sv.b + h * sv.h;
  const bf16* bh = bias + h * bias_h;
  const int n_tiles = (T_len + BK - 1) / BK;

  auto load_tile = [&](int t, int buf) {
    const int k0 = t * BK;
    bf16* kd = Ks + buf * BK * LDK;
    bf16* vd = Vs + buf * BK * LDK;
    bf16* bd = Bs + buf * BQ * LDB;
    for (int c = tid; c < BK * HD / 8; c += C::NT) {
      const int r = c / (HD / 8), d = (c % (HD / 8)) * 8;
      const bool ok = k0 + r < T_len;
      const long long row = ok ? k0 + r : 0;
      cp_async16(kd + r * LDK + d, kb + row * sk.t + d, ok);
      cp_async16(vd + r * LDK + d, vb + row * sv.t + d, ok);
    }
    for (int c = tid; c < BQ * BK / 8; c += C::NT) {
      const int r = c / (BK / 8), col = (c % (BK / 8)) * 8;
      const bool ok = q0 + r < T_len && k0 + col < T_len;
      cp_async16(bd + r * LDB + col,
                 bh + (ok ? (q0 + r) * bias_t + k0 + col : 0), ok);
    }
  };

  for (int st = 0; st < NSTAGE - 1; ++st) {
    if (st < n_tiles) load_tile(st, st);
    cp_async_commit();
  }

  // rows of this thread: lr[0] = w*16 + gq and lr[1] = lr[0] + 8 (local)
  const int lr0 = w * 16 + gq;
  const bool active = q0 + w * 16 < T_len;
  // Q's A fragments for the whole key walk: register 2*half + rr holds
  // row lr[rr], columns 16*ks + 8*half + 2*t4 and the next.
  uint32_t qa[KS][4];
  float gg[2], m[2], l[2], acc[NO][4];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int row = q0 + lr0 + 8 * rr;
    const bool ok = row < T_len;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float x0 = 0.f, x1 = 0.f;
        if (ok) {
          const __nv_bfloat162 x = *reinterpret_cast<const __nv_bfloat162*>(
              qb + row * sq.t + 16 * ks + 8 * half + 2 * t4);
          x0 = __bfloat162float(x.x) * scale;
          x1 = __bfloat162float(x.y) * scale;
        }
        qa[ks][2 * half + rr] = pack_bf16(x0, x1);
      }
    gg[rr] = 1.f;
    if (gate != nullptr && ok)
      gg[rr] = __bfloat162float(gate[((long long)b * H + h) * T_len + row]);
    m[rr] = NEG;
    l[rr] = 0.f;
  }
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<NSTAGE - 2>();  // tile t has landed
    __syncthreads();              // and every warp is done with tile t - 1
    if (t + NSTAGE - 1 < n_tiles)
      load_tile(t + NSTAGE - 1, (t + NSTAGE - 1) % NSTAGE);
    cp_async_commit();
    const int buf = t % NSTAGE;
    if (active) {
      const bf16* Kt = Ks + buf * BK * LDK;
      const bf16* Vt = Vs + buf * BK * LDK;
      const bf16* Bt = Bs + buf * BQ * LDB;
      const int k0 = t * BK;

      // S = Q . K^T: ldmatrix x4 gives the B fragments of two key n-tiles
      float s[NS][4];
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks)
#pragma unroll
        for (int np = 0; np < NS / 2; ++np) {
          const int mi = lane >> 3;
          uint32_t kf[4];
          ldsm_x4(kf, Kt + (16 * np + 8 * (mi >> 1) + (lane & 7)) * LDK +
                          16 * ks + 8 * (mi & 1));
          mma_bf16(s[2 * np], qa[ks], kf[0], kf[1]);
          mma_bf16(s[2 * np + 1], qa[ks], kf[2], kf[3]);
        }

      // gate * bias, the mask, the online softmax on the fragment
      float mx[2] = {NEG, NEG};
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const int cl = 8 * n + 2 * t4;
          const __nv_bfloat162 bv = *reinterpret_cast<const __nv_bfloat162*>(
              Bt + (lr0 + 8 * rr) * LDB + cl);
          const float bx[2] = {__bfloat162float(bv.x), __bfloat162float(bv.y)};
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float& x = s[n][2 * rr + e];
            if (k0 + cl + e < T_len)
              x = __fadd_rn(x, __fmul_rn(gg[rr], bx[e]));
            else
              x = NEG;
            mx[rr] = fmaxf(mx[rr], x);
          }
        }
      float alpha[2], m_new[2];
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(0xffffffffu, mx[rr], 1));
        mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(0xffffffffu, mx[rr], 2));
        m_new[rr] = fmaxf(m[rr], mx[rr]);
        alpha[rr] = expf(m[rr] - m_new[rr]);
        m[rr] = m_new[rr];
      }
      float sum[2] = {0.f, 0.f};
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = expf(s[n][e] - m_new[e >> 1]);
          sum[e >> 1] += p;
          s[n][e] = p;
        }
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) l[rr] = alpha[rr] * l[rr] + sum[rr];
#pragma unroll
      for (int n = 0; n < NO; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] *= alpha[e >> 1];

      // O += P . V: P rounded to bf16 from the S registers, V transposed
      // by ldmatrix
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const uint32_t pa[4] = {
            pack_bf16(s[2 * kk][0], s[2 * kk][1]),
            pack_bf16(s[2 * kk][2], s[2 * kk][3]),
            pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
            pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
        for (int np = 0; np < NO / 2; ++np) {
          const int mi = lane >> 3;
          uint32_t vf[4];
          ldsm_x4_trans(vf, Vt + (16 * kk + 8 * (mi & 1) + (lane & 7)) * LDK +
                                16 * np + 8 * (mi >> 1));
          mma_bf16(acc[2 * np], pa, vf[0], vf[1]);
          mma_bf16(acc[2 * np + 1], pa, vf[2], vf[3]);
        }
      }
    }
  }

  if (active) {
    float* ob = out + b * so.b + h * so.h;
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      l[rr] += __shfl_xor_sync(0xffffffffu, l[rr], 1);
      l[rr] += __shfl_xor_sync(0xffffffffu, l[rr], 2);
      const int row = q0 + lr0 + 8 * rr;
      if (row < T_len) {
#pragma unroll
        for (int n = 0; n < NO; ++n)
          *reinterpret_cast<float2*>(ob + row * so.t + 8 * n + 2 * t4) =
              make_float2(acc[n][2 * rr] / l[rr], acc[n][2 * rr + 1] / l[rr]);
      }
    }
  }
}

// ---- launch ---------------------------------------------------------------

struct Args {
  const void *q, *k, *v, *bias, *gate;
  void* out;
  Strides sq, sk, sv, so;
  long long bias_h, bias_t;
  int B, H, T_len;
  float scale;
  cudaStream_t stream;
};

// Raise the kernel's dynamic shared memory limit once per device.
template <typename Kernel>
cudaError_t configure(Kernel kernel, size_t smem, bool* done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (!done[dev]) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    done[dev] = true;
  }
  return cudaSuccess;
}

template <int HD>
cudaError_t launch_f32(const Args& a) {
  static bool done[MAX_DEVICES] = {};
  auto kernel = gated_flash_kernel_f32<HD>;
  constexpr size_t smem = F32Tiles<HD>::SMEM;
  cudaError_t err = configure(kernel, smem, done);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.T_len + BQ - 1) / BQ, a.H, a.B);
  kernel<<<grid, F32Tiles<HD>::NT, smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.bias),
      static_cast<const float*>(a.gate), static_cast<float*>(a.out), a.sq,
      a.sk, a.sv, a.so, a.bias_h, a.bias_t, a.T_len, a.scale);
  return cudaGetLastError();
}

constexpr int NOBIAS_WARPS = 8;

template <int HD>
cudaError_t launch_nobias(const Args& a) {
  static bool done[MAX_DEVICES] = {};
  auto kernel = nobias_flash_kernel_f32<HD, NOBIAS_WARPS>;
  typedef F32Tiles<HD, NOBIAS_WARPS, false> C;
  cudaError_t err = configure(kernel, C::SMEM, done);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.T_len + C::BQ - 1) / C::BQ, a.H, a.B);
  kernel<<<grid, C::NT, C::SMEM, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<float*>(a.out), a.sq, a.sk,
      a.sv, a.so, a.T_len, a.scale);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_bf16(const Args& a) {
  static bool done[MAX_DEVICES] = {};
  auto kernel = gated_flash_kernel_bf16<HD>;
  constexpr size_t smem = Bf16Tiles<HD>::SMEM;
  cudaError_t err = configure(kernel, smem, done);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.T_len + BQ - 1) / BQ, a.H, a.B);
  kernel<<<grid, Bf16Tiles<HD>::NT, smem, a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.bias),
      static_cast<const bf16*>(a.gate), static_cast<float*>(a.out), a.sq,
      a.sk, a.sv, a.so, a.bias_h, a.bias_t, a.T_len, a.scale);
  return cudaGetLastError();
}

}  // namespace

// q, k, v: (B, H, T, hd) views with a contiguous hd axis, element type
// `dtype` (0 = float32, 1 = bfloat16), rows and base 16-byte aligned;
// bias: (H, T, T) with a contiguous last axis, row stride bias_t and head
// stride bias_h (elements) 16-byte aligned, or null with a null gate and
// float32 (plain attention, the bias-free instantiation); gate: contiguous
// (B, H, T) or null; out: a float32 (B, H, T, hd) view with a contiguous
// hd axis and 16-byte aligned rows. The (b, h, t) element strides of q, k, v and out
// follow. Returns the cudaError_t of the launch (0 on success).
extern "C" int qpg_gated_flash_attention_cuda(
    const void* q, const void* k, const void* v, const void* bias,
    const void* gate, void* out, long long qb, long long qh, long long qt,
    long long kb, long long kh, long long kt, long long vb, long long vh,
    long long vt, long long ob, long long oh, long long ot, long long bias_h,
    long long bias_t, int B, int H, int T_len, int hd, int dtype,
    float scale, void* stream) {
  const Args a{q, k, v, bias, gate, out, {qb, qh, qt}, {kb, kh, kt},
               {vb, vh, vt}, {ob, oh, ot}, bias_h, bias_t, B, H, T_len,
               scale, static_cast<cudaStream_t>(stream)};
  if (dtype == 0 && bias == nullptr) {
    if (gate != nullptr) return cudaErrorInvalidValue;
    switch (hd) {
      case 16: return launch_nobias<16>(a);
      case 32: return launch_nobias<32>(a);
      case 64: return launch_nobias<64>(a);
    }
  } else if (dtype == 0) {
    switch (hd) {
      case 16: return launch_f32<16>(a);
      case 32: return launch_f32<32>(a);
      case 64: return launch_f32<64>(a);
    }
  } else if (dtype == 1) {
    switch (hd) {
      case 16: return launch_bf16<16>(a);
      case 32: return launch_bf16<32>(a);
      case 64: return launch_bf16<64>(a);
    }
  }
  return cudaErrorInvalidValue;
}
