// The matching engine's fusion scan (phase 2) for Hopper: every step of
// every lane in one launch.
//
// Replaces no Pallas kernel. The JAX package runs this phase as a lax.scan
// (qpgesture_tpu/match/engine.py :: _fuse_scan, vmapped over lanes by
// _fuse_scan_clips), which XLA compiles into one program. The port's plain
// version, qpgesture_tpu_torch/match/engine.py :: _scan_loop, is a host loop
// that launches ~40-65 small operations for each step: on an H100 a 24 s
// clip (48 steps) paid 39-58 ms of host launches for 3-5 ms of device work.
//
// What it computes, for lane c (one block) at each step t of its L steps
// (q = c * L + t, the flat step), as the loop does: at a reset step the carry
// (prev_code, prev_phase) becomes (reset_code[q], reset_phase[q]); the
// selection for prev_code is read from the tabulated selection rows; each
// candidate's (head, tail) phase pair is read from its side's pair grid at
// pos, or sliced from phase / amp at seq and clamp(start, 0, T - 32); the
// phase continuity picks a candidate (d0 <= d1); the step writes the
// candidate's block, the chosen tail (or the carried phase) and the vote; the
// seed chains from block[seed_off] at a window's last step, else from
// block[S - 1]. The mode, a template parameter, follows the engine's flags:
//   0  no phase, one side       sel (Q, P) -> block of that side
//   1  no phase, both sides     sel (Q, P); rand[q] != 0 picks audio
//   2  phase, one side          sel (Q, P, 2), the top-2 order
//   3  phase, both sides        sel_a, sel_b (Q, P); vote 0 audio, 1 text
//
// Bit for bit the loop's result: the continuity does the plain version's
// IEEE operations in its order. Squares and quotients are rounded alone,
// sums follow tree_sum's pairwise halving over 128 entries (x[i] + x[i + h],
// h = 64 .. 1: two levels in registers, five by shuffle-down), and sqrt and
// division are correctly rounded. The __f*_rn intrinsics keep nvcc from
// contracting any of it into FMAs, whatever the flags.
//
// What bounds it on an H100: the latency of dependent loads, not bytes or
// operations. A step needs ~2 KB and a few thousand flops, but it starts
// only once the previous one has chosen prev_code, and the plain
// loop's chain is four dependent loads a step (selection -> position ->
// pair -> block). The least a step can wait is one dependent load: which
// candidates' pairs to read is known only from prev_code.
//
// What the design does about it: everything of a step that does not depend
// on prev_code (the selection, block and position or (seq, start) rows, the
// reset and rand entries) is staged into shared memory one step ahead with
// cp.async, double-buffered. A step then resolves selection, position and
// block from shared memory; its one dependent global load is the
// candidates' 1 KB pairs, one float4 a thread. Two warps compute the two
// continuities at once. The carry stays in registers (prev_code) and shared
// memory (prev_phase). One block runs one lane, so C lanes take C SMs, and
// nothing limits L.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kPhase = 128;        // one 8 x 16 phase block
constexpr int kPair = 2 * kPhase;  // a candidate's (head, tail)
static_assert(kThreads == kPhase, "one thread per phase entry");
static_assert(kThreads == 2 * kPair / 4, "one float4 of two pairs a thread");

struct Side {
  const int64_t* sel;    // (Q, P[, 2]) selection; null for mode 1's text
  const int64_t* block;  // (Q, P, S) continuation codes
  const float* ht;       // (rows, 2, 8, 16) pair grid; null: sliced
  const int64_t* idx0;   // (Q, P) grid row (pos), or seq when sliced
  const int64_t* idx1;   // (Q, P) phase-window start when sliced
};

struct Params {
  Side side[2];
  const float* phase;  // (J, T, 8), read when a side is sliced
  const float* amp;
  const int32_t* mask;         // (L,) reset steps of every lane
  const int32_t* rand;         // (Q,) mode 1
  const int64_t* reset_code;   // (Q,), null when no step resets
  const float* reset_phase;    // (Q, 8, 16)
  int64_t* out_block;          // (Q, S)
  float* out_phase;            // (Q, 8, 16)
  int32_t* out_vote;           // (Q,)
  int T, L, P, S, n_steps, seed_off;
};

// Byte offsets of the regions of one stage buffer (16-byte aligned; -1:
// not staged in this mode).
struct Layout {
  int flags;        // mask (int32), rand (int32), reset code (int64)
  int reset_phase;  // 128 floats
  int sel[2];
  int blk[2];
  int idx[2][2];
  int bytes;
};

int take(int& at, int bytes) {
  const int off = at;
  at += (bytes + 15) & ~15;
  return off;
}

Layout make_layout(int mode, bool grid, int P, int S) {
  Layout lo;
  int at = 0;
  const bool phase = mode >= 2, both = mode & 1;
  lo.flags = take(at, 16);
  lo.reset_phase = take(at, kPhase * 4);
  lo.sel[0] = take(at, P * (mode == 2 ? 2 : 1) * 8);
  lo.sel[1] = mode == 3 ? take(at, P * 8) : -1;
  for (int s = 0; s < 2; ++s) {
    const bool used = s == 0 || both;
    lo.blk[s] = used ? take(at, P * S * 8) : -1;
    lo.idx[s][0] = used && phase ? take(at, P * 8) : -1;
    lo.idx[s][1] = used && phase && !grid ? take(at, P * 8) : -1;
  }
  lo.bytes = at;
  return lo;
}

__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         int chunk) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if (chunk == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 :: "r"(d), "l"(src) : "memory");
  } else if (chunk == 8) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n"
                 :: "r"(d), "l"(src) : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
                 :: "r"(d), "l"(src) : "memory");
  }
}

__device__ __forceinline__ void commit_group() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void wait_all_but_newest_group() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Queues a copy of `bytes` (a multiple of 4) from device to shared memory,
// spread over the block, in the widest chunks both addresses allow.
__device__ void stage_copy(unsigned char* dst, const void* src, int bytes) {
  const unsigned char* s = static_cast<const unsigned char*>(src);
  const uintptr_t a = reinterpret_cast<uintptr_t>(dst) |
                      reinterpret_cast<uintptr_t>(s) |
                      static_cast<uintptr_t>(bytes);
  const int chunk = (a & 15) == 0 ? 16 : (a & 7) == 0 ? 8 : 4;
  for (int i = threadIdx.x * chunk; i < bytes; i += kThreads * chunk) {
    cp_async(dst + i, s + i, chunk);
  }
}

// Queues everything of lane-local step t (flat step q) that does not depend
// on prev_code.
template <int MODE, bool GRID>
__device__ void stage_step(unsigned char* buf, const Layout& lo,
                           const Params& p, int t, int64_t q) {
  constexpr bool kPhaseMode = MODE >= 2;
  constexpr int kSides = MODE & 1 ? 2 : 1;
  const int64_t row = q * p.P;
  stage_copy(buf + lo.flags, p.mask + t, 4);
  if (MODE == 1) stage_copy(buf + lo.flags + 4, p.rand + q, 4);
  if (p.reset_code != nullptr) {
    stage_copy(buf + lo.flags + 8, p.reset_code + q, 8);
    stage_copy(buf + lo.reset_phase, p.reset_phase + q * kPhase, kPhase * 4);
  }
  stage_copy(buf + lo.sel[0], p.side[0].sel + row * (MODE == 2 ? 2 : 1),
             p.P * (MODE == 2 ? 2 : 1) * 8);
  if (MODE == 3) stage_copy(buf + lo.sel[1], p.side[1].sel + row, p.P * 8);
#pragma unroll
  for (int s = 0; s < kSides; ++s) {
    stage_copy(buf + lo.blk[s], p.side[s].block + row * p.S, p.P * p.S * 8);
    if (kPhaseMode) {
      stage_copy(buf + lo.idx[s][0], p.side[s].idx0 + row, p.P * 8);
      if (!GRID) stage_copy(buf + lo.idx[s][1], p.side[s].idx1 + row, p.P * 8);
    }
  }
}

// Float4 j (0..63) of candidate `cand`'s (head, tail) pair into dst: its
// grid row, or rows start .. start + 7 and start + 24 .. start + 31 of its
// sequence, phase | amp on the last axis.
template <bool GRID>
__device__ __forceinline__ void load_pair(float* dst, const Side& side,
                                          const unsigned char* buf,
                                          int idx0_off, int idx1_off,
                                          int64_t cand, const Params& p,
                                          int j) {
  const int64_t i0 = reinterpret_cast<const int64_t*>(buf + idx0_off)[cand];
  const float* src;
  if (GRID) {
    src = side.ht + i0 * kPair + 4 * j;
  } else {
    int64_t s = reinterpret_cast<const int64_t*>(buf + idx1_off)[cand];
    s = s < 0 ? 0 : s;
    s = s > p.T - 32 ? p.T - 32 : s;  // clamp(start, 0, T - 32)
    const int r = j >> 2, f = j & 3;
    const int64_t frame = s + r + (r >= 8 ? 16 : 0);
    src = (f < 2 ? p.phase : p.amp) + (i0 * p.T + frame) * 8 + (f & 1) * 4;
  }
  reinterpret_cast<float4*>(dst)[j] =
      __ldg(reinterpret_cast<const float4*>(src));
}

// tree_sum of a warp's 128 entries, entry lane + 32 j in x[j]: levels 64
// and 32 in registers, 16 .. 1 by shuffle-down; every lane gets the sum.
__device__ __forceinline__ float tree_sum128(const float (&x)[4]) {
  float s = __fadd_rn(__fadd_rn(x[0], x[2]), __fadd_rn(x[1], x[3]));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    s = __fadd_rn(s, __shfl_down_sync(0xffffffffu, s, off));
  }
  return __shfl_sync(0xffffffffu, s, 0);
}

// engine._phase_continuity of one candidate, by one warp:
// cos_dist(concat(prev[3:], head[:3]), concat(prev[5:], head[:5])).
__device__ float continuity(const float* prev, const float* head, int lane) {
  float a[4], b[4], aa[4], bb[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int i = lane + 32 * j, row = i >> 4, col = i & 15;
    a[j] = row < 5 ? prev[(row + 3) * 16 + col] : head[(row - 5) * 16 + col];
    b[j] = row < 3 ? prev[(row + 5) * 16 + col] : head[(row - 3) * 16 + col];
    aa[j] = __fmul_rn(a[j], a[j]);
    bb[j] = __fmul_rn(b[j], b[j]);
  }
  float na = __fsqrt_rn(tree_sum128(aa));
  float nb = __fsqrt_rn(tree_sum128(bb));
  na = na > 0.f ? na : 1.f;
  nb = nb > 0.f ? nb : 1.f;
  float ab[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    ab[j] = __fmul_rn(__fdiv_rn(a[j], na), __fdiv_rn(b[j], nb));
  }
  return __fsub_rn(1.f, tree_sum128(ab));
}

template <int MODE, bool GRID>
__global__ void __launch_bounds__(kThreads)
fusion_scan_kernel(const Params p, const Layout lo) {
  extern __shared__ __align__(16) unsigned char stage_mem[];
  __shared__ __align__(16) float pairs[2][kPair];
  __shared__ float prev_phase[kPhase];
  __shared__ float dist[2];
  constexpr bool kPhaseMode = MODE >= 2;
  const int tid = threadIdx.x;
  const int64_t q0 = static_cast<int64_t>(blockIdx.x) * p.L;
  // step t's rows live in stage buffer t & 1
  auto stage_buf = [&](int t) { return stage_mem + (t & 1) * lo.bytes; };

  prev_phase[tid] = 0.f;
  int64_t prev_code = 0;
  stage_step<MODE, GRID>(stage_buf(0), lo, p, 0, q0);
  commit_group();
  for (int t = 0; t < p.L; ++t) {
    const int64_t q = q0 + t;
    if (t + 1 < p.L) {
      stage_step<MODE, GRID>(stage_buf(t + 1), lo, p, t + 1, q + 1);
    }
    commit_group();
    wait_all_but_newest_group();
    __syncthreads();
    const unsigned char* buf = stage_buf(t);
    if (*reinterpret_cast<const int32_t*>(buf + lo.flags) != 0) {
      // in [0, P): the engine checks the codes it is given on the host
      prev_code = *reinterpret_cast<const int64_t*>(buf + lo.flags + 8);
      prev_phase[tid] =
          reinterpret_cast<const float*>(buf + lo.reset_phase)[tid];
      __syncthreads();
    }
    const int64_t* sel_a = reinterpret_cast<const int64_t*>(buf + lo.sel[0]);
    int side = 0;
    int64_t cand;
    float ph;
    int32_t vote = 0;
    if (!kPhaseMode) {
      cand = sel_a[prev_code];
      if (MODE == 1) {
        side = *reinterpret_cast<const int32_t*>(buf + lo.flags + 4) ? 0 : 1;
      }
      ph = prev_phase[tid];
    } else {
      int64_t c0, c1;
      if (MODE == 2) {
        c0 = sel_a[2 * prev_code];
        c1 = sel_a[2 * prev_code + 1];
      } else {
        c0 = sel_a[prev_code];
        c1 = reinterpret_cast<const int64_t*>(buf + lo.sel[1])[prev_code];
      }
      const int k = tid >> 6;   // the candidate whose pair this thread loads
      const bool kb = MODE == 3 && k == 1;
      load_pair<GRID>(pairs[k], kb ? p.side[1] : p.side[0], buf,
                      kb ? lo.idx[1][0] : lo.idx[0][0],
                      kb ? lo.idx[1][1] : lo.idx[0][1], k ? c1 : c0, p,
                      tid & 63);
      __syncthreads();
      if (tid < 64) {
        const float d = continuity(prev_phase, pairs[tid >> 5], tid & 31);
        if ((tid & 31) == 0) dist[tid >> 5] = d;
      }
      __syncthreads();
      const bool pick0 = dist[0] <= dist[1];
      cand = pick0 ? c0 : c1;
      if (MODE == 3) {
        side = pick0 ? 0 : 1;
        vote = pick0 ? 0 : 1;
      }
      ph = pairs[pick0 ? 0 : 1][kPhase + tid];  // the chosen tail
    }
    const int64_t* block =
        reinterpret_cast<const int64_t*>(buf + (side ? lo.blk[1] : lo.blk[0]))
        + cand * p.S;
    if (tid < p.S) p.out_block[q * p.S + tid] = block[tid];
    p.out_phase[q * kPhase + tid] = ph;
    if (tid == 0) p.out_vote[q] = vote;
    prev_code = block[t % p.n_steps == p.n_steps - 1 ? p.seed_off : p.S - 1];
    __syncthreads();  // every read of this step's buffer, pairs and carry
    prev_phase[tid] = ph;
  }
}

template <int MODE, bool GRID>
int launch(const Params& p, int C, cudaStream_t stream) {
  const Layout lo = make_layout(MODE, GRID, p.P, p.S);
  const int smem = 2 * lo.bytes;
  auto kernel = fusion_scan_kernel<MODE, GRID>;
  // The shared-memory limit follows P and S, so it is set at every launch
  // (one runtime call; an attribute is per device as well).
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<C, kThreads, smem, stream>>>(p, lo);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches the scan of C lanes of L steps on `stream` and returns
// cudaGetLastError() (0 on success), the error of raising the kernel's
// shared-memory limit, or -1 for a mode / source pair with no
// instantiation. Side b's pointers are read in modes 1 and 3 only, ht_* when
// grid is 1, phase / amp and idx1_* when it is 0.
extern "C" int qpg_fusion_scan_cuda(
    int mode, int grid, int C, int L, int P, int S, int n_steps, int seed_off,
    int T, const int64_t* sel_a, const int64_t* sel_b,
    const int64_t* block_a, const int64_t* block_b, const float* ht_a,
    const int64_t* idx0_a, const int64_t* idx1_a, const float* ht_b,
    const int64_t* idx0_b, const int64_t* idx1_b, const float* phase,
    const float* amp, const int32_t* mask, const int32_t* rand,
    const int64_t* reset_code, const float* reset_phase, int64_t* out_block,
    float* out_phase, int32_t* out_vote, void* stream) {
  Params p;
  p.side[0] = Side{sel_a, block_a, ht_a, idx0_a, idx1_a};
  p.side[1] = Side{sel_b, block_b, ht_b, idx0_b, idx1_b};
  p.phase = phase;
  p.amp = amp;
  p.mask = mask;
  p.rand = rand;
  p.reset_code = reset_code;
  p.reset_phase = reset_phase;
  p.out_block = out_block;
  p.out_phase = out_phase;
  p.out_vote = out_vote;
  p.T = T;
  p.L = L;
  p.P = P;
  p.S = S;
  p.n_steps = n_steps;
  p.seed_off = seed_off;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode * 2 + (grid ? 1 : 0)) {
    case 0: return launch<0, false>(p, C, s);
    case 2: return launch<1, false>(p, C, s);
    case 4: return launch<2, false>(p, C, s);
    case 5: return launch<2, true>(p, C, s);
    case 6: return launch<3, false>(p, C, s);
    case 7: return launch<3, true>(p, C, s);
    default: return -1;
  }
}
