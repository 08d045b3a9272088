// All-pairs edit distance between fixed-length code strings, for Hopper.
//
// Replaces the TPU kernel qpgesture_tpu/ops/pallas_kernels.py ::
// levenshtein_matrix_pallas (body _lev_kernel): out[q, n] is the edit
// distance between query string a[q] and database string b[n], each L int32
// symbols (L = 11 combined wavvq symbols g0*320+g1 on the matching path).
//
// What bounds it on an H100: integer operations. Every pair runs the full
// L x L DP, at least 4 int32 operations per cell (the symbol compare,
// min(up, left), diag + cost and a fused add-min, which Hopper's DPX
// instructions provide), so Q=48 x N=26,624 pairs is ~0.62 G operations
// against ~5 MB of output: over 100 operations per byte moved, far above
// the card's balance point for 32-bit ALU work (128 operations per SM per
// clock at ~2 GHz over 3.35 TB/s: ~10 operations per byte).
//
// What the design does about it: nothing of the DP leaves registers. Each
// thread owns one database string (its L symbols in registers, L a template
// parameter so every loop unrolls and the DP row lives in registers), a
// block stages a chunk of queries in shared memory (read as broadcasts: all
// threads of a warp read the same symbol), and each thread runs the DP row
// for each staged query and writes out[q*N + n] — neighbouring threads write
// neighbouring addresses. The grid covers N in blocks of kThreads strings
// and query chunks along y, so Q=48 at N=26,624 gives 208 x 6 blocks for
// the 132 SMs. The kernel masks the ragged N edge itself.
//
// Packed 16-bit min operations or a bit-parallel (Myers/Hyyro) DP would
// cut the operation count; they are not done here.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;         // database strings per block
constexpr int kQueriesPerBlock = 8;   // queries staged per block

template <int L>
__global__ void __launch_bounds__(kThreads)
lev_kernel(const int32_t* __restrict__ a, const int32_t* __restrict__ b,
           int32_t* __restrict__ out, int Q, int N) {
  __shared__ int32_t sq[kQueriesPerBlock * L];
  const int q0 = blockIdx.y * kQueriesPerBlock;
  const int nq = min(kQueriesPerBlock, Q - q0);
  for (int t = threadIdx.x; t < nq * L; t += blockDim.x) {
    sq[t] = a[static_cast<int64_t>(q0) * L + t];
  }
  __syncthreads();

  const int64_t n = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (n >= N) return;

  int32_t s[L];
#pragma unroll
  for (int j = 0; j < L; ++j) s[j] = b[n * L + j];

  for (int q = 0; q < nq; ++q) {
    int32_t row[L + 1];
#pragma unroll
    for (int j = 0; j <= L; ++j) row[j] = j;
#pragma unroll
    for (int i = 1; i <= L; ++i) {
      const int32_t ai = sq[q * L + i - 1];
      int32_t diag = row[0];
      row[0] = i;
#pragma unroll
      for (int j = 1; j <= L; ++j) {
        const int32_t up = row[j];
        const int32_t cost = (s[j - 1] != ai) ? 1 : 0;
        row[j] = min(min(up + 1, row[j - 1] + 1), diag + cost);
        diag = up;
      }
    }
    out[static_cast<int64_t>(q0 + q) * N + n] = row[L];
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success), or -1
// for a string length that has no instantiation.
extern "C" int qpg_levenshtein_matrix_cuda(const int32_t* a,
                                           const int32_t* b, int32_t* out,
                                           int Q, int N, int L,
                                           void* stream) {
  const dim3 block(kThreads);
  const dim3 grid((N + kThreads - 1) / kThreads,
                  (Q + kQueriesPerBlock - 1) / kQueriesPerBlock);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (L) {
    case 11:
      lev_kernel<11><<<grid, block, 0, s>>>(a, b, out, Q, N);
      break;
    default:
      return -1;
  }
  return static_cast<int>(cudaGetLastError());
}
