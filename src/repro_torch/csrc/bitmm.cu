// PBME packed bit-matrix products for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels in src/repro/kernels/bitmm.py:
//   bitmm_launch             <- bitmm_call            (body _bitmm_kernel)
//   bitmm_fused_delta_launch <- bitmm_fused_delta_call (body _bitmm_fused_kernel)
//
// C[i, w] = OR over k < K of (bit k of A[i, :] set ? B[k, w] : 0), on words
// where bit j of word w is column 32w + j.  A is [rows, kw] with
// kw = ceil(K / 32); B is [K, nw]; C is [rows, nw].  The fused variant never
// stores C: its epilogue writes delta = C & ~M and M' = M | delta.
//
// What bounds it: counted as a matrix product, 2 * nnz(A) * N operations
// against the 1,979 TOP/s int8 tensor-core peak, which for a dense A lies
// far above its bytes (three or five [n, n/32] word arrays at 3.35 TB/s);
// a frontier as sparse as the arc itself is bound by the bytes instead.
// This kernel does not use tensor cores: it runs on the integer ALUs, one
// AND/OR select per (row, set bit of A, output word), so its ceiling is the
// SMs' integer issue rate.
//
// Design:
//   * a block owns TR rows and TW consecutive output words; one thread per
//     output word column keeps TR accumulators in registers, so each B word it
//     loads (coalesced: neighbouring threads read neighbouring words of one B
//     row) serves TR rows;
//   * the block stages its rows' A words in shared memory, KC words at a time;
//   * for each A word column, the block walks only the set bits of the OR of
//     its TR words.  That test is uniform across the block, so there is no
//     divergence, and sparse frontiers (PBME deltas) skip most of B;
//   * A's bits at k >= K are masked off when staged, so B is never read past
//     row K - 1; the ragged word and row edges are masked, so no padding;
//   * all bit work is on uint32_t (logical shifts: bit 31 is a real column).
// Tensor cores (int8 wgmma on unpacked tiles, or b1 mma.sync with AND+POPC)
// and TMA staging are later work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int TW = 128;  // output words per block = threads per block
constexpr int TR = 8;    // output rows per block
constexpr int KC = 64;   // A words per row staged per shared-memory chunk

template <bool kFused>
__global__ void __launch_bounds__(TW)
bitmm_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
             const uint32_t* __restrict__ m, uint32_t* __restrict__ out0,
             uint32_t* __restrict__ out1, int rows, int kw, int k, int nw) {
  __shared__ uint32_t a_s[TR][KC];
  const int row0 = blockIdx.x * TR;
  const int w = blockIdx.y * TW + threadIdx.x;
  const bool live = w < nw;

  uint32_t acc[TR];
#pragma unroll
  for (int r = 0; r < TR; ++r) acc[r] = 0u;

  for (int q0 = 0; q0 < kw; q0 += KC) {
    for (int idx = threadIdx.x; idx < TR * KC; idx += TW) {
      const int r = idx / KC, q = q0 + idx % KC;
      const int i = row0 + r;
      uint32_t v = 0u;
      if (i < rows && q < kw) {
        v = a[static_cast<size_t>(i) * kw + q];
        const int valid = k - q * 32;  // bits of this word that name rows of B
        if (valid < 32) v = valid <= 0 ? 0u : (v & ((1u << valid) - 1u));
      }
      a_s[r][idx % KC] = v;
    }
    __syncthreads();

    const int qn = min(KC, kw - q0);
    for (int q = 0; q < qn; ++q) {
      uint32_t aw[TR];
      uint32_t any = 0u;
#pragma unroll
      for (int r = 0; r < TR; ++r) {
        aw[r] = a_s[r][q];
        any |= aw[r];
      }
      const uint32_t* bq = b + static_cast<size_t>(q0 + q) * 32 * nw + w;
      while (any) {
        const int j = __ffs(any) - 1;
        any &= any - 1u;
        const uint32_t bv = live ? __ldg(bq + static_cast<size_t>(j) * nw) : 0u;
#pragma unroll
        for (int r = 0; r < TR; ++r) acc[r] |= bv & (0u - ((aw[r] >> j) & 1u));
      }
    }
    __syncthreads();
  }

  if (!live) return;
#pragma unroll
  for (int r = 0; r < TR; ++r) {
    const int i = row0 + r;
    if (i >= rows) break;
    const size_t o = static_cast<size_t>(i) * nw + w;
    if (kFused) {
      const uint32_t mm = m[o];
      const uint32_t d = acc[r] & ~mm;
      out0[o] = d;
      out1[o] = mm | d;
    } else {
      out0[o] = acc[r];
    }
  }
}

dim3 grid_for(int rows, int nw) {
  return dim3((rows + TR - 1) / TR, (nw + TW - 1) / TW);
}

}  // namespace

extern "C" int bitmm_launch(const void* a, const void* b, void* c, int rows, int kw,
                            int k, int nw, void* stream) {
  bitmm_kernel<false><<<grid_for(rows, nw), TW, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(a), static_cast<const uint32_t*>(b), nullptr,
      static_cast<uint32_t*>(c), nullptr, rows, kw, k, nw);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int bitmm_fused_delta_launch(const void* a, const void* b, const void* m,
                                        void* delta, void* m_out, int rows, int kw, int k,
                                        int nw, void* stream) {
  bitmm_kernel<true><<<grid_for(rows, nw), TW, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(a), static_cast<const uint32_t*>(b),
      static_cast<const uint32_t*>(m), static_cast<uint32_t*>(delta),
      static_cast<uint32_t*>(m_out), rows, kw, k, nw);
  return static_cast<int>(cudaGetLastError());
}
