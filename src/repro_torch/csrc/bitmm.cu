// PBME packed bit-matrix products for Hopper (sm_90a), on the tensor cores.
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
// What bounds it.  On a dense A it is a matrix product of 2 * nnz(A) * N
// operations.  The kernel runs them as single-bit MMA, whose rate NVIDIA does
// not publish; tools/mma_rates.py measured 5.2e15 bit multiply-accumulates a
// second on the H100 (1.04e16 operations, 5.3x the 1,979 TOP/s int8 peak).
// At that rate they lie far above the bytes (three or five [n, n/32] word
// arrays at 3.35 TB/s), so a dense A is bound by operations.  On a frontier
// as sparse as the arc itself almost no work is left and it is bound by the
// bytes.
//
// How the design answers each:
//   * Operations: the product runs on the tensor cores as single-bit MMA,
//     mma.sync.m16n8k256.row.col.s32.b1.b1.s32.and.popc, straight on the packed
//     words: C_count[i, n] = sum over k-words of popc(A[i, q] & Bt[n, q]),
//     thresholded at > 0.  Measured on the H100 (tools/mma_rates.py), b1
//     mma.sync does 8x the bit multiply-accumulates of int8 mma.sync and 5x
//     those of int8 wgmma, and needs no unpacking; wgmma has no b1 form on
//     sm_90a.  Both MMA operands must be K-major, so each call first transposes
//     B's words once on the card (bt[n, q] holds bits k = 32q..32q+31 of column
//     n, zero for k >= K and up to kwp, a multiple of the stage depth).  Because
//     bt is zero past K, A's bits at k >= K multiply by zero and A needs no mask.
//   * Block tile: 128 rows x 256 columns (8 output words), 8 warps of 64 x 64;
//     K in stages of 1024 bits (32 words), three stages in flight with cp.async
//     (16-byte loads of bt, 4-byte loads of A, whose rows need not be aligned);
//     operands reach the MMA through ldmatrix from rows padded by 16 bytes, so
//     the eight rows of each 8x8 matrix hit distinct banks.  Measured at
//     n = 10000 (tools/bitmm_variants.py), the product kernel takes about
//     0.63 ms on dense A, a third of the b1 rate: 128 x 128 tiles at two
//     blocks per SM, 16 warps a block, 512-bit stages and four stages in
//     flight are all as fast or slower.
//   * Bytes, the sparse frontier: a plan pass counts the set bits of A in every
//     (128-row block, 1024-bit stage) tile, shared by all column blocks of
//     that row block.  An empty stage is skipped; a stage with fewer set bits
//     than WALK_BELOW (512) is listed bit by bit, and its rows of B
//     (8 words, one 32-byte sector each) are ORed into the block's packed
//     words; only the other stages load bt and run the MMA.  The decision is
//     uniform per block and needs no host sync.  Row blocks with no MMA stage
//     are left to a second, light kernel: the MMA kernel's registers and
//     shared memory allow one block per SM, too few to hide the latency of
//     the walk's scattered loads.
//   * Epilogue in registers: each thread thresholds its accumulators, packs
//     its 2 columns of each n8 tile into word bits, and the 4 lanes of a row
//     OR their parts with __shfl_xor; the packed tile is ORed with the walked
//     words in shared memory and written once (fused: M read, delta and M'
//     written, C never stored).  Ragged row and word edges are masked; no
//     operand is padded in memory.
//   * All bit work is on uint32_t (logical shifts: bit 31 is a real column).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

// Tile constants and the walk threshold.  Each can be set at build time with
// -DBITMM_<NAME>=<value>: tools/bitmm_variants.py builds and times other tiles
// and thresholds that way.
#ifndef BITMM_WNT
#define BITMM_WNT 8
#endif
#ifndef BITMM_THREADS
#define BITMM_THREADS 256
#endif
#ifndef BITMM_BKW
#define BITMM_BKW 32
#endif
#ifndef BITMM_NST
#define BITMM_NST 3
#endif
#ifndef BITMM_U
#define BITMM_U 8
#endif
#ifndef BITMM_WALK_BELOW
#define BITMM_WALK_BELOW 512
#endif

constexpr int WNT = BITMM_WNT;         // n8 tiles per warp: warp tile 64 x 8 WNT
constexpr int BN = 32 * WNT;           // columns per block (4 warps across)
constexpr int BNW = BN / 32;           // output words per block
constexpr int THREADS = BITMM_THREADS; // 2 x 4 warps, each 64 rows x 8 WNT columns
constexpr int BM = 64 * (THREADS / 128);  // rows per block
// MMA blocks per SM the registers allow (about 32 WNT registers a thread)
constexpr int MMA_BLOCKS = 65536 / (THREADS * 32 * WNT);
constexpr int BKW = BITMM_BKW;         // K words per stage (1024 bits)
constexpr int LDS = BKW + 4;           // shared row stride in words: 8 rows, 8 bank groups
constexpr int NST = BITMM_NST;         // stages in flight
// A stage whose BM x 32 BKW tile of A holds fewer set bits than this is walked
// (0: every nonempty stage runs the MMA); set from a sweep on the H100.
constexpr int WALK_BELOW = BITMM_WALK_BELOW;
constexpr int WALK_CAP = 8192;         // listed bits per row block
constexpr int U = BITMM_U;             // walked rows of B in flight per thread
constexpr int A_WORDS = BM * LDS, B_WORDS = BN * LDS;
constexpr int SMEM_BYTES = (NST * (A_WORDS + B_WORDS) + BM * BNW) * 4;

enum Plan : int { kSkip = 0, kWalk = 1, kMma = 2 };

struct Work {                          // carved from the caller's workspace
  uint32_t* bt;                        // [32 * nw, kwp]
  int* plan;                           // [row blocks, stages]
  int* walk_n;                         // [row blocks]
  uint2* walk;                         // [row blocks, WALK_CAP] (row in block, k)
};

__host__ __device__ inline int kwp_of(int kw) { return (kw + BKW - 1) / BKW * BKW; }
__host__ __device__ inline int row_blocks(int rows) { return (rows + BM - 1) / BM; }

// Lay the workspace out from `base` (transposed B, stage plan, walk counts,
// walk lists) into `w`; returns its bytes.  With base = nullptr it only sizes.
size_t carve(char* base, int rows, int kw, int nw, Work* w) {
  const size_t stages = kwp_of(kw) / BKW, rb = row_blocks(rows);
  const auto up8 = [](size_t n) { return (n + 7) / 8 * 8; };
  const size_t bt = 0, plan = bt + size_t(32) * nw * kwp_of(kw) * 4;
  const size_t walk_n = plan + up8(rb * stages * 4), walk = walk_n + up8(rb * 4);
  if (base != nullptr) {
    w->bt = reinterpret_cast<uint32_t*>(base + bt);
    w->plan = reinterpret_cast<int*>(base + plan);
    w->walk_n = reinterpret_cast<int*>(base + walk_n);
    w->walk = reinterpret_cast<uint2*>(base + walk);
  }
  return walk + rb * WALK_CAP * 8;
}

__device__ inline uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ inline void cp_async16(uint32_t dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(ok ? 16 : 0));
}

__device__ inline void cp_async4(uint32_t dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(ok ? 4 : 0));
}

__device__ inline void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ inline void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ inline void ldmatrix_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ inline void mma_b1(int (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// bt[n, q] = bits k = 32q .. 32q+31 of column n of B (zero for k >= K).  A block
// transposes 8 K-words x 8 B words: each warp one K-word, 32x32 bits at a time
// by ballots, staged in shared memory so that each bt row gets 32 contiguous
// bytes.
__global__ void __launch_bounds__(256)
transpose_kernel(const uint32_t* __restrict__ b, uint32_t* __restrict__ bt, int k, int nw,
                 int kwp) {
  __shared__ uint32_t t_s[256][9];
  const int lane = threadIdx.x & 31, qi = threadIdx.x >> 5;
  const int q0 = blockIdx.x * 8, w0 = blockIdx.y * 8;
  const int kr = 32 * (q0 + qi) + lane;
  uint32_t xs[8];
#pragma unroll
  for (int wi = 0; wi < 8; ++wi) {
    const int w = w0 + wi;
    xs[wi] = (kr < k && w < nw) ? __ldg(b + static_cast<size_t>(kr) * nw + w) : 0u;
  }
#pragma unroll
  for (int wi = 0; wi < 8; ++wi) {
    const uint32_t x = xs[wi];
    uint32_t mine = 0u;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const uint32_t v = __ballot_sync(0xffffffffu, (x >> j) & 1u);
      if (lane == j) mine = v;
    }
    t_s[wi * 32 + lane][qi] = mine;
  }
  __syncthreads();
  const int n = 32 * w0 + threadIdx.x;
  if (n < 32 * nw) {
    const uint32_t* s = t_s[threadIdx.x];
    uint4* dst = reinterpret_cast<uint4*>(bt + static_cast<size_t>(n) * kwp + q0);
    dst[0] = make_uint4(s[0], s[1], s[2], s[3]);
    dst[1] = make_uint4(s[4], s[5], s[6], s[7]);
  }
}

// One block per (row block, stage): count A's set bits below K in the tile and
// decide the stage's plan.  A walked stage reserves room in its row block's
// list and writes one (row in block, k) entry per set bit; if the list is
// full the stage runs on the MMA instead.
__global__ void __launch_bounds__(THREADS)
plan_kernel(const uint32_t* __restrict__ a, Work ws, int rows, int kw, int k, int stages) {
  __shared__ int total, mode, base, slot;
  const int rb = blockIdx.x / stages, s = blockIdx.x % stages;
  const int r = threadIdx.x >> 1, i = rb * BM + r;
  const int q0 = s * BKW + (threadIdx.x & 1) * (BKW / 2);
  uint32_t v[BKW / 2];
  int bits = 0;
#pragma unroll
  for (int j = 0; j < BKW / 2; ++j) {
    const int q = q0 + j;
    uint32_t x = 0u;
    if (i < rows && q < kw) {
      x = __ldg(a + static_cast<size_t>(i) * kw + q);
      const int valid = k - q * 32;
      if (valid < 32) x &= (1u << valid) - 1u;  // valid >= 1: q < kw
    }
    v[j] = x;
    bits += __popc(x);
  }
  if (threadIdx.x == 0) total = 0, slot = 0;
  __syncthreads();
  bits = __reduce_add_sync(0xffffffffu, bits);
  if ((threadIdx.x & 31) == 0) atomicAdd(&total, bits);
  __syncthreads();
  if (threadIdx.x == 0) {
    int m = total == 0 ? kSkip : kMma;
    if (total > 0 && total < WALK_BELOW) {
      int old = atomicAdd(ws.walk_n + rb, 0);
      while (old + total <= WALK_CAP) {
        const int prev = atomicCAS(ws.walk_n + rb, old, old + total);
        if (prev == old) {
          m = kWalk;
          base = old;
          break;
        }
        old = prev;
      }
    }
    mode = m;
    ws.plan[static_cast<size_t>(rb) * stages + s] = m;
  }
  __syncthreads();
  if (mode != kWalk) return;
  uint2* out = ws.walk + static_cast<size_t>(rb) * WALK_CAP + base;
#pragma unroll
  for (int j = 0; j < BKW / 2; ++j) {
    uint32_t x = v[j];
    while (x) {
      const int bit = __ffs(x) - 1;
      x &= x - 1u;
      out[atomicAdd(&slot, 1)] = make_uint2(r, 32 * (q0 + j) + bit);
    }
  }
}

// OR the row block's walked rows of B into the packed tile out_s, then write
// it: BNW neighbouring threads cover one row of the tile; the fused variant reads
// M and writes delta and M'.
template <bool kFused>
__device__ void finish_tile(uint32_t (*out_s)[BNW], const uint32_t* __restrict__ b,
                            const uint32_t* __restrict__ m, uint32_t* __restrict__ out0,
                            uint32_t* __restrict__ out1, const Work& ws, int rows, int nw) {
  const int t = threadIdx.x, rb = blockIdx.x, row0 = rb * BM, w0 = blockIdx.y * BNW;
  {  // the walk
    const int n_walk = min(ws.walk_n[rb], WALK_CAP);
    const uint2* list = ws.walk + static_cast<size_t>(rb) * WALK_CAP;
    const int wl = t % BNW, w = w0 + wl;
    const bool live = w < nw;
    for (int e0 = t / BNW; e0 < n_walk; e0 += (THREADS / BNW) * U) {
      uint2 en[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int e = e0 + u * (THREADS / BNW);
        en[u] = e < n_walk ? list[e] : make_uint2(0u, 0xffffffffu);
      }
      uint32_t v[U];
#pragma unroll
      for (int u = 0; u < U; ++u)
        v[u] = (live && en[u].y != 0xffffffffu)
                   ? __ldg(b + static_cast<size_t>(en[u].y) * nw + w) : 0u;
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (v[u]) atomicOr(&out_s[en[u].x][wl], v[u]);
    }
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < BM * BNW / THREADS; ++j) {
    const int idx = t + j * THREADS, r = idx / BNW, wl = idx % BNW;
    const int i = row0 + r, w = w0 + wl;
    if (i >= rows || w >= nw) continue;
    const size_t o = static_cast<size_t>(i) * nw + w;
    const uint32_t c = out_s[r][wl];
    if (kFused) {
      const uint32_t mm = m[o];
      const uint32_t d = c & ~mm;
      out0[o] = d;
      out1[o] = mm | d;
    } else {
      out0[o] = c;
    }
  }
}

__device__ inline bool has_mma(const int* plan, int stages) {
  for (int s = 0; s < stages; ++s)
    if (plan[s] == kMma) return true;
  return false;
}

// Row blocks with no MMA stage: a light kernel (BM x BNW words of shared memory,
// few registers) so that many blocks per SM hide the latency of the walk's loads.
template <bool kFused>
__global__ void __launch_bounds__(THREADS, 1024 / THREADS)
walk_kernel(const uint32_t* __restrict__ b, const uint32_t* __restrict__ m,
            uint32_t* __restrict__ out0, uint32_t* __restrict__ out1, Work ws, int rows, int nw,
            int stages) {
  __shared__ uint32_t out_s[BM][BNW];
  if (has_mma(ws.plan + static_cast<size_t>(blockIdx.x) * stages, stages)) return;
#pragma unroll
  for (int j = 0; j < BM * BNW / THREADS; ++j) {
    const int idx = threadIdx.x + j * THREADS;
    out_s[idx / BNW][idx % BNW] = 0u;
  }
  __syncthreads();
  finish_tile<kFused>(out_s, b, m, out0, out1, ws, rows, nw);
}

// Row blocks with at least one MMA stage: the tensor-core main loop, then the
// walked stages and the write.
template <bool kFused>
__global__ void __launch_bounds__(THREADS, MMA_BLOCKS)
mma_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
           const uint32_t* __restrict__ m, uint32_t* __restrict__ out0,
           uint32_t* __restrict__ out1, Work ws, int rows, int kw, int nw, int kwp) {
  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t* a_s = smem;                          // [NST][BM][LDS]
  uint32_t* b_s = smem + NST * A_WORDS;          // [NST][BN][LDS]
  uint32_t (*out_s)[BNW] = reinterpret_cast<uint32_t (*)[BNW]>(smem + NST * (A_WORDS + B_WORDS));

  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int wm = warp >> 2, wn = warp & 3;       // warps of 64 x 8 WNT, 4 across
  const int rb = blockIdx.x, row0 = rb * BM, w0 = blockIdx.y * BNW, col0 = blockIdx.y * BN;
  const int stages = kwp / BKW, ncols = 32 * nw;
  const int* plan = ws.plan + static_cast<size_t>(rb) * stages;

  auto next_mma = [&](int s) {
    for (++s; s < stages && plan[s] != kMma; ++s) {
    }
    return s;
  };
  auto load = [&](int buf, int s) {
    const uint32_t a_dst = smem_addr(a_s + buf * A_WORDS);
#pragma unroll
    for (int j = 0; j < BM * BKW / THREADS; ++j) {
      const int idx = t + j * THREADS, r = idx / BKW, q = idx % BKW;
      const int i = row0 + r, qg = s * BKW + q;
      const bool ok = i < rows && qg < kw;
      cp_async4(a_dst + (r * LDS + q) * 4, ok ? a + static_cast<size_t>(i) * kw + qg : a, ok);
    }
    const uint32_t b_dst = smem_addr(b_s + buf * B_WORDS);
#pragma unroll
    for (int j = 0; j < BN * BKW / 4 / THREADS; ++j) {
      const int idx = t + j * THREADS, n = idx / (BKW / 4), ch = idx % (BKW / 4);
      const bool ok = col0 + n < ncols;
      const uint32_t* src = ws.bt + static_cast<size_t>(ok ? col0 + n : 0) * kwp + s * BKW + ch * 4;
      cp_async16(b_dst + (n * LDS + ch * 4) * 4, src, ok);
    }
  };

  int acc[4][WNT][4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < WNT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0;

  // -- MMA stages, NST - 1 loads ahead --------------------------------------
  const int first = next_mma(-1);
  if (first >= stages) return;                   // walk_kernel's row block
  int fetch = first;
#pragma unroll
  for (int p = 0; p < NST - 1; ++p) {
    if (fetch < stages) {
      load(p, fetch);
      fetch = next_mma(fetch);
    }
    cp_async_commit();
  }
  int rd = 0;
  for (int s = first; s < stages; s = next_mma(s)) {
    cp_async_wait<NST - 2>();
    __syncthreads();
    if (fetch < stages) {
      load((rd + NST - 1) % NST, fetch);
      fetch = next_mma(fetch);
    }
    cp_async_commit();
    const uint32_t a_base = smem_addr(a_s + rd * A_WORDS);
    const uint32_t b_base = smem_addr(b_s + rd * B_WORDS);
#pragma unroll
    for (int ks = 0; ks < BKW / 8; ++ks) {
      uint32_t af[4][4];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        const int r = wm * 64 + mt * 16 + (lane & 15);
        ldmatrix_x4(a_base + (r * LDS + ks * 8 + (lane >> 4) * 4) * 4, af[mt]);
      }
#pragma unroll
      for (int np = 0; np < WNT / 2; ++np) {
        uint32_t bf[4];
        const int n = wn * 8 * WNT + np * 16 + ((lane >> 4) << 3) + (lane & 7);
        ldmatrix_x4(b_base + (n * LDS + ks * 8 + ((lane >> 3) & 1) * 4) * 4, bf);
#pragma unroll
        for (int mt = 0; mt < 4; ++mt) {
          mma_b1(acc[mt][2 * np], af[mt], bf[0], bf[1]);
          mma_b1(acc[mt][2 * np + 1], af[mt], bf[2], bf[3]);
        }
      }
    }
    rd = (rd + 1) % NST;
  }
  cp_async_wait<0>();

  // -- threshold and pack: lane (gid, tid) holds columns 2 tid, 2 tid + 1 of
  //    each n8 tile in rows gid and gid + 8 -------------------------------
  const int gid = lane >> 2, tid = lane & 3;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int wi = 0; wi < WNT / 4; ++wi) {
        uint32_t p = 0u;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int* c = acc[mt][wi * 4 + j];
          p |= static_cast<uint32_t>(c[2 * h] > 0) << (j * 8 + tid * 2);
          p |= static_cast<uint32_t>(c[2 * h + 1] > 0) << (j * 8 + tid * 2 + 1);
        }
        p |= __shfl_xor_sync(0xffffffffu, p, 1);
        p |= __shfl_xor_sync(0xffffffffu, p, 2);
        if (tid == 0) out_s[wm * 64 + mt * 16 + h * 8 + gid][wn * (WNT / 4) + wi] = p;
      }
  __syncthreads();
  finish_tile<kFused>(out_s, b, m, out0, out1, ws, rows, nw);
}

// Transpose B, plan the stages, run the product; all on `stream`.  The shared
// memory attribute is set on every call: it holds for the current device only.
template <bool kFused>
int run(const void* a, const void* b, const void* m, void* out0, void* out1, void* ws_ptr,
        int rows, int kw, int k, int nw, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(mma_kernel<kFused>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  Work ws;
  carve(static_cast<char*>(ws_ptr), rows, kw, nw, &ws);
  const int kwp = kwp_of(kw), stages = kwp / BKW, rb = row_blocks(rows);
  const auto* a32 = static_cast<const uint32_t*>(a);
  const auto* b32 = static_cast<const uint32_t*>(b);
  err = cudaMemsetAsync(ws.walk_n, 0, sizeof(int) * rb, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (stages > 0) {
    transpose_kernel<<<dim3(kwp / 8, (nw + 7) / 8), 256, 0, stream>>>(b32, ws.bt, k, nw, kwp);
    plan_kernel<<<rb * stages, THREADS, 0, stream>>>(a32, ws, rows, kw, k, stages);
  }
  const dim3 grid(rb, (nw + BNW - 1) / BNW);
  const auto* m32 = static_cast<const uint32_t*>(m);
  auto* o0 = static_cast<uint32_t*>(out0);
  auto* o1 = static_cast<uint32_t*>(out1);
  mma_kernel<kFused><<<grid, THREADS, SMEM_BYTES, stream>>>(a32, b32, m32, o0, o1, ws, rows, kw,
                                                            nw, kwp);
  walk_kernel<kFused><<<grid, THREADS, 0, stream>>>(b32, m32, o0, o1, ws, rows, nw, stages);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Bytes of scratch one call needs (transposed B, stage plan, walk lists).
extern "C" long long bitmm_workspace_bytes(int rows, int kw, int nw) {
  return static_cast<long long>(carve(nullptr, rows, kw, nw, nullptr));
}

extern "C" int bitmm_launch(const void* a, const void* b, void* c, void* ws, int rows, int kw,
                            int k, int nw, void* stream) {
  return run<false>(a, b, nullptr, c, nullptr, ws, rows, kw, k, nw,
                    static_cast<cudaStream_t>(stream));
}

extern "C" int bitmm_fused_delta_launch(const void* a, const void* b, const void* m,
                                        void* delta, void* m_out, void* ws, int rows, int kw,
                                        int k, int nw, void* stream) {
  return run<true>(a, b, m, delta, m_out, ws, rows, kw, k, nw,
                   static_cast<cudaStream_t>(stream));
}
