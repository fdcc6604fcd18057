// Gather-sum (ELL SpMM / embedding bag) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel in src/repro/kernels/gather_sum.py:
//   gather_sum_launch <- gather_sum_call (body _gather_sum_kernel)
//
// out[b, :] = sum over k < K with idx[b, k] >= 0 of x[idx[b, k], :].
// idx is int32[B, K] (a negative id is a padding slot), x is [N, D] in float32
// or bfloat16, out is [B, D] in x's type.  A bag that holds an id >= N comes
// out NaN in every column, as jnp.take's fill mode gives for the reference's
// embedding_bag; no row past N - 1 is ever read.  Each bag is summed in
// float32 in k order and rounded to x's type once.
//
// What bounds it: device memory, on more bytes than the bound counts.  The
// bound counts each distinct row once (D * elsize bytes), the ids and the
// output; the adds (B * K * D) are far below the card's float32 rate.
//   * A table with uniform ids (the two-tower user table: 5e6 rows, 25 % of
//     slots padded) repeats almost no row within L2's reach: every lookup is
//     a random 1 KB read from HBM, and the kernel has to keep enough of them
//     in flight.
//   * A Zipf table (the item table: ids drawn from Zipf(1), id = rank)
//     repeats most rows: 2,097,152 lookups of one field touch 434,157 rows.
//     The head is cheap: its repeats hit L1 or L2 (spreading the 256 most
//     drawn rows over 64 copies each makes every version slower, so their
//     L2 slices do not set the pace).  The middle of the tail is not: a row
//     read a few hundred times per batch is read again only after more than
//     an L2's worth (50 MB) of other rows went by, so it comes from HBM each
//     time.  An LRU model of the L2 over the batch's lookups reads 730k-835k
//     rows from HBM where the bound counts 434k.  Only lookups sorted by row
//     would read each row once; a kernel that sums each bag in k order in one
//     pass reads what misses L2.
//
// Design:
//   * a block takes a tile of T bags (at most TILE_BAGS, at most TILE_IDS ids,
//     and few enough that a small batch still gives every SM two tiles), so
//     that a caller hands all of its bags over one table to one launch;
//   * it stages the tile's T * K ids in shared memory once, then counts them
//     in a shared-memory hash table (open addressing, atomicCAS);
//   * a row that occurs twice or more in the tile gets a slot of the stage
//     (at most STAGE_ROWS rows; the rest stay direct) and is copied there once
//     by a TMA bulk copy (cp.async.bulk completing on an mbarrier), or by
//     plain loads where rows are not 16-byte vectors; every bag that holds it
//     sums it from shared memory, so the head costs one L2 read per tile;
//   * the stage reuses the hash table's bytes and stays small (37 KB a block
//     at T = 128): shared memory comes out of the SM's L1, which serves the
//     head's repeats across tiles, and a larger stage was slower;
//   * a row that occurs once is loaded straight into registers: one warp per
//     bag, lanes across D with 16-byte loads (4 floats or 8 bf16) when D and
//     both base pointers allow it, KU rows in flight, as the uniform table
//     needs; registers are capped for 3 blocks an SM (float32), as many warps
//     as the one-warp-per-bag kernel this replaces kept in flight;
//   * where STAGE_ROWS whole rows outgrow STAGE_BYTES the stage holds a slice
//     of columns, and the tile is summed slice by slice;
//   * warps claim the tile's bags one at a time (a shared counter), so that
//     no warp idles at the tile's end behind one that drew slow rows;
//   * a warp waits for the stage only when its bag reaches a staged row, so
//     direct loads overlap the copies;
//   * row offsets idx * D in int64 (a 5M x 256 table has 1.28e9 elements).
// The constants below are build-time (-D) so that tools/gather_sum_variants.py
// can time other tiles and stages.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#ifndef GS_TILE_BAGS
#define GS_TILE_BAGS 128          // bags per tile at most
#endif
#ifndef GS_TILE_IDS
#define GS_TILE_IDS 1024          // ids per tile at most (a longer bag takes a tile alone)
#endif
#ifndef GS_STAGE_ROWS
#define GS_STAGE_ROWS 32          // repeated rows staged per tile at most
#endif
#ifndef GS_STAGE_BYTES
#define GS_STAGE_BYTES (32 * 1024)  // stage size; wider rows are staged in column slices
#endif
#ifndef GS_WARPS
#define GS_WARPS 8                // warps per block
#endif
#ifndef GS_MIN_BLOCKS
#define GS_MIN_BLOCKS 3           // float32 blocks per SM that __launch_bounds__ asks registers for
#endif
#ifndef GS_U
#define GS_U 2                    // 16-byte vectors per lane per column tile
#endif
#ifndef GS_KU
#define GS_KU 4                   // rows in flight per lane
#endif

namespace {

constexpr int WARPS = GS_WARPS;
constexpr int LANES = 32;
constexpr int THREADS = WARPS * LANES;
constexpr int U = GS_U;
constexpr int KU = GS_KU;
constexpr int MIN_HASH_BITS = 5;
constexpr int64_t MAX_BLOCKS = 1 << 30;  // more tiles than blocks: a grid-stride loop

static_assert(GS_STAGE_BYTES < (1 << 20), "an mbarrier phase counts fewer than 2^20 bytes");

// Elements travel as raw bits: float32 as uint32_t, bfloat16 as uint16_t.
template <typename Bits> struct Elem;

template <> struct Elem<uint32_t> {
  static __device__ __forceinline__ float to_float(uint32_t b) { return __uint_as_float(b); }
  static __device__ __forceinline__ uint32_t from_float(float f) { return __float_as_uint(f); }
};

template <> struct Elem<uint16_t> {
  static __device__ __forceinline__ float to_float(uint16_t b) {
    return __uint_as_float(static_cast<uint32_t>(b) << 16);
  }
  static __device__ __forceinline__ uint16_t from_float(float f) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(f));
  }
};

template <typename Bits, int VEC>
struct alignas(sizeof(Bits) * VEC) Pack {
  Bits v[VEC];
};

// One launch's tile plan and shared-memory layout (byte offsets).  The hash
// table lives only until the staged ids are rewritten, so the stage reuses
// its bytes: the less shared memory a block takes, the more L1 the SM keeps
// for the rows it reads direct.
struct Layout {
  int tile;       // bags per tile
  int hash_bits;  // log2 of the hash table's slots
  int srows;      // stage rows
  int slice;      // columns per stage slice
  int off_ids, off_srow, off_keys, off_vals, off_stage;
  int smem;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t slot_of(int32_t id, int bits) {
  return (static_cast<uint32_t>(id) * 0x9E3779B1u) >> (32 - bits);
}

__device__ __forceinline__ void wait_phase(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  }
}

// Registers for GS_MIN_BLOCKS blocks an SM (80 a thread at 3: float32 fits
// without spilling); bfloat16's 8-wide vectors need more, so 2.
template <typename Bits, int VEC>
__global__ void __launch_bounds__(THREADS, VEC == 8 ? 2 : GS_MIN_BLOCKS)
gather_sum_kernel(const int32_t* __restrict__ idx, const Bits* __restrict__ x,
                  Bits* __restrict__ out, int64_t bags, int k, int64_t n, int d, Layout L) {
  using P = Pack<Bits, VEC>;
  using E = Elem<Bits>;
  constexpr bool kBulk = VEC > 1;  // 16-byte rows: TMA bulk copies into the stage
  extern __shared__ __align__(128) unsigned char smem[];
  int* n_staged = reinterpret_cast<int*>(smem + 8);
  int* next_bag = reinterpret_cast<int*>(smem + 12);
  int32_t* ids = reinterpret_cast<int32_t*>(smem + L.off_ids);
  int32_t* keys = reinterpret_cast<int32_t*>(smem + L.off_keys);
  int32_t* vals = reinterpret_cast<int32_t*>(smem + L.off_vals);
  int32_t* srow = reinterpret_cast<int32_t*>(smem + L.off_srow);
  Bits* stage = reinterpret_cast<Bits*>(smem + L.off_stage);
  const uint32_t bar = smem_u32(smem);
  const int tid = threadIdx.x, warp = tid / LANES, lane = tid % LANES;
  const int slots = 1 << L.hash_bits;

  if (kBulk && tid == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" :: "r"(bar) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  uint32_t phase = 0;

  const int64_t tiles = (bags + L.tile - 1) / L.tile;
  for (int64_t t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int64_t b0 = t * L.tile;
    const int nb = static_cast<int>(bags - b0 < L.tile ? bags - b0 : L.tile);
    const int nid = nb * k;

    // 1. the tile's ids into shared memory (any negative id becomes -1), an
    //    empty hash table
    const int32_t* src = idx + b0 * k;
    for (int j = tid; j < nid; j += THREADS) {
      const int32_t id = src[j];
      ids[j] = id < 0 ? -1 : id;
    }
    for (int h = tid; h < slots; h += THREADS) {
      keys[h] = -1;
      vals[h] = 0;
    }
    if (tid == 0) *n_staged = *next_bag = 0;
    __syncthreads();

    // 2. count each id of the table (an id >= n is read by no one)
    for (int j = tid; j < nid; j += THREADS) {
      const int32_t id = ids[j];
      if (id < 0 || id >= n) continue;
      uint32_t h = slot_of(id, L.hash_bits);
      for (;;) {
        const int32_t prev = atomicCAS(&keys[h], -1, id);
        if (prev == -1 || prev == id) break;
        h = (h + 1) & (slots - 1);
      }
      atomicAdd(&vals[h], 1);
    }
    __syncthreads();

    // 3. a stage slot for each row that occurs twice or more, while slots last
    for (int h = tid; h < slots; h += THREADS) {
      int s = -1;
      if (vals[h] >= 2) {
        s = atomicAdd(n_staged, 1);
        if (s < L.srows) srow[s] = keys[h];
        else s = -1;
      }
      vals[h] = s;
    }
    __syncthreads();

    // 4. a staged occurrence becomes -2 - slot
    for (int j = tid; j < nid; j += THREADS) {
      const int32_t id = ids[j];
      if (id < 0 || id >= n) continue;
      uint32_t h = slot_of(id, L.hash_bits);
      while (keys[h] != id) h = (h + 1) & (slots - 1);
      if (vals[h] >= 0) ids[j] = -2 - vals[h];
    }
    const int staged = min(*n_staged, L.srows);
    __syncthreads();

    for (int c0 = 0, claimed = 0; c0 < d; c0 += L.slice, claimed += nb + WARPS) {
      const int c1 = min(d, c0 + L.slice), width = c1 - c0;

      // 5. copy the staged rows' columns [c0, c1) into the stage
      if (kBulk) {
        if (warp == 0) {
          const uint32_t bytes = static_cast<uint32_t>(width) * sizeof(Bits);
          if (lane == 0) {
            asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                         :: "r"(bar), "r"(bytes * staged) : "memory");
          }
          __syncwarp();
          // the stage's last generic accesses (the hash table's, or the previous
          // slice's reads) before the async proxy writes it
          asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
          for (int s = lane; s < staged; s += LANES) {
            const Bits* row = x + static_cast<int64_t>(srow[s]) * d + c0;
            asm volatile(
                "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
                " [%0], [%1], %2, [%3];\n"
                :: "r"(smem_u32(stage + s * L.slice)), "l"(row), "r"(bytes), "r"(bar)
                : "memory");
          }
        }
      } else {
        for (int e = tid; e < staged * width; e += THREADS) {
          const int s = e / width, c = e % width;
          stage[s * L.slice + c] = x[static_cast<int64_t>(srow[s]) * d + c0 + c];
        }
        __syncthreads();
      }

      // 6. one warp per bag sums columns [c0, c1) in k order
      bool ready = !kBulk;
      // each slice takes nb + WARPS claims: one per bag, and one past the end a warp
      auto claim = [&]() {
        int v = 0;
        if (lane == 0) v = atomicAdd(next_bag, 1);
        return __shfl_sync(0xffffffffu, v, 0) - claimed;
      };
      for (int bi = claim(); bi < nb; bi = claim()) {
        const int32_t* bid = ids + bi * k;
        bool bad = false;
        for (int j = lane; j < k; j += LANES) bad |= bid[j] >= n;
        bad = __any_sync(0xffffffffu, bad);
        Bits* o = out + (b0 + bi) * d;
        if (bad) {
          const Bits nan = E::from_float(__int_as_float(0x7fc00000));
          for (int c = c0 + lane; c < c1; c += LANES) o[c] = nan;
          continue;
        }
        for (int cc = c0 + lane * VEC; cc < c1; cc += LANES * VEC * U) {
          float acc[U][VEC];
#pragma unroll
          for (int u = 0; u < U; ++u)
#pragma unroll
            for (int i = 0; i < VEC; ++i) acc[u][i] = 0.0f;

          for (int j0 = 0; j0 < k; j0 += KU) {
            int32_t gid[KU];
            bool any_staged = false;
#pragma unroll
            for (int jj = 0; jj < KU; ++jj) {
              gid[jj] = j0 + jj < k ? bid[j0 + jj] : -1;
              any_staged |= gid[jj] <= -2;
            }
            if (!ready && any_staged) {  // warp-uniform: every lane reads the same ids
              wait_phase(bar, phase);
              ready = true;
            }
            P p[KU][U];
            bool ok[KU][U];
#pragma unroll
            for (int jj = 0; jj < KU; ++jj) {
              const int32_t id = gid[jj];
#pragma unroll
              for (int u = 0; u < U; ++u) {
                const int c = cc + u * LANES * VEC;
                ok[jj][u] = id != -1 && c < c1;
                if (ok[jj][u] && id <= -2)
                  p[jj][u] = *reinterpret_cast<const P*>(stage + (-2 - id) * L.slice + (c - c0));
                else if (ok[jj][u])
                  p[jj][u] = *reinterpret_cast<const P*>(x + static_cast<int64_t>(id) * d + c);
              }
            }
#pragma unroll
            for (int jj = 0; jj < KU; ++jj)
#pragma unroll
              for (int u = 0; u < U; ++u)
                if (ok[jj][u]) {
#pragma unroll
                  for (int i = 0; i < VEC; ++i) acc[u][i] += E::to_float(p[jj][u].v[i]);
                }
          }

#pragma unroll
          for (int u = 0; u < U; ++u) {
            const int c = cc + u * LANES * VEC;
            if (c < c1) {
              P s;
#pragma unroll
              for (int i = 0; i < VEC; ++i) s.v[i] = E::from_float(acc[u][i]);
              *reinterpret_cast<P*>(o + c) = s;
            }
          }
        }
      }

      // 7. the copies have landed (a row held only by NaN bags is read by no
      //    bag) before the stage and the tables are written again
      if (kBulk) {
        wait_phase(bar, phase);
        phase ^= 1u;
      }
      __syncthreads();
    }
  }
}

// The tile plan: bags per tile, hash size, stage rows and slice, and the
// shared-memory layout, for `sms` multiprocessors.
Layout plan(int64_t bags, int k, int d, int elsize, int vec, int sms) {
  Layout L{};
  const int64_t spread = (bags + 2 * sms - 1) / (2 * sms);  // two tiles per SM at least
  int64_t tile = GS_TILE_BAGS;
  const int64_t by_ids = GS_TILE_IDS / (k > 0 ? k : 1);
  if (tile > by_ids) tile = by_ids;
  if (tile > spread) tile = spread;
  L.tile = static_cast<int>(tile < 1 ? 1 : tile);
  const int nid = L.tile * k;
  L.hash_bits = MIN_HASH_BITS;
  while ((1 << L.hash_bits) < 2 * nid) ++L.hash_bits;
  L.srows = GS_STAGE_ROWS < nid / 2 ? GS_STAGE_ROWS : nid / 2;
  L.slice = d;
  if (L.srows > 0 && static_cast<int64_t>(L.srows) * d * elsize > GS_STAGE_BYTES) {
    const int step = LANES * vec;
    const int fit = static_cast<int>(GS_STAGE_BYTES / (static_cast<int64_t>(L.srows) * elsize));
    L.slice = fit / step * step;
    if (L.slice < step) L.slice = step;
    if (L.slice > d) L.slice = d;
  }
  int off = 16;  // the mbarrier, the staged-row count and the next bag to claim
  L.off_ids = off;
  off += 4 * nid;
  L.off_srow = off;
  off += 4 * (L.srows > 0 ? L.srows : 1);
  off = (off + 127) / 128 * 128;
  L.off_keys = L.off_stage = off;        // the stage reuses the hash table's bytes
  L.off_vals = L.off_keys + (4 << L.hash_bits);
  const int hash_bytes = 8 << L.hash_bits, stage_bytes = L.srows * L.slice * elsize;
  L.smem = off + (hash_bytes > stage_bytes ? hash_bytes : stage_bytes);
  return L;
}

template <typename Bits, int VEC>
int launch(const void* idx, const void* x, void* out, int64_t bags, int k, int64_t n, int d,
           cudaStream_t stream) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Layout L = plan(bags, k, d, sizeof(Bits), VEC, sms);
  auto* kernel = gather_sum_kernel<Bits, VEC>;
  if (L.smem > 48 * 1024) {  // only by opting in; the attribute holds for the current device
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L.smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int64_t tiles = (bags + L.tile - 1) / L.tile;
  const int64_t blocks = tiles < MAX_BLOCKS ? tiles : MAX_BLOCKS;  // one tile a block
  kernel<<<static_cast<unsigned>(blocks), THREADS, L.smem, stream>>>(
      static_cast<const int32_t*>(idx), static_cast<const Bits*>(x), static_cast<Bits*>(out),
      bags, k, n, d, L);
  return static_cast<int>(cudaGetLastError());
}

template <typename Bits>
int dispatch(const void* idx, const void* x, void* out, int64_t bags, int k, int64_t n, int d,
             cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(Bits);
  const bool aligned = d % VEC == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(out) % 16 == 0;
  return aligned ? launch<Bits, VEC>(idx, x, out, bags, k, n, d, stream)
                 : launch<Bits, 1>(idx, x, out, bags, k, n, d, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns a cudaError_t (0 on success).
// The caller keeps k <= 1536: one bag's ids and their hash table (k * 4 +
// 2 * 4 * 4096 bytes) beside the stage stay well inside a block's shared memory.
extern "C" int gather_sum_launch(const void* idx, const void* x, void* out, int64_t bags,
                                 int k, int64_t n, int d, int dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return dispatch<uint32_t>(idx, x, out, bags, k, n, d, s);
    case 1: return dispatch<uint16_t>(idx, x, out, bags, k, n, d, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The tile plan of a launch, for the tools: bags per tile, stage rows, slice
// columns and shared-memory bytes, written to plan_out[0..3].
extern "C" int gather_sum_plan(int64_t bags, int k, int d, int dtype, int sms, int* plan_out) {
  const int elsize = dtype == 0 ? 4 : 2;
  const Layout L = plan(bags, k, d, elsize, 16 / elsize, sms);
  plan_out[0] = L.tile;
  plan_out[1] = L.srows;
  plan_out[2] = L.slice;
  plan_out[3] = L.smem;
  return 0;
}
