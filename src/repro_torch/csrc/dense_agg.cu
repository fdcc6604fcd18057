// The dense MIN/MAX table's update (a recursive MIN/MAX aggregate such as
// CC's labels or SSSP's distances), for Hopper (sm_90a).
//
// Replaces no TPU kernel.  The JAX package leaves the update to XLA
// (src/repro/core/relation.py: DenseAggRelation.update, `.at[keys].min`),
// and the plain PyTorch version (kernels/ref.py: dense_agg_update_plain)
// scatters with scatter_reduce.  A round's binding table has next_bucket(total)
// slots with its pads at the tail, and that version sends every pad to key 0:
// about 6.6 M same-address atomics a full round of RMAT-1M's CC, at about one
// nanosecond each, around a handful of full passes over the slots (an int64
// copy of the keys, the wheres, the compares) and four host reads of counts.
// These two kernels do the same integer MIN/MAX once and count what the round
// needs into four device counters, read by the host in one copy.
//
//   dense_agg_scatter_kernel  (one buffer of candidates -> the table).  A warp
//     walks 32 consecutive slots at a time (a grid-stride loop over slots).
//     A warp whose 32 slots are all pads reads their 32 valid bytes and
//     nothing else.  A valid slot's key is clamped to [0, n) (the engine's
//     torch.clamp); lanes with equal keys are grouped (__match_any_sync) and
//     reduced (__reduce_min_sync / __reduce_max_sync), so a node's
//     consecutive arcs in the base round or a hub's repeats cost one atomic a
//     group; the group's leader reads the current value through L2 and issues
//     atomicMin / atomicMax only where its candidate beats it.  Values only
//     move one way, so a stale read lets through an atomic that does nothing,
//     never drops one that was needed: the result is exact and order-free.
//     Counts: counts[0] += valid slots, counts[1] += atomics issued.
//     Bound: reading 1 B a slot, 8 B a valid slot, and the table's 4 B a key.
//
//   dense_agg_diff_kernel  (the round's Δ).  Over the n keys, Δ = new < old
//     (MIN) or new > old (MAX), written as bytes; counts[2] += keys present
//     (new != absent), counts[3] += keys in Δ.  A key improves in some buffer
//     of a round exactly when its final value beats its value before the
//     round, so this is the union of every buffer's improvements.  Bound:
//     reading 8 B a key and writing 1.
//
// Each block sums its counts in shared memory and adds them with one atomic
// per counter.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;
// resident blocks an SM holds at THREADS threads each (2048 threads an SM)
constexpr int BLOCKS_PER_SM = 2048 / THREADS;

// Adds a block's two per-thread counts to counts[0] and counts[1] (one atomic
// each); every thread of the block calls it.
__device__ inline void add_block_counts(unsigned a, unsigned b, unsigned long long* counts) {
  __shared__ unsigned long long part[2][WARPS];
  a = __reduce_add_sync(FULL, a);
  b = __reduce_add_sync(FULL, b);
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) {
    part[0][warp] = a;
    part[1][warp] = b;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned long long sa = 0, sb = 0;
    for (int w = 0; w < WARPS; ++w) {
      sa += part[0][w];
      sb += part[1][w];
    }
    if (sa) atomicAdd(counts, sa);
    if (sb) atomicAdd(counts + 1, sb);
  }
}

template <bool MIN>
__global__ void __launch_bounds__(THREADS)
dense_agg_scatter_kernel(const int* __restrict__ keys, const int* __restrict__ vals,
                         const unsigned char* __restrict__ valid, long long slots, int n,
                         int* values, unsigned long long* counts) {
  const int lane = threadIdx.x & 31;
  const long long stride = static_cast<long long>(gridDim.x) * THREADS;
  unsigned seen = 0, issued = 0;
  // the loop's bound is uniform over the warp, so every lane reaches each sync
  for (long long base = static_cast<long long>(blockIdx.x) * THREADS + (threadIdx.x & ~31);
       base < slots; base += stride) {
    const long long i = base + lane;
    const bool ok = i < slots && valid[i] != 0;
    if (__ballot_sync(FULL, ok) == 0u) continue;  // 32 pads
    int key = -1, v = 0;
    if (ok) {
      key = min(max(keys[i], 0), n - 1);
      v = vals[i];
    }
    const unsigned group = __match_any_sync(FULL, key);
    if (ok) {
      ++seen;
      const int best = MIN ? __reduce_min_sync(group, v) : __reduce_max_sync(group, v);
      if (lane == __ffs(group) - 1) {
        const int cur = __ldcg(values + key);
        if (MIN ? best < cur : best > cur) {
          if (MIN) atomicMin(values + key, best);
          else atomicMax(values + key, best);
          ++issued;
        }
      }
    }
  }
  add_block_counts(seen, issued, counts);
}

template <bool MIN>
__global__ void __launch_bounds__(THREADS)
dense_agg_diff_kernel(const int* __restrict__ old, const int* __restrict__ now, int n,
                      int absent, unsigned char* __restrict__ delta,
                      unsigned long long* counts) {
  unsigned present = 0, improved = 0;
  for (long long k = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x; k < n;
       k += static_cast<long long>(gridDim.x) * THREADS) {
    const int o = old[k], v = now[k];
    const bool d = MIN ? v < o : v > o;
    delta[k] = d;
    present += v != absent;
    improved += d;
  }
  add_block_counts(present, improved, counts + 2);
}

// Blocks for `work` items, one a thread, at most what the card holds at once.
int blocks_for(long long work, unsigned& blocks) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  long long b = (work + THREADS - 1) / THREADS;
  const long long most = static_cast<long long>(sms) * BLOCKS_PER_SM;
  blocks = static_cast<unsigned>(b < most ? b : most);
  return 0;
}

}  // namespace

// Every function returns the cudaError_t of its launch (0 on success) and
// launches nothing for an empty grid.  `counts` is unsigned long long[4].

extern "C" int dense_agg_scatter_launch(const void* keys, const void* vals, const void* valid,
                                        long long slots, int n, int is_min, void* values,
                                        void* counts, void* stream) {
  if (slots <= 0 || n <= 0) return 0;
  unsigned blocks = 0;
  if (int err = blocks_for(slots, blocks)) return err;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto k = static_cast<const int*>(keys);
  const auto v = static_cast<const int*>(vals);
  const auto ok = static_cast<const unsigned char*>(valid);
  const auto out = static_cast<int*>(values);
  const auto c = static_cast<unsigned long long*>(counts);
  if (is_min)
    dense_agg_scatter_kernel<true><<<blocks, THREADS, 0, s>>>(k, v, ok, slots, n, out, c);
  else
    dense_agg_scatter_kernel<false><<<blocks, THREADS, 0, s>>>(k, v, ok, slots, n, out, c);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int dense_agg_diff_launch(const void* old, const void* now, int n, int is_min,
                                     int absent, void* delta, void* counts, void* stream) {
  if (n <= 0) return 0;
  unsigned blocks = 0;
  if (int err = blocks_for(n, blocks)) return err;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto o = static_cast<const int*>(old);
  const auto v = static_cast<const int*>(now);
  const auto d = static_cast<unsigned char*>(delta);
  const auto c = static_cast<unsigned long long*>(counts);
  if (is_min)
    dense_agg_diff_kernel<true><<<blocks, THREADS, 0, s>>>(o, v, n, absent, d, c);
  else
    dense_agg_diff_kernel<false><<<blocks, THREADS, 0, s>>>(o, v, n, absent, d, c);
  return static_cast<int>(cudaGetLastError());
}
