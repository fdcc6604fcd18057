// PBME's conversions between (row, col) pairs and packed bit matrices, for
// Hopper (sm_90a).
//
// Replaces no TPU kernel.  The JAX package converts on the host
// (src/repro/core/bitmatrix.py: edges_to_bitmatrix ORs bits into numpy words
// with np.bitwise_or.at, bitmatrix_to_edges unpacks and np.nonzero-s).  Both
// conversions run once per PBME evaluation and in every serving update, and
// in plain PyTorch they went through a dense n x n matrix: an int64 pack of
// 1.8 GB of transients, and an unpack plus torch.nonzero that wrote about 5 GB
// to produce a 1.07 GB table at n = 10^4.  These kernels work on the packed
// words and write each output byte once.
//
// Words are uint32: bit j of word w of a row is column 32w + j (bit 31 is a
// real column, so every shift is logical); a row has w = ceil(n / 32) words,
// and bits at columns >= n in its last word are ignored.
//
//   bitpack_pack_launch   (edges -> matrix).  One thread an edge ORs its bit
//     into the zeroed matrix with atomicOr; the edges may come in any order
//     and repeat.  Lanes of a warp whose bits fall in one word are grouped
//     (__match_any_sync), OR their bits together (__reduce_or_sync) and the
//     group's lowest lane issues one atomic: a sorted table of 10^8 pairs
//     (the serving layer's re-pack) costs about one atomic a word, not one a
//     pair.  Edges outside [0, n) x [0, n) are skipped, so nothing outside the
//     matrix is written.  Bound: reading 8 B an edge and writing the words.
//
//   bitpack_count_launch  (matrix -> per-row set-bit counts, int64).  One warp
//     a row, __popc per word.  Bound: reading the words once.
//
//   bitpack_write_launch  (matrix -> the padded (row, col) table).  Given the
//     inclusive prefix of the row counts and the capacity, one block a row
//     writes the row's pairs at their final positions, in lexicographic order,
//     and extra blocks fill rows count .. capacity-1 with (fill, fill).  The 8
//     warps of a row block take contiguous word ranges; a first pass counts
//     each range's bits and a block-level prefix gives each warp its start.
//     A warp loads 32 words, one a lane, and walks the nonzero ones: for word
//     x, lane j holds bit j, and its slot is the warp's start plus
//     __popc(x & lanemask_lt); a full word is one coalesced 256-byte store.
//     Every byte of the table is written once, with streaming stores (__stcs):
//     the table (1.07 GB at n = 10^4) does not fit the 50 MB L2.  Bound:
//     writing the table, 8 B a row of its capacity, plus reading the words.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;
// blocks that fill the sentinel tail, at most (each thread loops)
constexpr long long TAIL_BLOCKS = 2048;

// The valid bits of a row's last word.
inline unsigned last_mask(int n) {
  return (n & 31) ? (1u << (n & 31)) - 1u : FULL;
}

__device__ inline unsigned word_at(const unsigned* row, int q, int w, unsigned last) {
  if (q >= w) return 0u;
  const unsigned x = __ldg(row + q);
  return q == w - 1 ? x & last : x;
}

__global__ void __launch_bounds__(THREADS)
pack_kernel(const int* __restrict__ edges, long long m, int n, int w,
            unsigned* __restrict__ words) {
  const long long i = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  int r = -1, c = -1;
  if (i < m) {
    r = edges[2 * i];
    c = edges[2 * i + 1];
  }
  const bool ok = static_cast<unsigned>(r) < static_cast<unsigned>(n) &&
                  static_cast<unsigned>(c) < static_cast<unsigned>(n);
  const unsigned long long key =
      ok ? static_cast<unsigned long long>(r) * w + (c >> 5) : ~0ull;
  // every lane of the warp reaches the match; a group is all valid or all not
  const unsigned group = __match_any_sync(FULL, key);
  if (!ok) return;
  const unsigned bits = __reduce_or_sync(group, 1u << (c & 31));
  if (static_cast<int>(threadIdx.x & 31) == __ffs(group) - 1) atomicOr(words + key, bits);
}

__global__ void __launch_bounds__(THREADS)
count_kernel(const unsigned* __restrict__ words, int rows, int w, unsigned last,
             long long* __restrict__ counts) {
  const long long r = (static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x) >> 5;
  if (r >= rows) return;  // uniform over the warp
  const int lane = threadIdx.x & 31;
  const unsigned* row = words + r * w;
  int bits = 0;
  for (int q = lane; q < w; q += 32) bits += __popc(word_at(row, q, w, last));
  bits = __reduce_add_sync(FULL, bits);
  if (lane == 0) counts[r] = bits;
}

__global__ void __launch_bounds__(THREADS)
write_kernel(const unsigned* __restrict__ words, int rows, int w, unsigned last,
             const long long* __restrict__ incl, long long count, long long capacity,
             int fill, int2* __restrict__ table) {
  if (static_cast<int>(blockIdx.x) >= rows) {  // the sentinel tail
    const long long stride = static_cast<long long>(gridDim.x - rows) * THREADS;
    const int2 s = make_int2(fill, fill);
    for (long long i = count + static_cast<long long>(blockIdx.x - rows) * THREADS + threadIdx.x;
         i < capacity; i += stride)
      __stcs(table + i, s);
    return;
  }
  const int r = blockIdx.x;
  const long long start = r ? incl[r - 1] : 0;
  if (incl[r] == start) return;  // an empty row: uniform over the block
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const unsigned* row = words + static_cast<long long>(r) * w;
  const int chunks = (w + 31) / 32;
  const int c0 = chunks * warp / WARPS, c1 = chunks * (warp + 1) / WARPS;

  int mine = 0;
  for (int ch = c0; ch < c1; ++ch) mine += __popc(word_at(row, ch * 32 + lane, w, last));
  mine = __reduce_add_sync(FULL, mine);
  __shared__ int before[WARPS];
  if (lane == 0) before[warp] = mine;
  __syncthreads();
  if (mine == 0) return;  // uniform over the warp
  long long base = start;
  for (int k = 0; k < warp; ++k) base += before[k];

  const unsigned lower = (1u << lane) - 1u;
  for (int ch = c0; ch < c1; ++ch) {
    const unsigned x = word_at(row, ch * 32 + lane, w, last);
    for (unsigned nz = __ballot_sync(FULL, x != 0u); nz; nz &= nz - 1u) {
      const int j = __ffs(nz) - 1;
      const unsigned word = __shfl_sync(FULL, x, j);
      if ((word >> lane) & 1u)
        __stcs(table + base + __popc(word & lower), make_int2(r, (ch * 32 + j) * 32 + lane));
      base += __popc(word);
    }
  }
}

}  // namespace

// Every function returns the cudaError_t of its launches (0 on success) and
// launches nothing for an empty grid.

extern "C" int bitpack_pack_launch(const void* edges, long long m, int n, void* words,
                                   void* stream) {
  if (m <= 0 || n <= 0) return 0;
  const int w = (n + 31) / 32;
  pack_kernel<<<static_cast<unsigned>((m + THREADS - 1) / THREADS), THREADS, 0,
                static_cast<cudaStream_t>(stream)>>>(static_cast<const int*>(edges), m, n, w,
                                                     static_cast<unsigned*>(words));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int bitpack_count_launch(const void* words, int rows, int n, void* counts,
                                    void* stream) {
  if (rows <= 0) return 0;
  const int w = (n + 31) / 32;
  const long long blocks = (static_cast<long long>(rows) + WARPS - 1) / WARPS;
  count_kernel<<<static_cast<unsigned>(blocks), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned*>(words), rows, w, last_mask(n),
      static_cast<long long*>(counts));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int bitpack_write_launch(const void* words, int rows, int n, const void* incl,
                                    long long count, long long capacity, int fill, void* table,
                                    void* stream) {
  const int w = (n + 31) / 32;
  const long long tail = capacity - count;
  long long tail_blocks = (tail + THREADS - 1) / THREADS;
  if (tail_blocks > TAIL_BLOCKS) tail_blocks = TAIL_BLOCKS;
  const long long blocks = static_cast<long long>(rows) + tail_blocks;
  if (blocks <= 0) return 0;
  write_kernel<<<static_cast<unsigned>(blocks), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned*>(words), rows, w, last_mask(n),
      static_cast<const long long*>(incl), count, capacity, fill, static_cast<int2*>(table));
  return static_cast<int>(cudaGetLastError());
}
