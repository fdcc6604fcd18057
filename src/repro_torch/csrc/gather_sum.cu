// Gather-sum (ELL SpMM / embedding bag) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel in src/repro/kernels/gather_sum.py:
//   gather_sum_launch <- gather_sum_call (body _gather_sum_kernel)
//
// out[b, :] = sum over k < K with idx[b, k] >= 0 of x[idx[b, k], :].
// idx is int32[B, K] (a negative id is a padding slot), x is [N, D] in float32
// or bfloat16, out is [B, D] in x's type.  A bag that holds an id >= N comes
// out NaN in every column, as jnp.take's fill mode gives for the reference's
// embedding_bag; no row past N - 1 is ever read.
//
// What bounds it: bytes.  Each referenced row of x is read (D * elsize bytes),
// each output row written once; the adds (B * K * D) are far below the card's
// float32 rate.  The rows are scattered over a table of gigabytes, so every
// row is its own burst of D * elsize bytes.
//
// Design (simple and right first):
//   * one warp per bag, WARPS bags per block, a grid-stride loop over bags
//     (a 1-D grid; B = 262,144 bags is 32,768 blocks);
//   * the warp stages its idx row in shared memory once, and votes whether
//     any id is >= N (then it writes NaN and reads no row);
//   * lanes run across D with 16-byte vector loads (4 floats or 8 bf16) when
//     D and both base pointers allow it, else one element per load;
//   * for each column tile the warp walks k in groups of KU, issuing all the
//     group's row loads before it adds them, so several rows are in flight;
//   * sums in float32 registers, rounded to x's type once at the store;
//   * row offsets idx * D in int64 (a 5M x 256 table has 1.28e9 elements).
// Later work: cp.async/TMA staging of rows, several bags per warp, and L2
// reuse of hot rows.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int WARPS = 8;   // bags per block
constexpr int LANES = 32;
constexpr int U = 2;       // vectors per lane per column tile
constexpr int KU = 4;      // rows in flight per lane
constexpr int64_t MAX_BLOCKS = 1 << 20;

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

template <typename Bits, int VEC>
__global__ void __launch_bounds__(WARPS * LANES)
gather_sum_kernel(const int32_t* __restrict__ idx, const Bits* __restrict__ x,
                  Bits* __restrict__ out, int64_t bags, int k, int64_t n, int d) {
  using P = Pack<Bits, VEC>;
  using E = Elem<Bits>;
  extern __shared__ int32_t s_idx[];
  const int warp = threadIdx.x / LANES, lane = threadIdx.x % LANES;
  int32_t* ids = s_idx + warp * k;

  for (int64_t b = static_cast<int64_t>(blockIdx.x) * WARPS + warp; b < bags;
       b += static_cast<int64_t>(gridDim.x) * WARPS) {
    bool oob = false;
    for (int j = lane; j < k; j += LANES) {
      const int32_t id = idx[b * k + j];
      ids[j] = id;
      oob |= static_cast<int64_t>(id) >= n;
    }
    oob = __any_sync(0xffffffffu, oob);
    __syncwarp();
    Bits* o = out + b * d;

    if (oob) {
      const Bits nan = E::from_float(__int_as_float(0x7fc00000));
      for (int c = lane; c < d; c += LANES) o[c] = nan;
    } else {
      for (int c0 = lane * VEC; c0 < d; c0 += LANES * VEC * U) {
        float acc[U][VEC];
#pragma unroll
        for (int u = 0; u < U; ++u)
#pragma unroll
          for (int i = 0; i < VEC; ++i) acc[u][i] = 0.0f;

        for (int j0 = 0; j0 < k; j0 += KU) {
          P p[KU][U];
          bool ok[KU][U];
#pragma unroll
          for (int jj = 0; jj < KU; ++jj) {
            const int32_t id = j0 + jj < k ? ids[j0 + jj] : -1;
            const Bits* row = x + static_cast<int64_t>(id < 0 ? 0 : id) * d;
#pragma unroll
            for (int u = 0; u < U; ++u) {
              const int c = c0 + u * LANES * VEC;
              ok[jj][u] = id >= 0 && c < d;
              if (ok[jj][u]) p[jj][u] = *reinterpret_cast<const P*>(row + c);
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
          const int c = c0 + u * LANES * VEC;
          if (c < d) {
            P s;
#pragma unroll
            for (int i = 0; i < VEC; ++i) s.v[i] = E::from_float(acc[u][i]);
            *reinterpret_cast<P*>(o + c) = s;
          }
        }
      }
    }
    __syncwarp();  // every lane is done with ids[] before the next bag overwrites it
  }
}

template <typename Bits, int VEC>
int launch(const void* idx, const void* x, void* out, int64_t bags, int k, int64_t n, int d,
           cudaStream_t stream) {
  int64_t blocks = (bags + WARPS - 1) / WARPS;
  if (blocks > MAX_BLOCKS) blocks = MAX_BLOCKS;
  const size_t smem = static_cast<size_t>(WARPS) * k * sizeof(int32_t);
  gather_sum_kernel<Bits, VEC><<<static_cast<unsigned>(blocks), WARPS * LANES, smem, stream>>>(
      static_cast<const int32_t*>(idx), static_cast<const Bits*>(x), static_cast<Bits*>(out),
      bags, k, n, d);
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
// The caller keeps the idx rows' shared memory (WARPS * k * 4 bytes) within the
// 48 KB a launch gets without opting in to more: k <= 1536.
extern "C" int gather_sum_launch(const void* idx, const void* x, void* out, int64_t bags,
                                 int k, int64_t n, int d, int dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return dispatch<uint32_t>(idx, x, out, bags, k, n, d, s);
    case 1: return dispatch<uint16_t>(idx, x, out, bags, k, n, d, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
