// Tensor-core issue rates on Hopper (sm_90a) for the two ways to run the PBME
// bit product, measured by tools/mma_rates.py:
//   MMA_KIND 0: mma.sync m16n8k32   s32 += s8 * s8         (unpacked {0,1} bytes)
//   MMA_KIND 1: mma.sync m16n8k256  s32 += popc(b1 AND b1) (packed words)
//   MMA_KIND 2: wgmma    m64n128k32  s32 += s8 * s8,         operands in shared memory
//   MMA_KIND 3: wgmma    m64n128k256 s32 += popc(b1 AND b1), operands in shared memory
// Each build holds one kind, so a kind the assembler refuses does not stop the
// others.  The operands' values do not matter for the rate: each warp keeps
// NACC independent accumulators (mma.sync) or its warpgroup issues NCHAIN
// products per commit group (wgmma), and writes a checksum so nothing is
// eliminated.

#include <cstdint>
#include <cuda_runtime.h>

#ifndef MMA_KIND
#error "define MMA_KIND"
#endif

namespace {

constexpr int NACC = 8;
constexpr int NCHAIN = 8;

#if MMA_KIND == 0 || MMA_KIND == 1
__global__ void rate_kernel(int iters, int* sink) {
  uint32_t a[4], b[2];
#pragma unroll
  for (int i = 0; i < 4; ++i) a[i] = threadIdx.x * 0x9E3779B9u + i;
  b[0] = threadIdx.x * 0x85EBCA6Bu;
  b[1] = ~b[0];
  int acc[NACC][4] = {};
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int j = 0; j < NACC; ++j) {
#if MMA_KIND == 0
      asm volatile(
          "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
          "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
          : "+r"(acc[j][0]), "+r"(acc[j][1]), "+r"(acc[j][2]), "+r"(acc[j][3])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
#else
      asm volatile(
          "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
          "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
          : "+r"(acc[j][0]), "+r"(acc[j][1]), "+r"(acc[j][2]), "+r"(acc[j][3])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
#endif
    }
  }
  int s = 0;
#pragma unroll
  for (int j = 0; j < NACC; ++j) s += acc[j][0] + acc[j][1] + acc[j][2] + acc[j][3];
  sink[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
#else
#define D64                                                                            \
  "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),  \
      "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]),       \
      "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]),    \
      "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),    \
      "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]),    \
      "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]),    \
      "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]), "+r"(d[42]),    \
      "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]),    \
      "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),    \
      "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]),    \
      "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
#define R64                                                                            \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "  \
  "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "   \
  "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "   \
  "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"

// K-major, no swizzle: 8-row x 16-byte core matrices, 128 B apart along K
// (leading offset) and 256 B apart along M/N (stride offset).
__device__ uint64_t desc(const void* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (uint64_t{128 >> 4} << 16) |
         (uint64_t{256 >> 4} << 32);
}

__global__ void rate_kernel(int iters, int* sink) {
  __shared__ __align__(128) uint8_t a_s[64 * 32];
  __shared__ __align__(128) uint8_t b_s[128 * 32];
  for (int i = threadIdx.x; i < 64 * 32; i += blockDim.x) a_s[i] = static_cast<uint8_t>(i * 7);
  for (int i = threadIdx.x; i < 128 * 32; i += blockDim.x) b_s[i] = static_cast<uint8_t>(i * 13);
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  const uint64_t da = desc(a_s), db = desc(b_s);
  uint32_t d[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) d[i] = 0u;
  for (int it = 0; it < iters; ++it) {
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int j = 0; j < NCHAIN; ++j) {
#if MMA_KIND == 2
      asm volatile(
          "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
          "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 " R64 ", %64, %65, p;\n}\n"
          : D64
          : "l"(da), "l"(db), "r"(1));
#else
      asm volatile(
          "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
          "wgmma.mma_async.sync.aligned.m64n128k256.s32.b1.b1.s32.and.popc " R64
          ", %64, %65, p;\n}\n"
          : D64
          : "l"(da), "l"(db), "r"(1));
#endif
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  }
  uint32_t s = 0;
#pragma unroll
  for (int i = 0; i < 64; ++i) s += d[i];
  sink[blockIdx.x * blockDim.x + threadIdx.x] = static_cast<int>(s);
}
#endif

}  // namespace

// Launch `blocks` blocks of `threads` threads (a multiple of 128) for
// `iters` iterations; sink holds blocks * threads ints.
extern "C" int mma_rate_launch(int blocks, int threads, int iters, void* sink, void* stream) {
  rate_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      iters, static_cast<int*>(sink));
  return static_cast<int>(cudaGetLastError());
}

// Bit multiply-accumulates one warp (mma.sync) or one warpgroup (wgmma) does
// per iteration.
extern "C" long long mma_rate_macs_per_iter() {
#if MMA_KIND == 0
  return 16LL * 8 * 32 * NACC;
#elif MMA_KIND == 1
  return 16LL * 8 * 256 * NACC;
#elif MMA_KIND == 2
  return 64LL * 128 * 32 * NCHAIN;
#else
  return 64LL * 128 * 256 * NCHAIN;
#endif
}
