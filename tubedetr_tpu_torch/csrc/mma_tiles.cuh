// Warp-level tensor-core tiles of the flat bottleneck probe P5
// (probe_flat_bottleneck.cu). K2 (with its variants P4) and the probe GEMMs
// P1-P3 run on TMA and wgmma instead (wgmma_tiles.cuh).
//
// One warp task is a (16 * kMT) x (8 * kNT) = 32 x 64 tile of A(M x K) *
// B(K x N) on mma.sync: m16n8k32 with s8 inputs and s32 sums, or m16n8k16
// with bf16 inputs and f32 sums. Both read a 32-byte k-step: each lane loads
// bytes [4t, 4t + 4) and [4t + 16, 4t + 20) of the step from two A rows (g
// and g + 8) and from one B row, so A is given row by row with the reduction
// contiguous and B output channel first (each row contiguous along the
// reduction): a fragment is one 32-bit load. K is counted in bytes.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMT = 2;  // m16 tiles per warp task: 32 rows
constexpr int kNT = 8;  // n8 tiles per warp task: 64 output channels

// s8 x s8 -> s32, k = 32
__device__ __forceinline__ void mma(int (&c)[4], const int (&a)[4], const int (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// bf16 x bf16 -> f32, k = 16
__device__ __forceinline__ void mma(float (&c)[4], const int (&a)[4], const int (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ int ld_global(const int8_t* p) {
  return __ldg(reinterpret_cast<const int*>(p));
}
__device__ __forceinline__ int ld_shared(const int8_t* p) {
  return *reinterpret_cast<const int*>(p);
}

// relu -> round half to even -> clamp to [0, 127]
__device__ __forceinline__ int8_t requant(float y) {
  return (int8_t)(int)fminf(rintf(fmaxf(y, 0.f)), 127.f);
}
__device__ __forceinline__ int8_t fold(int acc, float a, float b) {
  return requant(__fadd_rn(__fmul_rn((float)acc, a), b));
}

// One warp task of the A(M x K) * B(K x 64) product: A rows given as byte
// offsets (one per fragment row) from `abase`, B rows (output channels,
// reduction contiguous) `ldb` bytes apart from `bbase`. Accumulates into acc
// (int: s8 inputs; float: bf16 inputs). K and ldb are in bytes.
template <bool kSharedA, typename Acc>
__device__ __forceinline__ void warp_mma(Acc (&acc)[kMT][kNT][4], const int8_t* abase,
                                         const int (&aoff)[kMT][2], const int8_t* bbase,
                                         int ldb, int K) {
#pragma unroll 2
  for (int k0 = 0; k0 < K; k0 += 32) {
    int a[kMT][4];
#pragma unroll
    for (int i = 0; i < kMT; ++i) {
      const int8_t* r0 = abase + aoff[i][0] + k0;
      const int8_t* r1 = abase + aoff[i][1] + k0;
      if (kSharedA) {
        a[i][0] = ld_shared(r0);
        a[i][1] = ld_shared(r1);
        a[i][2] = ld_shared(r0 + 16);
        a[i][3] = ld_shared(r1 + 16);
      } else {
        a[i][0] = ld_global(r0);
        a[i][1] = ld_global(r1);
        a[i][2] = ld_global(r0 + 16);
        a[i][3] = ld_global(r1 + 16);
      }
    }
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      const int8_t* bj = bbase + (size_t)j * 8 * ldb + k0;
      const int b[2] = {ld_global(bj), ld_global(bj + 16)};
#pragma unroll
      for (int i = 0; i < kMT; ++i) mma(acc[i][j], a[i], b);
    }
  }
}

template <typename Acc>
__device__ __forceinline__ void zero_acc(Acc (&acc)[kMT][kNT][4]) {
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;
}

}  // namespace
