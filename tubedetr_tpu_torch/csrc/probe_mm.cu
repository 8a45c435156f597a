// Probes P1-P3: the plain GEMMs of scripts/probe_pallas_int8.py on Hopper.
//
// Replaces the TPU kernels of that script:
//   P1 `pl_dot`  (body `k_dot`)   s8 x s8 -> s32, (rows, K) @ (K, N), blocks of F*484 rows
//   P2 `pl_dotb` (body `k_dotb`)  bf16 x bf16 -> f32, same shapes
//   P3 `pl_dot3` (body `k_dot3`)  the P1 product on (frames, 484, K), blocks of F frames
// The script asked whether K2's deficit on the TPU was the int8 matmul
// itself; here they measure what K2's own GEMM method reaches on the card:
// the warp tiles of mma_tiles.cuh (mma.sync m16n8k32 s8 or m16n8k16 bf16,
// A fragments loaded straight from global memory, B fragments from L1/L2 on
// every k-step), with no shared-memory staging, no TMA and no wgmma.
//
// Bound, at the script's shapes (rows = 200*484 = 96800, K = 1024, N = 256):
// P1 moves 99 MB of A, 0.26 MB of B and 99 MB of s32 out, 0.059 ms at
// 3.35 TB/s, against 0.026 ms of int8 operations at 1979 TOP/s: bound by
// bytes. P2 moves 297 MB (bf16 in, f32 out): 0.089 ms. P3 as P1.
//
// Tiling: one block of 8 warps computes a 128-row x 128-column tile, warps
// 4 (rows) x 2 (columns), each a 32 x 64 warp task. `seg_rows` is the
// length of the row segments that tiles never cross: all rows for P1 and
// P2 (only the last tile of the whole product is partial), one frame (484
// rows) for P3, where the fourth tile of every frame holds 100 rows. That
// partial tile is what P3 measures against P1: its loads are clamped to the
// segment's last row and its stores predicated, and a warp whose 32 rows
// lie wholly past the segment skips its task.
//
// Arithmetic: s8 sums are exact in s32; in bf16 the script's inputs are
// integers in [-127, 127], every partial sum is an integer below 2^24, so
// the f32 sums are exact too and equal the plain version's.

#include "mma_tiles.cuh"

namespace {

constexpr int kBM = 128;  // rows of a block tile: 4 warps of 32
constexpr int kBN = 128;  // columns of a block tile: 2 warps of 64

// A (rows, kbytes) row-major, B (n, kbytes) output channel first, C (rows, n).
template <typename Acc>
__global__ void __launch_bounds__(kThreads)
    probe_mm_kernel(const int8_t* a, const int8_t* b, Acc* c, int n, int kbytes, int seg_rows,
                    int tiles_per_seg, int ntiles_n) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int tile = blockIdx.x / ntiles_n;
  const int seg = tile / tiles_per_seg;
  const int row_in_seg = (tile - seg * tiles_per_seg) * kBM;
  const int valid = min(kBM, seg_rows - row_in_seg);  // rows of this tile inside its segment
  const int mbase = (warp >> 1) * 16 * kMT;
  const int n0 = (blockIdx.x - tile * ntiles_n) * kBN + (warp & 1) * 8 * kNT;
  if (mbase >= valid || n0 >= n) return;  // warp-uniform: nothing of this task is real
  const size_t row0 = (size_t)seg * seg_rows + row_in_seg;
  const int8_t* abase = a + row0 * kbytes;

  int aoff[kMT][2];
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      aoff[i][h] = min(mbase + i * 16 + h * 8 + g, valid - 1) * kbytes + t * 4;
  Acc acc[kMT][kNT][4];
  zero_acc(acc);
  warp_mma<false>(acc, abase, aoff, b + (size_t)(n0 + g) * kbytes + t * 4, kbytes, kbytes);

#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = mbase + i * 16 + h * 8 + g;
      if (r >= valid) continue;
      Acc* dst = c + (row0 + r) * n + n0 + 2 * t;
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        dst[j * 8] = acc[i][j][2 * h];
        dst[j * 8 + 1] = acc[i][j][2 * h + 1];
      }
    }
}

// in_bytes: bytes of one input element (1 for s8, 2 for bf16)
template <typename Acc>
int launch(const void* a, const void* b, void* c, int rows, int n, int k, int in_bytes,
           int seg_rows, void* stream) {
  if (rows <= 0) return (int)cudaSuccess;
  const int kbytes = k * in_bytes;
  if (n % 64 || kbytes % 32 || seg_rows <= 0 || rows % seg_rows)
    return (int)cudaErrorInvalidValue;
  const int tiles_per_seg = (seg_rows + kBM - 1) / kBM;
  const int ntiles_n = (n + kBN - 1) / kBN;
  const long long blocks = (long long)(rows / seg_rows) * tiles_per_seg * ntiles_n;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  probe_mm_kernel<Acc><<<(unsigned)blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(a), static_cast<const int8_t*>(b), static_cast<Acc*>(c), n,
      kbytes, seg_rows, tiles_per_seg, ntiles_n);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points (loaded with ctypes). a (rows, k), b (n, k), c (rows,
// n), all contiguous; seg_rows divides rows (rows itself for one segment).
// Each launches on `stream`, does not synchronise, allocates nothing;
// returns cudaGetLastError() of the launch, or cudaErrorInvalidValue for a
// shape the kernel does not take (n not a multiple of 64, k not a multiple
// of 32 bytes).
extern "C" int probe_mm_s8(const void* a, const void* b, void* c, int rows, int n, int k,
                           int seg_rows, void* stream) {
  return launch<int>(a, b, c, rows, n, k, 1, seg_rows, stream);
}

extern "C" int probe_mm_bf16(const void* a, const void* b, void* c, int rows, int n, int k,
                             int seg_rows, void* stream) {
  return launch<float>(a, b, c, rows, n, k, 2, seg_rows, stream);
}
