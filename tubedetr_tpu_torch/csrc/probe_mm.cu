// Probes P1-P3: the plain GEMMs of scripts/probe_pallas_int8.py on Hopper.
//
// Replaces the TPU kernels of that script:
//   P1 `pl_dot`  (body `k_dot`)   s8 x s8 -> s32, (rows, K) @ (K, N), blocks of F*484 rows
//   P2 `pl_dotb` (body `k_dotb`)  bf16 x bf16 -> f32, same shapes
//   P3 `pl_dot3` (body `k_dot3`)  the P1 product on (frames, 484, K), blocks of F frames
// The script asked whether K2's deficit on the TPU was the int8 matmul
// itself; on the card they measure the GEMM method of wgmma_tiles.cuh, which
// K2's redesign takes next.
//
// Bound, at the script's shapes (rows = 200*484 = 96800, K = 1024, N = 256):
// P1 moves 99 MB of A, 0.26 MB of B and 99 MB of s32 out, 0.059 ms at
// 3.35 TB/s, against 0.026 ms of int8 operations at 1979 TOP/s: bound by
// bytes, half of them the output. P2 moves 298 MB (bf16 in, f32 out):
// 0.089 ms. P3 as P1.
//
// Design: one persistent, warp-specialised block an SM walks output tiles of
// 128 rows x 256 columns (grid: the SM count, capped at the tiles). Warpgroup
// 0 is the producer: one thread streams 128-byte slices of K of the tile's A
// rows (16 KB) and of B (32 KB) by TMA into a ring of 4 such stages (192 KB),
// each stage guarded by a full and an empty mbarrier; it runs ahead into the
// next tile while the consumers store the last one. Warpgroups 1 and 2 each
// own 64 rows of the tile: per stage, four wgmma m64n256 k-steps of 32 bytes
// (s8 k32 -> s32, or bf16 k16 -> f32) on shared-memory descriptors of both
// operands, one group left in flight while the next stage arrives; the 128
// accumulators a thread are stored straight from registers, each quad of
// lanes writing 32 contiguous bytes of a row, predicated on the tile's rows
// and on columns below N. B is re-read from L2 for every tile (256 KB in s8,
// 512 KB in bf16 at N=256, K=1024). On an NVIDIA H100 80GB HBM3 at 700 W
// (PERF.md) P1-P3 run at 68-74% of their bound, held by HBM under
// mixed reads and writes: the output stores take half of P1's time, and
// dropping B's loads altogether saves only 5-7%, so a cluster multicast of
// B was left out.
//
// Row segments: `seg_rows` is the length of the segments that tiles never
// cross: all rows for P1 and P2 (a 2-D map on (rows, K); only the last tile
// is partial), one frame for P3 (a 3-D map on (frames, HW, K) whose box is
// one frame deep, so the fourth 128-row tile of a 484-row frame holds 100
// rows). TMA fills rows past the segment, B rows at or past N and K bytes
// past the end with zeros, which add nothing to the sums.
//
// Arithmetic: s8 sums are exact in s32; in bf16 the script's inputs are
// integers in [-127, 127], every partial sum is an integer below 2^24, so
// the f32 sums are exact in any order and equal the plain version's.

#include <type_traits>

#include "wgmma_tiles.cuh"

namespace {

constexpr int kBM = 128;  // rows of a tile: two consumer warpgroups of 64
constexpr int kBN = 256;  // columns of a tile: one wgmma n256
constexpr int kStages = 4;
constexpr int kThreads = 384;  // producer warpgroup + two consumer warpgroups
constexpr int kConsumerWarps = 8;
constexpr int kABytes = kBM * kTileKBytes;  // 16 KB
constexpr int kBBytes = kBN * kTileKBytes;  // 32 KB
constexpr int kStageBytes = kABytes + kBBytes;
// alignment slack, the ring, its barriers
constexpr int kSmemBytes = 1024 + kStages * kStageBytes + 2 * kStages * 8;
constexpr int kSteps = kTileKBytes / kStepKBytes;  // wgmma k-steps a stage

struct Shape {
  int n;              // columns of C
  int kblocks;        // 128-byte slices of K
  int k_elems;        // elements of K in one slice
  int seg_rows;       // rows of a segment that no tile crosses
  int tiles_per_seg;  // 128-row tiles of a segment
  int ntiles_n;       // 256-column tiles
  int ntiles;
  int framed;         // A's map is 3-D (segments, seg_rows, K)
};

__device__ __forceinline__ void store2(int32_t* p, int32_t a, int32_t b) {
  *reinterpret_cast<int2*>(p) = make_int2(a, b);
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

struct Tile {
  int seg, r0, n0;  // segment, first row in it, first column
};

// the tile-th output tile, columns fastest
__device__ __forceinline__ Tile tile_at(int tile, const Shape& s) {
  const int m = tile / s.ntiles_n;
  const int seg = m / s.tiles_per_seg;
  return {seg, (m - seg * s.tiles_per_seg) * kBM, (tile - m * s.ntiles_n) * kBN};
}

// Acc int32_t: s8 inputs; float: bf16 inputs
template <typename Acc>
__device__ __forceinline__ void probe_mm_body(const CUtensorMap* amap, const CUtensorMap* bmap,
                                              Acc* c, const Shape& s) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* ring_a = smem;
  uint8_t* ring_b = smem + kStages * kABytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring_b + kStages * kBBytes);
  uint64_t* empty = full + kStages;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], kConsumerWarps);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {  // ---- producer
    setmaxnreg_dec<40>();
    if (threadIdx.x == 0) {
      tma_prefetch_map(amap);
      tma_prefetch_map(bmap);
      int stage = 0;
      uint32_t phase = 0;
      for (int tile = blockIdx.x; tile < s.ntiles; tile += gridDim.x) {
        const Tile t = tile_at(tile, s);
        for (int kb = 0; kb < s.kblocks; ++kb) {
          mbar_wait(&empty[stage], phase ^ 1);
          // the full box bytes, zero-filled parts included
          mbar_arrive_expect_tx(&full[stage], kStageBytes);
          const int kc = kb * s.k_elems;
          if (s.framed)
            tma_load_3d(ring_a + stage * kABytes, amap, &full[stage], kc, t.r0, t.seg);
          else
            tma_load_2d(ring_a + stage * kABytes, amap, &full[stage], kc, t.r0);
          tma_load_2d(ring_b + stage * kBBytes, bmap, &full[stage], kc, t.n0);
          if (++stage == kStages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {  // ---- consumers: warpgroup 1 rows 0-63 of a tile, 2 rows 64-127
    setmaxnreg_inc<232>();
    const int lane = threadIdx.x & 31;
    const int row_wg = (wg - 1) * 64;
    const int row_t = row_wg + ((threadIdx.x >> 5) & 3) * 16 + (lane >> 2);
    Acc acc[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] = 0;
    int stage = 0;
    uint32_t phase = 0;
    for (int tile = blockIdx.x; tile < s.ntiles; tile += gridDim.x) {
      const Tile t = tile_at(tile, s);
      int prev = 0;
      for (int kb = 0; kb < s.kblocks; ++kb) {
        mbar_wait(&full[stage], phase);
        const uint64_t da = wgmma_desc_sw128(ring_a + stage * kABytes + row_wg * kTileKBytes);
        const uint64_t db = wgmma_desc_sw128(ring_b + stage * kBBytes);
        wgmma_fence();
#pragma unroll
        for (int k = 0; k < kSteps; ++k)
          wgmma_m64n256(acc, wgmma_desc_step(da, k), wgmma_desc_step(db, k), kb | k);
        wgmma_commit();
        if (kb > 0) {  // the previous stage's group is done: release it
          wgmma_wait<1>();
          if (lane == 0) mbar_arrive(&empty[prev]);
        }
        prev = stage;
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
      wgmma_wait<0>();
      wgmma_pin_all(acc);
      if (lane == 0) mbar_arrive(&empty[prev]);

      const int valid = min(kBM, s.seg_rows - t.r0);  // rows of this tile inside its segment
      const size_t row0 = (size_t)t.seg * s.seg_rows + t.r0;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = row_t + 8 * h;
        if (r >= valid) continue;
        Acc* dst = c + (row0 + r) * s.n + t.n0 + 2 * (lane & 3);
#pragma unroll
        for (int j = 0; j < kBN / 8; ++j)
          if (t.n0 + 8 * j < s.n) store2(dst + 8 * j, acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1)
    probe_mm_s8_kernel(const __grid_constant__ CUtensorMap amap,
                       const __grid_constant__ CUtensorMap bmap, int32_t* c, const Shape s) {
  probe_mm_body<int32_t>(&amap, &bmap, c, s);
}

__global__ void __launch_bounds__(kThreads, 1)
    probe_mm_bf16_kernel(const __grid_constant__ CUtensorMap amap,
                         const __grid_constant__ CUtensorMap bmap, float* c, const Shape s) {
  probe_mm_body<float>(&amap, &bmap, c, s);
}

constexpr int kMaxDevices = 64;

// Per device, once: the SM count, and the kernels' dynamic shared memory
// limit raised to kSmemBytes. 0 on failure.
int prepare_device() {
  static int sms[kMaxDevices] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= kMaxDevices) return 0;
  if (!sms[dev]) {
    int count = 0;
    if (cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
        cudaFuncSetAttribute(probe_mm_s8_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmemBytes) != cudaSuccess ||
        cudaFuncSetAttribute(probe_mm_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmemBytes) != cudaSuccess)
      return 0;
    sms[dev] = count;
  }
  return sms[dev];
}

// in_bytes: bytes of one input element (1 for s8, 2 for bf16)
template <typename Acc>
int launch(const void* a, const void* b, void* c, int rows, int n, int k, int in_bytes,
           int seg_rows, void* stream) {
  if (rows <= 0) return (int)cudaSuccess;
  const long long kbytes = (long long)k * in_bytes;
  if (n <= 0 || n % 64 || k <= 0 || kbytes % 32 || seg_rows <= 0 || rows % seg_rows)
    return (int)cudaErrorInvalidValue;
  if ((uintptr_t)a % 16 || (uintptr_t)b % 16 || (uintptr_t)c % 16)
    return (int)cudaErrorInvalidValue;  // TMA takes 16-byte aligned bases

  Shape s;
  s.n = n;
  s.kblocks = (int)((kbytes + kTileKBytes - 1) / kTileKBytes);
  s.k_elems = kTileKBytes / in_bytes;
  s.seg_rows = seg_rows;
  s.tiles_per_seg = (seg_rows + kBM - 1) / kBM;
  s.ntiles_n = (n + kBN - 1) / kBN;
  const long long ntiles = (long long)(rows / seg_rows) * s.tiles_per_seg * s.ntiles_n;
  if (ntiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  s.ntiles = (int)ntiles;
  s.framed = seg_rows < rows;

  const CUtensorMapDataType type =
      in_bytes == 1 ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  CUtensorMap amap, bmap;
  const cuuint64_t a_dims[3] = {(cuuint64_t)k, (cuuint64_t)seg_rows, (cuuint64_t)(rows / seg_rows)};
  const cuuint64_t a_strides[2] = {(cuuint64_t)kbytes, (cuuint64_t)kbytes * seg_rows};
  const cuuint64_t b_dims[2] = {(cuuint64_t)k, (cuuint64_t)n};
  const cuuint64_t b_strides[1] = {(cuuint64_t)kbytes};
  if (!encode_k_major(&amap, type, in_bytes, a, s.framed ? 3 : 2, a_dims, a_strides, kBM) ||
      !encode_k_major(&bmap, type, in_bytes, b, 2, b_dims, b_strides, kBN))
    return (int)cudaErrorInvalidValue;

  const int sms = prepare_device();
  if (sms <= 0) return (int)cudaErrorInvalidDevice;
  const int grid = s.ntiles < sms ? s.ntiles : sms;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if constexpr (std::is_same<Acc, int32_t>::value)
    probe_mm_s8_kernel<<<grid, kThreads, kSmemBytes, st>>>(amap, bmap, static_cast<Acc*>(c), s);
  else
    probe_mm_bf16_kernel<<<grid, kThreads, kSmemBytes, st>>>(amap, bmap, static_cast<Acc*>(c), s);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points (loaded with ctypes). a (rows, k), b (n, k), c (rows,
// n), all contiguous and 16-byte aligned; seg_rows divides rows (rows itself
// for one segment). Each launches on `stream`, does not synchronise,
// allocates nothing; returns cudaGetLastError() of the launch, or
// cudaErrorInvalidValue for what the kernel does not take (n not a multiple
// of 64, k not a multiple of 32 bytes, a base not 16-byte aligned, a tensor
// map cuTensorMapEncodeTiled refuses).
extern "C" int probe_mm_s8(const void* a, const void* b, void* c, int rows, int n, int k,
                           int seg_rows, void* stream) {
  return launch<int32_t>(a, b, c, rows, n, k, 1, seg_rows, stream);
}

extern "C" int probe_mm_bf16(const void* a, const void* b, void* c, int rows, int n, int k,
                             int seg_rows, void* stream) {
  return launch<float>(a, b, c, rows, n, k, 2, seg_rows, stream);
}

// Dynamic shared memory a block of either kernel requests, in bytes.
extern "C" int probe_mm_smem_bytes() { return kSmemBytes; }
