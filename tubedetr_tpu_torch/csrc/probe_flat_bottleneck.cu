// Probe P5: K2's function on frames padded to a flat row stride, on Hopper.
//
// Replaces the TPU kernel of scripts/probe_fused_variants.py `run_flat`
// (body `make_kernel_flat`). The stream is (N, HWP, C) int8 with each
// frame's H*W real rows followed by HWP - H*W pad rows (the script: 484 real
// rows of a 22 x 22 frame in 512). It computes K2's bottleneck on the real
// rows, with every pad row's q1 forced to 0 and every output pad row written
// 0:
//     q1  = clip(rint(relu(conv1(x)  * a1 + b1)), 0, 127), 0 on pad rows
//     q2  = clip(rint(relu(conv2(q1) * a2 + b2)), 0, 127)  3x3 as flat row offsets
//     out = clip(rint(relu(conv3(q2) * a3 + b3 + x * sid)), 0, 127), 0 on pad rows
// The 3x3's tap (ky, kx) of flat row m reads q1 at row m + (ky-1)*W + (kx-1),
// masked to 0 where the column leaves the frame; with at least W + 1 pad rows
// between frames the zero pad rows are the vertical border, so no row mask
// is needed.
//
// Two variants, as in the script:
//   hwpad   the 9 taps as 9 accumulated products over shifted rows of the
//           q1 tile (a masked row reads a row of zeros kept in the tile);
//   im2col  the masked shifted rows copied into a (rows, 9P) patch in
//           shared memory, then one K = 9P product. w2 is laid out
//           [tap][out][in], so the product walks the patch's columns tap by
//           tap: the same mma.sync sequence as one K = 9P loop.
//
// Bound, at the script's shapes (N = 200, HWP = 512, 22 x 22, C = 1024,
// P = 256): the int8 work counted on the 484 real rows, as the script counts
// it, is 2.16e11 operations, 0.109 ms at 1979 TOP/s, against 210 MB of
// stream in and out (the pad rows included), 0.063 ms at 3.35 TB/s: bound by
// operations.
//
// Design: one block takes a run of kRB consecutive flat rows, crossing
// frames, and keeps its q1 tile (the run plus a halo of W + 1 rows on each
// side, recomputed by the neighbouring blocks) and q2 in shared memory:
// phase 1 conv1 into the tile, phase 2 the taps into q2, phase 3 conv3 with
// the residual straight to global memory. Products are K2's warp tiles
// (mma_tiles.cuh), and the epilogues K2's: __fmul_rn / __fadd_rn in the
// reference's order and rintf, so the output equals the plain version bit
// for bit. Simple, not fast: no TMA, no wgmma, weights from L2.

#include "mma_tiles.cuh"

namespace {

constexpr int kPad = 16;  // bytes of padding per row in shared memory

enum class Flat { kHwPad, kIm2col };

// Output rows a block: the im2col patch (kRB x (9P + kPad)) must fit beside
// the q1 tile, 64 rows at P = 256. Mirrored by FLAT_ROWS_PER_BLOCK in
// ops/probe_bottleneck.py, held to flat_bottleneck_smem_bytes by a card test.
template <Flat V>
__host__ __device__ constexpr int rows_per_block() {
  return V == Flat::kHwPad ? 128 : 64;
}

struct Params {
  const int8_t* x;
  int8_t* out;
  const int8_t* w1;  // (P, C)
  const int8_t* w2;  // (9, P, P): [tap][out][in]
  const int8_t* w3;  // (C, P)
  const float *a1, *b1, *a2, *b2, *a3, *b3, *sid;
  int total;       // flat rows: N * frame
  int frame;       // rows a frame, pads included (HWP)
  int real;        // real rows a frame (H * W)
  int W, C, P;
};

template <Flat V>
size_t smem_bytes(int w, int p) {
  constexpr int kRB = rows_per_block<V>();
  size_t bytes = ((size_t)(kRB + 2 * (w + 1) + 1) + kRB) * (p + kPad);  // q1 tile + zero row, q2
  if (V == Flat::kIm2col) bytes += (size_t)kRB * (9 * p + kPad);
  return bytes;
}

// At most 128 registers a thread, so that two blocks fit an SM's register
// file where their shared memory does (hwpad), as K2's do.
template <Flat V>
__global__ void __launch_bounds__(kThreads, 2) flat_bottleneck_kernel(Params p) {
  constexpr int kRB = rows_per_block<V>();
  extern __shared__ __align__(16) int8_t smem[];
  const int W = p.W, C = p.C, P = p.P, off = W + 1;
  const int ps = P + kPad;              // bytes per row of the q1 tile and q2
  const int tile_rows = kRB + 2 * off;  // q1 rows, halo included
  const int zrow = tile_rows;           // a row of zeros: what a masked tap reads
  int8_t* q1 = smem;
  int8_t* q2 = q1 + (size_t)(tile_rows + 1) * ps;
  int8_t* patch = q2 + (size_t)kRB * ps;  // im2col only
  const int pps = 9 * P + kPad;           // bytes per patch row

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = blockIdx.x * kRB;         // first flat output row of the block
  const int M = min(kRB, p.total - m0);    // output rows of the block
  const int ntasks_p = P / (8 * kNT);
  int acc[kMT][kNT][4];

  {  // zeros: halo rows outside the stream, pad rows, the zero row
    int4* z = reinterpret_cast<int4*>(q1);
    const int n16 = (tile_rows + 1) * ps / 16;
    for (int i = threadIdx.x; i < n16; i += kThreads) z[i] = make_int4(0, 0, 0, 0);
  }
  __syncthreads();

  // ---- phase 1: conv1 over the tile rows inside the stream; tile row j is
  // flat row m0 - off + j
  {
    const int j_lo = max(0, off - m0);
    const int j_hi = min(tile_rows, p.total - m0 + off);
    const int8_t* xb = p.x + (size_t)(m0 - off + j_lo) * C;
    const int mtasks = (j_hi - j_lo + 16 * kMT - 1) / (16 * kMT);
    for (int task = warp; task < mtasks * ntasks_p; task += kWarps) {
      const int mbase = (task / ntasks_p) * 16 * kMT;
      const int n0 = (task % ntasks_p) * 8 * kNT;
      int aoff[kMT][2];
#pragma unroll
      for (int i = 0; i < kMT; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          aoff[i][h] = min(mbase + i * 16 + h * 8 + g, j_hi - j_lo - 1) * C + t * 4;
      zero_acc(acc);
      warp_mma<false>(acc, xb, aoff, p.w1 + (size_t)(n0 + g) * C + t * 4, C, C);
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        const int n = n0 + j * 8 + 2 * t;
        const float a0 = p.a1[n], a1 = p.a1[n + 1], b0 = p.b1[n], b1 = p.b1[n + 1];
#pragma unroll
        for (int i = 0; i < kMT; ++i)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int jr = j_lo + mbase + i * 16 + h * 8 + g;  // tile row
            if (jr >= j_hi || (m0 - off + jr) % p.frame >= p.real) continue;  // pad rows stay 0
            int8_t* dst = q1 + (size_t)jr * ps + n;
            dst[0] = fold(acc[i][j][2 * h], a0, b0);
            dst[1] = fold(acc[i][j][2 * h + 1], a1, b1);
          }
      }
    }
  }
  __syncthreads();

  const int mtasks = (M + 16 * kMT - 1) / (16 * kMT);

  // ---- phase 2: the 3x3 over the q1 tile into q2
  if constexpr (V == Flat::kIm2col) {  // the masked shifted rows into the patch
    const int chunks = P / 16;         // 16-byte pieces of a row
    for (int idx = threadIdx.x; idx < M * 9 * chunks; idx += kThreads) {
      const int m = idx / (9 * chunks), rem = idx - m * 9 * chunks;
      const int tap = rem / chunks, ch = rem - tap * chunks;
      const int ky = tap / 3, kx = tap - ky * 3;
      const int col = ((m0 + m) % p.frame) % W + kx - 1;
      const int src = col >= 0 && col < W ? m + off + (ky - 1) * W + (kx - 1) : zrow;
      *reinterpret_cast<int4*>(patch + (size_t)m * pps + tap * P + ch * 16) =
          *reinterpret_cast<const int4*>(q1 + (size_t)src * ps + ch * 16);
    }
    __syncthreads();
  }
  for (int task = warp; task < mtasks * ntasks_p; task += kWarps) {
    const int mbase = (task / ntasks_p) * 16 * kMT;
    const int n0 = (task % ntasks_p) * 8 * kNT;
    int mrow[kMT][2], col[kMT][2];
#pragma unroll
    for (int i = 0; i < kMT; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mrow[i][h] = min(mbase + i * 16 + h * 8 + g, M - 1);
        col[i][h] = ((m0 + mrow[i][h]) % p.frame) % W;
      }
    zero_acc(acc);
    for (int tap = 0; tap < 9; ++tap) {
      const int ky = tap / 3, kx = tap - ky * 3;
      const int8_t* bbase = p.w2 + (size_t)tap * P * P + (size_t)(n0 + g) * P + t * 4;
      int aoff[kMT][2];
      if constexpr (V == Flat::kIm2col) {
#pragma unroll
        for (int i = 0; i < kMT; ++i)
#pragma unroll
          for (int h = 0; h < 2; ++h) aoff[i][h] = mrow[i][h] * pps + t * 4;
        warp_mma<true>(acc, patch + tap * P, aoff, bbase, P, P);
      } else {
#pragma unroll
        for (int i = 0; i < kMT; ++i)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int c = col[i][h] + kx - 1;
            const int src = c >= 0 && c < W ? mrow[i][h] + off + (ky - 1) * W + (kx - 1) : zrow;
            aoff[i][h] = src * ps + t * 4;
          }
        warp_mma<true>(acc, q1, aoff, bbase, P, P);
      }
    }
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      const int n = n0 + j * 8 + 2 * t;
      const float a0 = p.a2[n], a1 = p.a2[n + 1], b0 = p.b2[n], b1 = p.b2[n + 1];
#pragma unroll
      for (int i = 0; i < kMT; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = mbase + i * 16 + h * 8 + g;
          if (m >= M) continue;
          int8_t* dst = q2 + (size_t)m * ps + n;
          dst[0] = fold(acc[i][j][2 * h], a0, b0);
          dst[1] = fold(acc[i][j][2 * h + 1], a1, b1);
        }
    }
  }
  __syncthreads();

  // ---- phase 3: conv3 + residual + requant, pad rows written 0
  const int ntasks_c = C / (8 * kNT);
  const float sid = *p.sid;
  for (int task = warp; task < mtasks * ntasks_c; task += kWarps) {
    const int mbase = (task / ntasks_c) * 16 * kMT;
    const int n0 = (task % ntasks_c) * 8 * kNT;
    int aoff[kMT][2];
#pragma unroll
    for (int i = 0; i < kMT; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        aoff[i][h] = min(mbase + i * 16 + h * 8 + g, M - 1) * ps + t * 4;
    zero_acc(acc);
    warp_mma<true>(acc, q2, aoff, p.w3 + (size_t)(n0 + g) * P + t * 4, P, P);
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      const int n = n0 + j * 8 + 2 * t;
      const float a0 = p.a3[n], a1 = p.a3[n + 1], b0 = p.b3[n], b1 = p.b3[n + 1];
#pragma unroll
      for (int i = 0; i < kMT; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = mbase + i * 16 + h * 8 + g;
          if (m >= M) continue;
          const size_t at = (size_t)(m0 + m) * C + n;
          char2 o = make_char2(0, 0);
          if ((m0 + m) % p.frame < p.real) {
            const char2 xv = *reinterpret_cast<const char2*>(p.x + at);
            o.x = requant(__fadd_rn(__fadd_rn(__fmul_rn((float)acc[i][j][2 * h], a0), b0),
                                    __fmul_rn((float)xv.x, sid)));
            o.y = requant(__fadd_rn(__fadd_rn(__fmul_rn((float)acc[i][j][2 * h + 1], a1), b1),
                                    __fmul_rn((float)xv.y, sid)));
          }
          *reinterpret_cast<char2*>(p.out + at) = o;
        }
    }
  }
}

template <Flat V>
int launch(const void* x, void* out, const void* w1, const void* w2, const void* w3,
           const void* a1, const void* b1, const void* a2, const void* b2, const void* a3,
           const void* b3, const void* sid, int n, int frame, int h, int w, int c, int p,
           void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  if (c % 64 || p % 64 || h <= 0 || w <= 0 || frame - h * w < w + 1 ||
      (long long)n * frame > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  Params prm;
  prm.x = static_cast<const int8_t*>(x);
  prm.out = static_cast<int8_t*>(out);
  prm.w1 = static_cast<const int8_t*>(w1);
  prm.w2 = static_cast<const int8_t*>(w2);
  prm.w3 = static_cast<const int8_t*>(w3);
  prm.a1 = static_cast<const float*>(a1);
  prm.b1 = static_cast<const float*>(b1);
  prm.a2 = static_cast<const float*>(a2);
  prm.b2 = static_cast<const float*>(b2);
  prm.a3 = static_cast<const float*>(a3);
  prm.b3 = static_cast<const float*>(b3);
  prm.sid = static_cast<const float*>(sid);
  prm.total = n * frame;
  prm.frame = frame;
  prm.real = h * w;
  prm.W = w;
  prm.C = c;
  prm.P = p;
  const size_t smem = smem_bytes<V>(w, p);
  cudaError_t err = cudaFuncSetAttribute(
      flat_bottleneck_kernel<V>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  constexpr int kRB = rows_per_block<V>();
  const int blocks = (prm.total + kRB - 1) / kRB;
  flat_bottleneck_kernel<V><<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(prm);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points (loaded with ctypes), one per variant: x and out
// (n, frame, c) int8 with h * w real rows a frame, weights and folds as K2's.
// Each launches on `stream`, does not synchronise, allocates nothing;
// returns cudaGetLastError() of the launch, or cudaErrorInvalidValue for a
// shape the kernel does not take (channels not multiples of 64, fewer than
// w + 1 pad rows a frame).
#define FLAT_BOTTLENECK_ENTRY(name, variant)                                                    \
  extern "C" int name(const void* x, void* out, const void* w1, const void* w2, const void* w3, \
                      const void* a1, const void* b1, const void* a2, const void* b2,           \
                      const void* a3, const void* b3, const void* sid, int n, int frame, int h, \
                      int w, int c, int p, void* stream) {                                      \
    return launch<variant>(x, out, w1, w2, w3, a1, b1, a2, b2, a3, b3, sid, n, frame, h, w, c, \
                           p, stream);                                                          \
  }
FLAT_BOTTLENECK_ENTRY(flat_bottleneck_hwpad_s8, Flat::kHwPad)
FLAT_BOTTLENECK_ENTRY(flat_bottleneck_im2col_s8, Flat::kIm2col)

// Shared memory of one block of the variant (im2col != 0: im2col, else
// hwpad) at width w with p mid channels: what the wrapper's
// flat_smem_bytes must count.
extern "C" long long flat_bottleneck_smem_bytes(int im2col, int w, int p) {
  return (long long)(im2col ? smem_bytes<Flat::kIm2col>(w, p) : smem_bytes<Flat::kHwPad>(w, p));
}
