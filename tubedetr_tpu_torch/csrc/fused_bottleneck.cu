// K2: one whole int8 stride-1 ResNet bottleneck per launch, on Hopper.
//
// Replaces the TPU kernel tubedetr_tpu/ops/fused_bottleneck.py `_make_kernel`
// -> `kernel` (reached through `_fused_block_call` and
// `fused_bottleneck_block`). On the int8 NHWC stream x (N, H, W, C) with
// P = C/4 mid channels it computes
//     q1  = clip(rint(relu(conv1(x)  * a1 + b1)), 0, 127)           1x1, C -> P
//     q2  = clip(rint(relu(conv2(q1) * a2 + b2)), 0, 127)           3x3, dilation d, zero border
//     out = clip(rint(relu(conv3(q2) * a3 + b3 + x * sid)), 0, 127) 1x1, P -> C
// with s8 x s8 -> s32 products and f32 epilogues. The host folds the
// FrozenBN scale/shift and the calibrated scales into a1..b3 and sid.
//
// Bound, at the ResNet-101 stage shapes at 352x608 and N = 400: the int8
// work is 2*N*H*W*(C*P + 9*P*P + P*C) operations, against 2*N*H*W*C bytes of
// stream plus the weights. At 1979 TOP/s and 3.35 TB/s layer1 and layer2 are
// bound by bytes, layer3 and layer4 by operations (about 0.4-0.8 ms each).
//
// Design: the Pallas kernel holds two whole frames in VMEM; that does not
// fit an SM, so here one block computes one band of R = 2 output rows of one
// frame and keeps every intermediate in shared memory:
//   phase 1  conv1 over the band plus a halo of d rows (the halo is
//            recomputed by the neighbouring bands: (R+2d)/R times the conv1
//            work) into a zero-bordered (R+2d, W+2d, P) int8 tile, so the
//            3x3 needs no column mask; rows outside the frame stay 0, as
//            the reference pads q1 with zeros;
//   phase 2  the 9 dilated taps out of that tile into q2 (R, W, P);
//   phase 3  conv3, the residual read of x and the int8 store.
// Products are warp-level tensor-core tiles, mma.sync m16n8k32 s8: each warp
// task is 32 pixels x 64 output channels, with A (pixels, reduction
// contiguous) from global memory or shared memory and B (weights laid out
// output channel first) from global memory through L1/L2. Each pixel row in
// shared memory is padded by 16 bytes so the 8 rows a fragment load touches
// fall in distinct banks. This is the simple version: no TMA, no wgmma, no
// weight staging; that is the later redesign's work.
//
// Arithmetic: epilogues use __fmul_rn / __fadd_rn (no FMA contraction) in the
// reference's order, (acc*a + b) [+ x*sid], then relu, rintf (ties to even,
// as jnp.round / torch.round), clamp to [0, 127]: given the same folds the
// output equals the plain PyTorch version bit for bit.

#include "mma_tiles.cuh"

namespace {

constexpr int kPad = 16;  // bytes of padding per pixel row in shared memory
constexpr int kR = 2;     // output rows per block (the last band of an odd H has 1)

// Which parts of the block run. kFull is K2. The other two are the probes of
// scripts/probe_fused_variants.py (`run`, P4), K2 with one part switched off:
//   kNoShift   conv1 over the band only (no halo rows), and the 9 taps all
//              read the centre pixel of the q1 tile: the 3x3's work without
//              its shifted reads and halo;
//   kConvOnly  q2 = q1, no conv2: conv1 + conv3 alone.
// The probe's `dot2d` variant split a 3D dot into per-frame 2D dots, a
// question of how Mosaic lowers the code; here every block is already a band
// of one frame, so `dot2d` runs kFull. Its F (frames per grid step) has no
// counterpart either: a block is a band of one frame whatever F is.
enum class Variant { kFull, kNoShift, kConvOnly };

struct Params {
  const int8_t* x;
  int8_t* out;
  const int8_t* w1;  // (P, C)
  const int8_t* w2;  // (9, P, P)
  const int8_t* w3;  // (C, P)
  const float *a1, *b1, *a2, *b2, *a3, *b3, *sid;
  int H, W, C, P, d;
};

template <Variant V>
__global__ void __launch_bounds__(kThreads) fused_bottleneck_kernel(Params p) {
  extern __shared__ __align__(16) int8_t smem[];
  const int H = p.H, W = p.W, C = p.C, P = p.P, d = p.d;
  const int frame = blockIdx.y;
  const int r0 = blockIdx.x * kR;     // first output row of the band
  const int rows = min(kR, H - r0);   // output rows of this band
  const int hr = rows + 2 * d;        // q1 rows, halo included
  const int tw = W + 2 * d;           // q1 tile width, zero border included
  const int ps = P + kPad;            // bytes per pixel row in shared memory
  int8_t* q1 = smem;                                    // (kR + 2d) x tw pixels
  int8_t* q2 = smem + (size_t)(kR + 2 * d) * tw * ps;   // kR x W pixels

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int8_t* xf = p.x + (size_t)frame * H * W * C;
  const int ntasks_p = P / (8 * kNT);
  int acc[kMT][kNT][4];

  if constexpr (V == Variant::kFull) {  // the zero border, and the halo rows outside the frame
    int4* z = reinterpret_cast<int4*>(q1);
    const int n16 = hr * tw * ps / 16;
    for (int i = threadIdx.x; i < n16; i += kThreads) z[i] = make_int4(0, 0, 0, 0);
    __syncthreads();
  }

  // ---- phase 1: conv1 over the in-frame rows of the band plus halo (the
  // probe variants: the band's rows only)
  {
    const bool full = V == Variant::kFull;
    const int m_lo = full ? max(0, d - r0) * W : d * W;          // tile rows before the frame's top
    const int m_hi = full ? min(hr, H - r0 + d) * W : (d + rows) * W;  // ... and past its bottom
    const int mtasks = (m_hi - m_lo + 16 * kMT - 1) / (16 * kMT);
    for (int task = warp; task < mtasks * ntasks_p; task += kWarps) {
      const int mbase = m_lo + (task / ntasks_p) * 16 * kMT;
      const int n0 = (task % ntasks_p) * 8 * kNT;
      int aoff[kMT][2];
#pragma unroll
      for (int i = 0; i < kMT; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = min(mbase + i * 16 + h * 8 + g, m_hi - 1);
          const int rr = m / W, col = m - rr * W;
          aoff[i][h] = ((r0 - d + rr) * W + col) * C + t * 4;
        }
      zero_acc(acc);
      warp_mma<false>(acc, xf, aoff, p.w1 + (size_t)(n0 + g) * C + t * 4, C, C);
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        const int n = n0 + j * 8 + 2 * t;
        const float a0 = p.a1[n], a1 = p.a1[n + 1], b0 = p.b1[n], b1 = p.b1[n + 1];
#pragma unroll
        for (int i = 0; i < kMT; ++i)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int m = mbase + i * 16 + h * 8 + g;
            if (m >= m_hi) continue;
            const int rr = m / W, col = m - rr * W;
            int8_t* dst = V == Variant::kConvOnly ? q2 + (size_t)(m - m_lo) * ps + n
                                                  : q1 + ((size_t)rr * tw + col + d) * ps + n;
            dst[0] = fold(acc[i][j][2 * h], a0, b0);
            dst[1] = fold(acc[i][j][2 * h + 1], a1, b1);
          }
      }
    }
  }
  __syncthreads();

  const int M = rows * W;  // output pixels of the band
  const int mtasks = (M + 16 * kMT - 1) / (16 * kMT);

  // ---- phase 2: the 3x3 (dilation d) as 9 taps over the q1 tile (kNoShift:
  // 9 reads of the centre; kConvOnly: none, q2 = q1)
  for (int task = warp; V != Variant::kConvOnly && task < mtasks * ntasks_p; task += kWarps) {
    const int mbase = (task / ntasks_p) * 16 * kMT;
    const int n0 = (task % ntasks_p) * 8 * kNT;
    int aoff[kMT][2];
#pragma unroll
    for (int i = 0; i < kMT; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = min(mbase + i * 16 + h * 8 + g, M - 1);
        const int rr = m / W, col = m - rr * W;
        aoff[i][h] = (rr * tw + col) * ps + t * 4;  // tap (0, 0): tile row rr, col
      }
    zero_acc(acc);
    for (int tap = 0; tap < 9; ++tap) {
      const int ky = tap / 3, kx = tap - ky * 3;
      const int8_t* abase = V == Variant::kNoShift ? q1 + (d * tw + d) * ps
                                                   : q1 + (ky * d * tw + kx * d) * ps;
      const int8_t* bbase = p.w2 + (size_t)tap * P * P + (size_t)(n0 + g) * P + t * 4;
      warp_mma<true>(acc, abase, aoff, bbase, P, P);
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
  if constexpr (V != Variant::kConvOnly) __syncthreads();

  // ---- phase 3: conv3 + residual + requant, straight to global memory
  const int ntasks_c = C / (8 * kNT);
  const float sid = *p.sid;
  const size_t band = ((size_t)frame * H + r0) * W;  // first pixel of the band
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
          const size_t at = (band + m) * C + n;
          const char2 xv = *reinterpret_cast<const char2*>(p.x + at);
          const float y0 = __fadd_rn(__fadd_rn(__fmul_rn((float)acc[i][j][2 * h], a0), b0),
                                     __fmul_rn((float)xv.x, sid));
          const float y1 = __fadd_rn(__fadd_rn(__fmul_rn((float)acc[i][j][2 * h + 1], a1), b1),
                                     __fmul_rn((float)xv.y, sid));
          char2 o;
          o.x = requant(y0);
          o.y = requant(y1);
          *reinterpret_cast<char2*>(p.out + at) = o;
        }
    }
  }
}

// Dynamic shared memory of one block: the zero-bordered q1 tile of kR + 2d
// rows and the q2 tile of kR rows, each pixel row padded by kPad bytes.
size_t smem_bytes(int w, int p, int d) {
  return ((size_t)(kR + 2 * d) * (w + 2 * d) + (size_t)kR * w) * ((size_t)p + kPad);
}

// Launches the kernel of variant V (see the C entry points below).
template <Variant V>
int launch(const void* x, void* out, const void* w1, const void* w2, const void* w3,
           const void* a1, const void* b1, const void* a2, const void* b2,
           const void* a3, const void* b3, const void* sid,
           int n, int h, int w, int c, int p, int d, void* stream) {
  if (n <= 0 || h <= 0 || w <= 0) return (int)cudaSuccess;
  if (c % 64 || p % 64 || d < 1 || n > 65535) return (int)cudaErrorInvalidValue;
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
  prm.H = h;
  prm.W = w;
  prm.C = c;
  prm.P = p;
  prm.d = d;
  const size_t smem = smem_bytes(w, p, d);
  cudaError_t err = cudaFuncSetAttribute(
      fused_bottleneck_kernel<V>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((h + kR - 1) / kR, n);
  fused_bottleneck_kernel<V><<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(prm);
  return (int)cudaGetLastError();
}

}  // namespace

// Blocks of K2 resident on one SM for a band of width w with p mid
// channels at dilation d (cudaOccupancyMaxActiveBlocksPerMultiprocessor), or
// -1 on an error.
extern "C" int fused_bottleneck_blocks_per_sm(int w, int p, int d) {
  const size_t smem = smem_bytes(w, p, d);
  const auto kernel = fused_bottleneck_kernel<Variant::kFull>;
  int blocks = 0;
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem) !=
          cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, kThreads, smem) !=
          cudaSuccess)
    return -1;
  return blocks;
}

// Plain C entry points (loaded with ctypes), one per variant, all with the
// same arguments. Each launches on `stream`, does not synchronise, allocates
// nothing; returns cudaGetLastError() of the launch, or cudaErrorInvalidValue
// for a shape the kernel does not take. fused_bottleneck_s8 is K2.
#define FUSED_BOTTLENECK_ENTRY(name, variant)                                                   \
  extern "C" int name(const void* x, void* out, const void* w1, const void* w2, const void* w3, \
                      const void* a1, const void* b1, const void* a2, const void* b2,           \
                      const void* a3, const void* b3, const void* sid, int n, int h, int w,     \
                      int c, int p, int d, void* stream) {                                      \
    return launch<variant>(x, out, w1, w2, w3, a1, b1, a2, b2, a3, b3, sid, n, h, w, c, p, d,  \
                           stream);                                                             \
  }
FUSED_BOTTLENECK_ENTRY(fused_bottleneck_s8, Variant::kFull)
FUSED_BOTTLENECK_ENTRY(fused_bottleneck_noshift_s8, Variant::kNoShift)
FUSED_BOTTLENECK_ENTRY(fused_bottleneck_convonly_s8, Variant::kConvOnly)
