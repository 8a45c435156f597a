// G1: grouped s8 x s8 convolution, NHWC, with the int8 fold in its epilogue,
// on Hopper.
//
// Replaces no TPU kernel. The JAX package computes the grouped int8
// convolutions of its timm trunks (every depthwise `conv_dw` of an int8
// EfficientNet, every grouped 3x3 `conv2` of an int8 RegNet) with XLA's
// conv_general_dilated(int8, int8, preferred_element_type=int32,
// feature_group_count=g) in tubedetr_tpu/models/resnet.py `BottleneckConv`,
// outside any Pallas kernel, and folds its scales after it. PyTorch has no
// int8 grouped convolution, and torch._int_mm (cuBLASLt) wants K and N in
// multiples of 8 and more than 16 rows, which a depthwise group (N = 1) is
// not: so this kernel is written here (cuDNN's float32 grouped conv on the
// same integers is exact at the timm shapes and is its yardstick). It
// computes, bit for bit, the conv and the fold of models/resnet.py
// `_qforward`:
//     acc[n, y, x, o] = sum_{ky, kx, ci} in[n, y*s - p + ky, x*s - p + kx, g*I + ci]
//                                        * w[o, (ky*k + kx)*I + ci]
//     out[n, y, x, o] = dtype(float32(acc) * scale[o])       (round to nearest)
// with g = o / (O / groups), I = C / groups input channels a group, zero
// padding p = k / 2 and stride s; the weights are (O, k*k*I) int8, taps in
// (ky, kx, ci) order (models/resnet.py `_int8_weight`); scale is the (O,)
// float32 sx * sw; dtype is bfloat16 or float32. |acc| <= k*k*I * 127^2 stays
// below 2^24, so float32(acc) is exact; the product is one __fmul_rn (no
// contraction) and the bfloat16 store rounds to nearest even, as torch does.
//
// Three paths, chosen by the launcher from the shape (grouped_conv_s8_path):
//
// 1. Depthwise (I = 1, k 3 or 5, stride 1 or 2: EfficientNet's conv_dw).
//    Bound: memory. An output costs k*k multiply-adds against 1 byte in and 2
//    or 4 bytes out. A block takes 4 output rows x 8*TX columns x 32 channels
//    of one frame. It stages the input halo tile, ((4-1)*s + k) rows x
//    ((8*TX-1)*s + k) columns x 32 channels, into shared memory with 16-byte
//    cp.async copies (16 channels of one pixel; the frame's border and
//    channels past C zero-filled by the copy), and its 32 channels' k*k
//    weights and scales as float32. A thread owns 4 consecutive channels and
//    8 consecutive output pixels along x: for each tap row it reads each input
//    word (4 channels) of its window from shared memory once and adds it into
//    every output of its 8 that takes it (k and s are template parameters,
//    so the tap loops unroll and the sliding window is resolved at compile
//    time). Products and sums are exact in float32 (|acc| < 2^24), so the
//    multiply-adds run on the float pipe (FFMA, twice the IMAD rate); a byte
//    becomes a float by one byte permute into the mantissa of 1.5 * 2^23 and
//    one subtract. Row pitches are chosen so that the 4 tile rows a warp
//    reads fall on distinct banks. The epilogue folds and stores 4 channels
//    a pixel: 8 bytes (bfloat16) or 16 (float32) a thread.
// 2. Grouped (I % 4 == 0 and O / groups in 8, 16, 24, 32, 48, 64: RegNet's
//    3x3 conv2, I = 8-48). Each group is a small GEMM, (pixels x k*k*I) .
//    (k*k*I x I), 144 multiply-adds an output at I = 16: on the CUDA cores
//    (__dp4a) that caps it near its bytes bound, so it runs on the tensor
//    cores with mma.sync.m16n8k32 s8 x s8 -> s32. A block holds G whole
//    groups (up to 64 channels): it stages their weights once, straight into
//    the B-fragment order of mma.sync, K zero-padded to a multiple of 32 on
//    the way (the padding is this kernel's own: the weights in device memory
//    stay (O, k*k*I)). Then it walks tiles of output pixels (up to 64
//    columns, rows to make about 256 pixels) of those groups over the
//    frames: the next tile's input halo streams into the second of two
//    shared-memory buffers with cp.async (16-byte copies where the widths
//    allow, else 8 or 4) while this one computes. The grid is one wave of
//    resident blocks. A warp takes (32 pixels, one group) items: A fragments
//    are gathered from the halo tile through a table of tap offsets, an
//    implicit im2col that never reaches device memory; each B fragment feeds
//    both 16-pixel tiles' mma's, O/groups/8 of them a tile and k-step. The
//    epilogue folds each fragment into a shared-memory tile, which the block
//    writes out with 16-byte stores.
// 3. General (any other shape the launcher takes: odd widths, other k): a
//    thread an output element, __dp4a on 4 channels where I % 4 == 0, the
//    same fold. No timm trunk runs it.
//
// A depthwise block's copies are waited for once, then it computes and
// stores: several resident blocks an SM overlap one block's loads with
// another's work.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

enum Path { kGeneral = 0, kDepthwise = 1, kDepthwiseBytes = 2, kGroupedMma = 3 };

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// cp.async of BYTES (4, 8 or 16) bytes; a copy that is not `valid` writes zeros
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src, bool valid) {
  const int n = valid ? BYTES : 0;
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
                 "l"(src), "r"(n));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(smem_addr(dst)),
                 "l"(src), "n"(BYTES), "r"(n));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's committed copy groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ float fold(float acc, float s) { return __fmul_rn(acc, s); }

__device__ __forceinline__ unsigned pack_bf16(float a, float b) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(a, b);  // each rounded to nearest even
  return *reinterpret_cast<const unsigned*>(&v);
}

// ---------------------------------------------------------------- depthwise

constexpr int kCB = 32;  // channels a depthwise block stages: one 32-byte sector a pixel
constexpr int kTH = 4;   // output rows of a depthwise tile (a warp's 4 lane rows)
constexpr int kPX = 8;   // output pixels a thread, along x
constexpr int kMaxTX = 8;

struct DwArgs {
  const int8_t* in;
  const int8_t* w;
  const float* scale;
  void* out;
  int h, wd, c, ho, wo;
  int tx;                        // warps a block: columns 8 * tx
  int slices, tiles_x, tiles_y;  // blocks = slices * tiles_x * tiles_y * n
  int pitch;                     // bytes a staged row
};

// float of the signed byte `i` of `u ^ 0x80808080`: 1.5 * 2^23 + (b + 128) - (1.5 * 2^23 + 128)
__device__ __forceinline__ float byte_to_float(unsigned u, int i) {
  return __int_as_float(__byte_perm(u, 0x4B400000u, 0x7650 + i)) - 12583040.0f;
}

template <int K, int S, bool VEC, bool BF16>
__global__ void __launch_bounds__(32 * kMaxTX) dw_kernel(DwArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* wsm = reinterpret_cast<float*>(smem);  // [K*K][kCB]
  float* ssm = wsm + K * K * kCB;               // [kCB]
  unsigned char* tile = smem + (K * K * kCB + kCB) * 4;
  constexpr int R = (kTH - 1) * S + K;
  const int tw = kPX * a.tx, wt = (tw - 1) * S + K;
  int b = blockIdx.x;
  const int slice = b % a.slices;
  b /= a.slices;
  const int txi = b % a.tiles_x;
  b /= a.tiles_x;
  const int tyi = b % a.tiles_y;
  const int n = b / a.tiles_y;
  const int c0 = slice * kCB, oy0 = tyi * kTH, ox0 = txi * tw;
  const int iy0 = oy0 * S - K / 2, ix0 = ox0 * S - K / 2;
  const int8_t* frame = a.in + (size_t)n * a.h * a.wd * a.c;

  if (VEC) {  // 16 channels of one pixel a copy
    const int chunks = R * wt * 2;
    for (int q = threadIdx.x; q < chunks; q += blockDim.x) {
      const int r = q / (wt * 2), rem = q - r * wt * 2, cx = rem >> 1, half = rem & 1;
      const int y = iy0 + r, x = ix0 + cx, cc = c0 + half * 16;
      const bool ok = y >= 0 && y < a.h && x >= 0 && x < a.wd && cc < a.c;
      const int8_t* src = ok ? frame + ((size_t)y * a.wd + x) * a.c + cc : a.in;
      cp_async<16>(tile + r * a.pitch + cx * kCB + half * 16, src, ok);
    }
  } else {  // channels that are not a multiple of 16, or a misaligned base: bytes
    const int bytes = R * wt * kCB;
    for (int q = threadIdx.x; q < bytes; q += blockDim.x) {
      const int r = q / (wt * kCB), rem = q - r * wt * kCB, cx = rem / kCB, ch = rem % kCB;
      const int y = iy0 + r, x = ix0 + cx, cc = c0 + ch;
      const bool ok = y >= 0 && y < a.h && x >= 0 && x < a.wd && cc < a.c;
      tile[r * a.pitch + cx * kCB + ch] =
          ok ? static_cast<unsigned char>(frame[((size_t)y * a.wd + x) * a.c + cc]) : 0;
    }
  }
  for (int q = threadIdx.x; q < K * K * kCB; q += blockDim.x) {
    const int tap = q / kCB, cc = c0 + q % kCB;
    wsm[q] = cc < a.c ? static_cast<float>(a.w[(size_t)cc * K * K + tap]) : 0.0f;
  }
  for (int q = threadIdx.x; q < kCB; q += blockDim.x)
    ssm[q] = c0 + q < a.c ? a.scale[c0 + q] : 0.0f;
  cp_async_wait_all();
  __syncthreads();

  const int lane = threadIdx.x & 31, ct = lane & 7, ty = lane >> 3, tx = threadIdx.x >> 5;
  const int oy = oy0 + ty, ox = ox0 + tx * kPX, cc = c0 + ct * 4;
  if (oy >= a.ho || ox >= a.wo || cc >= a.c) return;  // no barrier follows

  float acc[kPX][4];
#pragma unroll
  for (int p = 0; p < kPX; ++p)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[p][i] = 0.0f;
  const unsigned char* base = tile + ty * S * a.pitch + tx * kPX * S * kCB + ct * 4;
  const float4* w4 = reinterpret_cast<const float4*>(wsm);
#pragma unroll
  for (int ky = 0; ky < K; ++ky) {
    float4 wk[K];
#pragma unroll
    for (int kx = 0; kx < K; ++kx) wk[kx] = w4[(ky * K + kx) * (kCB / 4) + ct];
    const unsigned char* row = base + ky * a.pitch;
#pragma unroll
    for (int j = 0; j < (kPX - 1) * S + K; ++j) {
      const unsigned u = *reinterpret_cast<const unsigned*>(row + j * kCB) ^ 0x80808080u;
      const float v0 = byte_to_float(u, 0), v1 = byte_to_float(u, 1);
      const float v2 = byte_to_float(u, 2), v3 = byte_to_float(u, 3);
#pragma unroll
      for (int p = 0; p < kPX; ++p) {
        const int kx = j - p * S;
        if (kx >= 0 && kx < K) {
          acc[p][0] = fmaf(v0, wk[kx].x, acc[p][0]);
          acc[p][1] = fmaf(v1, wk[kx].y, acc[p][1]);
          acc[p][2] = fmaf(v2, wk[kx].z, acc[p][2]);
          acc[p][3] = fmaf(v3, wk[kx].w, acc[p][3]);
        }
      }
    }
  }

  const float s0 = ssm[ct * 4], s1 = ssm[ct * 4 + 1], s2 = ssm[ct * 4 + 2], s3 = ssm[ct * 4 + 3];
  const size_t row0 = ((size_t)n * a.ho + oy) * a.wo + ox;
#pragma unroll
  for (int p = 0; p < kPX; ++p) {
    if (ox + p >= a.wo) break;
    const float f0 = fold(acc[p][0], s0), f1 = fold(acc[p][1], s1);
    const float f2 = fold(acc[p][2], s2), f3 = fold(acc[p][3], s3);
    const size_t at = (row0 + p) * a.c + cc;
    if (VEC) {  // C % 16 == 0: 4 channels are in range and aligned
      if (BF16)
        *reinterpret_cast<uint2*>(static_cast<__nv_bfloat16*>(a.out) + at) =
            make_uint2(pack_bf16(f0, f1), pack_bf16(f2, f3));
      else
        *reinterpret_cast<float4*>(static_cast<float*>(a.out) + at) = make_float4(f0, f1, f2, f3);
    } else {
      const float f[4] = {f0, f1, f2, f3};
      for (int i = 0; i < 4 && cc + i < a.c; ++i) {
        if (BF16)
          static_cast<__nv_bfloat16*>(a.out)[at + i] = __float2bfloat16_rn(f[i]);
        else
          static_cast<float*>(a.out)[at + i] = f[i];
      }
    }
  }
}

// ----------------------------------------------------------- grouped (mma)

constexpr int kMmaThreads = 128;

struct GArgs {
  const int8_t* in;
  const int8_t* w;
  const float* scale;
  void* out;
  int h, wd, c, o, ho, wo, k, s, ig, og;
  int g;              // groups a block
  int th, tw;         // output tile
  int ps, pitch;      // staged bytes a pixel (g * ig, padded for banks), a row
  int chunk;          // bytes a cp.async (16, 8 or 4)
  int gblocks, tiles_x, tiles_y;
  int tiles;          // tiles a group block walks: tiles_x * tiles_y * frames
  int walkers;        // blocks a group block: block b walks tiles b, b + walkers, ...
  int ks, mt;         // k-steps of 32, m16 tiles
  int os;             // bytes a row of the output tile
  int off_koff, off_poff, off_scale, off_tile, off_tile2, off_otile;  // shared-memory layout
  int ldm;            // A fragments by ldmatrix (I % 16 == 0: a 16-byte K piece is one tap's)
};

__device__ __forceinline__ void mma_s8(int (&d)[4], unsigned a0, unsigned a1, unsigned a2,
                                       unsigned a3, unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// four 8x8 b16 matrices from shared memory: lanes 8j..8j+7 give the 16-byte
// rows of matrix j, which lands in r[j] (the A fragment of an s8 m16n8k32)
__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(row)));
}

// the halo tile's pixels (rows x wt) of `bytes` channels each, CH bytes a
// copy: thread i takes copy i % per_px of pixels i / per_px, i / per_px +
// step, ... (no division in the loop: the pixel's row and column advance)
template <int CH>
__device__ __forceinline__ void stage_tile(const GArgs& a, unsigned char* tile, const int8_t* frame,
                                           int iy0, int ix0, int cbase, int rows, int wt) {
  const int per_px = a.g * a.ig / CH, step = blockDim.x / per_px;
  const int ci = threadIdx.x % per_px;
  int px = threadIdx.x / per_px;
  if (px >= step) return;  // the threads past a whole number of pixels
  int r = px / wt, cx = px - r * wt;
  const int dr = step / wt, dcx = step - dr * wt;
  for (; r < rows; r += dr, cx += dcx) {
    if (cx >= wt) cx -= wt, ++r;
    if (r >= rows) break;
    const int y = iy0 + r, x = ix0 + cx;
    const bool ok = y >= 0 && y < a.h && x >= 0 && x < a.wd;
    const int8_t* src = ok ? frame + ((size_t)y * a.wd + x) * a.c + cbase + ci * CH : a.in;
    cp_async<CH>(tile + r * a.pitch + cx * a.ps + ci * CH, src, ok);
  }
}

template <int NT, bool BF16>
__global__ void __launch_bounds__(kMmaThreads) grouped_mma_kernel(GArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint2* bsm = reinterpret_cast<uint2*>(smem);  // [g][ks][NT][32 lanes]: B fragments
  int* koff = reinterpret_cast<int*>(smem + a.off_koff);       // [ks * 8]: tap offsets
  int* poff = reinterpret_cast<int*>(smem + a.off_poff);       // [mt * 16]: pixel offsets
  float* ssm = reinterpret_cast<float*>(smem + a.off_scale);   // [g * og]
  // the halo tiles, in turns: tile i of the walk in buffer i % 2
  auto buffer = [&](int i) { return smem + ((i & 1) ? a.off_tile2 : a.off_tile); };
  unsigned char* otile = smem + a.off_otile;                   // [mt * 16][os]
  const int rows = (a.th - 1) * a.s + a.k, wt = (a.tw - 1) * a.s + a.k, pad = a.k / 2;
  const int gb = blockIdx.x % a.gblocks, walker = blockIdx.x / a.gblocks, g0 = gb * a.g;
  // the halo tile of tile `t` of this group block into `dst`, as one copy group
  auto stage = [&](int t, unsigned char* dst) {
    const int txi = t % a.tiles_x, r = t / a.tiles_x, tyi = r % a.tiles_y, n = r / a.tiles_y;
    const int8_t* frame = a.in + (size_t)n * a.h * a.wd * a.c;
    const int iy0 = tyi * a.th * a.s - pad, ix0 = txi * a.tw * a.s - pad;
    if (a.chunk == 16)
      stage_tile<16>(a, dst, frame, iy0, ix0, g0 * a.ig, rows, wt);
    else if (a.chunk == 8)
      stage_tile<8>(a, dst, frame, iy0, ix0, g0 * a.ig, rows, wt);
    else
      stage_tile<4>(a, dst, frame, iy0, ix0, g0 * a.ig, rows, wt);
    cp_async_commit();
  };
  if (walker < a.tiles) stage(walker, buffer(0));

  // the weights into the B fragments of mma.sync: a warp takes rows
  // (output channels), its lanes 4-byte units of the row's K (zero past the
  // unpadded K); unit u of row n goes to lane 4 * (n % 8) + u % 4 of k-step
  // u / 8, in .x for u % 8 < 4, else .y. Four rows' loads in flight a warp.
  const int kt = a.k * a.k * a.ig;  // the unpadded K of a group
  const int row_units = a.ks * 8, rows_b = a.g * a.og;
  const int wid = threadIdx.x >> 5, lid = threadIdx.x & 31, nw = blockDim.x >> 5;
  for (int r0 = wid * 4; r0 < rows_b; r0 += nw * 4) {
    const int8_t* w0 = a.w + (size_t)(g0 * a.og + r0) * kt;
    for (int u = lid; u < row_units; u += 32) {
      unsigned v[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        v[i] = r0 + i < rows_b && u * 4 < kt
                   ? *reinterpret_cast<const unsigned*>(w0 + (size_t)i * kt + u * 4)
                   : 0u;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (r0 + i >= rows_b) break;
        const int gl = (r0 + i) / a.og, n = r0 + i - gl * a.og;
        unsigned* frag = reinterpret_cast<unsigned*>(
            bsm + ((size_t)(gl * a.ks + (u >> 3)) * NT + (n >> 3)) * 32 + (n & 7) * 4 + (u & 3));
        frag[(u >> 2) & 1] = v[i];
      }
    }
  }
  for (int e = threadIdx.x; e < a.ks * 8; e += blockDim.x) {
    const int kk = e * 4, tap = kk / a.ig, ci = kk - tap * a.ig;
    koff[e] = kk < kt ? (tap / a.k) * a.pitch + (tap % a.k) * a.ps + ci : 0;  // pad: weight 0
  }
  for (int e = threadIdx.x; e < a.g * a.og; e += blockDim.x) ssm[e] = a.scale[g0 * a.og + e];
  for (int e = threadIdx.x; e < a.mt * 16; e += blockDim.x) {
    const int q = min(e, a.th * a.tw - 1);  // rows past the tile: any pixel
    poff[e] = (q / a.tw) * a.s * a.pitch + (q % a.tw) * a.s * a.ps;
  }

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, gr = lane >> 2, t = lane & 3;
  const int pairs = a.mt / 2;
  // the walk: the next tile's copies are in flight while this one computes
  for (int cur = walker, i = 0; cur < a.tiles; cur += a.walkers, ++i) {
    const unsigned char* tile = buffer(i);
    if (cur + a.walkers < a.tiles) {
      stage(cur + a.walkers, buffer(i + 1));  // read by the compute before the last barrier
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // this tile's copies (and, the first time, the tables) are in

    // a warp takes (two m16 tiles, one group) items: each B fragment it
    // loads feeds both tiles' mma's, and the two accumulator chains overlap
    for (int item = warp; item < pairs * a.g; item += kMmaThreads / 32) {
      const int gl = item / pairs, m0 = (item - gl * pairs) * 2;
      // ldmatrix: lane L gives row L % 8 + 8 * (L / 8 % 2) of a tile, K half L / 16;
      // else lane (g, t) reads rows g and g + 8 itself
      const unsigned char* arow[2][2];  // [tile][row g, row g + 8], or [tile][this lane's row]
#pragma unroll
      for (int tt = 0; tt < 2; ++tt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = a.ldm ? (lane & 7) + 8 * ((lane >> 3) & 1) : gr + 8 * h;
          arow[tt][h] = tile + poff[(m0 + tt) * 16 + row] + gl * a.ig;
        }
      int acc[2][NT][4];
#pragma unroll
      for (int tt = 0; tt < 2; ++tt)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[tt][j][e] = 0;
      const uint2* bg = bsm + (size_t)gl * a.ks * NT * 32 + lane;
      for (int step = 0; step < a.ks; ++step) {
        unsigned af[2][4];
        if (a.ldm) {
          const int kh = koff[step * 8 + (lane >> 4) * 4];
#pragma unroll
          for (int tt = 0; tt < 2; ++tt) ldmatrix_x4(af[tt], arow[tt][0] + kh);
        } else {
          const int k0 = koff[step * 8 + t], k1 = koff[step * 8 + 4 + t];
#pragma unroll
          for (int tt = 0; tt < 2; ++tt) {
            af[tt][0] = *reinterpret_cast<const unsigned*>(arow[tt][0] + k0);
            af[tt][1] = *reinterpret_cast<const unsigned*>(arow[tt][1] + k0);
            af[tt][2] = *reinterpret_cast<const unsigned*>(arow[tt][0] + k1);
            af[tt][3] = *reinterpret_cast<const unsigned*>(arow[tt][1] + k1);
          }
        }
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const uint2 bf = bg[(step * NT + j) * 32];
#pragma unroll
          for (int tt = 0; tt < 2; ++tt)
            mma_s8(acc[tt][j], af[tt][0], af[tt][1], af[tt][2], af[tt][3], bf.x, bf.y);
        }
      }
#pragma unroll
      for (int tt = 0; tt < 2; ++tt) {
        const int p_lo = (m0 + tt) * 16 + gr, p_hi = p_lo + 8;
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const int col = gl * a.og + j * 8 + t * 2;
          const float s0 = ssm[col], s1 = ssm[col + 1];
          const float lo0 = fold((float)acc[tt][j][0], s0), lo1 = fold((float)acc[tt][j][1], s1);
          const float hi0 = fold((float)acc[tt][j][2], s0), hi1 = fold((float)acc[tt][j][3], s1);
          if (BF16) {
            *reinterpret_cast<unsigned*>(otile + p_lo * a.os + col * 2) = pack_bf16(lo0, lo1);
            *reinterpret_cast<unsigned*>(otile + p_hi * a.os + col * 2) = pack_bf16(hi0, hi1);
          } else {
            *reinterpret_cast<float2*>(otile + p_lo * a.os + col * 4) = make_float2(lo0, lo1);
            *reinterpret_cast<float2*>(otile + p_hi * a.os + col * 4) = make_float2(hi0, hi1);
          }
        }
      }
    }
    __syncthreads();

    // a pixel's g * og outputs are contiguous: per_px 16-byte stores, lanes
    // over (pixel, store) so a warp writes 32 / per_px pixels at a time
    const int esize = BF16 ? 2 : 4, per_px = a.g * a.og * esize / 16, ppi = 32 / per_px;
    const int sub = lane / per_px, ci = lane - sub * per_px;
    const int txi = cur % a.tiles_x, r = cur / a.tiles_x, tyi = r % a.tiles_y, n = r / a.tiles_y;
    const int oy0 = tyi * a.th, ox0 = txi * a.tw;
    char* out = static_cast<char*>(a.out);
    if (sub < ppi) {
      const int dp = (kMmaThreads / 32) * ppi, dpy = dp / a.tw, dpx = dp - dpy * a.tw;
      int p = warp * ppi + sub, py = p / a.tw, px = p - py * a.tw;
      for (; p < a.th * a.tw; p += dp, py += dpy, px += dpx) {
        if (px >= a.tw) px -= a.tw, ++py;
        const int oy = oy0 + py, ox = ox0 + px;
        if (oy >= a.ho || ox >= a.wo) continue;
        const size_t at = ((((size_t)n * a.ho + oy) * a.wo + ox) * a.o + g0 * a.og) * esize;
        *reinterpret_cast<uint4*>(out + at + ci * 16) =
            *reinterpret_cast<const uint4*>(otile + p * a.os + ci * 16);
      }
    }
  }  // the next tile's first barrier orders these reads of otile before its writes
}

// ------------------------------------------------------------------ general

constexpr int kThreads = 256;

template <int kVec, bool BF16>
__global__ void __launch_bounds__(kThreads) direct_kernel(
    const int8_t* __restrict__ in, const int8_t* __restrict__ w, const float* __restrict__ scale,
    void* __restrict__ out, int h, int wd, int c, int ho, int wo, int o, int k, int stride,
    int pad, int ig, int og) {
  const int row = blockIdx.x;  // n * ho + y
  const int j = blockIdx.y * kThreads + threadIdx.x;  // x * o + oc
  if (j >= wo * o) return;
  const int n = row / ho, y = row - n * ho;
  const int xo = j / o, oc = j - xo * o;
  const int taps = k * k * ig;
  const int8_t* wrow = w + (size_t)oc * taps;
  const int8_t* frame = in + (size_t)n * h * wd * c + (oc / og) * ig;
  const int y0 = y * stride - pad, x0 = xo * stride - pad;
  int acc = 0;
  for (int ky = 0; ky < k; ++ky) {
    const int yi = y0 + ky;
    if (yi < 0 || yi >= h) continue;
    for (int kx = 0; kx < k; ++kx) {
      const int xi = x0 + kx;
      if (xi < 0 || xi >= wd) continue;
      const int8_t* xp = frame + ((size_t)yi * wd + xi) * c;
      const int8_t* wp = wrow + (ky * k + kx) * ig;
      if (kVec == 4) {
        for (int ci = 0; ci < ig; ci += 4)
          acc = __dp4a(*reinterpret_cast<const int*>(xp + ci),
                       *reinterpret_cast<const int*>(wp + ci), acc);
      } else {
        for (int ci = 0; ci < ig; ++ci) acc += int(xp[ci]) * int(wp[ci]);
      }
    }
  }
  const float f = fold((float)acc, scale[oc]);
  const size_t at = (size_t)row * wo * o + j;
  if (BF16)
    static_cast<__nv_bfloat16*>(out)[at] = __float2bfloat16_rn(f);
  else
    static_cast<float*>(out)[at] = f;
}

// ------------------------------------------------------------------ launch

int round_up(int x, int m) { return (x + m - 1) / m * m; }

struct Shape {
  const void *in, *w, *out;
  int n, h, wd, c, o, k, stride, groups, ho, wo;
};

bool aligned(const void* p, int bytes) { return (uintptr_t)p % bytes == 0; }

constexpr int kMmaSmemMax = 227 * 1024;  // what a block can have on the card
int plan_grouped(const Shape& s, int g, int esize, GArgs& a);

int choose_path(const Shape& s) {
  const int ig = s.c / s.groups, og = s.o / s.groups, nt = og / 8;
  if (ig == 1 && og == 1 && (s.k == 3 || s.k == 5))
    return s.c % 16 == 0 && aligned(s.in, 16) && aligned(s.out, 16) ? kDepthwise
                                                                     : kDepthwiseBytes;
  if (ig % 4 == 0 && og % 8 == 0 && (nt <= 4 || nt == 6 || nt == 8) && s.c % 4 == 0 &&
      aligned(s.in, 4) && aligned(s.w, 4) && aligned(s.out, 16)) {
    GArgs a;
    if (plan_grouped(s, 1, 4, a) <= kMmaSmemMax) return kGroupedMma;
  }
  return kGeneral;
}

// the depthwise tile: the widest (at most kMaxTX warps of 8 columns) that
// leaves at most an eighth of the row's 8-column runs idle, else the one
// that leaves fewest
int dw_warps(int wo) {
  const int runs = (wo + kPX - 1) / kPX;
  int best = 1, best_idle = runs;
  for (int tx = kMaxTX < runs ? kMaxTX : runs; tx >= 1; --tx) {
    const int idle = (runs + tx - 1) / tx * tx - runs;
    if (idle * 8 <= runs) return tx;
    if (idle < best_idle) best = tx, best_idle = idle;
  }
  return best;
}

template <int K, int S, bool VEC, bool BF16>
cudaError_t launch_dw(const DwArgs& a, int n, cudaStream_t stream) {
  constexpr int R = (kTH - 1) * S + K;
  const int smem = (K * K * kCB + kCB) * 4 + R * a.pitch;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        dw_kernel<K, S, VEC, BF16>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  const long long blocks = (long long)a.slices * a.tiles_x * a.tiles_y * n;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  dw_kernel<K, S, VEC, BF16><<<(unsigned)blocks, 32 * a.tx, smem, stream>>>(a);
  return cudaGetLastError();
}

template <bool VEC, bool BF16>
cudaError_t dispatch_dw(const DwArgs& a, int k, int stride, int n, cudaStream_t st) {
  if (k == 3) return stride == 1 ? launch_dw<3, 1, VEC, BF16>(a, n, st)
                                 : launch_dw<3, 2, VEC, BF16>(a, n, st);
  return stride == 1 ? launch_dw<5, 1, VEC, BF16>(a, n, st) : launch_dw<5, 2, VEC, BF16>(a, n, st);
}

cudaError_t run_depthwise(const Shape& s, const float* scale, bool vec, bool bf16,
                          cudaStream_t st) {
  DwArgs a;
  a.in = static_cast<const int8_t*>(s.in);
  a.w = static_cast<const int8_t*>(s.w);
  a.scale = scale;
  a.out = const_cast<void*>(s.out);
  a.h = s.h, a.wd = s.wd, a.c = s.c, a.ho = s.ho, a.wo = s.wo;
  a.tx = dw_warps(s.wo);
  a.slices = (s.c + kCB - 1) / kCB;
  a.tiles_x = (s.wo + kPX * a.tx - 1) / (kPX * a.tx);
  a.tiles_y = (s.ho + kTH - 1) / kTH;
  const int wt = (kPX * a.tx - 1) * s.stride + s.k;
  // the 4 rows a warp reads start on distinct 32-byte bank groups:
  // stride * pitch must be an odd multiple of 32 bytes modulo 128
  a.pitch = s.stride == 1 ? kCB * (wt | 1) : kCB * wt + 16;
  if (vec)
    return bf16 ? dispatch_dw<true, true>(a, s.k, s.stride, s.n, st)
                : dispatch_dw<true, false>(a, s.k, s.stride, s.n, st);
  return bf16 ? dispatch_dw<false, true>(a, s.k, s.stride, s.n, st)
              : dispatch_dw<false, false>(a, s.k, s.stride, s.n, st);
}

constexpr int kMmaSmemCap = 72 * 1024;  // three blocks an SM

// `bytes` rounded to an odd number of 16-byte slots where it is a multiple of
// 16: 8 rows that far apart start on distinct banks
int odd16(int bytes) { return bytes % 16 == 0 && (bytes / 16) % 2 == 0 ? bytes + 16 : bytes; }

// the grouped tile and its shared-memory layout for `g` groups a block and
// `esize`-byte outputs; returns the bytes it needs
int plan_grouped(const Shape& s, int g, int esize, GArgs& a) {
  a.g = g;
  a.ig = s.c / s.groups, a.og = s.o / s.groups;
  const int xt = (s.wo + 63) / 64;  // at most 64 columns a tile, balanced
  a.tw = (s.wo + xt - 1) / xt;
  a.tiles_x = (s.wo + a.tw - 1) / a.tw;
  int th = 256 / a.tw > 1 ? 256 / a.tw : 1;  // about 256 pixels
  th = th < s.ho ? th : s.ho;
  a.tiles_y = (s.ho + th - 1) / th;
  a.th = (s.ho + a.tiles_y - 1) / a.tiles_y;
  a.k = s.k, a.s = s.stride;
  const int bytes = g * a.ig;
  a.chunk = bytes % 16 == 0 && s.c % 16 == 0 && aligned(s.in, 16) ? 16
            : bytes % 8 == 0 && s.c % 8 == 0 && aligned(s.in, 8)  ? 8
                                                                  : 4;
  a.ps = odd16(bytes);
  const int rows = (a.th - 1) * s.stride + s.k, wt = (a.tw - 1) * s.stride + s.k;
  a.pitch = wt * a.ps;
  a.ks = (s.k * s.k * a.ig + 31) / 32;
  a.mt = (a.th * a.tw + 31) / 32 * 2;  // m16 tiles, an even number: a warp takes two
  a.os = odd16(g * a.og * esize);
  a.off_koff = g * a.ks * (a.og / 8) * 32 * 8;
  a.off_poff = a.off_koff + a.ks * 8 * 4;
  a.off_scale = a.off_poff + a.mt * 16 * 4;
  a.ldm = a.ig % 16 == 0;
  a.off_tile = round_up(a.off_scale + g * a.og * 4, 16);
  a.off_tile2 = round_up(a.off_tile + rows * a.pitch, 16);
  a.off_otile = round_up(a.off_tile2 + rows * a.pitch, 16);
  return a.off_otile + a.mt * 16 * a.os;
}

// one wave of resident blocks, spread over the group blocks, each walking
// its share of the tiles
template <int NT, bool BF16>
cudaError_t launch_mma(GArgs a, int smem, int n, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        grouped_mma_kernel<NT, BF16>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  int dev = 0, sms = 0, resident = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident, grouped_mma_kernel<NT, BF16>,
                                                        kMmaThreads, smem);
  if (err != cudaSuccess) return err;
  const long long tiles = (long long)a.tiles_x * a.tiles_y * n;
  if (tiles > 0x7fffffffLL || resident < 1) return cudaErrorInvalidValue;
  a.tiles = (int)tiles;
  const long long want = (long long)sms * resident / a.gblocks;
  a.walkers = (int)(want < 1 ? 1 : want < tiles ? want : tiles);
  const long long blocks = (long long)a.gblocks * a.walkers;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  grouped_mma_kernel<NT, BF16><<<(unsigned)blocks, kMmaThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <bool BF16>
cudaError_t dispatch_mma(const GArgs& a, int smem, int n, cudaStream_t st) {
  switch (a.og / 8) {
    case 1: return launch_mma<1, BF16>(a, smem, n, st);
    case 2: return launch_mma<2, BF16>(a, smem, n, st);
    case 3: return launch_mma<3, BF16>(a, smem, n, st);
    case 4: return launch_mma<4, BF16>(a, smem, n, st);
    case 6: return launch_mma<6, BF16>(a, smem, n, st);
    default: return launch_mma<8, BF16>(a, smem, n, st);
  }
}

cudaError_t run_grouped(const Shape& s, const float* scale, bool bf16, cudaStream_t st) {
  GArgs a;
  a.in = static_cast<const int8_t*>(s.in);
  a.w = static_cast<const int8_t*>(s.w);
  a.scale = scale;
  a.out = const_cast<void*>(s.out);
  a.h = s.h, a.wd = s.wd, a.c = s.c, a.o = s.o, a.ho = s.ho, a.wo = s.wo;
  const int width = s.c / s.groups > s.o / s.groups ? s.c / s.groups : s.o / s.groups;
  // the most groups a block (a divisor of groups, at most 64 channels) within the cap
  int smem = 0;
  for (int g = 64 / width > 1 ? 64 / width : 1; g >= 1; --g) {
    if (s.groups % g) continue;
    smem = plan_grouped(s, g, bf16 ? 2 : 4, a);
    if (smem <= kMmaSmemCap) break;
  }
  a.gblocks = s.groups / a.g;
  return bf16 ? dispatch_mma<true>(a, smem, s.n, st) : dispatch_mma<false>(a, smem, s.n, st);
}

cudaError_t run_general(const Shape& s, const float* scale, bool bf16, cudaStream_t st) {
  const long long cols = ((long long)s.wo * s.o + kThreads - 1) / kThreads;
  if (cols > 65535 || (long long)s.n * s.ho > 0x7fffffffLL) return cudaErrorInvalidValue;
  const int ig = s.c / s.groups, og = s.o / s.groups;
  const bool vec = ig % 4 == 0 && aligned(s.in, 4) && aligned(s.w, 4);
  const dim3 grid((unsigned)(s.n * s.ho), (unsigned)cols);
  const int8_t* x = static_cast<const int8_t*>(s.in);
  const int8_t* wt = static_cast<const int8_t*>(s.w);
  void* y = const_cast<void*>(s.out);
  const int pad = s.k / 2;
  if (vec && bf16)
    direct_kernel<4, true><<<grid, kThreads, 0, st>>>(x, wt, scale, y, s.h, s.wd, s.c, s.ho,
                                                      s.wo, s.o, s.k, s.stride, pad, ig, og);
  else if (vec)
    direct_kernel<4, false><<<grid, kThreads, 0, st>>>(x, wt, scale, y, s.h, s.wd, s.c, s.ho,
                                                       s.wo, s.o, s.k, s.stride, pad, ig, og);
  else if (bf16)
    direct_kernel<1, true><<<grid, kThreads, 0, st>>>(x, wt, scale, y, s.h, s.wd, s.c, s.ho,
                                                      s.wo, s.o, s.k, s.stride, pad, ig, og);
  else
    direct_kernel<1, false><<<grid, kThreads, 0, st>>>(x, wt, scale, y, s.h, s.wd, s.c, s.ho,
                                                       s.wo, s.o, s.k, s.stride, pad, ig, og);
  return cudaGetLastError();
}

bool valid_shape(const Shape& s) {
  if (s.groups < 1 || s.c % s.groups || s.o % s.groups || s.k < 1 || s.k % 2 == 0 ||
      (s.stride != 1 && s.stride != 2))
    return false;
  const int pad = s.k / 2;
  return s.ho == (s.h + 2 * pad - s.k) / s.stride + 1 &&
         s.wo == (s.wd + 2 * pad - s.k) / s.stride + 1;
}

}  // namespace

// Which path the launcher takes for a shape (0 general, 1 depthwise, 2
// depthwise with byte staging, 3 grouped on mma.sync), or -1 for a shape it
// refuses. The tests and chip_smoke.py read it; it launches nothing.
extern "C" int grouped_conv_s8_path(const void* in, const void* w, const void* out, int n, int h,
                                    int wd, int c, int o, int k, int stride, int groups, int ho,
                                    int wo) {
  const Shape s{in, w, out, n, h, wd, c, o, k, stride, groups, ho, wo};
  return valid_shape(s) ? choose_path(s) : -1;
}

// Plain C entry point (loaded with ctypes). `out` is (n, ho, wo, o) bfloat16
// when `bf16` is 1, else float32; `scale` is (o,) float32. Launches on
// `stream`, does not synchronise, allocates nothing; returns
// cudaGetLastError() of the launch, or cudaErrorInvalidValue for a shape it
// does not take (channels that the groups do not divide, an even or
// non-positive k, a stride other than 1 or 2, an output size other than the
// padded conv's, a grid too large).
extern "C" int grouped_conv_s8(const void* in, const void* w, const void* scale, void* out, int n,
                               int h, int wd, int c, int o, int k, int stride, int groups, int ho,
                               int wo, int bf16, void* stream) {
  const Shape s{in, w, out, n, h, wd, c, o, k, stride, groups, ho, wo};
  if (!valid_shape(s)) return (int)cudaErrorInvalidValue;
  if (n <= 0 || ho <= 0 || wo <= 0 || o <= 0) return (int)cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  switch (choose_path(s)) {
    case kDepthwise: return (int)run_depthwise(s, sc, true, bf16 != 0, st);
    case kDepthwiseBytes: return (int)run_depthwise(s, sc, false, bf16 != 0, st);
    case kGroupedMma: return (int)run_grouped(s, sc, bf16 != 0, st);
    default: return (int)run_general(s, sc, bf16 != 0, st);
  }
}
