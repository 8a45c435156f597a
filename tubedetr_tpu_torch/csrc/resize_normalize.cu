// Fused bilinear resize (+ crop) + normalize for uint8 video frames, on Hopper.
//
// Replaces the TPU kernel K1: tubedetr_tpu/ops/pallas_preprocess.py `_kernel`
// (reached through `_call` and `resize_normalize_pallas`). Per frame it computes
//     out = (A_h @ img @ A_w3) * scale[c] + shift[c]
// with img the uint8 frame as f32, A_h / A_w the cv2.INTER_LINEAR
// interpolation matrices (crop folded in) and scale/shift folding /255 and the
// ImageNet mean/std. The Pallas kernel multiplies dense matrices on the MXU;
// every row of A_h and A_w has at most two non-zeros, so this kernel gathers
// instead: the host passes, per output row and per output column, the two
// source taps and their weights read from the matrix (at a clamped border
// both taps are one row or column and w_hi == 0, the merged weight in w_lo).
// With a padded size (ph, pw) the output is (N, ph, pw, 3): rows [oh, ph) and
// columns [ow, pw) are written 0, the pipeline's bucket pad in normalised
// units, in the same launch.
//
// Bound: memory. About 11 flops an output element against 2 or 4 bytes
// stored, so the kernel must read N*ih*iw*3 bytes once and write
// N*ph*pw*3*{2|4}; at the serving shape (200, 360, 640, 3) -> (330, 586)
// padded to (352, 608) that is 138 + 257 MB in bf16, 0.118 ms at 3.35 TB/s
// (0.111 ms unpadded, 0.180 ms in f32).
//
// Design. One block of 256 threads takes a band of `rows_per_block`
// consecutive output rows of one frame at full width (grid: bands x frames);
// the host's schedule (ops/resize_normalize.py:k1_schedule) lists the source
// rows each band reads (`slots` of them at most) and picks the tallest band
// whose shared memory leaves five blocks an SM.
//   1. The block loads the column tables and its rows' entries of the row
//      tables (no global load is left on a row's own path) and stages every
//      source row of its band into shared memory at once with cp.async (only
//      the bytes between the first and the last column tap), so all of a
//      band's reads are in flight together. A row sits at its address mod
//      16, so its body moves as 16-byte copies and only a head and a tail of
//      at most 15 bytes go byte by byte, whatever the row's alignment.
//   2. Per output row, thread t makes pixels t, t + 256, ... of the row: one
//      table entry a pixel, its three channels unrolled (the affine's
//      constants fixed a channel), the two source rows interpolated at the
//      two column taps, then the columns, then the affine, into a row buffer
//      in shared memory (two, used in turn: one barrier an output row).
//      Neighbouring threads read neighbouring staged bytes and table entries
//      (no bank conflicts); a byte becomes a float by OR-ing it into the
//      mantissa of 2^23 and subtracting 2^23 (exact; two full-rate operations
//      for a quarter-rate conversion).
//   3. The row goes out as 16-byte stores at 8-aligned element indices of
//      the flat output (one in bf16, two in f32); the buffer holds the row at
//      its start's offset mod 8, so the reads are aligned too. A chunk that
//      straddles the row's start or end (rows of pw*3 elements need not be a
//      multiple of 8) is stored element by element, the neighbour row's part
//      left to its own block.
// What holds it at about half its bound (PERF.md): step 2 issues some 60
// instructions a pixel, and the blocks do not hide that issue time behind
// the memory traffic of the others.
// Rows of the band past oh are written 0 without touching the input.
//
// Arithmetic order follows A_h @ img @ A_w3 in f32: the two source rows are
// interpolated first (at both source columns), then the two columns, then
// the affine; bf16 output rounds to nearest even.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSmemLimit = 232448;  // opt-in shared memory of one block on sm_90
constexpr int kSmemDefault = 48 * 1024;

struct Params {
  const uint8_t* in;
  void* out;
  const int4* rows;      // per output row: its two source rows' slots, w_lo bits, w_hi bits
  const int4* cols;      // per output column: 3*lo - x_lo, 3*hi - x_lo, w_lo bits, w_hi bits
  const int* band_src;   // per band, `slots` source rows (-1: unused)
  float s0, s1, s2, h0, h1, h2;
  int ih, iw, oh, ow, ph, pw;
  int x_lo, x_len;       // the source bytes of a row that the column taps read
  int rows_per_block, slots;
};

// Shared memory: the column tables, the band's row entries, two output row
// buffers (4 bytes an element whatever the output type), the staged source
// rows.
__host__ __device__ inline int obuf_elems(int pw) { return ((3 * pw + 7) / 8 + 1) * 8; }
__host__ __device__ inline int stage_bytes(int x_len) { return (x_len + 15 + 15) / 16 * 16; }
inline long long smem_of(int ow, int pw, int x_len, int slots, int rows_per_block) {
  return 16LL * ow + 16LL * rows_per_block + 8LL * obuf_elems(pw) +
         (long long)slots * stage_bytes(x_len);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_all;" ::: "memory"); }

// Start copying `len` bytes from `src` (any alignment) into shared memory at
// S + (src mod 16): the aligned body by cp.async, the head and tail by bytes.
__device__ __forceinline__ void stage_row(uint8_t* S, const uint8_t* src, int len) {
  const int d = (int)((uintptr_t)src & 15);
  const uint8_t* aligned = src - d;
  const int chunks = (d + len + 15) / 16;
  for (int k = threadIdx.x; k < chunks; k += kThreads) {
    if (16 * k >= d && 16 * k + 16 <= d + len) {
      cp_async16(S + 16 * k, aligned + 16 * k);
    } else {
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int i = 16 * k + j - d;
        if (i >= 0 && i < len) S[16 * k + j] = __ldg(src + i);
      }
    }
  }
}

// a byte as a float: 0x4B0000bb is 2^23 + bb
__device__ __forceinline__ float byte_f(uint8_t b) {
  return __uint_as_float(0x4B000000u | b) - 8388608.f;
}

__device__ __forceinline__ float from_f(float v, float) { return v; }
__device__ __forceinline__ __nv_bfloat16 from_f(float v, __nv_bfloat16) { return __float2bfloat16_rn(v); }

// 8 elements (16 or 32 bytes) from an aligned row buffer to aligned global memory
__device__ __forceinline__ void copy8(float* dst, const float* src) {
  reinterpret_cast<float4*>(dst)[0] = reinterpret_cast<const float4*>(src)[0];
  reinterpret_cast<float4*>(dst)[1] = reinterpret_cast<const float4*>(src)[1];
}
__device__ __forceinline__ void copy8(__nv_bfloat16* dst, const __nv_bfloat16* src) {
  *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
}
__device__ __forceinline__ void zero8(float* dst) {
  reinterpret_cast<float4*>(dst)[0] = reinterpret_cast<float4*>(dst)[1] = make_float4(0.f, 0.f, 0.f, 0.f);
}
__device__ __forceinline__ void zero8(__nv_bfloat16* dst) { *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0); }

template <typename OutT>
__global__ void __launch_bounds__(kThreads) resize_normalize_kernel(const Params p) {
  extern __shared__ __align__(16) uint8_t smem[];
  int4* ctab = reinterpret_cast<int4*>(smem);
  int4* rtab = ctab + p.ow;  // per band row: its two staged rows' byte offsets, w_lo and w_hi bits
  const int obuf = obuf_elems(p.pw);
  OutT* orows = reinterpret_cast<OutT*>(rtab + p.rows_per_block);
  uint8_t* stage = reinterpret_cast<uint8_t*>(orows) + 8 * obuf;
  const int sbytes = stage_bytes(p.x_len);

  const int f = blockIdx.y, band = blockIdx.x;
  const int y0 = band * p.rows_per_block, y1 = min(y0 + p.rows_per_block, p.ph);
  const size_t in_row = (size_t)p.iw * 3;
  const uint8_t* frame = p.in + (size_t)f * p.ih * in_row + p.x_lo;
  const int* src_rows = p.band_src + (size_t)band * p.slots;
  const int ow3 = p.ow * 3, pw3 = p.pw * 3;
  OutT* out = static_cast<OutT*>(p.out);

  if (y0 < p.oh) {  // block-uniform: a band of pad rows reads nothing
    for (int i = threadIdx.x; i < p.ow; i += kThreads) ctab[i] = __ldg(&p.cols[i]);
    if (threadIdx.x < min(y1, p.oh) - y0) {
      const int4 rt = __ldg(&p.rows[y0 + threadIdx.x]);
      const int d0 = (int)((uintptr_t)(frame + __ldg(src_rows + rt.x) * in_row) & 15);
      const int d1 = (int)((uintptr_t)(frame + __ldg(src_rows + rt.y) * in_row) & 15);
      rtab[threadIdx.x] = make_int4(rt.x * sbytes + d0, rt.y * sbytes + d1, rt.z, rt.w);
    }
    for (int s = 0; s < p.slots; ++s) {
      const int r = __ldg(src_rows + s);
      if (r < 0) break;
      stage_row(stage + s * sbytes, frame + r * in_row, p.x_len);
    }
    cp_async_wait_all();
    __syncthreads();  // the staged rows and the tables visible to every thread
  }

  for (int oy = y0; oy < y1; ++oy) {
    const size_t row0 = ((size_t)f * p.ph + oy) * pw3;  // the row's first flat element
    const int shift = (int)(row0 & 7);
    const int chunks = (shift + pw3 + 7) / 8;  // the 8-aligned chunks of 8 elements it touches
    OutT* out8 = out + (row0 - shift);          // chunk kk at out8 + 8 * kk
    if (oy >= p.oh) {  // a pad row (block-uniform)
      for (int kk = threadIdx.x; kk < chunks; kk += kThreads) {
        const int e0 = 8 * kk - shift;
        if (e0 >= 0 && e0 + 8 <= pw3) {
          zero8(out8 + 8 * kk);
        } else {
          for (int j = 0; j < 8; ++j)
            if (e0 + j >= 0 && e0 + j < pw3) out8[8 * kk + j] = from_f(0.f, OutT());
        }
      }
      continue;
    }
    // the buffer's last reader, the stores of row oy - 2, is done: every
    // thread has passed the barrier of row oy - 1 since
    OutT* ob = orows + (oy & 1) * obuf;  // element e at ob[shift + e], chunk kk at ob + 8 * kk
    const int4 rt = rtab[oy - y0];
    const uint8_t* S0 = stage + rt.x;
    const uint8_t* S1 = stage + rt.y;
    const float wy0 = __int_as_float(rt.z), wy1 = __int_as_float(rt.w);
    for (int px = threadIdx.x; px < p.pw; px += kThreads) {
      float v[3] = {0.f, 0.f, 0.f};  // a pad column: 0
      if (px < p.ow) {
        const int4 t = ctab[px];
        const float wl = __int_as_float(t.z), wh = __int_as_float(t.w);
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          // rows first (A_h @ img) at the two source columns, then the columns
          const float v0 = wy0 * byte_f(S0[t.x + c]) + wy1 * byte_f(S1[t.x + c]);
          const float v1 = wy0 * byte_f(S0[t.y + c]) + wy1 * byte_f(S1[t.y + c]);
          const float x = wl * v0 + wh * v1;
          v[c] = x * (c == 0 ? p.s0 : c == 1 ? p.s1 : p.s2) + (c == 0 ? p.h0 : c == 1 ? p.h1 : p.h2);
        }
      }
      OutT* d = ob + shift + 3 * px;
#pragma unroll
      for (int c = 0; c < 3; ++c) d[c] = from_f(v[c], OutT());
    }
    __syncthreads();  // the row buffer complete
    for (int kk = threadIdx.x; kk < chunks; kk += kThreads) {
      const int e0 = 8 * kk - shift;
      const OutT* src = ob + 8 * kk;
      if (e0 >= 0 && e0 + 8 <= pw3) {
        copy8(out8 + 8 * kk, src);
      } else {
        for (int j = 0; j < 8; ++j)
          if (e0 + j >= 0 && e0 + j < pw3) out8[8 * kk + j] = src[j];
      }
    }
  }
}

}  // namespace

// Dynamic shared memory of one block for `ow` output columns in rows of `pw`,
// `x_len` staged source bytes a row, `slots` staged rows and bands of
// `rows_per_block` rows (what the wrapper checks before a launch).
extern "C" long long resize_normalize_smem_bytes(int ow, int pw, int x_len, int slots,
                                                 int rows_per_block) {
  return smem_of(ow, pw, x_len, slots, rows_per_block);
}

// Plain C entry point (loaded with ctypes). Launches on `stream`, does not
// synchronise, allocates nothing; returns cudaGetLastError() of the launch, or
// cudaErrorInvalidValue for a shape it does not take (a padded size below
// the output size, more than 65535 frames, an output base that is not
// 16-byte aligned, shared memory above the limit).
extern "C" int resize_normalize_u8(
    const void* in, void* out, int out_bf16, const void* rows, const void* cols,
    const void* band_src, float s0, float s1, float s2, float h0, float h1, float h2, int n,
    int ih, int iw, int oh, int ow, int ph, int pw, int x_lo, int x_len, int rows_per_block,
    int slots, void* stream) {
  if (n <= 0 || ph <= 0 || pw <= 0) return (int)cudaSuccess;
  const long long smem = smem_of(ow, pw, x_len, slots, rows_per_block);
  if (oh <= 0 || ow <= 0 || ph < oh || pw < ow || n > 65535 || x_lo < 0 || x_len < 1 ||
      x_lo + (long long)x_len > 3LL * iw || rows_per_block < 1 || rows_per_block > kThreads ||
      slots < 1 ||
      (uintptr_t)out % 16 || smem > kSmemLimit)
    return (int)cudaErrorInvalidValue;
  Params prm;
  prm.in = static_cast<const uint8_t*>(in);
  prm.out = out;
  prm.rows = static_cast<const int4*>(rows);
  prm.cols = static_cast<const int4*>(cols);
  prm.band_src = static_cast<const int*>(band_src);
  prm.s0 = s0;
  prm.s1 = s1;
  prm.s2 = s2;
  prm.h0 = h0;
  prm.h1 = h1;
  prm.h2 = h2;
  prm.ih = ih;
  prm.iw = iw;
  prm.oh = oh;
  prm.ow = ow;
  prm.ph = ph;
  prm.pw = pw;
  prm.x_lo = x_lo;
  prm.x_len = x_len;
  prm.rows_per_block = rows_per_block;
  prm.slots = slots;
  const dim3 grid((ph + rows_per_block - 1) / rows_per_block, n);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto kernel = out_bf16 ? resize_normalize_kernel<__nv_bfloat16> : resize_normalize_kernel<float>;
  if (smem > kSmemDefault) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<grid, kThreads, (size_t)smem, s>>>(prm);
  return (int)cudaGetLastError();
}
