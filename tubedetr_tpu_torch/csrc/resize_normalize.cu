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
// source taps (lo, hi) and their weights (w_lo, w_hi) read from the matrix
// (at a clamped border lo == hi and w_hi == 0, the merged weight sits in w_lo).
//
// Bound: memory. Each output element costs 4 byte loads (mostly L1/L2 hits,
// neighbouring threads share source pixels) and ~10 flops, so the kernel
// must read N*ih*iw*3 bytes once and write N*oh*ow*3*{4|2} bytes; at the
// serving shape (200, 360, 640, 3) -> (330, 586) that is 0.11 ms (bf16) or
// 0.18 ms (f32) at 3.35 TB/s. Design against that bound: one thread per
// output element, neighbouring threads on neighbouring (ox, c) addresses so
// the stores coalesce, tables read once per thread from L1, no shared memory.
//
// Arithmetic order follows A_h @ img @ A_w3 in f32: the two source rows are
// interpolated first (at both source columns), then the two columns, then
// the affine; bf16 output rounds to nearest even (__float2bfloat16_rn).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename OutT>
__global__ void resize_normalize_kernel(
    const uint8_t* __restrict__ in, OutT* __restrict__ out,
    const int* __restrict__ row_lo, const int* __restrict__ row_hi,
    const float* __restrict__ row_wlo, const float* __restrict__ row_whi,
    const int* __restrict__ col_lo, const int* __restrict__ col_hi,
    const float* __restrict__ col_wlo, const float* __restrict__ col_whi,
    float s0, float s1, float s2, float h0, float h1, float h2,
    int ih, int iw, int oh, int ow) {
  const int row_elems = ow * 3;
  const int e = blockIdx.x * blockDim.x + threadIdx.x;  // ox * 3 + c
  if (e >= row_elems) return;
  const int oy = blockIdx.y;
  const int f = blockIdx.z;
  const int ox = e / 3;
  const int c = e - ox * 3;

  const size_t in_row = (size_t)iw * 3;
  const uint8_t* frame = in + (size_t)f * ih * in_row;
  const uint8_t* r0 = frame + (size_t)row_lo[oy] * in_row;
  const uint8_t* r1 = frame + (size_t)row_hi[oy] * in_row;
  const float wy0 = row_wlo[oy];
  const float wy1 = row_whi[oy];
  const int x0 = col_lo[ox] * 3 + c;
  const int x1 = col_hi[ox] * 3 + c;

  // rows first (A_h @ img) at the two source columns, then the columns
  const float v0 = wy0 * (float)r0[x0] + wy1 * (float)r1[x0];
  const float v1 = wy0 * (float)r0[x1] + wy1 * (float)r1[x1];
  const float v = col_wlo[ox] * v0 + col_whi[ox] * v1;

  const float sc = c == 0 ? s0 : (c == 1 ? s1 : s2);
  const float sh = c == 0 ? h0 : (c == 1 ? h1 : h2);
  store(out + ((size_t)f * oh + oy) * row_elems + e, v * sc + sh);
}

}  // namespace

// Plain C entry point (loaded with ctypes). Launches on `stream`, does not
// synchronise, allocates nothing; returns cudaGetLastError() of the launch.
extern "C" int resize_normalize_u8(
    const void* in, void* out, int out_bf16,
    const void* row_lo, const void* row_hi, const void* row_wlo, const void* row_whi,
    const void* col_lo, const void* col_hi, const void* col_wlo, const void* col_whi,
    float s0, float s1, float s2, float h0, float h1, float h2,
    int n, int ih, int iw, int oh, int ow, void* stream) {
  if (n <= 0 || oh <= 0 || ow <= 0) return (int)cudaSuccess;
  const int threads = 256;
  const dim3 grid((ow * 3 + threads - 1) / threads, oh, n);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* src = static_cast<const uint8_t*>(in);
  const auto* rl = static_cast<const int*>(row_lo);
  const auto* rh = static_cast<const int*>(row_hi);
  const auto* rwl = static_cast<const float*>(row_wlo);
  const auto* rwh = static_cast<const float*>(row_whi);
  const auto* cl = static_cast<const int*>(col_lo);
  const auto* ch = static_cast<const int*>(col_hi);
  const auto* cwl = static_cast<const float*>(col_wlo);
  const auto* cwh = static_cast<const float*>(col_whi);
  if (out_bf16) {
    resize_normalize_kernel<__nv_bfloat16><<<grid, threads, 0, s>>>(
        src, static_cast<__nv_bfloat16*>(out), rl, rh, rwl, rwh, cl, ch, cwl,
        cwh, s0, s1, s2, h0, h1, h2, ih, iw, oh, ow);
  } else {
    resize_normalize_kernel<float><<<grid, threads, 0, s>>>(
        src, static_cast<float*>(out), rl, rh, rwl, rwh, cl, ch, cwl, cwh, s0,
        s1, s2, h0, h1, h2, ih, iw, oh, ow);
  }
  return (int)cudaGetLastError();
}
