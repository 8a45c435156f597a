// G1: grouped s8 x s8 -> s32 convolution, NHWC, on Hopper.
//
// Replaces no TPU kernel. The JAX package computes the grouped int8
// convolutions of its timm trunks (every depthwise `conv_dw` of an int8
// EfficientNet, every grouped 3x3 `conv2` of an int8 RegNet) with XLA's
// conv_general_dilated(int8, int8, preferred_element_type=int32,
// feature_group_count=g) in tubedetr_tpu/models/resnet.py `BottleneckConv`,
// outside any Pallas kernel. PyTorch has no int8 grouped convolution, and
// torch._int_mm (cuBLASLt) wants K and N in multiples of 8 and more than 16
// rows, which a depthwise group (N = 1) is not: so this kernel is written
// here (cuDNN's float32 grouped conv on the same integers is exact at the
// timm shapes and is its yardstick). It computes XLA's result exactly, in
// int32:
//     out[n, y, x, o] = sum_{ky, kx, ci} in[n, y*s - p + ky, x*s - p + kx, g*I + ci]
//                                        * w[o, (ky*k + kx)*I + ci]
// with g = o / (O / groups), I = C / groups input channels a group, zero
// padding p = k / 2 and stride s; the weights are (O, k*k*I) int8, taps in
// (ky, kx, ci) order (models/resnet.py `_int8_weight`).
//
// Bound: memory. A depthwise conv does k*k multiply-adds an output against 1
// byte read and 4 bytes written; a 16-wide 3x3 group 144 against the same.
// The least traffic is the input read once, the weights once and the int32
// output written once (at efficientnet_b0's first depthwise conv at 200
// frames of 352x608: 342 MB in, 1.37 GB out, about 0.5 ms at 3.35 TB/s).
//
// Design: the first, direct version. One thread an output element; a block
// of 256 threads covers 256 consecutive (x, o) elements of one output row
// (grid: N*Ho rows x ceil(Wo*O / 256)), so neighbouring threads hold
// neighbouring output channels and their input reads fall on neighbouring
// (depthwise) or equal (grouped) bytes, and the int32 stores are coalesced.
// Taps outside the frame are skipped (the zero pad). When I is a multiple of
// 4 (RegNet's groups) a thread reads 4 input channels and 4 weights as one
// 32-bit word each and multiplies them with __dp4a; a depthwise conv (I = 1)
// reads bytes. Nothing is staged in shared memory: the k*k reuse of an
// input byte and the reuse of a weight row across a row's pixels are left
// to the L1 cache. Making it fast (input tiles in shared memory, several
// channels a thread, int8 output with the fold fused) is later work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

template <int kVec>
__global__ void __launch_bounds__(kThreads) grouped_conv_s8_kernel(
    const int8_t* __restrict__ in, const int8_t* __restrict__ w, int32_t* __restrict__ out,
    int h, int wd, int c, int ho, int wo, int o, int k, int stride, int pad, int ig, int og) {
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
  out[(size_t)row * wo * o + j] = acc;
}

}  // namespace

// Plain C entry point (loaded with ctypes). Launches on `stream`, does not
// synchronise, allocates nothing; returns cudaGetLastError() of the launch, or
// cudaErrorInvalidValue for a shape it does not take (channels that the
// groups do not divide, an even or non-positive k, a stride other than 1 or
// 2, an output size other than the padded conv's, too many column blocks,
// or 32-bit reads (I % 4 == 0) from bases that are not 4-byte aligned).
extern "C" int grouped_conv_s8(const void* in, const void* w, void* out, int n, int h, int wd,
                               int c, int o, int k, int stride, int groups, int ho, int wo,
                               void* stream) {
  if (groups < 1 || c % groups || o % groups || k < 1 || k % 2 == 0 ||
      (stride != 1 && stride != 2))
    return (int)cudaErrorInvalidValue;
  const int pad = k / 2;
  if (ho != (h + 2 * pad - k) / stride + 1 || wo != (wd + 2 * pad - k) / stride + 1)
    return (int)cudaErrorInvalidValue;
  if (n <= 0 || ho <= 0 || wo <= 0 || o <= 0) return (int)cudaSuccess;
  const long long cols = ((long long)wo * o + kThreads - 1) / kThreads;
  if (cols > 65535 || (long long)n * ho > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int ig = c / groups, og = o / groups;
  const bool vec = ig % 4 == 0;
  if (vec && ((uintptr_t)in % 4 || (uintptr_t)w % 4)) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)(n * ho), (unsigned)cols);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* x = static_cast<const int8_t*>(in);
  const int8_t* wt = static_cast<const int8_t*>(w);
  int32_t* y = static_cast<int32_t*>(out);
  if (vec)
    grouped_conv_s8_kernel<4><<<grid, kThreads, 0, s>>>(x, wt, y, h, wd, c, ho, wo, o, k, stride,
                                                        pad, ig, og);
  else
    grouped_conv_s8_kernel<1><<<grid, kThreads, 0, s>>>(x, wt, y, h, wd, c, ho, wo, o, k, stride,
                                                        pad, ig, og);
  return (int)cudaGetLastError();
}
