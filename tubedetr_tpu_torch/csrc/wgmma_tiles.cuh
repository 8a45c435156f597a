// Hopper (sm_90a) building blocks for GEMMs fed by TMA through a shared-memory
// ring: tensor maps and TMA loads (2-D and 3-D), mbarrier helpers, wgmma
// shared-memory descriptors, the s8 and bf16 m64n256 instructions,
// fence/commit/wait and setmaxnreg. The probe GEMMs P1-P3 (probe_mm.cu) run
// on it; K2's redesign (fused_bottleneck.cu) takes it next for conv1 and
// conv3.
//
// One layout throughout: both operands K-major (each row contiguous along the
// reduction, as A and the output-channel-first weights of the port are), cut
// into tiles of 128 bytes of K by TMA with CU_TENSOR_MAP_SWIZZLE_128B. A tile
// of R rows is R x 128 bytes, its 16-byte chunks XOR-swizzled by (row % 8),
// 8-row groups 1024 bytes apart; tiles start 1024-byte aligned. A wgmma k-step
// reads 32 bytes of every row (k32 for s8, k16 for bf16), so the k-th step of
// a tile is its descriptor plus 32 * k bytes (+2 in the address field).
// Out-of-bounds rows and K bytes of a box arrive as zeros and still count
// towards the box's bytes on the mbarrier.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums; nothing of libcuda is linked
#include <cudaTypedefs.h>  // PFN_cuTensorMapEncodeTiled_v12000
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileKBytes = 128;  // bytes of K in one swizzled TMA box
constexpr int kStepKBytes = 32;   // bytes of K in one wgmma k-step

// ---------------------------------------------------------------- host side

// cuTensorMapEncodeTiled through the runtime's entry-point query, so the
// library links no -lcuda. nullptr if libcuda does not provide it.
inline PFN_cuTensorMapEncodeTiled_v12000 tensor_map_encoder() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                     &found);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p);
  }
  return fn;
}

// A map of a K-major tensor of `rank` (2 or 3) dimensions, innermost first:
// dims[0] is K in elements, strides[i] the bytes between steps of dims[i + 1].
// Boxes are 128 bytes of K by `box_rows` rows (by 1 along a third dimension),
// swizzled for wgmma. Returns false if cuTensorMapEncodeTiled refuses the map
// (base not 16-byte aligned, a stride not a multiple of 16, ...).
inline bool encode_k_major(CUtensorMap* map, CUtensorMapDataType type, int elem_bytes,
                           const void* base, int rank, const cuuint64_t* dims,
                           const cuuint64_t* strides, cuuint32_t box_rows) {
  const auto encode = tensor_map_encoder();
  if (!encode || rank < 2 || rank > 3) return false;
  const cuuint32_t box[3] = {(cuuint32_t)(kTileKBytes / elem_bytes), box_rows, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return encode(map, type, (cuuint32_t)rank, const_cast<void*>(base), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// -------------------------------------------------------------- device side

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarrier

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t arrivals) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(arrivals)
               : "memory");
}

// after the barriers of a block are initialised, before any thread uses them
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// the producer's arrival, announcing the bytes its TMA loads will complete
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar)) : "memory");
}

// Spin until the phase of parity `parity` has completed. A wait that never
// ends (a byte count that the loads do not reach, a parity off by one) traps
// after 2^26 tries, far beyond any real wait, so the launch fails instead of
// hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done;
  for (uint32_t tries = 0;; ++tries) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (tries == (1u << 26)) __trap();
  }
}

// ---- TMA: one thread copies a box of global memory into shared memory and
// the copy completes its bytes on `bar`; coordinates in elements, innermost
// first

__device__ __forceinline__ void tma_prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];" ::"l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// ---- wgmma

// Descriptor of a K-major, 128-byte-swizzled tile at `tile` (1024-byte
// aligned): start address >> 4, leading offset 1 (unused for swizzled
// K-major), stride 1024 bytes between 8-row groups, layout B128.
__device__ __forceinline__ uint64_t wgmma_desc_sw128(const void* tile) {
  return (uint64_t)((smem_u32(tile) & 0x3FFFF) >> 4) | (1ull << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

// the descriptor of k-step `k` (32 bytes each) inside a tile
__device__ __forceinline__ uint64_t wgmma_desc_step(uint64_t desc, int k) {
  return desc + (uint64_t)((k * kStepKBytes) >> 4);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

// wait until at most N committed groups of this warpgroup are in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Pin accumulator registers at this point of the program: the compiler must
// not move their reads or writes across a wgmma wait or fence.
__device__ __forceinline__ void wgmma_pin(int32_t& r) { asm volatile("" : "+r"(r)::"memory"); }
__device__ __forceinline__ void wgmma_pin(float& r) { asm volatile("" : "+f"(r)::"memory"); }

template <typename T, int N>
__device__ __forceinline__ void wgmma_pin_all(T (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) wgmma_pin(d[i]);
}

#define WGMMA_OP8(C, d, i)                                                                      \
  C(d[(i) + 0]), C(d[(i) + 1]), C(d[(i) + 2]), C(d[(i) + 3]), C(d[(i) + 4]), C(d[(i) + 5]), \
      C(d[(i) + 6]), C(d[(i) + 7])
#define WGMMA_OP32(C, d, i) \
  WGMMA_OP8(C, d, i), WGMMA_OP8(C, d, (i) + 8), WGMMA_OP8(C, d, (i) + 16), WGMMA_OP8(C, d, (i) + 24)
#define WGMMA_OP128(C, d) \
  WGMMA_OP32(C, d, 0), WGMMA_OP32(C, d, 32), WGMMA_OP32(C, d, 64), WGMMA_OP32(C, d, 96)
#define WGMMA_S32(x) "+r"(x)
#define WGMMA_F32(x) "+f"(x)
#define WGMMA_D128                                                                          \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "                 \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "        \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "         \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "         \
  "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "         \
  "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "         \
  "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, "   \
  "%111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, " \
  "%126, %127}"

// One k-step of 32 bytes for the warpgroup: D(64 x 256) (+)= A(64 x 32
// bytes) * B(256 x 32 bytes)^T, both from shared memory; `accumulate` 0
// overwrites D. s8 inputs (k32) sum into int32_t, bf16 inputs (k16) into
// float. Thread t of the warpgroup holds rows 16 * (t / 32) + (t % 32) / 4 +
// 8 * h and columns 8 * j + 2 * (t % 4) + e in d[4 * j + 2 * h + e].
__device__ __forceinline__ void wgmma_m64n256(int32_t (&d)[128], uint64_t a, uint64_t b,
                                              int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 " WGMMA_D128 ", %128, %129, p;\n"
      "}\n"
      : WGMMA_OP128(WGMMA_S32, d)
      : "l"(a), "l"(b), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_m64n256(float (&d)[128], uint64_t a, uint64_t b,
                                              int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 " WGMMA_D128
      ", %128, %129, p, 1, 1, 0, 0;\n"
      "}\n"
      : WGMMA_OP128(WGMMA_F32, d)
      : "l"(a), "l"(b), "r"(accumulate));
}

// ---- register rebalancing between warpgroups; takes effect only where the
// roles split in one top-level if/else that never reconverges

template <int R>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(R));
}

template <int R>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(R));
}

}  // namespace
