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
// Design. The 3x3 runs on the zero-padded grid: every frame row is padded to
// tw = W + 2d columns, and d zero rows separate the frames (and sit above the
// first), so the whole batch is one flat grid of N * (H + d) * tw positions
// and tap (ky, kx) of output position o reads q1 at o + ky*d*tw + kx*d: a
// constant offset, no mask. Outputs on padding columns and separator rows are
// computed and dropped. A band is a run of 64 * tiles consecutive grid
// positions (tiles from the host's plan, which fills shared memory); bands
// cross frames, so only the batch's last band is partial.
//
// One persistent block an SM walks the bands. Warpgroup 2 is the producer:
// one thread streams, by TMA, 128-byte slices of K into a ring of 2 or 3 stages
// of 32 KB (128-byte swizzle, full/empty mbarriers): for conv1 a stage holds
// 128 rows of x and up to 128 rows of w1, for conv2 up to N rows of one tap's
// w2, for conv3 N rows of w3 (N = 128, 256 from P = 256 on). The weights do not
// fit shared memory; every 128 positions of a band read all of them once
// from L2. Warpgroups 0 and 1 consume each stage together, each on its own
// 64-position wgmma tile (m64nNk32 s8, accumulators in registers; setmaxnreg
// gives them 232 registers and the producer 40):
//   conv1  over the compact x rows whose q1 the band needs (its positions
//          plus a halo of d*tw + d on each side: the neighbouring bands
//          recompute it), the fold written into the q1 tile in shared memory
//          at its grid position; the tile is zeroed first, so padding columns
//          and separator rows read 0, as the reference pads q1 with zeros;
//   conv2  per 64-position tile, nine taps x P/128 slices against w2, the A
//          descriptor moved by the tap's offset; the fold into a q2 tile of
//          64 x P per warpgroup;
//   conv3  on that q2 tile, C in passes of N output channels, the residual
//          x (loaded before the pass's MMAs) added and the int8 result stored
//          for the real positions only.
// q1 and q2 are kept without swizzle (wgmma's interleaved layout): 16-byte
// columns of K ("planes") each hold every position's 16 bytes contiguously,
// so a row offset of any count of positions is a valid descriptor (start
// address + 16 * offset), and the eight rows of a core matrix are 128
// contiguous bytes. The epilogues transpose their int8 pairs across each
// quad of lanes, so every lane moves 8 contiguous bytes of x, out, q1 or q2.
//
// The three GEMMs share one accumulator array: ptxas gives each array that
// wgmma writes registers of its own, and three spill (PERF.md).
//
// A width whose q1 tile does not fit beside the ring (at P = 512 and d = 2,
// W > 43) is refused here; the wrapper runs it in column strips.
//
// Arithmetic: epilogues use __fmul_rn / __fadd_rn (no FMA contraction) in the
// reference's order, (acc*a + b) [+ x*sid], then relu, rintf (ties to even,
// as jnp.round / torch.round), clamp to [0, 127]: given the same folds the
// output equals the plain PyTorch version bit for bit.

#include <initializer_list>

#include "wgmma_tiles.cuh"

namespace {

constexpr int kConsumerWarps = 8;               // two consumer warpgroups, warps 0-7
constexpr int kThreads = 384;                   // and a producer warpgroup
constexpr int kTile = 64;                       // grid positions of one wgmma tile
constexpr int kSlotBytes = 256 * kTileKBytes;   // one ring stage: 32 KB
constexpr int kXBytes = 2 * kTile * kTileKBytes;  // conv1's slice of x: 128 rows, 16 KB
constexpr int kMaxStages = 3;
constexpr int kMinStages = 2;
constexpr int kMaxTiles = 16;
constexpr int kAlign = 1024;                    // slack to align the ring for the swizzle
constexpr int kBarBytes = 128;                  // the ring's full and empty barriers
constexpr int kSmemLimit = 232448;              // opt-in shared memory of one block on sm_90

// Which parts of the block run. kFull is K2. The other two are the probes of
// scripts/probe_fused_variants.py (`run`, P4), K2 with one part switched off:
//   kNoShift   conv1 over the band only (no halo), and the 9 taps all read
//              the centre: the 3x3's work without its shifted reads and halo
//              (kFull's compiled kernel, run with Params::halo = 0);
//   kConvOnly  q2 = q1, no conv2: conv1 + conv3 alone.
// The probe's `dot2d` variant split a 3D dot into per-frame 2D dots, a
// question of how Mosaic lowers the code, and its F (frames per grid step)
// has no counterpart here: both run kFull.
enum class Variant { kFull, kNoShift, kConvOnly };

// ---------------------------------------------------------------- the plan

// The shape of the tiling for a width, mid channels and dilation; mirrored by
// tile_plan in ops/fused_bottleneck.py (a card test holds the two equal).
struct Plan {
  int tw;       // padded width W + 2d
  int stages;   // ring stages of kSlotBytes
  int tiles;    // 64-position tiles a band
  int q1_rows;  // positions of the q1 tile: the band and its halo, rounded up to 8
  int smem;     // dynamic shared memory of a block, bytes
};

inline int q1_rows_of(int tiles, int tw, int d) {
  return (kTile * tiles + 2 * d * tw + 2 * d + 7) / 8 * 8;
}

inline long long smem_of(int p, int stages, int tiles, int q1_rows) {
  return kAlign + (long long)stages * kSlotBytes + kBarBytes + (long long)q1_rows * p +
         (long long)kTile * (tiles < 2 ? tiles : 2) * p;
}

// The most tiles (at most kMaxTiles) that fit beside `stages` ring stages.
inline int tiles_fitting(int w, int p, int d, int stages) {
  const int tw = w + 2 * d;
  int tiles = 0;
  for (int t = 1; t <= kMaxTiles; ++t)
    if (smem_of(p, stages, t, q1_rows_of(t, tw, d)) <= kSmemLimit) tiles = t;
  return tiles;
}

// 3 ring stages if that leaves a band of at least 4 tiles, else 2 stages with
// the most tiles that fit. False if not even one tile fits
// or P is not one the kernel is built for.
inline bool make_plan(int w, int p, int d, Plan* out) {
  if (!(p == 64 || p == 128 || p == 256 || p == 512) || w < 1 || d < 1 || w > (1 << 20) ||
      d > (1 << 20))
    return false;
  int stages = kMinStages, tiles = tiles_fitting(w, p, d, kMinStages);
  for (int s = kMaxStages; s > kMinStages; --s) {
    const int t = tiles_fitting(w, p, d, s);
    if (t >= 4) {
      stages = s;
      tiles = t;
      break;
    }
  }
  if (tiles < 1) return false;
  out->tw = w + 2 * d;
  out->stages = stages;
  out->tiles = tiles;
  out->q1_rows = q1_rows_of(tiles, out->tw, d);
  out->smem = (int)smem_of(p, stages, tiles, out->q1_rows);
  return true;
}

// -------------------------------------------------------------- device side

struct Params {
  const int8_t* x;
  int8_t* out;
  const float *a1, *b1, *a2, *b2, *a3, *b3, *sid;
  int N, H, W, C, d;
  int halo;        // 1: conv1 over the halo and shifted taps (K2); 0: kNoShift
  int tw, hd;      // padded width W + 2d; grid rows a frame, H + d
  int stages, tiles, q1_rows;
  int total;       // positions of the output grid, N * hd * tw
  int nbands;
};

template <int P>
struct Widths {
  static constexpr int kNC1 = P < 128 ? P : 128;    // conv1 output channels a pass
  // the widest wgmma tile: 64 x 256 (128 registers a thread) from P = 256 on,
  // 64 x 128 below, where the stages are short anyway
  static constexpr int kNMax = P < 256 ? 128 : 256;
  static constexpr int kNC2 = P < kNMax ? P : kNMax;  // conv2 output channels a pass
  static constexpr int kNC3 = kNMax;                  // conv3 output channels a pass
  static constexpr int kKP = (P + 127) / 128;       // 128-byte slices of K = P
  static constexpr int kStepsP = P < 128 ? P / 32 : 4;  // wgmma k-steps in each of them
};

// The first R registers of the accumulator array, as an array of R.
template <int R, int N>
__device__ __forceinline__ int32_t (&acc_view(int32_t (&a)[N]))[R] {
  static_assert(R <= N, "a view inside the array");
  return *reinterpret_cast<int32_t(*)[R]>(&a[0]);
}

// relu -> round half to even -> clamp to [0, 127]
__device__ __forceinline__ int8_t requant(float y) {
  return (int8_t)(int)fminf(rintf(fmaxf(y, 0.f)), 127.f);
}
__device__ __forceinline__ int8_t fold(int acc, float a, float b) {
  return requant(__fadd_rn(__fmul_rn((float)acc, a), b));
}

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

// generic-proxy writes to shared memory become visible to wgmma's reads
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// Descriptor of a K-major operand without swizzle at `p` (16-byte aligned):
// 8-position core matrices of 16 bytes a position, 128 bytes apart along
// the positions; `plane` bytes between the 16-byte columns of K.
__device__ __forceinline__ uint64_t wgmma_desc_planes(uint32_t addr, uint32_t plane) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(plane >> 4) << 16) |
         ((uint64_t)(128 >> 4) << 32);
}

// Real (in-frame) positions of the q1 grid before grid index q. The q1 grid
// has d zero rows on top, then per frame H rows and d separator rows, each
// row tw wide with the frame's W pixels at columns [d, d + W).
__device__ __forceinline__ int real_before(int q, const Params& p) {
  const int r = q / p.tw, col = q - r * p.tw;
  const int u = r - p.d;  // frame-major row, separators included
  if (u < 0) return 0;
  const int f = u / p.hd, hh = u - f * p.hd;
  if (f >= p.N) return p.N * p.H * p.W;
  const int before = (f * p.H + min(hh, p.H)) * p.W;
  return hh < p.H ? before + min(max(col - p.d, 0), p.W) : before;
}

struct Band {
  int m0, bm;    // first output grid position, positions in the band
  int q_lo;      // q1 grid index of the tile's first position
  int p_lo, m1;  // first compact x row conv1 needs, and how many
  int t1, t2;    // 64-row tiles of conv1, of conv2 and conv3
};

template <Variant V>
__device__ __forceinline__ Band band_at(int b, const Params& p) {
  Band r;
  r.m0 = b * kTile * p.tiles;
  r.bm = min(kTile * p.tiles, p.total - r.m0);
  const int centre = p.d * p.tw + p.d;
  const bool halo = V == Variant::kFull && p.halo;
  r.q_lo = halo ? r.m0 : r.m0 + centre;
  const int ext = halo ? r.bm + 2 * centre : r.bm;
  r.p_lo = real_before(r.q_lo, p);
  r.m1 = real_before(r.q_lo + ext, p) - r.p_lo;
  r.t1 = (r.m1 + kTile - 1) / kTile;
  r.t2 = (r.bm + kTile - 1) / kTile;
  return r;
}

// One run of `nsteps` ring stages accumulated into acc, KSTEPS wgmma k-steps
// of 32 bytes a stage; B at byte `boff` of each stage (swizzled), A from
// adesc(step, stage address, k); shared memory by its 32-bit addresses (the
// ring, the full and empty barriers). Both consumer warpgroups wait on every
// stage and release it (one arrival a warp); an inactive warpgroup (its tile
// past the band) issues nothing. One wgmma group stays in flight while the
// next stage arrives, as in probe_mm.cu.
template <int KSTEPS, int R, typename ADesc>
__device__ __forceinline__ void mma_steps(int32_t (&acc)[R], int nsteps, bool active,
                                          uint32_t ring, uint32_t full, uint32_t empty,
                                          int& stage, uint32_t& phase, int stages, int boff,
                                          ADesc adesc) {
  const int lane = threadIdx.x & 31;
  int prev = -1;
#pragma unroll 1
  for (int s = 0; s < nsteps; ++s) {
    mbar_wait(full + 8 * stage, phase);
    const uint32_t slot = ring + stage * kSlotBytes;
    if (active) {
      const uint64_t db = wgmma_desc_sw128(slot + boff);
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < KSTEPS; ++k)
        wgmma_s8(acc, adesc(s, slot, k), wgmma_desc_step(db, k), s | k);
      wgmma_commit();
      if (prev >= 0) {  // the previous stage's group is done: release it
        wgmma_wait<1>();
        if (lane == 0) mbar_arrive(empty + 8 * prev);
      }
      prev = stage;
    } else if (lane == 0) {
      mbar_arrive(empty + 8 * stage);
    }
    if (++stage == stages) {
      stage = 0;
      phase ^= 1;
    }
  }
  if (prev >= 0) {
    wgmma_wait<0>();
    if (lane == 0) mbar_arrive(empty + 8 * prev);
  }
  wgmma_pin_all(acc);
}

// Epilogue memory accesses as volatile asm: the compiler keeps them in
// program order, so it cannot hoist a whole epilogue's fold loads ahead of
// the stores and run out of registers.
__device__ __forceinline__ float2 ld_fold(const float* p) {
  float2 v;
  asm volatile("ld.global.nc.v2.f32 {%0, %1}, [%2];" : "=f"(v.x), "=f"(v.y) : "l"(p));
  return v;
}
__device__ __forceinline__ void ld_quad(const int8_t* p, uint32_t& lo, uint32_t& hi) {
  asm volatile("ld.global.nc.v2.u32 {%0, %1}, [%2];" : "=r"(lo), "=r"(hi) : "l"(p));
}
__device__ __forceinline__ void st_quad(int8_t* p, uint32_t lo, uint32_t hi) {
  asm volatile("st.global.v2.u32 [%0], {%1, %2};" ::"l"(p), "r"(lo), "r"(hi) : "memory");
}
__device__ __forceinline__ void st_shared_quad(uint32_t addr, uint32_t lo, uint32_t hi) {
  asm volatile("st.shared.v2.u32 [%0], {%1, %2};" ::"r"(addr), "r"(lo), "r"(hi) : "memory");
}

// A 4 x 4 transpose of 16-bit values across the four lanes of a quad. On
// entry lane t holds M[t][0..3] as lo = M[t][0] | M[t][1] << 16, hi =
// M[t][2] | M[t][3] << 16; on exit it holds M[0..3][t] the same way. A lane
// of an accumulator tile holds the column pair 2t, 2t+1 of four groups of 8
// columns; after the transpose it holds all 8 columns (8 contiguous bytes) of
// group t, so a quad moves 32 contiguous bytes of a row in one access. The
// transpose is its own inverse.
__device__ __forceinline__ void quad_transpose(uint32_t& lo, uint32_t& hi) {
  const bool up = threadIdx.x & 2, odd = threadIdx.x & 1;
  const uint32_t got = __shfl_xor_sync(0xffffffffu, up ? lo : hi, 2);
  if (up)
    lo = got;
  else
    hi = got;
  // now lane t holds [M[t][0], M[t][1], M[t^2][0], M[t^2][1]] (t < 2) or
  // [M[t^2][2], M[t^2][3], M[t][2], M[t][3]] (t >= 2): swap odd halves with t^1
  const uint32_t send = odd ? __byte_perm(lo, hi, 0x5410) : __byte_perm(lo, hi, 0x7632);
  const uint32_t pair = __shfl_xor_sync(0xffffffffu, send, 1);
  if (odd) {
    lo = __byte_perm(lo, pair, 0x3254);
    hi = __byte_perm(hi, pair, 0x3276);
  } else {
    lo = __byte_perm(lo, pair, 0x5410);
    hi = __byte_perm(hi, pair, 0x7610);
  }
}

// The fold of an accumulator tile (rows row_t and row_t + 8 of the thread,
// columns n0 + 8j + col_t, +1) into a planar int8 tile at shared address
// `base`, positions ti[h]; a position < 0 (a whole quad's row) is skipped.
// Four groups of 8 columns at a time are transposed across the quad, so a
// lane stores the 8 bytes of group j = j0 + lane % 4: plane n0/16 + j/2, at
// byte 8 * (j % 2) (n0 is a multiple of 16).
template <int R>
__device__ __forceinline__ void store_fold(const int32_t (&acc)[R], uint32_t base, uint32_t plane,
                                           const int (&ti)[2], int n0, int col_t, const float* a,
                                           const float* b) {
  const int q = col_t >> 1;
  uint32_t at[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) at[h] = base + (uint32_t)(n0 >> 4) * plane + ti[h] * 16;
  a += n0 + col_t;
  b += n0 + col_t;
#pragma unroll
  for (int j0 = 0; j0 < R / 4; j0 += 4) {
    float2 av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      av[i] = ld_fold(a + 8 * (j0 + i));
      bv[i] = ld_fold(b + 8 * (j0 + i));
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      uint32_t v[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        v[i] = (uint32_t)(uint8_t)fold(acc[4 * (j0 + i) + 2 * h], av[i].x, bv[i].x) |
               (uint32_t)(uint8_t)fold(acc[4 * (j0 + i) + 2 * h + 1], av[i].y, bv[i].y) << 8;
      uint32_t lo = v[0] | v[1] << 16, hi = v[2] | v[3] << 16;
      quad_transpose(lo, hi);
      const int j = j0 + q;
      if (ti[h] >= 0) st_shared_quad(at[h] + (j >> 1) * plane + 8 * (j & 1), lo, hi);
    }
  }
}

template <int P, Variant V>
__global__ void __launch_bounds__(kThreads, 1)
    fused_bottleneck_kernel(const __grid_constant__ CUtensorMap xmap,
                            const __grid_constant__ CUtensorMap w1map,
                            const __grid_constant__ CUtensorMap w2map,
                            const __grid_constant__ CUtensorMap w3map, const Params p) {
  using Wd = Widths<P>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = smem_raw + ((kAlign - (smem_u32(smem_raw) & (kAlign - 1))) & (kAlign - 1));
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + p.stages * kSlotBytes);
  uint64_t* empty = full + kMaxStages;
  int8_t* q1 = reinterpret_cast<int8_t*>(ring + p.stages * kSlotBytes + kBarBytes);
  int8_t* q2 = q1 + (size_t)p.q1_rows * P;
  const int stages = p.stages;
  const int kc = p.C / kTileKBytes;  // 128-byte slices of K = C
  constexpr int kNC3 = Wd::kNC3;
  const int nc3 = (p.C + kNC3 - 1) / kNC3;
  const int wg = threadIdx.x / 128;  // consumer warpgroup 0 or 1; 2 is the producer

  if (threadIdx.x == 0) {
    for (int i = 0; i < stages; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], kConsumerWarps);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 2) {  // ---- producer: one thread streams, the warpgroup gives up registers
    setmaxnreg_dec<40>();
    if (threadIdx.x == 2 * 128) {
      tma_prefetch_map(&xmap);
      tma_prefetch_map(&w1map);
      tma_prefetch_map(&w2map);
      tma_prefetch_map(&w3map);
      int stage = 0;
      uint32_t phase = 0;
      // the next stage, once both consumers released it, expecting `bytes`
      // (whole boxes, zero-filled parts included)
      auto acquire = [&](int bytes) {
        mbar_wait(&empty[stage], phase ^ 1);
        mbar_arrive_expect_tx(&full[stage], bytes);
        return ring + stage * kSlotBytes;
      };
      auto advance = [&]() {
        if (++stage == stages) {
          stage = 0;
          phase ^= 1;
        }
      };
#pragma unroll 1
      for (int b = blockIdx.x; b < p.nbands; b += gridDim.x) {
        const Band bd = band_at<V>(b, p);
#pragma unroll 1
        for (int pair = 0; 2 * pair < bd.t1; ++pair)
#pragma unroll 1
          for (int nc = 0; nc < P / Wd::kNC1; ++nc)
#pragma unroll 1
            for (int kb = 0; kb < kc; ++kb) {
              uint8_t* slot = acquire(kXBytes + Wd::kNC1 * kTileKBytes);
              tma_load_2d(slot, &xmap, &full[stage], kb * kTileKBytes, bd.p_lo + 2 * kTile * pair);
              tma_load_2d(slot + kXBytes, &w1map, &full[stage], kb * kTileKBytes, nc * Wd::kNC1);
              advance();
            }
#pragma unroll 1
        for (int pair = 0; 2 * pair < bd.t2; ++pair) {
          if constexpr (V != Variant::kConvOnly) {
#pragma unroll 1
            for (int nc = 0; nc < P / Wd::kNC2; ++nc)
#pragma unroll 1
              for (int tap = 0; tap < 9; ++tap)
#pragma unroll 1
                for (int kb = 0; kb < Wd::kKP; ++kb) {
                  uint8_t* slot = acquire(Wd::kNC2 * kTileKBytes);
                  tma_load_2d(slot, &w2map, &full[stage], kb * kTileKBytes,
                              tap * P + nc * Wd::kNC2);
                  advance();
                }
          }
#pragma unroll 1
          for (int nc = 0; nc < nc3; ++nc)
#pragma unroll 1
            for (int kb = 0; kb < Wd::kKP; ++kb) {
              uint8_t* slot = acquire(kNC3 * kTileKBytes);
              tma_load_2d(slot, &w3map, &full[stage], kb * kTileKBytes, nc * kNC3);
              advance();
            }
        }
      }
    }
  } else {  // ---- consumers: warpgroup w takes tile 2 * pair + w of each pair
    setmaxnreg_inc<232>();
    const int w = wg;
    const int lane = threadIdx.x & 31;
    const int row_t = ((threadIdx.x >> 5) & 3) * 16 + (lane >> 2);  // +8 for its second row
    const int q = lane & 3;        // lane in its quad
    const int col_t = 2 * q;
    const uint32_t plane1 = (uint32_t)p.q1_rows * 16;
    constexpr uint32_t plane2 = kTile * 16;
    // shared memory by 32-bit address: the ring, its barriers, q1, this warpgroup's q2
    const uint32_t ring_s = smem_u32(ring), full_s = smem_u32(full), empty_s = smem_u32(empty);
    const uint32_t q1_s = smem_u32(q1), q2_s = smem_u32(q2) + w * kTile * P;
    const int centre = p.d * p.tw + p.d;
    const float sid = __ldg(p.sid);
    // One accumulator array for the three GEMMs: ptxas keeps each array that
    // wgmma writes in registers of its own, and three of them do not fit.
    int32_t accs[kNC3 / 2];
    int stage = 0;
    uint32_t phase = 0;

#pragma unroll 1
    for (int b = blockIdx.x; b < p.nbands; b += gridDim.x) {
      const Band bd = band_at<V>(b, p);
      named_sync(1, 256);  // both consumers are done reading the last band's q1
      {  // the zero border (the probe variants zero it as well: one code path)
        int4* z = reinterpret_cast<int4*>(q1);
        const int n16 = p.q1_rows * P / 16;
        for (int i = threadIdx.x; i < n16; i += 256) z[i] = make_int4(0, 0, 0, 0);
        named_sync(1, 256);
      }

      // ---- conv1 into the q1 tile
#pragma unroll 1
      for (int pair = 0; 2 * pair < bd.t1; ++pair) {
        const int tile = 2 * pair + w;
        const bool active = tile < bd.t1;
        int ti[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {  // compact row -> grid position -> tile position
          const int m = tile * kTile + row_t + 8 * h;
          ti[h] = -1;
          if (m < bd.m1) {
            const int px = bd.p_lo + m;
            const int f = px / (p.H * p.W), rem = px - f * p.H * p.W;
            const int hh = rem / p.W, ww = rem - hh * p.W;
            ti[h] = (f * p.hd + p.d + hh) * p.tw + p.d + ww - bd.q_lo;
          }
        }
#pragma unroll 1
        for (int nc = 0; nc < P / Wd::kNC1; ++nc) {
          auto& acc = acc_view<Wd::kNC1 / 2>(accs);
          mma_steps<4>(acc, kc, active, ring_s, full_s, empty_s, stage, phase, stages, kXBytes,
                       [&](int, uint32_t slot, int k) {
                         return wgmma_desc_step(
                             wgmma_desc_sw128(slot + w * kTile * kTileKBytes), k);
                       });
          if (active) store_fold(acc, q1_s, plane1, ti, nc * Wd::kNC1, col_t, p.a1, p.b1);
        }
      }
      fence_async_shared();
      named_sync(1, 256);  // q1 complete

      // ---- per pair of 64-position tiles: conv2 into q2, conv3 to global memory
#pragma unroll 1
      for (int pair = 0; 2 * pair < bd.t2; ++pair) {
        const int tile = 2 * pair + w;
        const bool active = tile < bd.t2;
        const int row0 = tile * kTile;
        if constexpr (V != Variant::kConvOnly) {
          // every warp's wgmma reads of the last pair's q2 are done
          if (pair > 0) named_sync(2 + w, 128);
          const int ti[2] = {row_t, row_t + 8};
          // the taps' dilation; kNoShift reads the centre, where its tile starts
          const int dt = p.halo ? p.d : 0;
#pragma unroll 1
          for (int nc = 0; nc < P / Wd::kNC2; ++nc) {
            auto& acc = acc_view<Wd::kNC2 / 2>(accs);
            mma_steps<Wd::kStepsP>(
                acc, 9 * Wd::kKP, active, ring_s, full_s, empty_s, stage, phase, stages, 0,
                [&](int s, uint32_t, int k) {
                  const int tap = s / Wd::kKP, kb = s - tap * Wd::kKP;
                  const int off = (tap / 3) * dt * p.tw + (tap - (tap / 3) * 3) * dt;
                  return wgmma_desc_planes(q1_s + (row0 + off) * 16 + (kb * 8 + 2 * k) * plane1,
                                           plane1);
                });
            if (active) store_fold(acc, q2_s, plane2, ti, nc * Wd::kNC2, col_t, p.a2, p.b2);
          }
          fence_async_shared();
          named_sync(2 + w, 128);  // this warpgroup's q2 complete
        }
        int pix[2];  // compact pixel of each of the thread's rows, or -1
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = row0 + row_t + 8 * h;
          const int o = bd.m0 + m;
          const int r = o / p.tw, ww = o - r * p.tw;
          const int f = r / p.hd, hh = r - f * p.hd;
          pix[h] = (m < bd.bm && ww < p.W && hh < p.H) ? (f * p.H + hh) * p.W + ww : -1;
        }
        const int8_t* xrow[2];  // the rows of x and out (row 0 of x for a dropped position)
        int8_t* orow[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const size_t at = (size_t)(pix[h] < 0 ? 0 : pix[h]) * p.C;
          xrow[h] = p.x + at;
          orow[h] = p.out + at;
        }
#pragma unroll 1
        for (int nc = 0; nc < nc3; ++nc) {
          // the residual x of this pass, 8 contiguous bytes a lane and row (group
          // 4g + lane % 4 of 8 columns), loaded before the MMAs so that they hide
          // its latency; transposed to the accumulators' columns after them
          const int nb = nc * kNC3;
          const int groups = min(kNC3, p.C - nb) / 32;  // groups of 32 columns in this pass
          uint32_t xlo[kNC3 / 32][2], xhi[kNC3 / 32][2];
#pragma unroll
          for (int g = 0; g < kNC3 / 32; ++g)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              xlo[g][h] = xhi[g][h] = 0;
              if (active && g < groups && pix[h] >= 0)
                ld_quad(xrow[h] + nb + 32 * g + 8 * q, xlo[g][h], xhi[g][h]);
            }
          auto& acc = accs;
          mma_steps<Wd::kStepsP>(
              acc, Wd::kKP, active, ring_s, full_s, empty_s, stage, phase, stages, 0,
              [&](int s, uint32_t, int k) {
                return V == Variant::kConvOnly  // q2 = q1, the tile starts at the centre
                           ? wgmma_desc_planes(q1_s + row0 * 16 + (s * 8 + 2 * k) * plane1, plane1)
                           : wgmma_desc_planes(q2_s + (s * 8 + 2 * k) * plane2, plane2);
              });
          if (!active) continue;
#pragma unroll
          for (int g = 0; g < kNC3 / 32; ++g) {
            if (g >= groups) break;
            float2 av[4], bv[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              av[i] = ld_fold(p.a3 + nb + col_t + 8 * (4 * g + i));
              bv[i] = ld_fold(p.b3 + nb + col_t + 8 * (4 * g + i));
            }
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              quad_transpose(xlo[g][h], xhi[g][h]);  // x pair of column group 4g + i in slot i
              uint32_t v[4];
#pragma unroll
              for (int i = 0; i < 4; ++i) {
                const uint32_t xv = (i < 2 ? xlo[g][h] : xhi[g][h]) >> (16 * (i & 1));
                const int j = 4 * g + i;
                const float y0 = __fadd_rn(
                    __fadd_rn(__fmul_rn((float)acc[4 * j + 2 * h], av[i].x), bv[i].x),
                    __fmul_rn((float)(int8_t)(xv & 0xff), sid));
                const float y1 = __fadd_rn(
                    __fadd_rn(__fmul_rn((float)acc[4 * j + 2 * h + 1], av[i].y), bv[i].y),
                    __fmul_rn((float)(int8_t)((xv >> 8) & 0xff), sid));
                v[i] = (uint32_t)(uint8_t)requant(y0) | (uint32_t)(uint8_t)requant(y1) << 8;
              }
              uint32_t lo = v[0] | v[1] << 16, hi = v[2] | v[3] << 16;
              quad_transpose(lo, hi);
              if (pix[h] >= 0) st_quad(orow[h] + nb + 32 * g + 8 * q, lo, hi);
            }
          }
        }
      }
    }
  }
}

// ---------------------------------------------------------------- host side

struct Args {
  const void *x, *w1, *w2, *w3;
  void* out;
  const void *a1, *b1, *a2, *b2, *a3, *b3, *sid;
  int n, h, w, c, p, d;
  cudaStream_t stream;
};

template <int P, Variant V>
int launch_planes(const Args& a, const Plan& plan, int halo) {
  const auto kernel = fused_bottleneck_kernel<P, V>;
  CUtensorMap maps[4];
  const CUtensorMapDataType u8 = CU_TENSOR_MAP_DATA_TYPE_UINT8;
  const cuuint64_t x_dims[2] = {(cuuint64_t)a.c, (cuuint64_t)a.n * a.h * a.w};
  const cuuint64_t w1_dims[2] = {(cuuint64_t)a.c, (cuuint64_t)P};
  const cuuint64_t w2_dims[2] = {(cuuint64_t)P, (cuuint64_t)9 * P};
  const cuuint64_t w3_dims[2] = {(cuuint64_t)P, (cuuint64_t)a.c};
  const cuuint64_t c_stride[1] = {(cuuint64_t)a.c}, p_stride[1] = {(cuuint64_t)P};
  if (!encode_k_major(&maps[0], u8, 1, a.x, 2, x_dims, c_stride, 2 * kTile) ||
      !encode_k_major(&maps[1], u8, 1, a.w1, 2, w1_dims, c_stride, Widths<P>::kNC1) ||
      !encode_k_major(&maps[2], u8, 1, a.w2, 2, w2_dims, p_stride, Widths<P>::kNC2) ||
      !encode_k_major(&maps[3], u8, 1, a.w3, 2, w3_dims, p_stride, Widths<P>::kNC3))
    return (int)cudaErrorInvalidValue;

  Params prm;
  prm.x = static_cast<const int8_t*>(a.x);
  prm.out = static_cast<int8_t*>(a.out);
  prm.a1 = static_cast<const float*>(a.a1);
  prm.b1 = static_cast<const float*>(a.b1);
  prm.a2 = static_cast<const float*>(a.a2);
  prm.b2 = static_cast<const float*>(a.b2);
  prm.a3 = static_cast<const float*>(a.a3);
  prm.b3 = static_cast<const float*>(a.b3);
  prm.sid = static_cast<const float*>(a.sid);
  prm.N = a.n;
  prm.H = a.h;
  prm.W = a.w;
  prm.C = a.c;
  prm.d = a.d;
  prm.halo = halo;
  prm.tw = plan.tw;
  prm.hd = a.h + a.d;
  prm.stages = plan.stages;
  prm.tiles = plan.tiles;
  prm.q1_rows = plan.q1_rows;
  prm.total = (int)((long long)a.n * prm.hd * plan.tw);
  const int band = kTile * plan.tiles;
  prm.nbands = (prm.total + band - 1) / band;

  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, plan.smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = prm.nbands < sms ? prm.nbands : sms;
  kernel<<<grid, kThreads, plan.smem, a.stream>>>(maps[0], maps[1], maps[2], maps[3], prm);
  return (int)cudaGetLastError();
}

template <Variant V>
int launch(const Args& a) {
  if (a.n <= 0 || a.h <= 0 || a.w <= 0) return (int)cudaSuccess;
  Plan plan;
  if (a.c <= 0 || a.c % kTileKBytes || !make_plan(a.w, a.p, a.d, &plan))
    return (int)cudaErrorInvalidValue;
  // grid positions and compact rows in 32-bit ints, with a band of slack
  const long long total = (long long)a.n * (a.h + a.d) * plan.tw;
  if (total + (long long)(plan.tiles + 2) * kTile + 2LL * a.d * plan.tw > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  for (const void* ptr : {a.x, a.w1, a.w2, a.w3})
    if ((uintptr_t)ptr % 16) return (int)cudaErrorInvalidValue;  // TMA takes 16-byte aligned bases
  // kNoShift runs K2's own compiled kernel with the halo and the tap shifts
  // off, so the two differ only in that work
  constexpr Variant K = V == Variant::kConvOnly ? Variant::kConvOnly : Variant::kFull;
  const int halo = V == Variant::kFull;
  switch (a.p) {
    case 64: return launch_planes<64, K>(a, plan, halo);
    case 128: return launch_planes<128, K>(a, plan, halo);
    case 256: return launch_planes<256, K>(a, plan, halo);
    default: return launch_planes<512, K>(a, plan, halo);
  }
}

}  // namespace

// The plan of a block for width w, p mid channels and dilation d: writes
// {padded width, ring stages, tiles a band, q1 tile positions} to out and
// returns the dynamic shared memory in bytes; -1 for a shape the kernel does
// not take.
extern "C" int fused_bottleneck_plan(int w, int p, int d, int* out) {
  Plan plan;
  if (!make_plan(w, p, d, &plan)) return -1;
  out[0] = plan.tw;
  out[1] = plan.stages;
  out[2] = plan.tiles;
  out[3] = plan.q1_rows;
  return plan.smem;
}

// Plain C entry points (loaded with ctypes), one per variant, all with the
// same arguments. Each launches on `stream`, does not synchronise, allocates
// nothing; returns cudaGetLastError() of the launch, or cudaErrorInvalidValue
// for a shape the kernel does not take (P not 64, 128, 256 or 512, C not a
// multiple of 128, a band that does not fit shared memory, a base that is not
// 16-byte aligned). fused_bottleneck_s8 is K2.
#define FUSED_BOTTLENECK_ENTRY(name, variant)                                                   \
  extern "C" int name(const void* x, void* out, const void* w1, const void* w2, const void* w3, \
                      const void* a1, const void* b1, const void* a2, const void* b2,           \
                      const void* a3, const void* b3, const void* sid, int n, int h, int w,     \
                      int c, int p, int d, void* stream) {                                      \
    const Args args{x,  w1, w2, w3, out, a1, b1, a2, b2, a3, b3, sid,                           \
                    n,  h,  w,  c,  p,   d,  static_cast<cudaStream_t>(stream)};                \
    return launch<variant>(args);                                                               \
  }
FUSED_BOTTLENECK_ENTRY(fused_bottleneck_s8, Variant::kFull)
FUSED_BOTTLENECK_ENTRY(fused_bottleneck_noshift_s8, Variant::kNoShift)
FUSED_BOTTLENECK_ENTRY(fused_bottleneck_convonly_s8, Variant::kConvOnly)
