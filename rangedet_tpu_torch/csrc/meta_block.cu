// The fused Meta-Kernel block over (B, H, C, W): the three TPU kernels of
// rangedet_tpu/ops/meta_block_pallas.py, with the (B, H, 9C, W) tensor of
// tap products never written to device memory.
//
// Per pixel and tap t = (dy, dx) of its 3x3 neighbourhood (_taps_row):
//   rel = coords[h+dy-1, w+dx-1] - coords[h, w]   (f32 of the bf16 coords,
//                                                  zero padding)
//   h1  = relu(W0^T rel + b0)                      (Cm)
//   wt  = W1^T h1 + b1                             (C)
//   a   = bf16(feat[h+dy-1, :, w+dx-1] * wt)       (C, the tap product)
//
// meta_stats_fwd replaces meta_stats_pallas (_fwd_kernel, mode "stats"):
//   s1 = sum a, s2 = sum a^2 over all B*H*W pixels, per channel of 9C.
// meta_kernel_taps replaces _meta_kernel_fused_impl
//   (rangedet_tpu/ops/meta_kernel_pallas.py, kernel 7, the eval taps): a
//   itself, as (B, H, 9C, W) bf16, tap-major and channel-minor (the TPU
//   kernel rounds rel and h1 to bf16; this one rounds once, at the product).
// meta_agg_fwd replaces meta_agg_pallas (_fwd_kernel, mode "agg"):
//   y[co] = sum_t sum_c A[t*C+c, co] * relu(a_t[c] * s9 + b9), f32, rounded
//   once to bf16.
// meta_block_bwd replaces _bwd_call (_bwd_kernel), both modes:
//   "agg":   dz = (A_t gy) [z > 0]; dA += relu(z) gy^T, ds9 += dz a,
//            db9 += dz, da = dz s9;
//   "stats": da = e0 + e1 a (e0 = ds1, e1 = 2 ds2);
//   both:    dnb = da wt goes to dfeat at the neighbour; dwt = da nb feeds
//            the MLP backward (dW1, db1, dW0, db0).
//
// All four on Hopper: tensor cores over exact bf16 splits, and one tap
// stage (hidden, tap_stage) that forms the same a for every kernel. Every
// contraction has one factor that is exactly bf16: W1 (rounded to bf16 on
// load, as the block rounds it), agg, gy. The other factor x, f32, goes in
// as three bf16 terms hi = bf16(x), mid = bf16(x - hi), lo = bf16(x - hi -
// mid), which sum to x exactly (24 significand bits; both differences are
// exact in f32), and a bf16 x bf16 product is exact in f32. So three
// wgmma products accumulated in f32 give the f32 FFMA's products; only the
// order (and the tensor core's internal rounding) of the additions differs.
// dW1 = dwt h1^T has two f32 factors: both are split and six of the nine
// cross products are taken (hi.hi, hi.mid, mid.hi, hi.lo, lo.hi, mid.mid);
// the three dropped ones are below 2^-24 of the product.
//
// The contractions (M x N x K; wgmma M is 64, so the 64 pixels of a chunk
// are M wherever they are not K):
//   forward  wt   = h1 W1            px x C x Cm    h1 split, A in registers
//            y   += relu(z) A_t      px x Co x C    relu(z) split, registers
//   backward wt   = h1 W1            px x C x Cm    as above
//            dr   = gy A_t^T         px x C x Co    both bf16, gy registers
//            dA_t += relu(z)^T gy    C x Co x px    split, both in smem
//            dh1  = dwt W1^T         px x Cm x C    dwt split, registers
//            dW1 += dwt^T [h1 | 1]   C x (Cm+8) x px  6 cross products; the
//                                                   ones column gives db1
// A product's accumulators hold pixel m, channel n in the layout of wgmma's
// D fragment, which is also the layout of its A fragment from registers
// (pairs of columns packed as bf16x2): so wt, relu(z), dwt feed the next
// product without a trip through shared memory. The elementwise stage (rel,
// h1, a, z, dz, da, dnb, dwt, the splits) runs on the CUDA cores in those
// registers, with the plain version's f32 operations. Operands in shared
// memory are bf16 tiles of 128-byte rows with the 128-byte swizzle
// (hopper.cuh's sw128_desc); one tile serves as K-major or M/N-major
// depending on the product (agg[t][c][co] is the forward's N-major B and
// the backward's K-major B; W1[k][c] likewise).
//
// The tap product a = bf16(nb wt) is rounded mid-way, so a wt one f32 ulp
// from the plain version's moves some a by a bf16 ulp, and with it y (the
// model's gradients followed: chip_smoke's head gate read 0.143 > 0.14) and
// z's sign in the backward. So where nb wt lies within NEAR_TIE of a bf16
// rounding boundary (0.13% of the step's tap products), wt is recomputed
// on the CUDA cores in the plain version's order (tap_stage), and a is the
// plain version's bit for bit.
//
// Loads: the feature, coordinate and gy rows of a chunk come by TMA (boxes of
// a 4-D map, zero fill outside the image: that is the taps' zero padding, and
// rel at a border tap is -centre as in the plain version), into a 2-stage
// ring under mbarriers: the next chunk loads while this one computes (TAPS:
// one stage, loaded after the chunk, which leaves room for three blocks an
// SM: 3% and 9% faster at B=4 and B=1, PERF.md); the agg tile of each tap (8
// KB, from L2) streams into a 2-tile ring the same way. A box must start on
// 16 bytes along W, so boxes start 8 pixels left of the chunk and the
// one-pixel shifts are offsets of the elementwise stage's ordinary
// shared-memory loads.
//
// Loop order. Forward (meta_fwd_kernel, one template for kernels 3, 4 and 7):
// a block is one warpgroup (two or three blocks an SM) walking its chunks of
// 64 pixels of one row, taps inside, and each mode has its own tap epilogue.
// AGG: the tap's product with agg is added to y in f32 as the plain version
// adds the taps. STATS: a and a^2 of the chunk's columns < W summed over the
// thread's two pixel rows, then over the 8 lanes holding the same channels,
// into the warp's f32 sums in shared memory (no barrier inside a chunk); at
// the end the 4 warps' sums are added in order into the block's (2, 9C)
// partial. TAPS: the (64 channels x 64 pixels) tile of a goes to shared
// memory transposed (stmatrix .trans, [c][px], 128-byte swizzle) and from
// there to the output rows t*C .. t*C+63 by one TMA store (columns >= W
// clipped), through a 2-tile ring: before a tap's barrier thread 0 waits
// until the last tap's store has read its tile, so the tile written next is
// free. (A store of each warp's 16 pixels without the barrier measured 2%
// slower, PERF.md.) Backward: the gather form. A block (one warpgroup, one an
// SM) owns a chunk of 64 OUTPUT pixels q of one row; for tap t it rebuilds
// the tap at the source s = q - (dy-1, dx-1), whose tap-t neighbour is q, so
// nb is feat[q] and dnb lands on q: the 9 taps of dfeat add up in registers
// in tap order, and no f32 dfeat leaves the chip (the first port's backward
// kept a (B, H, C, W) f32 scratch, 87 MB at B=2, read and written at each
// tap). Chunks cover the
// rows -1 .. H and the columns -8 .. W, so that every (source, tap) pair
// inside the image is visited exactly once and the sums are complete;
// sources outside the image are masked. The f32 gradient sums: dA_t moves
// between the accumulators and the block's partial in device memory (147
// KB a block, L2-resident) at each tap; ds9, db9 are reduced over the
// lanes and warps in a fixed order into shared memory; dW1 and db1
// accumulate in the dW1 product's registers over the whole launch; db0,
// dW0 per thread in shared memory. Each block writes one f32 partial, and
// reduce_blocks_kernel adds the partials in block order. No float atomics:
// two runs give the same bits.
//
// Channel groups. The kernels are templates on (C, CO), built for (64, 64)
// and (128, 128); a block's tiles, W1 columns and f32 vectors cover a group
// of CG = 64 channels, and at C = 128 there are two. STATS, TAPS and the
// backward give each block one group (g = blockIdx % 2, the chunk range of
// blockIdx / 2): the sums, tap rows, dfeat channels, dA and ds9/db9 rows
// and dW1/db1 columns of a group are its own, and dW0/db0, linear in each
// group's dh1 (relu' of h1 does not depend on the group), are partials of
// every block. reduce_blocks_kernel adds, per element, the partials of the
// blocks that hold it in block order. AGG adds every group into y: a block
// walks each of its chunks' groups in turn (units), its y summing group 0's
// taps, then group 1's. CO = 128 outputs are two 64-column tiles: two N=64
// products of one A fragment. The backward's three gy rows are 60 KB at
// CO = 128, so its ring has one stage and one agg tap (two of each at 64).
// The C = 64 instance is the kernels as they were before the template, bit
// for bit (tools/profile_meta.py --against).
//
// What bounds them now: at the recipe's widths the split contractions are
// 0.11 TFLOP (meta_agg) and 0.25 TFLOP (agg-mode backward) per B=2 step,
// 0.1-0.3 ms at 989 TFLOP/s (the tensor-core bounds, with the rest of the
// work, are 0.038 and 0.089 ms); the CUDA-core elementwise stage between
// the dependent products of a tap, with few warps an SM to hide their
// waits, holds them at ~20-35x that (PERF.md). meta_stats is bound by its
// f32 elementwise work (0.025 ms per B=2 step) and the taps by the 783 MB
// they write at B=4 (0.26 ms at 3.35 TB/s); the same tap stage holds them
// at ~20x and ~3.3x (PERF.md).
//
// The geometry (chunks, box coordinates, the tap order and the order of
// the partials) is rangedet_tpu_torch/ops/meta_block.py:plan_meta, and
// tests/test_torch_meta_plan.py runs a torch emulation of these loops on
// the CPU with it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

// The widths are template arguments: C feature channels (the MLP's output)
// and CO aggregation outputs, built for (64, 64) (the veh, ped, cyc and
// multiclass recipes) and (128, 128) (rangedet_veh_tpuopt_all_36e). A
// block's tiles hold one group of CG channels; at C = 128 the groups
// g = 0, 1 split the channels [64g, 64g + 64) (see "Channel groups" above).
constexpr int CM = 32;   // MLP hidden width
constexpr int NT = 9;    // taps
constexpr int CG = 64;   // channels of a group

__device__ __forceinline__ float bf(const __nv_bfloat16 v) {
  return __bfloat162float(v);
}

// per-block partial layout of the backward (floats), of the block's group:
// its rows of dA, ds9, db9, its columns of dW1, db1, and dW0, db0
template <int CO>
struct Part {
  static constexpr int OFF_A = 0;                     // (9 CG, CO)
  static constexpr int OFF_S9 = OFF_A + NT * CG * CO;  // (9 CG)
  static constexpr int OFF_B9 = OFF_S9 + NT * CG;      // (9 CG)
  static constexpr int AGG_SUMS = OFF_B9 + NT * CG;
};
constexpr int MLP_W0 = 0;                 // (3, CM)
constexpr int MLP_B0 = MLP_W0 + 3 * CM;   // (CM)
constexpr int MLP_W1 = MLP_B0 + CM;       // (CM, CG)
constexpr int MLP_B1 = MLP_W1 + CM * CG;  // (CG)
constexpr int MLP_SUMS = MLP_B1 + CG;

// ------------------------------------------------ the tensor-core kernels
constexpr int TQ = 64;               // pixels of a chunk (wgmma M)
constexpr int HALO = 8;              // box columns left of the chunk: 16 B
constexpr int BOXW = TQ + 2 * HALO;  // box width of the shifted rows
constexpr int WGT = 128;             // threads of a warpgroup
constexpr int TILE = 64 * 128;       // 64 rows of 128 B: 8 KB
constexpr int H1_ROWS = CM + 8;      // h1 planes: CM rows, ones, zeros
constexpr int H1_PLANE = H1_ROWS * 128;
constexpr int FRAG_KSTEP = 2048;     // 16 rows of an M/N-major tile
constexpr int W1_TILES = 2 * CM * 128;  // W1 and |W1|, bf16 [k][c]
// where nb * wt lies within NEAR_TIE |nb| sum_k |h1 W1| of a bf16 rounding
// boundary, wt is recomputed in the plain version's order. On the card a
// tensor-core wt and the plain f32 wt lay well inside 2^-21 sum_k |h1 W1|
// of the exact sum (the worst case of 32 f32 roundings is 2^-19), and a
// margin 4x smaller gave the same y (PERF.md)
constexpr float NEAR_TIE = 1.f / (1 << 21);
constexpr int H1_PITCH = CM + 4;       // f32 rows of h1 in shared memory

constexpr int up128(int n) { return (n + 127) / 128 * 128; }

// f32 vectors in shared memory (float offsets) of a block that loads LC
// channels (its groups')
template <int LC>
struct Vec {
  static constexpr int B1 = 0;              // (LC)
  static constexpr int W0 = B1 + LC;        // (3, CM)
  static constexpr int B0 = W0 + 3 * CM;    // (CM)
  static constexpr int MLP = B0 + CM;       // the MLP's; then, for AGG and
  static constexpr int E0 = MLP;            // (9 LC) s9 or c1  the backward:
  static constexpr int E1 = E0 + NT * LC;   // (9 LC) b9 or c2
  static constexpr int FLOATS = E1 + NT * LC;
};

// the forward kernel's modes: kernels 3, 4 and 7 (meta_block_grid's kinds
// 0, 1 and 4)
enum FwdMode { STATS = 0, AGG = 1, TAPS = 2 };

// meta_fwd_kernel shared memory, bytes from a 1024-aligned base. STATS and
// TAPS: a block takes one group (GB = C / CG groups across the grid); AGG:
// a block takes every group of its chunks (GI = C / CG inside it), whose
// products all add into y.
template <int MODE, int C, int CO>
struct FwdLayout {
  static constexpr int G = C / CG;
  static constexpr int GB = MODE == AGG ? 1 : G;    // groups across blocks
  static constexpr int GI = G / GB;                 // groups inside a block
  static constexpr int LC = GI * CG;                // channels it loads
  static constexpr int NCO = CO / 64;               // 64-column agg tiles
  static constexpr int W1 = 0;                      // W1, |W1| [k][c], GI
  // AGG: the agg tiles of 2 taps; TAPS: 2 tiles of a [c][px] for the store
  static constexpr int AT = W1 + GI * W1_TILES;
  static constexpr int FEAT = 3 * CG * BOXW * 2;    // rows h-1..h+1 [c][x]
  static constexpr int CRD = 3 * 3 * BOXW * 2;      // rows h-1..h+1 [j][x]
  static constexpr int STAGE = up128(FEAT + CRD);
  // TAPS: one stage, which leaves room for three blocks an SM
  static constexpr int STAGES = MODE == TAPS ? 1 : 2;
  static constexpr int RING =
      AT + (MODE == STATS ? 0 : MODE == AGG ? 2 * NCO * TILE : 2 * TILE);
  static constexpr int W1F = RING + STAGES * STAGE;  // W1 f32 [k][c]
  static constexpr int H1R = W1F + CM * LC * 4;     // h1 f32 [m][H1_PITCH]
  static constexpr int VEC = H1R + TQ * H1_PITCH * 4;
  // STATS: each warp's sums [warp][tap][128] (slot_channel)
  static constexpr int SLOT =
      VEC + (MODE == AGG ? Vec<LC>::FLOATS : Vec<LC>::MLP) * 4;
  static constexpr int BAR = SLOT + (MODE == STATS ? 4 * NT * 128 * 4 : 0);
  static constexpr int SMEM = BAR + 4 * 8 + 1024;
};

// meta_block_bwd shared memory: a block takes one group (C / CG across the
// grid). At CO = 128 the three gy rows of a stage are 60 KB: one stage and
// one agg tap (RA) fit, where CO = 64 has two of each.
template <bool AGG, int C, int CO>
struct BwdLayout {
  static constexpr int NCO = CO / 64;
  static constexpr int STAGES = AGG && CO > 64 ? 1 : 2;
  static constexpr int RA = AGG && CO > 64 ? 1 : 2;
  static constexpr int W1 = 0;                       // W1, |W1| [k][c]
  static constexpr int DP = W1 + W1_TILES;           // dwt: 3 planes [m][c]
  static constexpr int H1P = DP + 3 * TILE;          // h1: 3 planes [k][m]
  static constexpr int RP = H1P + 3 * H1_PLANE;      // relu(z): 3 [m][c]
  static constexpr int GYC = RP + (AGG ? 3 * TILE : 0);  // gy [m][co]
  static constexpr int AT = GYC + (AGG ? NCO * TILE : 0);  // agg, RA taps
  static constexpr int FEAT = CG * TQ * 2;           // row hq [c][m]
  static constexpr int CRD = 3 * 3 * BOXW * 2;       // rows hq-1..hq+1
  static constexpr int GY = AGG ? 3 * CO * BOXW * 2 : 0;  // rows hq-1..hq+1
  static constexpr int S_CRD = FEAT;
  static constexpr int S_GY = S_CRD + up128(CRD);
  static constexpr int STAGE = up128(S_GY + GY);
  static constexpr int RING = AT + (AGG ? RA * NCO * TILE : 0);
  static constexpr int W1F = RING + STAGES * STAGE;  // W1 f32 [k][c]
  static constexpr int H1R = W1F + CM * CG * 4;     // h1 f32 [m][H1_PITCH]
  static constexpr int VEC = H1R + TQ * H1_PITCH * 4;
  static constexpr int MACC = VEC + Vec<CG>::FLOATS * 4;  // db0, dW0
  static constexpr int SLOT = MACC + 32 * WGT * 4;   // ds9, db9 [9][128]
  static constexpr int XCH = SLOT + (AGG ? NT * 128 * 4 : 0);  // 2 [4][128]
  static constexpr int BAR = XCH + (AGG ? 2 * 4 * 128 * 4 : 0);
  static constexpr int SMEM = BAR + 4 * 8 + 1024;
};
static_assert(BwdLayout<true, 64, 64>::SMEM <= 232448, "shared memory");
static_assert(2 * (FwdLayout<AGG, 64, 64>::SMEM + 1024) <= 233472,
              "2 blocks an SM");
static_assert(3 * (FwdLayout<TAPS, 64, 64>::SMEM + 1024) <= 233472,
              "3 blocks an SM");
static_assert(2 * (FwdLayout<STATS, 64, 64>::SMEM + 1024) <= 233472,
              "2 blocks an SM");
static_assert(BwdLayout<true, 128, 128>::SMEM <= 232448, "shared memory");
static_assert(FwdLayout<AGG, 128, 128>::SMEM <= 232448, "shared memory");
static_assert(3 * (FwdLayout<TAPS, 128, 128>::SMEM + 1024) <= 233472,
              "3 blocks an SM");
static_assert(2 * (FwdLayout<STATS, 128, 128>::SMEM + 1024) <= 233472,
              "2 blocks an SM");

struct BlockArgs {
  const float* w0;            // (3, CM), f32 (rounded to bf16 on load)
  const float* b0;            // (CM)
  const float* w1;            // (CM, C)
  const float* b1;            // (C)
  const float* e0;            // (9C) s9 or c1; null for STATS, TAPS
  const float* e1;            // (9C) b9 or c2; null for STATS, TAPS
  __nv_bfloat16* out;         // y (B, H, CO, W) or dfeat (B, H, C, W)
  float* part;                // (blocks, per-block floats): STATS, backward
  int H, W, chunks, nq;
};

// d (64 x 64, f32) = scale_d * d + A (64 x 16 bf16, in registers) *
// B (16 x 64, bf16 in shared memory, K-major (TB = 0) or N-major (1))
template <int TB>
__device__ __forceinline__ void wgmma_rs64(float (&d)[32], const uint32_t* a,
                                      uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d),
        "n"(TB));
}

// d (64 x 64, f32) = scale_d * d + A (64 x 16) * B (16 x 64), bf16 in
// shared memory, each K-major (0) or M/N-major (1)
template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss64(float (&d)[32], uint64_t da,
                                      uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31"
      "}, %32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

// d (64 x 40, f32) = scale_d * d + A (64 x 16) * B (16 x 40), bf16 in
// shared memory, each K-major (0) or M/N-major (1)
template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss40(float (&d)[20], uint64_t da,
                                      uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %22, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n40k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19"
      "}, %20, %21, p, 1, 1, %23, %24;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

// d (64 x 32, f32) = scale_d * d + A (64 x 16) * B (16 x 32), bf16 in
// shared memory, each K-major (0) or M/N-major (1)
template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss32(float (&d)[16], uint64_t da,
                                      uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, %19, %20;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// byte offset of bf16 element (row, col) in a tile of 128-byte rows with
// the 128-byte swizzle (the tile 1024-aligned)
__device__ __forceinline__ uint32_t swz(int row, int col) {
  return row * 128 + (((col >> 3) ^ (row & 7)) << 4) + ((col & 7) << 1);
}

__device__ __forceinline__ void st_pair(uint8_t* tile, int row, int col,
                                        uint32_t v) {
  *reinterpret_cast<uint32_t*>(tile + swz(row, col)) = v;
}

// (x0, x1) as three bf16 pairs hi + mid + lo that sum to them exactly
__device__ __forceinline__ void split_pair(float x0, float x1, uint32_t& hi,
                                           uint32_t& mid, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  const float r0 = __fsub_rn(x0, hf.x), r1 = __fsub_rn(x1, hf.y);
  const __nv_bfloat162 m = __floats2bfloat162_rn(r0, r1);
  const float2 mf = __bfloat1622float2(m);
  hi = as_u32(h);
  mid = as_u32(m);
  lo = as_u32(__floats2bfloat162_rn(__fsub_rn(r0, mf.x), __fsub_rn(r1, mf.y)));
}

// keeps registers read by an asynchronous wgmma alive until its wait
template <int N>
__device__ __forceinline__ void reg_fence(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}
template <int N, int M>
__device__ __forceinline__ void reg_fence(uint32_t (&r)[N][M]) {
#pragma unroll
  for (int i = 0; i < N; ++i) reg_fence(r[i]);
}

// descriptors: an M/N-major tile steps 16 rows per k-step, a K-major one
// 32 bytes along its rows
__device__ __forceinline__ uint64_t desc_mn(uint32_t addr, int kk) {
  return sw128_desc(addr + kk * FRAG_KSTEP, TILE);
}
__device__ __forceinline__ uint64_t desc_k(uint32_t addr, int kk) {
  return sw128_desc(addr + kk * 32, 16);
}

// x rounded to bf16, in f32
__device__ __forceinline__ float rbf(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// The block's constant operands, of its LC channels c0 .. c0+LC-1 of C:
// W1 and |W1| as [k][c], bf16 with the 128-byte swizzle, one pair of tiles
// a group, W1 in f32 [k][LC], and the f32 vectors (b1, s9/b9 or c1/c2 of
// those channels). The MLP's weights are rounded to bf16 here (the block's
// cast before the TPU kernel), so the caller passes them as they are.
template <int C, int LC>
__device__ void load_operands(const BlockArgs& p, uint8_t* sm, int w1_off,
                              int w1f_off, int vec_off, int c0) {
  using V = Vec<LC>;
  const int tid = threadIdx.x, n = blockDim.x;
  float* w1f = reinterpret_cast<float*>(sm + w1f_off);
  for (int e = tid; e < CM * LC / 2; e += n) {
    const int k = e / (LC / 2), c = 2 * (e % (LC / 2));
    const float* w = p.w1 + k * C + c0 + c;
    const float w0 = rbf(w[0]), w1 = rbf(w[1]);
    uint8_t* tile = sm + w1_off + (c / CG) * W1_TILES;
    st_pair(tile, k, c % CG, as_u32(__floats2bfloat162_rn(w0, w1)));
    st_pair(tile + CM * 128, k, c % CG,
            as_u32(__floats2bfloat162_rn(fabsf(w0), fabsf(w1))));
    w1f[k * LC + c] = w0;
    w1f[k * LC + c + 1] = w1;
  }
  float* v = reinterpret_cast<float*>(sm + vec_off);
  if (p.e0 != nullptr)
    for (int e = tid; e < NT * LC; e += n) {
      const int src = (e / LC) * C + c0 + e % LC;
      v[V::E0 + e] = p.e0[src];
      v[V::E1 + e] = p.e1[src];
    }
  for (int e = tid; e < LC; e += n) v[V::B1 + e] = rbf(p.b1[c0 + e]);
  for (int e = tid; e < 3 * CM; e += n) v[V::W0 + e] = rbf(p.w0[e]);
  for (int e = tid; e < CM; e += n) v[V::B0 + e] = rbf(p.b0[e]);
}

// h1[k] of one pixel = relu(W0^T rel + b0), with the plain version's f32
// operations in its order (no contraction into FMA); v: Vec<LC>'s vectors
template <int LC>
__device__ __forceinline__ float hidden_one(const float* v,
                                            const float (&r)[3], int k) {
  using V = Vec<LC>;
  float h = __fmul_rn(v[V::W0 + k], r[0]);
  h = __fadd_rn(h, __fmul_rn(v[V::W0 + CM + k], r[1]));
  h = __fadd_rn(h, __fmul_rn(v[V::W0 + 2 * CM + k], r[2]));
  return fmaxf(__fadd_rn(h, v[V::B0 + k]), 0.f);
}

// h1 at the thread's 16 places of a 64 x CM accumulator (pixel row r0 +
// 8*((e>>1)&1), k = 8*(e>>2) + 2*qd + (e&1)), split into three A
// fragments (K = CM), and in f32 into the rows h1r [m][H1_PITCH] (the quad
// of lanes of rows r0, r0 + 8 writes them whole)
template <int LC>
__device__ __forceinline__ void hidden(const float* v, const float (&rel)[2][3],
                                       int qd, int r0, float* h1r,
                                       float (&h1)[16], uint32_t (&ha)[3][8]) {
#pragma unroll
  for (int e = 0; e < 16; e += 2) {
    const int mi = (e >> 1) & 1, k = 8 * (e >> 2) + 2 * qd;
    h1[e] = hidden_one<LC>(v, rel[mi], k);
    h1[e + 1] = hidden_one<LC>(v, rel[mi], k + 1);
    split_pair(h1[e], h1[e + 1], ha[0][e / 2], ha[1][e / 2], ha[2][e / 2]);
    *reinterpret_cast<float2*>(h1r + (r0 + 8 * mi) * H1_PITCH + k) =
        make_float2(h1[e], h1[e + 1]);
  }
}

// wt = h1 W1 + b1 and the tap product a = bf16(nb wt) (packed pairs) at the
// thread's 32 places (pixel row r0 + 8*((e>>1)&1), channel c = 8*(e>>2) +
// 2*qd + (e&1) of the group); nb of pixel row r0, channel c is nbp[c *
// pitch], of row r0 + 8 nbp[c * pitch + 8]; b1v, w1f: the group's b1 and
// its W1 columns (f32, rows W1P apart), w1: its W1 tiles. wt comes from
// the tensor cores (the split h1
// against W1), and a is the plain version's a bit for bit: the hi term of
// h1 against |W1| gives the margin, and where nb wt lies within NEAR_TIE of
// a bf16 rounding boundary, wt is recomputed as the plain version sums it
// (k = 0 .. CM-1 by FFMA from h1r and w1f, then + b1). A tap product one
// bf16 ulp off moves y across its own rounding, z across 0, and the sums
// that see a (PERF.md).
template <int W1P>
__device__ __forceinline__ void tap_stage(
    float (&wt)[32], uint32_t (&a2)[16], uint32_t (&ha)[3][8],
    const __nv_bfloat16* nbp, int pitch, const float* b1v, const float* w1f,
    const float* h1r, int r0, uint32_t w1, int qd) {
  float mag[32];  // sum_k h1 |W1|, to a relative 2^-8
  wgmma_fence();
#pragma unroll
  for (int s = 0; s < 3; ++s)
#pragma unroll
    for (int kk = 0; kk < 2; ++kk)
      wgmma_rs64<1>(wt, &ha[s][4 * kk], desc_mn(w1, kk), s | kk);
#pragma unroll
  for (int kk = 0; kk < 2; ++kk)
    wgmma_rs64<1>(mag, &ha[0][4 * kk], desc_mn(w1 + CM * 128, kk), kk);
  wgmma_commit();
  wgmma_wait<0>();
  acc_fence(wt);
  acc_fence(mag);
  reg_fence(ha);
  uint32_t near = 0;  // bit e: nb wt within the margin of a bf16 boundary
#pragma unroll
  for (int e = 0; e < 32; ++e) {
    const int mi = (e >> 1) & 1, c = 8 * (e >> 2) + 2 * qd + (e & 1);
    wt[e] = __fadd_rn(wt[e], b1v[c]);
    const float nb = bf(nbp[c * pitch + 8 * mi]);
    const float p = __fmul_rn(nb, wt[e]);
    const float d = fmaf(NEAR_TIE * 1.01f, fabsf(nb) * mag[e],
                         fabsf(p) * (1.f / (1 << 22)));
    if (bf(__float2bfloat16_rn(p - d)) != bf(__float2bfloat16_rn(p + d)))
      near |= 1u << e;  // (as values: -0 and +0 are one)
  }
  // two elements a lane per pass, the lanes of a warp together (a few
  // passes a tap): wt in the plain version's order
  while (near) {
    const int e = __ffs(near) - 1;
    near &= near - 1;
    const int f = near ? __ffs(near) - 1 : e;
    near &= near - 1;
    const int ce = 8 * (e >> 2) + 2 * qd + (e & 1);
    const int cf = 8 * (f >> 2) + 2 * qd + (f & 1);
    const float* he = h1r + (r0 + 8 * ((e >> 1) & 1)) * H1_PITCH;
    const float* hf = h1r + (r0 + 8 * ((f >> 1) & 1)) * H1_PITCH;
    float se = 0.f, sf = 0.f;
#pragma unroll
    for (int k = 0; k < CM; k += 4) {
      const float4 x = *reinterpret_cast<const float4*>(he + k);
      const float4 y = *reinterpret_cast<const float4*>(hf + k);
      se = fmaf(x.x, w1f[k * W1P + ce], se);
      sf = fmaf(y.x, w1f[k * W1P + cf], sf);
      se = fmaf(x.y, w1f[(k + 1) * W1P + ce], se);
      sf = fmaf(y.y, w1f[(k + 1) * W1P + cf], sf);
      se = fmaf(x.z, w1f[(k + 2) * W1P + ce], se);
      sf = fmaf(y.z, w1f[(k + 2) * W1P + cf], sf);
      se = fmaf(x.w, w1f[(k + 3) * W1P + ce], se);
      sf = fmaf(y.w, w1f[(k + 3) * W1P + cf], sf);
    }
    se = __fadd_rn(se, b1v[ce]);
    sf = __fadd_rn(sf, b1v[cf]);
#pragma unroll
    for (int e2 = 0; e2 < 32; ++e2)
      wt[e2] = e2 == e ? se : e2 == f ? sf : wt[e2];
  }
  __syncwarp();  // the warp's h1 rows are read
#pragma unroll
  for (int e = 0; e < 32; e += 2) {
    const int mi = (e >> 1) & 1, c = 8 * (e >> 2) + 2 * qd;
    a2[e / 2] = as_u32(__floats2bfloat162_rn(
        __fmul_rn(bf(nbp[c * pitch + 8 * mi]), wt[e]),
        __fmul_rn(bf(nbp[(c + 1) * pitch + 8 * mi]), wt[e + 1])));
  }
}

// One step of reduce_lanes: v[0..HALF-1] += the partner's half (lane bit
// HALF), each lane keeping the half its bit selects. HALF is a template
// argument so that every index is a constant: with a loop over the halves
// ptxas kept v in local memory (a 128-byte stack frame, PERF.md).
template <int HALF>
__device__ __forceinline__ void fold_lanes(float (&v)[32], int lane) {
  const bool up = lane & HALF;
#pragma unroll
  for (int i = 0; i < HALF; ++i) {
    const float send = up ? v[i] : v[i + HALF];
    const float keep = up ? v[i + HALF] : v[i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, HALF);
  }
}

// Sums v[0..31] over lane bits 4, 3, 2 (the 8 lanes holding the same
// channels), halving the set at each step: lane l keeps the items 4*L + j,
// j < 4, L = 4*bit4 + 2*bit3 + bit2 of l, in v[0..3].
__device__ __forceinline__ void reduce_lanes(float (&v)[32], int lane) {
  fold_lanes<16>(v, lane);
  fold_lanes<8>(v, lane);
  fold_lanes<4>(v, lane);
}

// The channel of slot s (0..127) of a warp's sums of a tap: after
// reduce_lanes, lane l of quad qd holds its items 4L .. 4L+3 for slots s =
// 32 qd + item; item ci < 16 (the first sum) and 16 + ci (the second) are
// channel 8 (ci >> 1) + 2 qd + (ci & 1).
__device__ __forceinline__ int slot_channel(int s) {
  const int q = s / 32, ci = s % 16;
  return 8 * (ci >> 1) + 2 * q + (ci & 1);
}

// -------------------------------- kernels 3, 4 and 7: the forward taps
// MODE STATS (meta_stats), AGG (meta_agg) or TAPS (the eval taps). map_a:
// the agg tiles (AGG) or the output (B, H, 9C, W) (TAPS); p.part: the
// block's (2, 9 CG) sums of its group (STATS). A block walks units: a
// chunk and one of its groups (STATS, TAPS: the block's group, g =
// blockIdx % C/CG; AGG: every group of the chunk in turn, y adding the
// groups' products).
template <int MODE, int C, int CO>
__global__ void __launch_bounds__(WGT, 2)
    meta_fwd_kernel(const __grid_constant__ CUtensorMap map_f,
                    const __grid_constant__ CUtensorMap map_c,
                    const __grid_constant__ CUtensorMap map_a, BlockArgs p) {
  using L = FwdLayout<MODE, C, CO>;
  using V = Vec<L::LC>;
  constexpr int GI = L::GI, NCO = L::NCO;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* sm = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t sb = smem_u32(sm);
  const float* vec = reinterpret_cast<const float*>(sm + L::VEC);
  const float* w1f = reinterpret_cast<const float*>(sm + L::W1F);
  float* h1r = reinterpret_cast<float*>(sm + L::H1R);
  float* slot = reinterpret_cast<float*>(sm + L::SLOT);
  const int t = threadIdx.x, wq = t / 32, lane = t % 32;
  const int r0 = 16 * wq + lane / 4, qd = lane % 4;
  const int H = p.H, W = p.W;
  // the block's group (STATS, TAPS) and its place among the blocks of it
  const int gb = blockIdx.x % L::GB, jb = blockIdx.x / L::GB;
  const int nb = gridDim.x / L::GB;
  const uint32_t bar0 = sb + L::BAR;  // 2 ring stages, 2 agg tiles
  if (t == 0) {
    for (int j = 0; j < 4; ++j) mbar_init(bar0 + 8 * j, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  load_operands<C, L::LC>(p, sm, L::W1, L::W1F, L::VEC, gb * L::LC);
  if (MODE == STATS)
    for (int e = t; e < 4 * NT * 128; e += WGT) slot[e] = 0.f;
  fence_async_smem();
  __syncthreads();

  const int c_begin = (int)((long long)p.chunks * jb / nb);
  const int c_end = (int)((long long)p.chunks * (jb + 1) / nb);
  // the unit (chunk ch, group gb * GI + gi): rows h-1..h+1, columns w0-8 ..
  auto issue = [&](int ch, int gi, int s) {
    const int g = gb * GI + gi;
    const int kq = ch % p.nq, bh = ch / p.nq;
    const int b = bh / H, h = bh % H;
    const uint32_t st = sb + L::RING + s * L::STAGE;
    const uint32_t bar = bar0 + 8 * s;
    mbar_expect_tx(bar, L::FEAT + L::CRD);
    tma_load_4d(st, &map_f, bar, kq * TQ - HALO, g * CG, h - 1, b);
    tma_load_4d(st + L::FEAT, &map_c, bar, kq * TQ - HALO, 0, h - 1, b);
  };
  const int ntaps = (c_end - c_begin) * GI * NT;
  auto issue_agg = [&](int n) {  // agg[t] (its group's rows) of tap n
    const int g = gb * GI + (n / NT) % GI;
    const uint32_t bar = bar0 + 16 + 8 * (n & 1);
    mbar_expect_tx(bar, NCO * TILE);
#pragma unroll
    for (int j = 0; j < NCO; ++j)
      tma_load_4d(sb + L::AT + ((n & 1) * NCO + j) * TILE, &map_a, bar,
                  64 * j, (n % NT) * C + g * CG, 0, 0);
  };
  if (t == 0 && c_begin < c_end) {
    issue(c_begin, 0, 0);
    if (MODE == AGG) issue_agg(0);
  }
  int u = 0;  // the block's unit
  for (int ch = c_begin; ch < c_end; ++ch) {
    const int kq = ch % p.nq, bh = ch / p.nq;
    const int w0 = kq * TQ;
    const int b = bh / H, h = bh % H;
    float y[NCO][32];  // AGG: the chunk's outputs, over its groups' taps
    for (int gi = 0; gi < GI; ++gi, ++u) {
      const int g = gb * GI + gi;
      // stage s of the ring; its phase flips every STAGES units. The next
      // unit: this chunk's next group, or the next chunk's first
      const int s = L::STAGES == 2 ? u & 1 : 0;
      const bool last = gi + 1 == GI;
      if (L::STAGES == 2 && t == 0 && (!last || ch + 1 < c_end))
        issue(last ? ch + 1 : ch, last ? 0 : gi + 1, s ^ 1);
      const uint8_t* st = sm + L::RING + s * L::STAGE;
      const __nv_bfloat16* fs = reinterpret_cast<const __nv_bfloat16*>(st);
      const __nv_bfloat16* cs =
          reinterpret_cast<const __nv_bfloat16*>(st + L::FEAT);
      mbar_wait(bar0 + 8 * s, (u / L::STAGES) & 1);

      float cen[2][3];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int j = 0; j < 3; ++j)
          cen[mi][j] = bf(cs[(3 + j) * BOXW + HALO + r0 + 8 * mi]);
      if (gi == 0)
#pragma unroll
        for (int j = 0; j < NCO; ++j)
#pragma unroll
          for (int e = 0; e < 32; ++e) y[j][e] = 0.f;
#pragma unroll 1
      for (int tap = 0; tap < NT; ++tap) {
        const int n = u * NT + tap;
        const int dy = tap / 3, dx = tap % 3;
        const int x0 = HALO + r0 + dx - 1;  // box column of the neighbour
        // the last tap's product is done with its agg tile
        if (MODE == AGG && t == 0 && n + 1 < ntaps) issue_agg(n + 1);
        float rel[2][3];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int j = 0; j < 3; ++j)
            rel[mi][j] =
                bf(cs[(dy * 3 + j) * BOXW + x0 + 8 * mi]) - cen[mi][j];
        float h1[16];
        uint32_t ha[3][8];
        hidden<L::LC>(vec, rel, qd, r0, h1r, h1, ha);
        float wt[32];
        uint32_t a2[16];
        tap_stage<L::LC>(wt, a2, ha, fs + dy * CG * BOXW + x0, BOXW,
                         vec + V::B1 + gi * CG, w1f + gi * CG, h1r, r0,
                         sb + L::W1 + gi * W1_TILES, qd);

        if constexpr (MODE == AGG) {
          uint32_t ra[3][16];  // relu(z), split, as A fragments (K = CG)
          const float* e0 = vec + V::E0 + tap * L::LC + gi * CG;
          const float* e1 = vec + V::E1 + tap * L::LC + gi * CG;
#pragma unroll
          for (int e = 0; e < 32; e += 2) {
            const int c = 8 * (e >> 2) + 2 * qd;
            __nv_bfloat162 ab;
            *reinterpret_cast<uint32_t*>(&ab) = a2[e / 2];
            const float2 af = __bfloat1622float2(ab);
            float r[2];
#pragma unroll
            for (int v2 = 0; v2 < 2; ++v2) {
              const float z = __fadd_rn(
                  __fmul_rn(v2 ? af.y : af.x, e0[c + v2]), e1[c + v2]);
              r[v2] = fmaxf(z, 0.f);
            }
            split_pair(r[0], r[1], ra[0][e / 2], ra[1][e / 2], ra[2][e / 2]);
          }
          // this tap's product, added to y in f32 as the plain version
          // adds the taps (at C = 128: group 0's taps, then group 1's)
          mbar_wait(bar0 + 16 + 8 * (n & 1), (n >> 1) & 1);
#pragma unroll
          for (int j = 0; j < NCO; ++j) {
            float o[32];
            wgmma_fence();
#pragma unroll
            for (int sp = 0; sp < 3; ++sp)
#pragma unroll
              for (int kk = 0; kk < 4; ++kk)
                wgmma_rs64<1>(o, &ra[sp][4 * kk],
                              desc_mn(sb + L::AT + ((n & 1) * NCO + j) * TILE,
                                      kk),
                              sp | kk);
            wgmma_commit();
            wgmma_wait<0>();
            acc_fence(o);
            reg_fence(ra);
#pragma unroll
            for (int e = 0; e < 32; ++e) y[j][e] = __fadd_rn(y[j][e], o[e]);
          }
        } else if constexpr (MODE == STATS) {
          // [ci] sum a, [16 + ci] sum a^2 of channel 8 (ci >> 1) + 2 qd +
          // (ci & 1) over the thread's pixel rows inside the image
          const bool in0 = w0 + r0 < W, in1 = w0 + r0 + 8 < W;
          float red[32];
#pragma unroll
          for (int e = 0; e < 32; ++e) red[e] = 0.f;
#pragma unroll
          for (int k = 0; k < 16; ++k) {  // a2[k]: row r0 + 8 (k & 1)
            __nv_bfloat162 ab;
            *reinterpret_cast<uint32_t*>(&ab) = a2[k];
            const float2 af = __bfloat1622float2(ab);
            if ((k & 1) ? in1 : in0) {
              const int ci = 2 * (k >> 1);
              red[ci] = __fadd_rn(red[ci], af.x);
              red[ci + 1] = __fadd_rn(red[ci + 1], af.y);
              red[16 + ci] = __fadd_rn(red[16 + ci], __fmul_rn(af.x, af.x));
              red[17 + ci] = __fadd_rn(red[17 + ci], __fmul_rn(af.y, af.y));
            }
          }
          reduce_lanes(red, lane);
          // added to the warp's sums of this tap (each lane its own slots)
          const int li = 4 * (4 * ((lane >> 4) & 1) + 2 * ((lane >> 3) & 1) +
                              ((lane >> 2) & 1));
          float* sl = slot + (wq * NT + tap) * 128 + qd * 32 + li;
#pragma unroll
          for (int j = 0; j < 4; ++j) sl[j] += red[j];
        } else {
          // the tile of a, [c][px], into the free tile of the ring: four
          // transposing fragment stores a warp (matrix q of store k:
          // channels 8 (2k + q / 2) .., pixels 16 wq + 8 (q % 2) ..)
          const uint32_t tile = sb + L::AT + (n & 1) * TILE;
          const int q = lane / 8, rr = lane % 8;
#pragma unroll
          for (int k = 0; k < 4; ++k)
            stmatrix_x4_trans(tile + swz(8 * (2 * k + q / 2) + rr,
                                         16 * wq + 8 * (q % 2)),
                              a2[4 * k], a2[4 * k + 1], a2[4 * k + 2],
                              a2[4 * k + 3]);
          fence_async_smem();
          // the last tap's store has read its tile: the next tap may
          // rewrite it
          if (t == 0) bulk_wait_read<0>();
          __syncthreads();
          if (t == 0) {
            tma_store_4d(&map_a, tile, w0, tap * C + g * CG, h, b);
            bulk_commit();
          }
        }
      }
      if (MODE == AGG && last) {  // y of the chunk: every group added
#pragma unroll
        for (int j = 0; j < NCO; ++j)
#pragma unroll
          for (int e = 0; e < 32; ++e) {
            const int w = w0 + r0 + 8 * ((e >> 1) & 1);
            const int co = 64 * j + 8 * (e >> 2) + 2 * qd + (e & 1);
            if (w < W)
              p.out[((size_t)(b * H + h) * CO + co) * W + w] =
                  __float2bfloat16(y[j][e]);
          }
      }
      __syncthreads();  // the stage is read: the next TMA may overwrite it
      if (L::STAGES == 1 && t == 0 && (!last || ch + 1 < c_end))
        issue(last ? ch + 1 : ch, last ? 0 : gi + 1, 0);
    }
  }
  if constexpr (MODE == TAPS) {
    if (t == 0) bulk_wait<0>();  // the stores are done with shared memory
  }
  if constexpr (MODE == STATS) {
    // the block's sums: (2, 9 CG) of its group, row 0 sum a, row 1 sum
    // a^2; the four warps' in order
    __syncthreads();
    float* part = p.part + (size_t)blockIdx.x * 2 * NT * CG;
    for (int e = t; e < NT * 128; e += WGT) {
      const int tap = e / 128, item = e % 32;
      const float v = ((slot[e] + slot[NT * 128 + e]) +
                       slot[2 * NT * 128 + e]) + slot[3 * NT * 128 + e];
      part[(item < 16 ? 0 : NT * CG) + tap * CG + slot_channel(e % 128)] = v;
    }
  }
}

// ------------------------------------- kernel 5: the block backward
// A block takes one group g = blockIdx % (C / CG): the dfeat channels, dA
// and ds9/db9 rows, and dW1/db1 columns of the group, and its share of
// dW0/db0 (linear in the group's terms: relu' of h1 does not depend on them).
template <bool AGG, int C, int CO>
__global__ void __launch_bounds__(WGT, 1)
    meta_bwd_kernel(const __grid_constant__ CUtensorMap map_f,
                    const __grid_constant__ CUtensorMap map_c,
                    const __grid_constant__ CUtensorMap map_g,
                    const __grid_constant__ CUtensorMap map_a, BlockArgs p) {
  using L = BwdLayout<AGG, C, CO>;
  using V = Vec<CG>;
  using P = Part<CO>;
  constexpr int G = C / CG, NCO = L::NCO, RA = L::RA;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* sm = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t sb = smem_u32(sm);
  const float* vec = reinterpret_cast<const float*>(sm + L::VEC);
  float* macc = reinterpret_cast<float*>(sm + L::MACC);
  float* slot = reinterpret_cast<float*>(sm + L::SLOT);
  float* xch = reinterpret_cast<float*>(sm + L::XCH);
  const int t = threadIdx.x, wq = t / 32, lane = t % 32;
  const int r0 = 16 * wq + lane / 4, qd = lane % 4;
  const int H = p.H, W = p.W, Hq = H + 2;
  const int g = blockIdx.x % G, jb = blockIdx.x / G, nb = gridDim.x / G;
  const float* w1f = reinterpret_cast<const float*>(sm + L::W1F);
  float* h1r = reinterpret_cast<float*>(sm + L::H1R);
  const uint32_t bar0 = sb + L::BAR;  // ring stages, agg tiles
  if (t == 0) {
    for (int j = 0; j < 4; ++j) mbar_init(bar0 + 8 * j, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  load_operands<C, CG>(p, sm, L::W1, L::W1F, L::VEC, g * CG);
  // rows CM.. of the h1 planes: a row of ones in the first (its product
  // with dwt is db1), zeros
  for (int e = t; e < 3 * 8 * TQ; e += WGT) {
    const int s = e / (8 * TQ), row = CM + (e / TQ) % 8, col = e % TQ;
    *reinterpret_cast<__nv_bfloat16*>(sm + L::H1P + s * H1_PLANE +
                                      swz(row, col)) =
        __float2bfloat16(s == 0 && row == CM ? 1.f : 0.f);
  }
  for (int e = t; e < 32 * WGT; e += WGT) macc[e] = 0.f;
  if (AGG)
    for (int e = t; e < NT * 128; e += WGT) slot[e] = 0.f;
  fence_async_smem();
  __syncthreads();

  const int c_begin = (int)((long long)p.chunks * jb / nb);
  const int c_end = (int)((long long)p.chunks * (jb + 1) / nb);
  float* part = p.part + (size_t)blockIdx.x * ((AGG ? P::AGG_SUMS : 0) +
                                               MLP_SUMS);
  float* mlp = part + (AGG ? P::AGG_SUMS : 0);
  auto issue = [&](int ch, int s) {  // row hq at q0 .., rows hq-1..hq+1
    const int kq = ch % p.nq, rest = ch / p.nq;
    const int hq = rest % Hq - 1, b = rest / Hq, q0 = kq * TQ - HALO;
    const uint32_t st = sb + L::RING + s * L::STAGE;
    const uint32_t bar = bar0 + 8 * s;
    mbar_expect_tx(bar, L::FEAT + L::CRD + L::GY);
    tma_load_4d(st, &map_f, bar, q0, g * CG, hq, b);
    tma_load_4d(st + L::S_CRD, &map_c, bar, q0 - HALO, 0, hq - 1, b);
    if (AGG) tma_load_4d(st + L::S_GY, &map_g, bar, q0 - HALO, 0, hq - 1, b);
  };
  // agg[t] (the group's rows) for the block's n-th tap, into tile n % RA
  // (RA is 1 or 2: masks and shifts, as ptxas allocates the C = 64 kernel
  // best with them)
  const int ntaps = (c_end - c_begin) * NT;
  auto issue_agg = [&](int n) {
    const uint32_t bar = bar0 + 16 + 8 * (n & (RA - 1));
    mbar_expect_tx(bar, NCO * TILE);
#pragma unroll
    for (int j = 0; j < NCO; ++j)
      tma_load_4d(sb + L::AT + ((n & (RA - 1)) * NCO + j) * TILE, &map_a,
                  bar, 64 * j, (n % NT) * C + g * CG, 0, 0);
  };

  float dw1[20];  // dW1^T (CG x CM) and db1 (column CM) of the launch
  if (t == 0 && c_begin < c_end) {
    issue(c_begin, 0);
    if (AGG && RA == 2) issue_agg(0);
  }
  int i = 0;
  for (int ch = c_begin; ch < c_end; ++ch, ++i) {
    const int s = L::STAGES == 2 ? i & 1 : 0;
    if (L::STAGES == 2 && t == 0 && ch + 1 < c_end) issue(ch + 1, s ^ 1);
    const int kq = ch % p.nq, rest = ch / p.nq;
    const int hq = rest % Hq - 1, b = rest / Hq, q0 = kq * TQ - HALO;
    const uint8_t* st = sm + L::RING + s * L::STAGE;
    const __nv_bfloat16* fs = reinterpret_cast<const __nv_bfloat16*>(st);
    const __nv_bfloat16* cs =
        reinterpret_cast<const __nv_bfloat16*>(st + L::S_CRD);
    const __nv_bfloat16* gs =
        reinterpret_cast<const __nv_bfloat16*>(st + L::S_GY);
    mbar_wait(bar0 + 8 * s, (i >> (L::STAGES - 1)) & 1);

    float cq[2][3];  // coordinates of the output pixels (the neighbours)
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int j = 0; j < 3; ++j)
        cq[mi][j] = bf(cs[(3 + j) * BOXW + HALO + r0 + 8 * mi]);
    float dfeat[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) dfeat[e] = 0.f;

#pragma unroll 1
    for (int tap = 0; tap < NT; ++tap) {
      const int n = i * NT + tap;
      const int dy = tap / 3, dx = tap % 3;
      const int hs = hq - dy + 1;         // the sources' row
      const int srow = 2 - dy;            // its box row
      const int x0 = HALO + r0 + 1 - dx;  // box column of source m = r0
      float rel[2][3];
      bool valid[2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const int sq = q0 + r0 + 8 * mi + 1 - dx;
        valid[mi] = hs >= 0 && hs < H && sq >= 0 && sq < W;
#pragma unroll
        for (int j = 0; j < 3; ++j)
          rel[mi][j] =
              cq[mi][j] - bf(cs[(srow * 3 + j) * BOXW + x0 + 8 * mi]);
      }
      float h1[16];
      uint32_t ha[3][8];
      hidden<CG>(vec, rel, qd, r0, h1r, h1, ha);
      uint32_t on1 = 0;  // bit e: h1 > 0
#pragma unroll
      for (int e = 0; e < 16; ++e) on1 |= (h1[e] > 0.f ? 1u : 0u) << e;
      // the last tap's dW1 product reads the planes; its agg tile is free
      wgmma_wait<0>();
      acc_fence(dw1);
      if (AGG && t == 0 && n + RA - 1 < ntaps) issue_agg(n + RA - 1);
#pragma unroll
      for (int e = 0; e < 16; e += 2) {  // h1 planes [k][m] for dW1
        const int m = r0 + 8 * ((e >> 1) & 1), k = 8 * (e >> 2) + 2 * qd;
#pragma unroll
        for (int sp = 0; sp < 3; ++sp) {
          uint8_t* pl = sm + L::H1P + sp * H1_PLANE;
          const uint32_t v = ha[sp][e / 2];
          *reinterpret_cast<uint16_t*>(pl + swz(k, m)) = v & 0xffff;
          *reinterpret_cast<uint16_t*>(pl + swz(k + 1, m)) = v >> 16;
        }
      }
      float wt[32];
      uint32_t a2[16];
      tap_stage<CG>(wt, a2, ha, fs + r0, TQ, vec + V::B1, w1f, h1r, r0,
                    sb + L::W1, qd);

      float da[32];  // A_t gy (agg), then da
      uint32_t ga[CO / 4];
      if constexpr (AGG) {
        // gy at the sources: A fragments (K = Co) and the N-major copy
        // (64 columns a tile)
#pragma unroll
        for (int e = 0; e < CO / 2; e += 2) {
          // column cc of the gy tile j: co = 64 j + cc
          const int j = e / 32, mi = (e >> 1) & 1;
          const int cc = 8 * ((e % 32) >> 2) + 2 * qd;
          const __nv_bfloat16* gp =
              gs + (srow * CO + 64 * j + cc) * BOXW + x0 + 8 * mi;
          __nv_bfloat162 v;
          v.x = gp[0];
          v.y = gp[BOXW];
          ga[e / 2] = as_u32(v);
          st_pair(sm + L::GYC + j * TILE, r0 + 8 * mi, cc, ga[e / 2]);
        }
        mbar_wait(bar0 + 16 + 8 * (n & (RA - 1)), (n >> (RA - 1)) & 1);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < CO / 16; ++kk)
          wgmma_rs64<0>(da, &ga[4 * kk],
                        desc_k(sb + L::AT +
                                   ((n & (RA - 1)) * NCO + kk / 4) * TILE,
                               kk % 4),
                        kk);
        wgmma_commit();
      }
      if constexpr (AGG) {
        wgmma_wait<0>();
        acc_fence(da);
        reg_fence(ga);
      }
      // per element: dz and relu(z) (agg), da; dfeat += da wt in tap order;
      // dwt = da nb, split into the planes of dh1 and dW1
      float red[32];  // agg: [ci] sum dz*a, [16 + ci] sum dz, per channel
#pragma unroll
      for (int e = 0; e < 32; ++e) red[e] = 0.f;
#pragma unroll
      for (int e = 0; e < 32; e += 2) {
        const int mi = (e >> 1) & 1, m = r0 + 8 * mi;
        const int c = 8 * (e >> 2) + 2 * qd;
        __nv_bfloat162 ab;
        *reinterpret_cast<uint32_t*>(&ab) = a2[e / 2];
        const float2 af = __bfloat1622float2(ab);
        float r[2], dw[2];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const float a = u ? af.y : af.x;
          const float e0 = vec[V::E0 + tap * CG + c + u];
          const float e1 = vec[V::E1 + tap * CG + c + u];
          float d;
          if constexpr (AGG) {
            const int ci = 2 * (e >> 2) + u;
            const float z = __fadd_rn(__fmul_rn(a, e0), e1);
            const bool on = valid[mi] && z > 0.f;
            const float dz = on ? da[e + u] : 0.f;
            r[u] = on ? z : 0.f;
            red[ci] = __fadd_rn(red[ci], __fmul_rn(dz, a));
            red[16 + ci] += dz;
            d = __fmul_rn(dz, e0);
          } else {
            d = valid[mi] ? __fadd_rn(e0, __fmul_rn(e1, a)) : 0.f;
          }
          dfeat[e + u] = __fadd_rn(dfeat[e + u], __fmul_rn(d, wt[e + u]));
          dw[u] = __fmul_rn(d, bf(fs[(c + u) * TQ + m]));
        }
        uint32_t hi, mid, lo;
        if constexpr (AGG) {
          split_pair(r[0], r[1], hi, mid, lo);
          st_pair(sm + L::RP, m, c, hi);
          st_pair(sm + L::RP + TILE, m, c, mid);
          st_pair(sm + L::RP + 2 * TILE, m, c, lo);
        }
        split_pair(dw[0], dw[1], hi, mid, lo);
        st_pair(sm + L::DP, m, c, hi);
        st_pair(sm + L::DP + TILE, m, c, mid);
        st_pair(sm + L::DP + 2 * TILE, m, c, lo);
      }
      float dA[NCO][32];
      float* sl = part + P::OFF_A + tap * CG * CO;  // this tap's dA partial
      if constexpr (AGG) {
        if (ch != c_begin)
#pragma unroll
          for (int j = 0; j < NCO; ++j)
#pragma unroll
            for (int e = 0; e < 32; e += 2) {
              const int c = r0 + 8 * ((e >> 1) & 1);
              const int co = 64 * j + 8 * (e >> 2) + 2 * qd;
              const float2 v =
                  *reinterpret_cast<const float2*>(sl + c * CO + co);
              dA[j][e] = v.x;
              dA[j][e + 1] = v.y;
            }
        reduce_lanes(red, lane);
        const int li = 4 * (4 * ((lane >> 4) & 1) + 2 * ((lane >> 3) & 1) +
                            ((lane >> 2) & 1));
        float* x = xch + (n & 1) * 512;
#pragma unroll
        for (int j = 0; j < 4; ++j) x[wq * 128 + qd * 32 + li + j] = red[j];
      }
      fence_async_smem();
      __syncthreads();
      if constexpr (AGG) {
        // ds9, db9 of this tap: the four warps' sums in order
        const float* x = xch + (n & 1) * 512;
        slot[tap * 128 + t] += ((x[t] + x[128 + t]) + x[256 + t]) + x[384 + t];
        // dA_t += relu(z)^T gy over the chunk's sources
        wgmma_fence();
#pragma unroll
        for (int j = 0; j < NCO; ++j)
#pragma unroll
          for (int sp = 0; sp < 3; ++sp)
#pragma unroll
            for (int kk = 0; kk < 4; ++kk)
              wgmma_ss64<1, 1>(dA[j], desc_mn(sb + L::RP + sp * TILE, kk),
                               desc_mn(sb + L::GYC + j * TILE, kk),
                               (sp | kk) != 0 || ch != c_begin);
        wgmma_commit();
      }
      // dh1 = dwt W1^T
      float dh[16];
      wgmma_fence();
#pragma unroll
      for (int sp = 0; sp < 3; ++sp)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_ss32<0, 0>(dh, desc_k(sb + L::DP + sp * TILE, kk),
                           desc_k(sb + L::W1, kk), sp | kk);
      wgmma_commit();
      // dW1^T += dwt^T [h1 | 1]: six cross products of the splits
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        constexpr int SA[6] = {0, 0, 1, 0, 2, 1}, SB[6] = {0, 1, 0, 2, 0, 1};
#pragma unroll
        for (int pr = 0; pr < 6; ++pr)
          wgmma_ss40<1, 0>(dw1, desc_mn(sb + L::DP + SA[pr] * TILE, kk),
                           desc_k(sb + L::H1P + SB[pr] * H1_PLANE, kk),
                           kk | pr | n);
      }
      wgmma_commit();
      if constexpr (AGG) {
        wgmma_wait<2>();  // dA
#pragma unroll
        for (int j = 0; j < NCO; ++j) {
          acc_fence(dA[j]);
#pragma unroll
          for (int e = 0; e < 32; e += 2) {
            const int c = r0 + 8 * ((e >> 1) & 1);
            const int co = 64 * j + 8 * (e >> 2) + 2 * qd;
            *reinterpret_cast<float2*>(sl + c * CO + co) =
                make_float2(dA[j][e], dA[j][e + 1]);
          }
        }
      }
      wgmma_wait<1>();  // dh1
      acc_fence(dh);
      float loc[32];  // this tap's db0 [kk], dW0 [8 (1 + j) + kk]
#pragma unroll
      for (int e = 0; e < 32; ++e) loc[e] = 0.f;
#pragma unroll
      for (int e = 0; e < 16; ++e) {  // dh1 [h1 > 0] -> db0, dW0
        const int mi = (e >> 1) & 1, kk = 2 * (e >> 2) + (e & 1);
        const float d = (on1 >> e) & 1 ? dh[e] : 0.f;
        loc[kk] += d;
#pragma unroll
        for (int j = 0; j < 3; ++j)
          loc[8 * (1 + j) + kk] = fmaf(d, rel[mi][j], loc[8 * (1 + j) + kk]);
      }
#pragma unroll
      for (int e = 0; e < 32; ++e) macc[e * WGT + t] += loc[e];
    }
    if (hq >= 0 && hq < H)
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int q = q0 + r0 + 8 * ((e >> 1) & 1);
        const int c = g * CG + 8 * (e >> 2) + 2 * qd + (e & 1);
        if (q >= 0 && q < W)
          p.out[((size_t)(b * H + hq) * C + c) * W + q] =
              __float2bfloat16(dfeat[e]);
      }
    if (L::STAGES == 1) {  // the stage is read: the next TMA may overwrite it
      __syncthreads();
      if (t == 0 && ch + 1 < c_end) issue(ch + 1, 0);
    }
  }
  wgmma_wait<0>();
  acc_fence(dw1);

  // the block's partials
#pragma unroll
  for (int e = 0; e < 20; ++e) {
    const int c = r0 + 8 * ((e >> 1) & 1);
    const int k = 8 * (e >> 2) + 2 * qd + (e & 1);
    if (k < CM)
      mlp[MLP_W1 + k * CG + c] = dw1[e];
    else if (k == CM)
      mlp[MLP_B1 + c] = dw1[e];
  }
  __syncthreads();  // every thread's slot and accumulators are written
  if (AGG)
    for (int e = t; e < NT * 128; e += WGT) {
      const int tap = e / 128, item = e % 32;
      part[(item < 16 ? P::OFF_S9 : P::OFF_B9) + tap * CG +
           slot_channel(e % 128)] = slot[e];
    }
  {  // db0, dW0 over the 32 threads holding each k, in thread order
    const int kind = t / 32, k = t % 32;
    const int kk = 2 * (k / 8) + (k & 1);
    float v = 0.f;
    for (int u = (k % 8) / 2; u < WGT; u += 4)
      v += macc[(8 * kind + kk) * WGT + u];
    mlp[kind == 0 ? MLP_B0 + k : MLP_W0 + (kind - 1) * CM + k] = v;
  }
}

// f32 partials of one block (floats) of a launch kind (0 stats, 2 stats
// backward, 3 agg backward): its group's, as at C = CG
template <int CO>
__host__ __device__ constexpr int part_floats(int kind) {
  return kind == 0   ? 2 * NT * CG
         : kind == 2 ? MLP_SUMS
         : kind == 3 ? Part<CO>::AGG_SUMS + MLP_SUMS
                     : 0;
}

// the reduced sums (floats): (2, 9C); or [dA (9C, CO), ds9, db9] (agg
// only) then [dW0 (3, CM), db0, dW1 (CM, C), db1]
template <int C, int CO>
__host__ __device__ constexpr int sum_floats(int kind) {
  return kind == 0 ? 2 * NT * C
                   : (kind == 3 ? NT * C * CO + 2 * NT * C : 0) + 4 * CM +
                         CM * C + C;
}

// Element e of the sums: the group g whose blocks hold it (-1: every block,
// dW0 and db0) and its index in their partials. At C = 64 the partials are
// laid out as the sums: idx = e.
template <int C, int CO>
__device__ void sum_source(int kind, int e, int& g, int& idx) {
  if (kind == 0) {  // (2, 9C)
    const int r = e / (NT * C), t = (e / C) % NT, c = e % C;
    g = c / CG;
    idx = (r * NT + t) * CG + c % CG;
    return;
  }
  int a = 0;  // the partial's floats before the MLP's
  if (kind == 3) {
    constexpr int NA = NT * C * CO;
    if (e < NA) {  // dA (9C, CO)
      const int row = e / CO, t = row / C, c = row % C;
      g = c / CG;
      idx = (t * CG + c % CG) * CO + e % CO;
      return;
    }
    if (e < NA + 2 * NT * C) {  // ds9, db9 (9C each)
      const int f = e - NA, k = f / (NT * C), t = (f / C) % NT, c = f % C;
      g = c / CG;
      idx = Part<CO>::OFF_S9 + (k * NT + t) * CG + c % CG;
      return;
    }
    e -= NA + 2 * NT * C;
    a = Part<CO>::AGG_SUMS;
  }
  if (e < MLP_W1) {  // dW0, db0
    g = -1;
    idx = a + e;
  } else if (e < MLP_W1 + CM * C) {  // dW1 (CM, C)
    const int k = (e - MLP_W1) / C, c = (e - MLP_W1) % C;
    g = c / CG;
    idx = a + MLP_W1 + k * CG + c % CG;
  } else {  // db1 (C)
    const int c = e - MLP_W1 - CM * C;
    g = c / CG;
    idx = a + MLP_B1 + c % CG;
  }
}

// out[e] = the sum of the partials that hold e over their blocks, in block
// order (blocks g, g + G, .. of group g; every block for dW0, db0).
template <int C, int CO>
__global__ void reduce_blocks_kernel(const float* __restrict__ part,
                                     float* __restrict__ out, int blocks,
                                     int kind) {
  constexpr int G = C / CG;
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= sum_floats<C, CO>(kind)) return;
  int g, idx;
  sum_source<C, CO>(kind, e, g, idx);
  const int pf = part_floats<CO>(kind), step = g < 0 ? 1 : G;
  float v = 0.f;
  for (int b = g < 0 ? 0 : g; b < blocks; b += step)
    v += part[(size_t)b * pf + idx];
  out[e] = v;
}

template <int C, int CO>
void reduce_blocks(const void* part, void* sums, int blocks, int kind,
                   cudaStream_t s) {
  const int n = sum_floats<C, CO>(kind);
  reduce_blocks_kernel<C, CO><<<(n + 255) / 256, 256, 0, s>>>(
      (const float*)part, (float*)sums, blocks, kind);
}

// chunks of a launch: kinds 0, 1, 4 (meta_stats, meta_agg, the taps)
// 64-pixel chunks of the image's rows; kinds 2, 3 (the backward) output
// chunks of rows -1 .. H, columns -8 .. W (ops/meta_block.py:plan_meta)
bool forward_kind(int kind) { return kind == 0 || kind == 1 || kind == 4; }
int chunks_per_row(int kind, int W) {
  return forward_kind(kind) ? (W + TQ - 1) / TQ
                            : (W + HALO + 1 + TQ - 1) / TQ;
}
int chunks_of(int kind, int B, int H, int W) {
  return B * (forward_kind(kind) ? H : H + 2) * chunks_per_row(kind, W);
}

// blocks of a persistent launch: as many as fit on every SM at once, a
// multiple of `groups` (the channel groups across the grid), at most one
// per `work` chunks a group; negative on error
template <typename K>
int blocks_for(K kernel, int threads, int smem, int work, int groups) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return -(int)err;
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      threads, smem);
  if (err != cudaSuccess) return -(int)err;
  const int blocks = per_sm * sms / groups;
  if (blocks < 1) return -1;
  return groups * (blocks < work ? blocks : work);
}

template <int C, int CO>
int grid_of(int kind, int B, int H, int W) {
  constexpr int G = C / CG;
  const int work = chunks_of(kind, B, H, W);
  switch (kind) {
    case 0:
      return blocks_for(meta_fwd_kernel<STATS, C, CO>, WGT,
                        FwdLayout<STATS, C, CO>::SMEM, work, G);
    case 1:
      return blocks_for(meta_fwd_kernel<AGG, C, CO>, WGT,
                        FwdLayout<AGG, C, CO>::SMEM, work, 1);
    case 2:
      return blocks_for(meta_bwd_kernel<false, C, CO>, WGT,
                        BwdLayout<false, C, CO>::SMEM, work, G);
    case 3:
      return blocks_for(meta_bwd_kernel<true, C, CO>, WGT,
                        BwdLayout<true, C, CO>::SMEM, work, G);
    default:
      return blocks_for(meta_fwd_kernel<TAPS, C, CO>, WGT,
                        FwdLayout<TAPS, C, CO>::SMEM, work, G);
  }
}

// a bf16 tensor (d3, d2, d1, d0) with row pitch p0 >= d0 elements as the
// 4-D map (d0, d1, d2, d3); boxes of box0 x box1 x box2 elements, no
// swizzle, zeros out of range
int encode_box(CUtensorMap* map, const void* ptr, int d0, int d1, int d2,
               int d3, int p0, int box0, int box1, int box2) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return -1;
  const cuuint64_t dims[4] = {(cuuint64_t)d0, (cuuint64_t)d1, (cuuint64_t)d2,
                              (cuuint64_t)d3};
  const cuuint64_t strides[3] = {(cuuint64_t)p0 * 2,
                                 (cuuint64_t)p0 * 2 * d1,
                                 (cuuint64_t)p0 * 2 * d1 * d2};
  const cuuint32_t box[4] = {(cuuint32_t)box0, (cuuint32_t)box1,
                             (cuuint32_t)box2, 1};
  const cuuint32_t estride[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                        const_cast<void*>(ptr), dims, strides, box, estride,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_NONE,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : -1;
}

// feat (B, H, C, pitch) and cb (B, H, 3, pitch) as the forward's maps:
// boxes of one group's channels of rows h-1 .. h+1 from 8 pixels left of a
// chunk
template <int C>
int encode_fwd(CUtensorMap* map_f, CUtensorMap* map_c, const void* feat,
               const void* cb, int B, int H, int W, int pitch) {
  return encode_box(map_f, feat, W, C, H, B, pitch, BOXW, CG, 3) != 0 ||
                 encode_box(map_c, cb, W, 3, H, B, pitch, BOXW, 3, 3) != 0
             ? -1
             : 0;
}

// agg (9C, CO) bf16 as tiles of 64 rows (a group's channels of a tap) by
// 64 columns, 128-byte swizzle
template <int C, int CO>
int encode_agg(CUtensorMap* map, const void* agg) {
  return encode_map(map, agg, CO, NT * C, 1, 1, CO, 64, CG);
}

BlockArgs block_args(const void* w0, const void* b0, const void* w1,
                     const void* b1, const void* e0, const void* e1,
                     void* out, void* part, int kind, int B, int H, int W) {
  BlockArgs a = {};
  a.w0 = (const float*)w0;
  a.b0 = (const float*)b0;
  a.w1 = (const float*)w1;
  a.b1 = (const float*)b1;
  a.e0 = (const float*)e0;
  a.e1 = (const float*)e1;
  a.out = (__nv_bfloat16*)out;
  a.part = (float*)part;
  a.H = H;
  a.W = W;
  a.nq = chunks_per_row(kind, W);
  a.chunks = chunks_of(kind, B, H, W);
  return a;
}

template <int C, int CO>
int stats_fwd(const void* feat, const void* cb, const void* w0,
              const void* b0, const void* w1, const void* b1, void* part,
              void* sums, int B, int H, int W, int pitch, int blocks,
              void* stream) {
  CUtensorMap map_f, map_c;
  if (encode_fwd<C>(&map_f, &map_c, feat, cb, B, H, W, pitch) != 0)
    return -1;
  const BlockArgs a = block_args(w0, b0, w1, b1, nullptr, nullptr, nullptr,
                                 part, 0, B, H, W);
  cudaStream_t s = (cudaStream_t)stream;
  meta_fwd_kernel<STATS, C, CO><<<blocks, WGT, FwdLayout<STATS, C, CO>::SMEM,
                                  s>>>(map_f, map_c, map_f, a);
  reduce_blocks<C, CO>(part, sums, blocks, 0, s);
  return (int)cudaGetLastError();
}

template <int C, int CO>
int agg_fwd(const void* feat, const void* cb, const void* w0,
            const void* b0, const void* w1, const void* b1, const void* s9,
            const void* b9, const void* agg, void* y, int B, int H, int W,
            int pitch, int blocks, void* stream) {
  CUtensorMap map_f, map_c, map_a;
  if (encode_fwd<C>(&map_f, &map_c, feat, cb, B, H, W, pitch) != 0 ||
      encode_agg<C, CO>(&map_a, agg) != 0)
    return -1;
  const BlockArgs a =
      block_args(w0, b0, w1, b1, s9, b9, y, nullptr, 1, B, H, W);
  meta_fwd_kernel<AGG, C, CO><<<blocks, WGT, FwdLayout<AGG, C, CO>::SMEM,
                                (cudaStream_t)stream>>>(map_f, map_c, map_a,
                                                        a);
  return (int)cudaGetLastError();
}

template <int C, int CO>
int taps_fwd(const void* feat, const void* cb, const void* w0,
             const void* b0, const void* w1, const void* b1, void* out,
             int B, int H, int W, int pitch, int blocks, void* stream) {
  CUtensorMap map_f, map_c, map_o;
  if (encode_fwd<C>(&map_f, &map_c, feat, cb, B, H, W, pitch) != 0 ||
      encode_map(&map_o, out, W, NT * C, H, B, pitch, TQ, CG) != 0)
    return -1;
  const BlockArgs a =
      block_args(w0, b0, w1, b1, nullptr, nullptr, out, nullptr, 4, B, H, W);
  meta_fwd_kernel<TAPS, C, CO><<<blocks, WGT, FwdLayout<TAPS, C, CO>::SMEM,
                                 (cudaStream_t)stream>>>(map_f, map_c, map_o,
                                                         a);
  return (int)cudaGetLastError();
}

template <int C, int CO>
int block_bwd(const void* feat, const void* cb, const void* w0,
              const void* b0, const void* w1, const void* b1, const void* e0,
              const void* e1, const void* agg, const void* gy, void* dfeat,
              void* part, void* sums, int B, int H, int W, int pitch,
              int blocks, int mode, void* stream) {
  CUtensorMap map_f, map_c, map_g, map_a;
  if (encode_box(&map_f, feat, W, C, H, B, pitch, TQ, CG, 1) != 0 ||
      encode_box(&map_c, cb, W, 3, H, B, pitch, BOXW, 3, 3) != 0)
    return -1;
  if (mode != 1) {  // not read
    map_g = map_f;
    map_a = map_f;
  } else if (encode_box(&map_g, gy, W, CO, H, B, pitch, BOXW, CO, 3) != 0 ||
             encode_agg<C, CO>(&map_a, agg) != 0) {
    return -1;
  }
  cudaStream_t s = (cudaStream_t)stream;
  const int kind = mode == 1 ? 3 : 2;
  const BlockArgs a = block_args(w0, b0, w1, b1, e0, e1, dfeat, part, kind,
                                 B, H, W);
  if (mode == 1)
    meta_bwd_kernel<true, C, CO><<<blocks, WGT,
                                   BwdLayout<true, C, CO>::SMEM, s>>>(
        map_f, map_c, map_g, map_a, a);
  else
    meta_bwd_kernel<false, C, CO><<<blocks, WGT,
                                    BwdLayout<false, C, CO>::SMEM, s>>>(
        map_f, map_c, map_g, map_a, a);
  reduce_blocks<C, CO>(part, sums, blocks, kind, s);
  return (int)cudaGetLastError();
}

}  // namespace

// the instance for C feature channels: <64, 64> or <128, 128>; -2 for a
// width none is built for
#define BY_WIDTH(C, fn, ...)                    \
  ((C) == 64    ? fn<64, 64>(__VA_ARGS__)       \
   : (C) == 128 ? fn<128, 128>(__VA_ARGS__)     \
                : -2)

extern "C" {

// Blocks of a launch (kind 0 stats, 1 agg, 2 stats backward, 3 agg
// backward, 4 the eval taps) at width C on the current device; negative on
// error.
int meta_block_grid(int kind, int C, int B, int H, int W) {
  return BY_WIDTH(C, grid_of, kind, B, H, W);
}

// f32 partials per block at width C: the caller allocates blocks * this.
int meta_block_part_floats(int kind, int C) {
  return C == 64 ? part_floats<64>(kind)
                 : C == 128 ? part_floats<128>(kind) : -2;
}

// sums: (2, 9C) f32 = (sum a, sum a^2); part (blocks, part floats) f32.
// feat (B, H, C, pitch) and cb (B, H, 3, pitch), pitch >= W a multiple of
// 8 (TMA's 16-byte row strides), 16-byte aligned. Returns
// cudaGetLastError(), -1 if a tensor map could not be encoded, -2 for a
// width with no instance.
int meta_stats_fwd(const void* feat, const void* cb, const void* w0,
                   const void* b0, const void* w1, const void* b1, void* part,
                   void* sums, int C, int B, int H, int W, int pitch,
                   int blocks, void* stream) {
  return BY_WIDTH(C, stats_fwd, feat, cb, w0, b0, w1, b1, part, sums, B, H,
                  W, pitch, blocks, stream);
}

// y: (B, H, Co, W) bf16; feat, cb and the pitch as for meta_stats_fwd.
int meta_agg_fwd(const void* feat, const void* cb, const void* w0,
                 const void* b0, const void* w1, const void* b1,
                 const void* s9, const void* b9, const void* agg, void* y,
                 int C, int B, int H, int W, int pitch, int blocks,
                 void* stream) {
  return BY_WIDTH(C, agg_fwd, feat, cb, w0, b0, w1, b1, s9, b9, agg, y, B, H,
                  W, pitch, blocks, stream);
}

// The eval taps: out (B, H, 9C, pitch) bf16, tap-major and channel-minor,
// of which columns < W are written; feat, cb and the pitch as for
// meta_stats_fwd. Blocks: meta_block_grid's kind 4.
int meta_kernel_taps(const void* feat, const void* cb, const void* w0,
                     const void* b0, const void* w1, const void* b1,
                     void* out, int C, int B, int H, int W, int pitch,
                     int blocks, void* stream) {
  return BY_WIDTH(C, taps_fwd, feat, cb, w0, b0, w1, b1, out, B, H, W, pitch,
                  blocks, stream);
}

// mode 0 "stats" (e0 = ds1, e1 = 2 ds2), 1 "agg" (e0 = s9, e1 = b9, agg,
// gy (B, H, Co, pitch)). feat, cb as for meta_stats_fwd; dfeat (B, H, C, W)
// bf16; part (blocks, meta_block_part_floats) f32; sums: the reduced
// partials, [dA (9C, Co), ds9, db9] (agg only) then [dW0 (3, Cm), db0,
// dW1 (Cm, C), db1].
int meta_block_bwd(const void* feat, const void* cb, const void* w0,
                   const void* b0, const void* w1, const void* b1,
                   const void* e0, const void* e1, const void* agg,
                   const void* gy, void* dfeat, void* part, void* sums, int C,
                   int B, int H, int W, int pitch, int blocks, int mode,
                   void* stream) {
  return BY_WIDTH(C, block_bwd, feat, cb, w0, b0, w1, b1, e0, e1, agg, gy,
                  dfeat, part, sums, B, H, W, pitch, blocks, mode, stream);
}

}  // extern "C"
