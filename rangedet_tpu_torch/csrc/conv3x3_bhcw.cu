// 3x3 convolution over (B, H, C, W) activations, bf16 in / f32 accumulate /
// bf16 out, with the fused options of the TPU kernel it replaces:
// rangedet_tpu/ops/conv_pallas.py:_conv3x3_fwd / _fwd_kernel. The same
// kernel runs the forward and, with the flipped (Ci, Co)-swapped weight,
// the data gradient (dgrad) of the backward.
//
//   y[b,h,co,u] = sum_{dy,dx,ci} W[dy,dx,ci,co] * a[b, h+dy-1, ci, s*u+dx-p]
//
// Input ("ingest"), one of: a = x; a = bf16(relu(f32(x)*scale + bias))
// (_ingest: the producer's BatchNorm apply + relu); a = bf16(f32(gy) + g1 +
// 2*f32(yc)*g2) (_ingest_cot: the BatchNorm-sums cotangents folded into the
// dgrad's gy). Epilogue, one of:
//   plain:  y = bf16(acc)
//   stats:  y = bf16(acc), and per output channel sum(y), sum(y^2) of the
//           stored bf16 value (BatchNorm sums for the consumer)
//   bwd:    the dgrad of the fused forward relu(xo*s+b): dz = acc where
//           xo*s+b > 0 (else 0), y = bf16(dz*s), and per channel
//           sum(dz*xo) -> dscale, sum(dz) -> dbias
// Padding is zero in the ACTIVATED domain: out-of-range rows and columns
// contribute 0, never relu(bias). Stride s=1 uses p=1 (SAME); s=2 uses p=0,
// which is XLA SAME for an even W (pad 0 left, 1 right).
//
// What bounds it on Hopper: an implicit GEMM with M = Co, N = pixels and
// K = 9*Ci (72..2304); at the model's widths it is far above the H100's
// ~295 FLOP/byte ridge, so compute-bound (2.27 TFLOP per B=2 train step's
// forward). The design, in a prologue, the GEMM and a reduction:
//
// 1. Prologue (ingest_t, hopper.cuh; shared with the wgrad): one
//    elementwise pass writes the GEMM's activation operand a' channel-
//    innermost, (B, H, Wq, Cp), with the ingest applied by the exact f32
//    operations of the plain version, so the operands are bit-identical.
//    Cp rounds the channels up to 8 (TMA needs 16-byte strides); the
//    tensor map's channel extent is the true count, so the pad channels
//    are never read. At stride 2 it writes the phase-packed operand
//    a'[b,h,u,(f,ci)] = a[b,h,ci,2u+f], Wq = W/2, 2*Ci channels, and the
//    GEMM runs the stride-1 conv with the packed weight of
//    ops/conv3x3.py:phase_pack, skipping its all-zero tap column dx=0 and
//    the zero odd half of column dx=2. So the GEMM knows only stride 1.
//    The transpose is what moves the one-pixel W shift off the innermost
//    dimension: a TMA box must start on 16 bytes there.
//
// 2. GEMM (conv3x3_gemm_kernel): a tile is one output row (b, h), BM
//    output channels and BN pixels; one block per SM walks the tiles
//    blockIdx, blockIdx + grid, ... (persistent), so the producer loads the
//    next tile's first stages while the consumers run the epilogue of the
//    last (on the card this took 2-5% off the GEMM against one block per
//    tile). A tile's K-steps walk the taps (dy, dx) and, per tap, the
//    64-channel blocks; each K-step one producer thread loads, under one
//    mbarrier, a weight box (64 ci x BM co, K-major, from the packed
//    (taps, Co, Cp) weight) and the activation box for the tap at map
//    coordinates (ci0, u0+dx-1, h+dy-1, b) of a' seen as (Cp, Wq, H, B):
//    both shifts fall on outer dimensions, and TMA's zero fill out of
//    range is the activated-domain padding, so no thread builds a shifted
//    copy. The boxes are 128B-swizzled into a ring of 4-6 stages (one
//    producer warp; setmaxnreg 40 / 232). Two consumer warpgroups issue
//    wgmma.m64n128k16 (both operands K-major, f32 accumulators) and keep
//    one K-step's products in flight while they release the stage before
//    it. The wgmmas are issued unconditionally: skipping the all-zero
//    16-channel steps of Ci = 8 and 72 under a runtime test made ptxas
//    serialize them, and every shape slower (PERF.md).
//    Tiles (ops/conv3x3.py:plan_conv picks them): per K-step a stage
//    brings (BM + BN) * 128 bytes for 2*BM*BN*64 FLOPs, so the wider the
//    tile the fewer bytes per FLOP it pulls from L2 (each a' row is read
//    by 9 taps of 3 rows of tiles). BM = 128 (one warpgroup per 64 Co)
//    with BN = 256 (two m64n128 products per warpgroup and k-step, 128
//    accumulators a thread) where Co > 64 and the row has >= 512 pixels:
//    85 FLOP per staged byte, four 48 KB stages; BN = 128 on the narrow
//    rows (W = 166 and 332 at full size), where a 256 tile would be a
//    third empty; BM = 64 with BN = 256 (the warpgroups split the
//    pixels) at Co = 64. On an H100 the GEMM reaches 400-470 TFLOP/s at
//    the large shapes; removing its y stores or two thirds of its
//    activation bytes (a throw-away timing probe) gained 10-25% and 3-16%,
//    so neither alone bounds it (PERF.md).
//    Epilogue, from the wgmma accumulator layout (rows Co, columns pixels):
//    pairs of pixels stored as bf16x2, masked at ragged W and Co; the bwd
//    epilogue first loads xo at the same positions, 16 pairs at a time,
//    then stores. The per-channel sums of a tile go, in a fixed order, to
//    one scratch row per tile.
//
// 3. reduce_rows_kernel adds the rows in a fixed order: no atomics, so two
//    runs on the same inputs give the same bits.
//
// The geometry (Wq, Cp, tiles, the K-step decode, the box coordinates, the
// scratch rows) is planned in rangedet_tpu_torch/ops/conv3x3.py:plan_conv;
// the kernel computes the same formulas, and the CPU tests run the plan
// through a torch emulation of this tile loop.

#include "hopper.cuh"

namespace {

constexpr int KB = 64;         // input channels per K-step: 128-byte rows
constexpr int CONSUMERS = 2;   // warpgroups issuing wgmma
constexpr int THREADS = (CONSUMERS + 1) * 128;  // + the producer warpgroup
constexpr int RING_BYTES = 196608;  // shared memory for the stages
constexpr int RED_THREADS = 256;

enum Epilogue { PLAIN = 0, STATS = 1, BWD = 2 };

// d (64 x 128, f32) += A (64 x 16) * B (16 x 128), bf16, both K-major
__device__ __forceinline__ void wgmma_64x128x16(float (&d)[64], uint64_t da,
                                                uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

template <int BM, int BN>
struct Tiling {
  static constexpr int W_BYTES = BM * KB * 2;  // weight box, BM rows
  static constexpr int A_BYTES = BN * KB * 2;  // activation box, BN rows
  static constexpr int STAGE = W_BYTES + A_BYTES;
  static constexpr int STAGES = RING_BYTES / STAGE < 6 ? RING_BYTES / STAGE
                                                       : 6;
  static constexpr int WG_M = BM / 64;          // warpgroups along Co
  static constexpr int WG_N = CONSUMERS / WG_M;  // ... along the pixels
  static constexpr int WN = BN / WG_N;          // pixels of a warpgroup
  static constexpr int NT = WN / 128;           // its m64n128 products
  static constexpr int SMEM = STAGES * STAGE + 16 * STAGES +
                              CONSUMERS * 64 * 2 * 4 + 1024;
  static_assert(STAGES >= 4, "a ring of at least 4 stages");
  static_assert(WN % 128 == 0 && BM % 64 == 0, "tile");
};

struct GemmArgs {
  const __nv_bfloat16* bwd_x;  // (B, H, Co, Wq) bwd epilogue, or null
  const float* bwd_s;          // (Co,)
  const float* bwd_b;
  __nv_bfloat16* y;  // (B, H, Co, Wq)
  float* part;       // (B*H*nwt, 2, Co) per-tile sums, or null
  int H, Co, Wq, dx0, kc, kc2, ksteps;
  int nwt, co_tiles, ntiles;  // pixel tiles per row, Co tiles, all tiles
};

// tile -> its pixel tile wt, Co tile ct and row bh = b*H + h; pixel tiles
// vary fastest, so the blocks at work at one time share input rows in L2
__device__ __forceinline__ void tile_origin(const GemmArgs& p, int tile,
                                            int& wt, int& ct, int& bh) {
  wt = tile % p.nwt;
  const int r = tile / p.nwt;
  ct = r % p.co_tiles;
  bh = r / p.co_tiles;
}

// K-step k -> tap row dy, tap column dx, 64-channel block cb and the
// packed weight's tap index: per dy the columns dx0..1 take kc blocks
// each, then column 2 takes kc2 (ops/conv3x3.py:ConvPlan.k_step)
__device__ __forceinline__ void k_step(const GemmArgs& p, int k, int& dy,
                                       int& dx, int& cb, int& tap) {
  const int lead = (2 - p.dx0) * p.kc;
  const int per = lead + p.kc2;
  dy = k / per;
  const int r = k - dy * per;
  if (r < lead) {
    dx = p.dx0 + r / p.kc;
    cb = r - (dx - p.dx0) * p.kc;
  } else {
    dx = 2;
    cb = r - lead;
  }
  tap = dy * (3 - p.dx0) + dx - p.dx0;
}

template <int BM, int BN, int EPI>
__global__ void __launch_bounds__(THREADS, 1)
    conv3x3_gemm_kernel(const __grid_constant__ CUtensorMap map_w,
                        const __grid_constant__ CUtensorMap map_a,
                        GemmArgs p) {
  using T = Tiling<BM, BN>;
  extern __shared__ __align__(1024) uint8_t smem[];
  const uint32_t base = (smem_u32(smem) + 1023u) & ~1023u;
  const uint32_t full_bar = base + T::STAGES * T::STAGE;  // STAGES x 8 B
  const uint32_t empty_bar = full_bar + T::STAGES * 8;
  float* red = reinterpret_cast<float*>(
      smem + (base - smem_u32(smem)) + T::STAGES * T::STAGE + 16 * T::STAGES);

  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < T::STAGES; ++s) {
      mbar_init(full_bar + 8 * s, 1);
      mbar_init(empty_bar + 8 * s, CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == CONSUMERS) {
    // ---- producer warpgroup: one thread keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x % 128 != 0) return;
    int stage = 0;
    uint32_t phase = 0;
    for (int tile = blockIdx.x; tile < p.ntiles; tile += gridDim.x) {
      int wt, ct, bh;
      tile_origin(p, tile, wt, ct, bh);
      const int b = bh / p.H;
      const int h = bh - b * p.H;
      for (int k = 0; k < p.ksteps; ++k) {
        int dy, dx, cb, tap;
        k_step(p, k, dy, dx, cb, tap);
        mbar_wait(empty_bar + 8 * stage, phase ^ 1);
        const uint32_t full = full_bar + 8 * stage;
        const uint32_t st = base + stage * T::STAGE;
        mbar_expect_tx(full, T::STAGE);
        tma_load_4d(st, &map_w, full, cb * KB, ct * BM, tap, 0);
        tma_load_4d(st + T::W_BYTES, &map_a, full, cb * KB,
                    wt * BN + dx - 1, h + dy - 1, b);
        if (++stage == T::STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  // ---- consumers: warpgroup (wm, wn) owns Co rows 64*wm.. and pixels
  // WN*wn.. of the block's tile
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int wm = wg % T::WG_M;
  const int wn = wg / T::WG_M;
  int stage = 0;
  uint32_t phase = 0;
  for (int tile = blockIdx.x; tile < p.ntiles; tile += gridDim.x) {
    int wt, ct, bh;
    tile_origin(p, tile, wt, ct, bh);
    const int u0 = wt * BN;
    const int co0 = ct * BM;
    float acc[T::NT][64];
#pragma unroll
    for (int j = 0; j < T::NT; ++j)
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[j][i] = 0.f;

    int prev = -1;
    for (int k = 0; k < p.ksteps; ++k) {
      mbar_wait(full_bar + 8 * stage, phase);
      const uint32_t st = base + stage * T::STAGE;
      const uint64_t da = sw128_desc(st + wm * 64 * 128, 16);
      const uint64_t db = sw128_desc(st + T::W_BYTES + wn * T::WN * 128, 16);
#pragma unroll
      for (int j = 0; j < T::NT; ++j) acc_fence(acc[j]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KB / 16; ++kk)
#pragma unroll
        for (int j = 0; j < T::NT; ++j)
          wgmma_64x128x16(acc[j], da + 2 * kk,
                          db + ((j * 128 * 128) >> 4) + 2 * kk);
      wgmma_commit();
      wgmma_wait<1>();  // the previous K-step's products are done
#pragma unroll
      for (int j = 0; j < T::NT; ++j) acc_fence(acc[j]);
      if (prev >= 0 && threadIdx.x % 128 == 0)
        mbar_arrive(empty_bar + 8 * prev);
      prev = stage;
      if (++stage == T::STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }
    wgmma_wait<0>();
#pragma unroll
    for (int j = 0; j < T::NT; ++j) acc_fence(acc[j]);
    if (threadIdx.x % 128 == 0) mbar_arrive(empty_bar + 8 * prev);

    // ---- epilogue. Accumulator i of product j of thread t holds row
    // r0 + 8*((i>>1)&1) (Co) and column 128*j + 8*(i>>2) + 2*(t%4) + (i&1)
    // (pixels) of the warpgroup's tile.
    const int t = threadIdx.x % 128;
    const int r0 = 16 * (t / 32) + (t % 32) / 4;
    const int cbase = co0 + wm * 64 + r0;
    const int ubase = u0 + wn * T::WN + 2 * (t % 4);
    const bool pairs = p.Wq % 2 == 0;  // bf16x2 at even u lies on 4 bytes
    float sc[2] = {0.f, 0.f}, bb[2] = {0.f, 0.f};
    if (EPI == BWD) {
#pragma unroll
      for (int rh = 0; rh < 2; ++rh)
        if (cbase + 8 * rh < p.Co) {
          sc[rh] = __ldg(p.bwd_s + cbase + 8 * rh);
          bb[rh] = __ldg(p.bwd_b + cbase + 8 * rh);
        }
    }
    // sum[rh][k]: channel cbase + 8*rh, k = 0 (sum y or dz*xo) and 1
    // (sum y^2 or dz), over this thread's columns
    float sum[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
    // (co, u) of accumulator i of product j, and the offset of (co, u) in y
    // and in xo; false where it lies outside the output
    auto at = [&](int j, int i, size_t& idx, bool& two) {
      const int co = cbase + 8 * ((i >> 1) & 1);
      const int u = ubase + 128 * j + 8 * (i >> 2);
      idx = ((size_t)bh * p.Co + co) * p.Wq + u;
      two = u + 1 < p.Wq;
      return co < p.Co && u < p.Wq;
    };
#pragma unroll
    for (int j = 0; j < T::NT; ++j) {
#pragma unroll
      for (int i0 = 0; i0 < 64; i0 += 32) {
        // the bwd epilogue's xo for these 16 pairs, all loads issued before
        // any store, so their latencies overlap
        __nv_bfloat162 xs[16];
        if (EPI == BWD) {
#pragma unroll
          for (int q = 0; q < 16; ++q) {
            size_t idx;
            bool two;
            xs[q] = __floats2bfloat162_rn(0.f, 0.f);
            if (!at(j, i0 + 2 * q, idx, two)) continue;
            if (two && pairs) {
              xs[q] = __ldg(reinterpret_cast<const __nv_bfloat162*>(p.bwd_x) +
                            idx / 2);
            } else {
              xs[q].x = __ldg(p.bwd_x + idx);
              if (two) xs[q].y = __ldg(p.bwd_x + idx + 1);
            }
          }
        }
#pragma unroll
        for (int q = 0; q < 16; ++q) {
          const int i = i0 + 2 * q;
          const int rh = (i >> 1) & 1;
          size_t idx;
          bool two;
          if (!at(j, i, idx, two)) continue;
          float v0 = acc[j][i], v1 = acc[j][i + 1];
          if (EPI == BWD) {
            const float x0 = __low2float(xs[q]);
            const float x1 = __high2float(xs[q]);
            const float z0 = __fadd_rn(__fmul_rn(x0, sc[rh]), bb[rh]);
            const float z1 = __fadd_rn(__fmul_rn(x1, sc[rh]), bb[rh]);
            const float dz0 = z0 > 0.f ? v0 : 0.f;
            const float dz1 = (two && z1 > 0.f) ? v1 : 0.f;
            sum[rh][0] += __fmul_rn(dz0, x0);
            sum[rh][1] += dz0;
            sum[rh][0] += __fmul_rn(dz1, x1);
            sum[rh][1] += dz1;
            v0 = __fmul_rn(dz0, sc[rh]);
            v1 = __fmul_rn(dz1, sc[rh]);
          }
          const __nv_bfloat16 y0 = __float2bfloat16(v0);
          const __nv_bfloat16 y1 = __float2bfloat16(v1);
          if (two && pairs) {
            __nv_bfloat162 yv;
            yv.x = y0;
            yv.y = y1;
            *reinterpret_cast<__nv_bfloat162*>(p.y + idx) = yv;
          } else {
            p.y[idx] = y0;
            if (two) p.y[idx + 1] = y1;
          }
          if (EPI == STATS) {
            const float f0 = __bfloat162float(y0);
            sum[rh][0] += f0;
            sum[rh][1] += __fmul_rn(f0, f0);
            if (two) {
              const float f1 = __bfloat162float(y1);
              sum[rh][0] += f1;
              sum[rh][1] += __fmul_rn(f1, f1);
            }
          }
        }
      }
    }
    if constexpr (EPI != PLAIN) {
      // reduce over the 4 threads of a row (same channels), then over the
      // warpgroups that split the pixels, always in the same order
#pragma unroll
      for (int rh = 0; rh < 2; ++rh)
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          float v = sum[rh][k];
          v += __shfl_xor_sync(0xffffffffu, v, 1);
          v += __shfl_xor_sync(0xffffffffu, v, 2);
          sum[rh][k] = v;
        }
      if (t % 4 == 0) {
#pragma unroll
        for (int rh = 0; rh < 2; ++rh)
#pragma unroll
          for (int k = 0; k < 2; ++k)
            red[((wg * 64) + r0 + 8 * rh) * 2 + k] = sum[rh][k];
      }
      asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMERS * 128) : "memory");
      const int c = threadIdx.x;  // 0 .. 255, the consumers
      if (c < BM && co0 + c < p.Co) {
        const int m = c / 64, r = c % 64;
        const size_t row = (size_t)bh * p.nwt + wt;
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          float v = 0.f;
#pragma unroll
          for (int n = 0; n < T::WG_N; ++n)
            v += red[(((n * T::WG_M + m) * 64) + r) * 2 + k];
          p.part[(row * 2 + k) * p.Co + co0 + c] = v;
        }
      }
      // red is written again by the next tile
      asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMERS * 128) : "memory");
    }
  }
}

// sums[k * Co + c] = sum over rows of part[(row * 2 + k) * Co + c], in a
// fixed order: one block per (c, k), a strided walk, then a tree.
__global__ void __launch_bounds__(RED_THREADS)
reduce_rows_kernel(const float* __restrict__ part, float* __restrict__ sums,
                   int rows, int Co) {
  __shared__ float s[RED_THREADS];
  const int c = blockIdx.x;
  const int k = blockIdx.y;
  float v = 0.f;
  for (int r = threadIdx.x; r < rows; r += RED_THREADS)
    v += part[((size_t)r * 2 + k) * Co + c];
  s[threadIdx.x] = v;
  __syncthreads();
  for (int n = RED_THREADS / 2; n > 0; n >>= 1) {
    if (threadIdx.x < n) s[threadIdx.x] += s[threadIdx.x + n];
    __syncthreads();
  }
  if (threadIdx.x == 0) sums[k * Co + c] = s[0];
}

template <int BM, int BN, int EPI>
void launch_gemm(const CUtensorMap& mw, const CUtensorMap& ma,
                 const GemmArgs& a, dim3 grid, cudaStream_t s) {
  static bool smem_set[64] = {};  // per device
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= 64 || !smem_set[dev]) {
    cudaFuncSetAttribute(conv3x3_gemm_kernel<BM, BN, EPI>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         Tiling<BM, BN>::SMEM);
    if (dev >= 0 && dev < 64) smem_set[dev] = true;
  }
  conv3x3_gemm_kernel<BM, BN, EPI>
      <<<grid, THREADS, Tiling<BM, BN>::SMEM, s>>>(mw, ma, a);
}

template <int BM, int BN>
void launch_epi(int epi, const CUtensorMap& mw, const CUtensorMap& ma,
                const GemmArgs& a, dim3 grid, cudaStream_t s) {
  if (epi == PLAIN) launch_gemm<BM, BN, PLAIN>(mw, ma, a, grid, s);
  else if (epi == STATS) launch_gemm<BM, BN, STATS>(mw, ma, a, grid, s);
  else launch_gemm<BM, BN, BWD>(mw, ma, a, grid, s);
}

}  // namespace

extern "C" {

// C entry point for ctypes: the prologue, the GEMM and (with part) the
// reduction, on `stream`; returns cudaGetLastError() (0 on success), -1 if
// a tensor map could not be encoded, -2 for a tile the kernel does not
// take. It never synchronises. The plan (ops/conv3x3.py:plan_conv) gives
// Ce (GEMM channels: Ci, or 2*Ci at stride 2), Wq (output width), Cp (a'
// and weight channel pitch), dx0, kc, kc2 (the K-steps) and the tile
// (bm, bn); sms is the card's SM count (the persistent grid's size).
// Scratch: a_buf (B, H, Wq, Cp) bf16; part (B*H*nwt, 2, Co) f32
// and sums (2, Co) f32, both null or both set: then sums holds
// (sum y, sum y^2), or with bwd_x set (dscale, dbias). wp is the packed
// weight (taps, Co, Cp), bf16.
int conv3x3_bhcw_fwd(const void* x, const void* wp, const void* scale,
                     const void* bias, const void* cot_y, const void* cot_g1,
                     const void* cot_g2, const void* bwd_x, const void* bwd_s,
                     const void* bwd_b, void* y, void* a_buf, void* part,
                     void* sums, int B, int H, int Ci, int W, int Co,
                     int stride, int Ce, int Wq, int Cp, int dx0, int kc,
                     int kc2, int bm, int bn, int sms, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const bool cot = cot_y != nullptr;
  ingest_t(cot ? INGEST_COT : (scale != nullptr ? INGEST_AFFINE
                                                : INGEST_NONE),
           x, cot_y, cot ? cot_g1 : scale, cot ? cot_g2 : bias, a_buf,
           B * H, Ci, Cp, W, stride == 2 ? 1 : 0, s);
  CUtensorMap map_w, map_a;
  if (encode_map(&map_w, wp, Ce, Co, 3 * (3 - dx0), 1, Cp, KB, bm) != 0 ||
      encode_map(&map_a, a_buf, Ce, Wq, H, B, Cp, KB, bn) != 0)
    return -1;
  GemmArgs a;
  a.bwd_x = (const __nv_bfloat16*)bwd_x;
  a.bwd_s = (const float*)bwd_s;
  a.bwd_b = (const float*)bwd_b;
  a.y = (__nv_bfloat16*)y;
  a.part = (float*)part;
  a.H = H;
  a.Co = Co;
  a.Wq = Wq;
  a.dx0 = dx0;
  a.kc = kc;
  a.kc2 = kc2;
  a.ksteps = 3 * ((2 - dx0) * kc + kc2);
  a.nwt = (Wq + bn - 1) / bn;
  a.co_tiles = (Co + bm - 1) / bm;
  a.ntiles = a.nwt * a.co_tiles * B * H;
  const dim3 grid(a.ntiles < sms ? a.ntiles : sms);
  const int epi = bwd_x != nullptr ? BWD : (part != nullptr ? STATS : PLAIN);
  if (bm == 128 && bn == 256)
    launch_epi<128, 256>(epi, map_w, map_a, a, grid, s);
  else if (bm == 128 && bn == 128)
    launch_epi<128, 128>(epi, map_w, map_a, a, grid, s);
  else if (bm == 64 && bn == 256)
    launch_epi<64, 256>(epi, map_w, map_a, a, grid, s);
  else
    return -2;
  if (part != nullptr)
    reduce_rows_kernel<<<dim3(Co, 2), RED_THREADS, 0, s>>>(
        (const float*)part, (float*)sums, B * H * a.nwt, Co);
  return (int)cudaGetLastError();
}

}  // extern "C"
