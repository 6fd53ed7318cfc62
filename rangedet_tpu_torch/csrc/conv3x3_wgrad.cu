// Weight gradient of the 3x3 SAME stride-1 convolution over (B, H, C, W):
//
//   dW[dy,dx,ci,co] = sum_{b,h,w} a[b, h+dy-1, ci, w+dx-1] * g[b, h, co, w]
//
// Replaces the TPU kernel rangedet_tpu/ops/conv_pallas.py:_conv3x3_wgrad /
// _wgrad_kernel, with its two load-time options:
//   a = x, or bf16(relu(f32(x) * scale[ci] + bias[ci]))       (_ingest)
//   g = gy, or bf16(f32(gy) + g1[co] + 2*f32(yc)*g2[co])       (_ingest_cot)
// Out-of-range rows and columns of a are 0 in the activated domain, never
// relu(bias). The TPU kernel's row-pair and phase packing (_pair_gain) fill
// the 128-wide MXU; they are not carried over.
//
// What bounds it on Hopper: a GEMM with M = 9*Ci, N = Co and a long
// K = B*H*W (340k at B=2 and full width): compute-bound at the model's
// widths (2.27 TFLOP per B=2 train step), with a small output, so the grid
// over M and N alone gives 1-16 blocks for 132 SMs and K is split. On an
// H100 the GEMM reaches ~640 TFLOP/s at the largest shapes and the
// prologue, bound by memory, is ~40 % of the device time (PERF.md).
//
// The design, in two prologue kernels, the GEMM and a reduction (the
// mbarrier, TMA and wgmma plumbing is in hopper.cuh):
//
// 1. Prologue: elementwise passes with the exact operations of the fused
//    load they replace, so the GEMM's operands are bit-identical to the
//    plain version's.
//    - wgrad_ingest_kernel writes a' = ingest(x) (B,H,Ci,Wp) in bf16. Wp
//      rounds W up to a multiple of 8: TMA needs 16-byte global strides,
//      which rows of W = 166 or 332 are not. x itself is read in place
//      when it needs no ingest, W % 8 == 0 and its base is 16-byte aligned.
//    - ingest_t (hopper.cuh, shared with the forward/dgrad kernel) writes
//      g' = cot(gy) transposed, (B,H,W,Cp) with Cp = Co rounded up to 64
//      (zero channels), through a 64 x 64 tile in shared memory so both
//      its reads and its writes are coalesced.
//
// 2. GEMM (conv3x3_wgrad_kernel), the dx shift moved to the cotangent:
//    with w' = w+dx-1,
//      dW[dy,dx] = sum_{b,h,w'} A_dy[ci, (b,h,w')] G_dx[co, (b,h,w')]
//      A_dy = a'[b, h+dy-1, ci, w']    G_dx = g'[b, h, co, w'-dx+1]
//    Every shift is a TMA box coordinate of a 4-D tensor map: A's over
//    (W, Ci, H, B) shifts the row h+dy-1, G's over (Cp, W, H, B) shifts
//    the column w0-dx+1. A TMA box must start on 16 bytes in its innermost
//    dimension, so a one-pixel shift has to fall on an outer one: that is
//    why g' is transposed. Out-of-range rows and columns come back from
//    the TMA unit as zeros (the W extent is the true W), which is the
//    activated-domain padding; no thread builds a shifted copy.
//    A block owns 9 taps x 64 ci x 64 co and walks a contiguous run of
//    64-pixel chunks (b, h, w0). Per chunk one producer thread loads six
//    128B-swizzled 8 KB boxes under one mbarrier: A rows h-1, h, h+1
//    (64 ci x 64 pixels, K-major) and G row h at columns w0+1, w0, w0-1
//    (64 pixels x 64 co, N-major), 48 KB, into a ring of 4 stages
//    (192 KB). Three consumer warpgroups, one per dy, each issue one
//    wgmma.m64n192k16 per 16-pixel k-step: the three G boxes lie 8 KB
//    apart and form one N-major operand of 192 columns, so A is read from
//    shared memory once for the three dx taps, not three times (on the
//    card the two forms ran the step's GEMMs in the same time). The 96 f32
//    accumulators a thread hold the three taps; the warpgroup then
//    releases the stage.
//    The producer warpgroup gives registers to the consumers (setmaxnreg
//    40 / 152). Ragged Ci is zero-filled by TMA and masked at the store.
//
// 3. Split K, deterministic: the chunks are cut into S contiguous ranges,
//    S = SMs / tiles so the grid fills the card in one wave; each block
//    writes an f32 partial (9, Ci, Co) tile and reduce_splits_kernel adds
//    the S partials in a fixed order (no atomics: repeats are bit-equal).
//
// The geometry (Wp, Cp, chunk decode, box coordinates, S and the split
// ranges) is planned in rangedet_tpu_torch/ops/conv3x3.py:plan_wgrad; the
// kernel computes the same formulas, and the CPU tests run the plan
// through a torch emulation of this tile loop.

#include "hopper.cuh"

namespace {

constexpr int BOX_W = 64;                       // pixels per stage (GEMM K)
constexpr int TILE = 64;                        // ci (wgmma M) = co (N)
constexpr int STAGES = 4;
constexpr int BOX_BYTES = TILE * BOX_W * 2;     // 8 KB, 64 rows of 128 B
constexpr int STAGE_BYTES = 6 * BOX_BYTES;      // 3 A + 3 G boxes
constexpr int CONSUMERS = 3;                    // warpgroups, one per dy
constexpr int THREADS = (CONSUMERS + 1) * 128;  // + the producer warpgroup
constexpr int SMEM_BYTES = STAGES * STAGE_BYTES + 2 * STAGES * 8 + 1024;

// The stage's operands for sw128_desc: A is one 64 x 64 K-major tile
// (rows are ci, pixels contiguous); a 16-pixel k-step is 32 B along the
// row (+2 in the address field). B is the stage's three G boxes, 64 pixels
// x 64 co each, N-major (rows are pixels, co contiguous), taken as one
// 192-wide N: the leading offset (LBO) is the 8 KB from one box to the
// next; a k-step is 16 rows, 2048 B (+128).
constexpr uint64_t A_KSTEP = 32 >> 4;
constexpr uint64_t G_KSTEP = (16 * 128) >> 4;

// d (64 x 192, f32) += A (64 x 16, K-major) * B (16 x 192, N-major), bf16
__device__ __forceinline__ void wgmma_64x192x16(float (&d)[96], uint64_t da,
                                                uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, "
      "%74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, "
      "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
      "}, %96, %97, p, 1, 1, 0, 1;\n}\n"
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
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95])
      : "l"(da), "l"(db), "r"(1));
}

struct Args {
  float* part;  // (S, 9, Ci, Co)
  int H, Ci, Co, nwc, chunks;
};

__global__ void __launch_bounds__(THREADS, 1)
    conv3x3_wgrad_kernel(const __grid_constant__ CUtensorMap map_a,
                         const __grid_constant__ CUtensorMap map_g,
                         Args p) {
  extern __shared__ __align__(1024) uint8_t smem[];
  const uint32_t base = (smem_u32(smem) + 1023u) & ~1023u;
  const uint32_t full_bar = base + STAGES * STAGE_BYTES;  // STAGES x 8 B
  const uint32_t empty_bar = full_bar + STAGES * 8;

  const int ci0 = blockIdx.x * TILE;
  const int co0 = blockIdx.y * TILE;
  const int S = gridDim.z;
  const int c_begin = (int)((long long)p.chunks * blockIdx.z / S);
  const int c_end = (int)((long long)p.chunks * (blockIdx.z + 1) / S);
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
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
    for (int c = c_begin; c < c_end; ++c) {
      const int bh = c / p.nwc;
      const int w0 = (c - bh * p.nwc) * BOX_W;
      const int b = bh / p.H;
      const int h = bh - b * p.H;
      mbar_wait(empty_bar + 8 * stage, phase ^ 1);
      const uint32_t full = full_bar + 8 * stage;
      const uint32_t st = base + stage * STAGE_BYTES;
      mbar_expect_tx(full, STAGE_BYTES);
#pragma unroll
      for (int dy = 0; dy < 3; ++dy)
        tma_load_4d(st + dy * BOX_BYTES, &map_a, full, w0, ci0, h + dy - 1,
                    b);
#pragma unroll
      for (int dx = 0; dx < 3; ++dx)
        tma_load_4d(st + (3 + dx) * BOX_BYTES, &map_g, full, co0,
                    w0 - dx + 1, h, b);
      if (++stage == STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }
  } else {
    // ---- consumers: warpgroup dy, accumulators for dx = 0, 1, 2
    asm volatile("setmaxnreg.inc.sync.aligned.u32 152;\n");
    const int dy = wg;
    // columns 64*dx + co - co0 of the 192-wide product hold tap (dy, dx)
    float acc[96];
#pragma unroll
    for (int i = 0; i < 96; ++i) acc[i] = 0.f;

    int stage = 0;
    uint32_t phase = 0;
    for (int c = c_begin; c < c_end; ++c) {
      mbar_wait(full_bar + 8 * stage, phase);
      const uint32_t st = base + stage * STAGE_BYTES;
      const uint64_t da = sw128_desc(st + dy * BOX_BYTES, 16);
      const uint64_t dg = sw128_desc(st + 3 * BOX_BYTES, BOX_BYTES);
      acc_fence(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BOX_W / 16; ++kk)
        wgmma_64x192x16(acc, da + A_KSTEP * kk, dg + G_KSTEP * kk);
      wgmma_commit();
      wgmma_wait<0>();
      acc_fence(acc);
      if (threadIdx.x % 128 == 0) mbar_arrive(empty_bar + 8 * stage);
      if (++stage == STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }

    // ---- partial tile: the wgmma accumulator layout, rows ci, columns
    // (dx, co)
    const int t = threadIdx.x % 128;
    const int row0 = ci0 + 16 * (t / 32) + (t % 32) / 4;
    const int col0 = 2 * (t % 4);
    const int Ci = p.Ci, Co = p.Co;
    float* out = p.part + (size_t)blockIdx.z * 9 * Ci * Co;
#pragma unroll
    for (int i = 0; i < 96; ++i) {
      const int dx = i / 32;
      const int ci = row0 + 8 * ((i >> 1) & 1);
      const int co = co0 + col0 + 8 * ((i % 32) >> 2) + (i & 1);
      if (ci < Ci && co < Co)
        out[((size_t)(dy * 3 + dx) * Ci + ci) * Co + co] = acc[i];
    }
  }
}

// a' (rows, Wp) from x (rows, W), row r holding channel r % C: x, or with
// `ingest` bf16(relu(x*scale[c] + bias[c])); 0 in the pad columns
// w >= W. One thread writes 8 columns (16 B) and reads them as one 16-byte
// load where the rows allow it (vec).
__global__ void __launch_bounds__(PRO_THREADS)
    wgrad_ingest_kernel(const __nv_bfloat16* __restrict__ x,
                        const float* __restrict__ scale,
                        const float* __restrict__ bias,
                        __nv_bfloat16* __restrict__ dst, long long rows,
                        int C, int W, int Wp, int ingest, int vec) {
  const long long idx = (long long)blockIdx.x * PRO_THREADS + threadIdx.x;
  const int per_row = Wp / 8;
  if (idx >= rows * per_row) return;
  const long long r = idx / per_row;
  const int w0 = (int)(idx - r * per_row) * 8;
  const int c = (int)(r % C);
  const size_t in = (size_t)r * W + w0;
  const __nv_bfloat16 zero = __float2bfloat16(0.f);
  alignas(16) __nv_bfloat16 v[8];
  if (vec) {
    *reinterpret_cast<uint4*>(v) = *reinterpret_cast<const uint4*>(x + in);
  } else {
#pragma unroll
    for (int k = 0; k < 8; ++k) v[k] = w0 + k < W ? x[in + k] : zero;
  }
  const float s = ingest ? scale[c] : 0.f;
  const float bb = ingest ? bias[c] : 0.f;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    if (ingest) {
      float f = __fmul_rn(__bfloat162float(v[k]), s);
      f = __fadd_rn(f, bb);
      v[k] = __float2bfloat16(fmaxf(f, 0.f));
    }
    if (w0 + k >= W) v[k] = zero;
  }
  *reinterpret_cast<uint4*>(dst + (size_t)r * Wp + w0) =
      *reinterpret_cast<const uint4*>(v);
}

// dw[e] = sum_s part[s][e] for e < n, s in order 0..S-1.
__global__ void reduce_splits_kernel(const float* __restrict__ part,
                                     float* __restrict__ dw, int S, int n) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  float v = 0.f;
  for (int s = 0; s < S; ++s) v += part[(size_t)s * n + e];
  dw[e] = v;
}

}  // namespace

extern "C" {

// dw (3, 3, Ci, Co) f32 = the weight gradient of x (B, H, Ci, W) and gy
// (B, H, Co, W), bf16, with the ingest (scale, bias; null for none) and
// the cot (y, g1, g2; null for none). Scratch, all 16-byte aligned: a_buf
// (B, H, Ci, Wp) for a', or null to read x in place (then Wp == W); g_buf
// (B, H, W, Cp) for g'; part (splits, 9, Ci, Co) f32. nwc = ceil(W / 64)
// chunks per row, chunks = B * H * nwc (conv3x3.py:plan_wgrad). Launches
// the prologue, the GEMM and the reduction on `stream`; returns
// cudaGetLastError(), or -1 if a tensor map could not be encoded.
int conv3x3_wgrad(const void* x, const void* gy, const void* scale,
                  const void* bias, const void* y, const void* g1,
                  const void* g2, void* a_buf, void* g_buf, void* part,
                  void* dw, int B, int H, int Ci, int W, int Co, int Wp,
                  int Cp, int nwc, int chunks, int splits, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const void* a = x;
  if (a_buf != nullptr) {
    const long long rows = (long long)B * H * Ci;
    const long long n = rows * (Wp / 8);
    const bool vec = W % 8 == 0 && (uintptr_t)x % 16 == 0;
    wgrad_ingest_kernel<<<(unsigned)((n + PRO_THREADS - 1) / PRO_THREADS),
                          PRO_THREADS, 0, s>>>(
        (const __nv_bfloat16*)x, (const float*)scale, (const float*)bias,
        (__nv_bfloat16*)a_buf, rows, Ci, W, Wp, scale != nullptr ? 1 : 0,
        vec ? 1 : 0);
    a = a_buf;
  }
  ingest_t(y != nullptr ? INGEST_COT : INGEST_NONE, gy, y, g1, g2, g_buf,
           B * H, Co, Cp, W, 0, s);

  CUtensorMap map_a, map_g;
  if (encode_map(&map_a, a, W, Ci, H, B, Wp, BOX_W, TILE) != 0 ||
      encode_map(&map_g, g_buf, Cp, W, H, B, Cp, TILE, BOX_W) != 0)
    return -1;
  static bool smem_set[64] = {};  // per device
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= 64 || !smem_set[dev]) {
    cudaFuncSetAttribute(conv3x3_wgrad_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         SMEM_BYTES);
    if (dev >= 0 && dev < 64) smem_set[dev] = true;
  }
  Args args;
  args.part = (float*)part;
  args.H = H;
  args.Ci = Ci;
  args.Co = Co;
  args.nwc = nwc;
  args.chunks = chunks;
  dim3 grid((Ci + TILE - 1) / TILE, (Co + TILE - 1) / TILE, splits);
  conv3x3_wgrad_kernel<<<grid, THREADS, SMEM_BYTES, s>>>(map_a, map_g, args);
  const int n = 9 * Ci * Co;
  reduce_splits_kernel<<<(n + 255) / 256, 256, 0, s>>>(
      (const float*)part, (float*)dw, splits, n);
  return (int)cudaGetLastError();
}

}  // extern "C"
