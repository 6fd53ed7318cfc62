// 3x3 convolution over (B, H, C, W) activations, bf16 in / f32 accumulate /
// bf16 out, with the fused options of the TPU kernel it replaces:
// rangedet_tpu/ops/conv_pallas.py:_conv3x3_fwd / _fwd_kernel. The same
// kernel runs the forward and, with the flipped (Ci, Co)-swapped weight,
// the data gradient (dgrad) of the backward.
//
//   y[b,h,co,u] = sum_{dy,dx,ci} W[dy,dx,ci,co] * a[b, h+dy-1, ci, s*u+dx-p]
//
// Input load ("ingest"), in this order, each optional:
//   cot:    g = bf16(f32(x) + g1[ci] + 2*f32(yc)*g2[ci])   (_ingest_cot: the
//           BatchNorm-sums cotangents folded into the dgrad's gy)
//   affine: a = bf16(relu(f32(g) * scale[ci] + bias[ci]))  (_ingest: the
//           producer's BatchNorm apply + relu)
// Epilogue, one of:
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
// What bounds it on Hopper: the convs are matmul-shaped (M=Co, N=W, K=9*Ci)
// with K in 72..1152 and N up to 2656 per row, so at the head towers'
// 128->128 channels (58% of the model's FLOPs) the arithmetic intensity is
// far above the H100's ~295 FLOP/byte ridge: compute-bound. The design runs
// the MACs on the tensor cores (mma.sync m16n8k16 bf16, f32 accumulate in
// registers) as an implicit GEMM; every block stages its three input rows
// (ingest applied, zeros outside) and its Co-tile of weights in shared
// memory one 16-channel K-chunk at a time, so each operand byte is read
// from device memory once per block. It is simple and synchronous: no
// wgmma, TMA, multi-stage pipeline or persistent tiling yet.
//
// The per-channel sums cannot be carried from block to block (blocks run in
// no order): each block writes its partial sums to a scratch row, and a
// second pass adds the rows in a fixed order. No atomics, so two runs on
// the same inputs give the same bits.
//
// Tiling: one block per (b*H + h, 64-wide Co tile, 64-wide output W tile);
// 4 warps in a 2x2 layout, each warp 32 Co x 32 W = 2x4 mma tiles.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;        // Co per block
constexpr int BN = 64;        // output columns per block
constexpr int CK = 16;        // input channels per K-chunk (one mma k-step)
constexpr int LDS = 24;       // smem row pitch in bf16 (16 data + 8 pad)
constexpr int MAX_COLS = 2 * (BN - 1) + 3;  // stride-2 input columns
constexpr int THREADS = 128;
constexpr int RED_THREADS = 256;

__device__ __forceinline__ void mma_bf16_16816(float* c, uint32_t a0,
                                               uint32_t a1, uint32_t a2,
                                               uint32_t a3, uint32_t b0,
                                               uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

struct Args {
  const __nv_bfloat16* x;   // (B, H, Ci, W)
  const __nv_bfloat16* wp;  // (Co_pad, 9, Ci_pad)
  const float* scale;       // (Ci,) affine ingest, or null
  const float* bias;
  const __nv_bfloat16* cot_y;  // (B, H, Ci, W) cot ingest, or null
  const float* cot_g1;         // (Ci,)
  const float* cot_g2;
  const __nv_bfloat16* bwd_x;  // (B, H, Co, Wo) bwd epilogue, or null
  const float* bwd_s;          // (Co,)
  const float* bwd_b;
  __nv_bfloat16* y;  // (B, H, Co, Wo)
  float* part;       // (B*H*nwt, 2, Co) per-block sums, or null
  int H, Ci, W, Co, Ci_pad, stride, Wo;
};

// The ingest and epilogue options are template parameters, so that each
// combination compiles to a loop without the others' branches; loads of
// the read-only operands go through the read-only data cache (__ldg).
enum Epilogue { PLAIN = 0, STATS = 1, BWD = 2 };

template <bool COT, bool AFFINE, int EPI>
__global__ void __launch_bounds__(THREADS) conv3x3_bhcw_kernel(Args p) {
  __shared__ __align__(16) __nv_bfloat16 sx[3 * MAX_COLS * LDS];
  __shared__ __align__(16) __nv_bfloat16 sw[9 * BM * LDS];

  const int H = p.H, Ci = p.Ci, W = p.W, Co = p.Co, stride = p.stride;
  const int bh = blockIdx.z;  // b * H + h
  const int b = bh / H;
  const int h = bh - b * H;
  const int co0 = blockIdx.y * BM;
  const int w0 = blockIdx.x * BN;
  const int pad = stride == 1 ? 1 : 0;
  const int c_base = stride * w0 - pad;  // input column of local column 0
  const int ncols = stride * (BN - 1) + 3;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int warp_m = warp >> 1;  // 32-row Co slab
  const int warp_n = warp & 1;   // 32-column W slab
  const int g = lane >> 2;       // mma group id
  const int q = lane & 3;        // thread in group

  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.f;

  const __nv_bfloat16 zero = __float2bfloat16(0.f);

  for (int ci0 = 0; ci0 < p.Ci_pad; ci0 += CK) {
    __syncthreads();  // previous chunk's reads are done
    // ---- stage input rows h-1..h+1, channels ci0..ci0+15, ingest applied
    const int n_in = 3 * CK * ncols;
    for (int e = tid; e < n_in; e += THREADS) {
      const int col = e % ncols;
      const int rest = e / ncols;
      const int ci = rest % CK;
      const int dy = rest / CK;
      const int hh = h + dy - 1;
      const int gc = c_base + col;
      const int cg = ci0 + ci;
      __nv_bfloat16 v = zero;
      if (hh >= 0 && hh < H && gc >= 0 && gc < W && cg < Ci) {
        const size_t idx = ((size_t)(b * H + hh) * Ci + cg) * W + gc;
        v = __ldg(p.x + idx);
        if (COT) {
          const float t = __fmul_rn(
              2.f * __bfloat162float(__ldg(p.cot_y + idx)),
              __ldg(p.cot_g2 + cg));
          v = __float2bfloat16(__fadd_rn(
              __fadd_rn(__bfloat162float(v), __ldg(p.cot_g1 + cg)), t));
        }
        if (AFFINE) {
          float f = __fmul_rn(__bfloat162float(v), __ldg(p.scale + cg));
          f = __fadd_rn(f, __ldg(p.bias + cg));
          v = __float2bfloat16(fmaxf(f, 0.f));
        }
      }
      sx[(dy * MAX_COLS + col) * LDS + ci] = v;
    }
    // ---- stage the Co tile's weights for this chunk, 16-byte vectors
    const int n_vec = BM * 9 * 2;
    for (int v = tid; v < n_vec; v += THREADS) {
      const int half = v & 1;
      const int rest = v >> 1;
      const int t = rest % 9;
      const int co = rest / 9;
      const uint4 val = __ldg(reinterpret_cast<const uint4*>(
          p.wp + ((size_t)(co0 + co) * 9 + t) * p.Ci_pad + ci0 + half * 8));
      *reinterpret_cast<uint4*>(&sw[(t * BM + co) * LDS + half * 8]) = val;
    }
    __syncthreads();

    // ---- 9 taps x one k16 step each
#pragma unroll
    for (int t = 0; t < 9; ++t) {
      const int dy = t / 3;
      const int dx = t - dy * 3;
      uint32_t af[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = warp_m * 32 + i * 16 + g;
        const __nv_bfloat16* p0 = &sw[(t * BM + row) * LDS + 2 * q];
        const __nv_bfloat16* p1 = &sw[(t * BM + row + 8) * LDS + 2 * q];
        af[i][0] = *reinterpret_cast<const uint32_t*>(p0);
        af[i][1] = *reinterpret_cast<const uint32_t*>(p1);
        af[i][2] = *reinterpret_cast<const uint32_t*>(p0 + 8);
        af[i][3] = *reinterpret_cast<const uint32_t*>(p1 + 8);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = warp_n * 32 + j * 8 + g;
        const int col = stride * n + dx;
        const __nv_bfloat16* pb = &sx[(dy * MAX_COLS + col) * LDS + 2 * q];
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(pb);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(pb + 8);
#pragma unroll
        for (int i = 0; i < 2; ++i)
          mma_bf16_16816(acc[i][j], af[i][0], af[i][1], af[i][2], af[i][3],
                         b0, b1);
      }
    }
  }

  // ---- epilogue: masked store, and per-channel partial sums
  // sum[i][rh][k]: channel warp_m*32 + i*16 + rh*8 + g, k = 0 (sum y or
  // dz*xo) and 1 (sum y^2 or dz), over this thread's 8 columns
  float sum[2][2][2] = {};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int co = co0 + warp_m * 32 + i * 16 + g + (r >= 2 ? 8 : 0);
        const int u = w0 + warp_n * 32 + j * 8 + 2 * q + (r & 1);
        if (co < Co && u < p.Wo) {
          const size_t idx = ((size_t)bh * Co + co) * p.Wo + u;
          if (EPI == BWD) {
            const float xo = __bfloat162float(__ldg(p.bwd_x + idx));
            const float sc = __ldg(p.bwd_s + co);
            const float z = __fadd_rn(__fmul_rn(xo, sc), __ldg(p.bwd_b + co));
            const float dz = z > 0.f ? acc[i][j][r] : 0.f;
            p.y[idx] = __float2bfloat16(__fmul_rn(dz, sc));
            sum[i][r >> 1][0] += __fmul_rn(dz, xo);
            sum[i][r >> 1][1] += dz;
          } else {
            const __nv_bfloat16 yb = __float2bfloat16(acc[i][j][r]);
            p.y[idx] = yb;
            const float yf = __bfloat162float(yb);
            sum[i][r >> 1][0] += yf;
            sum[i][r >> 1][1] += __fmul_rn(yf, yf);
          }
        }
      }
    }
  }
  if (EPI == PLAIN) return;

  // reduce over the 4 threads of an mma group (same channels), then over
  // the two W slabs through shared memory, always in the same order
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int rh = 0; rh < 2; ++rh)
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        float v = sum[i][rh][k];
        v += __shfl_xor_sync(0xffffffffu, v, 1);
        v += __shfl_xor_sync(0xffffffffu, v, 2);
        sum[i][rh][k] = v;
      }
  __syncthreads();  // sx is free: reuse it for the slab sums
  float* red = reinterpret_cast<float*>(sx);  // [warp_n][64][2]
  if (q == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int rh = 0; rh < 2; ++rh) {
        const int c = warp_m * 32 + i * 16 + rh * 8 + g;
        red[(warp_n * BM + c) * 2 + 0] = sum[i][rh][0];
        red[(warp_n * BM + c) * 2 + 1] = sum[i][rh][1];
      }
  }
  __syncthreads();
  if (tid < BM && co0 + tid < Co) {
    const size_t row = (size_t)bh * gridDim.x + blockIdx.x;
#pragma unroll
    for (int k = 0; k < 2; ++k)
      p.part[(row * 2 + k) * Co + co0 + tid] =
          red[tid * 2 + k] + red[(BM + tid) * 2 + k];
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

template <bool COT, bool AFFINE>
void launch_epi(int epi, dim3 grid, cudaStream_t s, const Args& a) {
  if (epi == PLAIN)
    conv3x3_bhcw_kernel<COT, AFFINE, PLAIN><<<grid, THREADS, 0, s>>>(a);
  else if (epi == STATS)
    conv3x3_bhcw_kernel<COT, AFFINE, STATS><<<grid, THREADS, 0, s>>>(a);
  else
    conv3x3_bhcw_kernel<COT, AFFINE, BWD><<<grid, THREADS, 0, s>>>(a);
}

void launch(bool cot, bool affine, int epi, dim3 grid, cudaStream_t s,
            const Args& a) {
  if (cot && affine) launch_epi<true, true>(epi, grid, s, a);
  else if (cot) launch_epi<true, false>(epi, grid, s, a);
  else if (affine) launch_epi<false, true>(epi, grid, s, a);
  else launch_epi<false, false>(epi, grid, s, a);
}

}  // namespace

extern "C" {

// Rows of the partial-sums scratch a call with these shapes needs.
int conv3x3_bhcw_part_rows(int B, int H, int W, int stride) {
  const int Wo = stride == 1 ? W : (W + 1) / 2;
  return B * H * ((Wo + BN - 1) / BN);
}

// C entry point for ctypes. Launches on `stream` and returns
// cudaGetLastError() (0 on success); it never synchronises. `part` (f32,
// part_rows * 2 * Co) and `sums` (f32, 2 * Co) are both null, or both set:
// then sums holds (sum y, sum y^2), or with bwd_x set (dscale, dbias).
int conv3x3_bhcw_fwd(const void* x, const void* wp, const void* scale,
                     const void* bias, const void* cot_y, const void* cot_g1,
                     const void* cot_g2, const void* bwd_x, const void* bwd_s,
                     const void* bwd_b, void* y, void* part, void* sums, int B,
                     int H, int Ci, int W, int Co, int Ci_pad, int stride,
                     void* stream) {
  const int Wo = stride == 1 ? W : (W + 1) / 2;
  Args a;
  a.x = (const __nv_bfloat16*)x;
  a.wp = (const __nv_bfloat16*)wp;
  a.scale = (const float*)scale;
  a.bias = (const float*)bias;
  a.cot_y = (const __nv_bfloat16*)cot_y;
  a.cot_g1 = (const float*)cot_g1;
  a.cot_g2 = (const float*)cot_g2;
  a.bwd_x = (const __nv_bfloat16*)bwd_x;
  a.bwd_s = (const float*)bwd_s;
  a.bwd_b = (const float*)bwd_b;
  a.y = (__nv_bfloat16*)y;
  a.part = (float*)part;
  a.H = H;
  a.Ci = Ci;
  a.W = W;
  a.Co = Co;
  a.Ci_pad = Ci_pad;
  a.stride = stride;
  a.Wo = Wo;
  dim3 grid((Wo + BN - 1) / BN, (Co + BM - 1) / BM, B * H);
  cudaStream_t s = (cudaStream_t)stream;
  const int epi = bwd_x != nullptr ? BWD : (part != nullptr ? STATS : PLAIN);
  const bool cot = cot_y != nullptr, affine = scale != nullptr;
  launch(cot, affine, epi, grid, s, a);
  if (part != nullptr) {
    const int rows = B * H * (int)grid.x;
    reduce_rows_kernel<<<dim3(Co, 2), RED_THREADS, 0, s>>>(
        (const float*)part, (float*)sums, rows, Co);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
