// 3x3 convolution over (B, H, C, W) activations, bf16 in / f32 accumulate /
// bf16 out, with an optional fused producer BatchNorm+relu on the input load.
//
// Replaces the TPU kernel rangedet_tpu/ops/conv_pallas.py:_conv3x3_fwd /
// _fwd_kernel (forward only: stats=False, bwd_affine=None, cot_adjust=None).
//
//   y[b,h,co,u] = sum_{dy,dx,ci} W[dy,dx,ci,co] * a[b, h+dy-1, ci, s*u+dx-p]
//   a = x, or a = bf16(relu(f32(x) * scale[ci] + bias[ci]))   (ingest)
//
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

// x: (B, H, Ci, W) bf16. wp: (Co_pad, 9, Ci_pad) bf16, tap t = dy*3 + dx,
// zero-padded to Co_pad % 64 == 0 and Ci_pad % 16 == 0. scale/bias: (Ci,)
// f32 or null. y: (B, H, Co, Wo) bf16.
__global__ void __launch_bounds__(THREADS)
conv3x3_bhcw_kernel(const __nv_bfloat16* __restrict__ x,
                    const __nv_bfloat16* __restrict__ wp,
                    const float* __restrict__ scale,
                    const float* __restrict__ bias,
                    __nv_bfloat16* __restrict__ y, int H, int Ci, int W,
                    int Co, int Ci_pad, int stride, int Wo) {
  __shared__ __align__(16) __nv_bfloat16 sx[3 * MAX_COLS * LDS];
  __shared__ __align__(16) __nv_bfloat16 sw[9 * BM * LDS];

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

  for (int ci0 = 0; ci0 < Ci_pad; ci0 += CK) {
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
        v = x[((size_t)(b * H + hh) * Ci + cg) * W + gc];
        if (scale != nullptr) {
          float f = __fmul_rn(__bfloat162float(v), scale[cg]);
          f = __fadd_rn(f, bias[cg]);
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
      const uint4 val = *reinterpret_cast<const uint4*>(
          wp + ((size_t)(co0 + co) * 9 + t) * Ci_pad + ci0 + half * 8);
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

  // ---- epilogue: f32 -> bf16, masked store
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int co = co0 + warp_m * 32 + i * 16 + g + (r >= 2 ? 8 : 0);
        const int u = w0 + warp_n * 32 + j * 8 + 2 * q + (r & 1);
        if (co < Co && u < Wo)
          y[((size_t)bh * Co + co) * Wo + u] = __float2bfloat16(acc[i][j][r]);
      }
    }
  }
}

}  // namespace

// C entry point for ctypes. Launches on `stream` and returns
// cudaGetLastError() (0 on success); it never synchronises.
extern "C" int conv3x3_bhcw_fwd(const void* x, const void* wp,
                                const void* scale, const void* bias, void* y,
                                int B, int H, int Ci, int W, int Co,
                                int Ci_pad, int stride, void* stream) {
  const int Wo = stride == 1 ? W : (W + 1) / 2;
  dim3 grid((Wo + BN - 1) / BN, (Co + BM - 1) / BM, B * H);
  conv3x3_bhcw_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)x, (const __nv_bfloat16*)wp, (const float*)scale,
      (const float*)bias, (__nv_bfloat16*)y, H, Ci, W, Co, Ci_pad, stride, Wo);
  return (int)cudaGetLastError();
}
