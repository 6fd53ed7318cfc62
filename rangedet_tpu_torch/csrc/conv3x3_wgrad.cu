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
// K = B*H*W (340k at B=2 and full width), so the work is compute-bound at
// the model's widths, but the output is small: a grid over M and N alone
// gives 2-64 blocks for 132 SMs. The design splits K: grid (Ci/16, Co/64,
// S), each block owns 9 taps x 16 input channels x 64 output channels and
// walks a contiguous run of 64-pixel chunks of one image row, staging the
// three input rows (ingest applied, three dx-shifted copies so every
// mma.sync operand load is aligned) and the cotangent row in shared memory
// and accumulating in f32 registers (mma.sync m16n8k16 bf16). It writes an
// f32 partial (9, Ci, Co) tile; a second pass adds the S partials in a
// fixed order, so the result has the same bits on every run (no atomics).
// S is chosen to put about 8 blocks on each SM. Simple and synchronous: no
// wgmma, TMA or pipelining yet.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int CT = 16;       // input channels per block (mma M tile)
constexpr int NT = 64;       // output channels per block
constexpr int KC = 64;       // pixels per chunk (4 mma k-steps)
constexpr int LDA = KC + 8;  // smem row pitch in bf16
constexpr int THREADS = 128;
constexpr int TARGET_BLOCKS = 8 * 132;

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
  const __nv_bfloat16* gy;  // (B, H, Co, W)
  const float* scale;       // (Ci,) or null
  const float* bias;
  const __nv_bfloat16* cot_y;  // (B, H, Co, W) or null
  const float* cot_g1;         // (Co,)
  const float* cot_g2;
  float* part;  // (S, 9, Ci, Co)
  int H, Ci, W, Co, nwc, chunks;
};

// The two load-time options are template parameters (no per-element
// branches); read-only operands load through the read-only cache (__ldg).
template <bool AFFINE, bool COT>
__global__ void __launch_bounds__(THREADS) conv3x3_wgrad_kernel(Args p) {
  // sa[dx][dy][ci][k] = a[h+dy-1][ci0+ci][w0+k+dx-1]; sg[co][k] = g[h][co][w0+k]
  __shared__ __align__(16) __nv_bfloat16 sa[3 * 3 * CT * LDA];
  __shared__ __align__(16) __nv_bfloat16 sg[NT * LDA];

  const int H = p.H, Ci = p.Ci, W = p.W, Co = p.Co;
  const int ci0 = blockIdx.x * CT;
  const int co0 = blockIdx.y * NT;
  const int S = gridDim.z;
  const int c_begin = (int)((long long)p.chunks * blockIdx.z / S);
  const int c_end = (int)((long long)p.chunks * (blockIdx.z + 1) / S);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;  // output channels warp*16 .. +15
  const int g = lane >> 2;
  const int q = lane & 3;

  float acc[9][2][4];
#pragma unroll
  for (int t = 0; t < 9; ++t)
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[t][n][r] = 0.f;

  const __nv_bfloat16 zero = __float2bfloat16(0.f);

  for (int chunk = c_begin; chunk < c_end; ++chunk) {
    const int bh = chunk / p.nwc;
    const int w0 = (chunk - bh * p.nwc) * KC;
    const int b = bh / H;
    const int h = bh - b * H;
    __syncthreads();  // previous chunk's reads are done
    // ---- a: rows h-1..h+1, columns w0-1 .. w0+KC, ingest applied
    constexpr int NCOL = KC + 2;
    for (int e = tid; e < 3 * CT * NCOL; e += THREADS) {
      const int col = e % NCOL;
      const int rest = e / NCOL;
      const int ci = rest % CT;
      const int dy = rest / CT;
      const int hh = h + dy - 1;
      const int gc = w0 - 1 + col;
      const int cg = ci0 + ci;
      __nv_bfloat16 v = zero;
      if (hh >= 0 && hh < H && gc >= 0 && gc < W && cg < Ci) {
        v = __ldg(p.x + ((size_t)(b * H + hh) * Ci + cg) * W + gc);
        if (AFFINE) {
          float f = __fmul_rn(__bfloat162float(v), __ldg(p.scale + cg));
          f = __fadd_rn(f, __ldg(p.bias + cg));
          v = __float2bfloat16(fmaxf(f, 0.f));
        }
      }
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) {
        const int k = col - dx;
        if (k >= 0 && k < KC) sa[((dx * 3 + dy) * CT + ci) * LDA + k] = v;
      }
    }
    // ---- g: row h, output channels co0 .. co0+NT-1, cot applied
    for (int e = tid; e < NT * KC; e += THREADS) {
      const int k = e % KC;
      const int co = e / KC;
      const int gw = w0 + k;
      const int cg = co0 + co;
      __nv_bfloat16 v = zero;
      if (gw < W && cg < Co) {
        const size_t idx = ((size_t)bh * Co + cg) * W + gw;
        v = __ldg(p.gy + idx);
        if (COT) {
          const float t = __fmul_rn(
              2.f * __bfloat162float(__ldg(p.cot_y + idx)),
              __ldg(p.cot_g2 + cg));
          v = __float2bfloat16(__fadd_rn(
              __fadd_rn(__bfloat162float(v), __ldg(p.cot_g1 + cg)), t));
        }
      }
      sg[co * LDA + k] = v;
    }
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < KC; kk += 16) {
      uint32_t bf[2][2];
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        const __nv_bfloat16* pb = &sg[(warp * 16 + n * 8 + g) * LDA + kk + 2 * q];
        bf[n][0] = *reinterpret_cast<const uint32_t*>(pb);
        bf[n][1] = *reinterpret_cast<const uint32_t*>(pb + 8);
      }
#pragma unroll
      for (int t = 0; t < 9; ++t) {
        const int dy = t / 3;
        const int dx = t - dy * 3;
        const __nv_bfloat16* p0 = &sa[((dx * 3 + dy) * CT + g) * LDA + kk + 2 * q];
        const __nv_bfloat16* p1 = p0 + 8 * LDA;
        const uint32_t a0 = *reinterpret_cast<const uint32_t*>(p0);
        const uint32_t a1 = *reinterpret_cast<const uint32_t*>(p1);
        const uint32_t a2 = *reinterpret_cast<const uint32_t*>(p0 + 8);
        const uint32_t a3 = *reinterpret_cast<const uint32_t*>(p1 + 8);
#pragma unroll
        for (int n = 0; n < 2; ++n)
          mma_bf16_16816(acc[t][n], a0, a1, a2, a3, bf[n][0], bf[n][1]);
      }
    }
  }

  // ---- partial tile: rows ci (g, g+8), columns co (2q, 2q+1) per n-tile
  float* out = p.part + (size_t)blockIdx.z * 9 * Ci * Co;
#pragma unroll
  for (int t = 0; t < 9; ++t)
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int ci = ci0 + g + (r >= 2 ? 8 : 0);
        const int co = co0 + warp * 16 + n * 8 + 2 * q + (r & 1);
        if (ci < Ci && co < Co)
          out[((size_t)t * Ci + ci) * Co + co] = acc[t][n][r];
      }
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

int num_chunks(int B, int H, int W) { return B * H * ((W + KC - 1) / KC); }

}  // namespace

extern "C" {

// Number of K splits for these shapes; the caller allocates the f32
// scratch of splits * 9 * Ci * Co floats.
int conv3x3_wgrad_splits(int B, int H, int Ci, int W, int Co) {
  const int tiles = ((Ci + CT - 1) / CT) * ((Co + NT - 1) / NT);
  int s = (TARGET_BLOCKS + tiles - 1) / tiles;
  const int chunks = num_chunks(B, H, W);
  return s < chunks ? s : chunks;
}

// dw: (3, 3, Ci, Co) f32. Launches on `stream`, returns cudaGetLastError().
int conv3x3_wgrad(const void* x, const void* gy, const void* scale,
                  const void* bias, const void* cot_y, const void* cot_g1,
                  const void* cot_g2, void* part, void* dw, int B, int H,
                  int Ci, int W, int Co, int splits, void* stream) {
  Args a;
  a.x = (const __nv_bfloat16*)x;
  a.gy = (const __nv_bfloat16*)gy;
  a.scale = (const float*)scale;
  a.bias = (const float*)bias;
  a.cot_y = (const __nv_bfloat16*)cot_y;
  a.cot_g1 = (const float*)cot_g1;
  a.cot_g2 = (const float*)cot_g2;
  a.part = (float*)part;
  a.H = H;
  a.Ci = Ci;
  a.W = W;
  a.Co = Co;
  a.nwc = (W + KC - 1) / KC;
  a.chunks = num_chunks(B, H, W);
  cudaStream_t s = (cudaStream_t)stream;
  dim3 grid((Ci + CT - 1) / CT, (Co + NT - 1) / NT, splits);
  if (scale != nullptr && cot_y != nullptr)
    conv3x3_wgrad_kernel<true, true><<<grid, THREADS, 0, s>>>(a);
  else if (scale != nullptr)
    conv3x3_wgrad_kernel<true, false><<<grid, THREADS, 0, s>>>(a);
  else if (cot_y != nullptr)
    conv3x3_wgrad_kernel<false, true><<<grid, THREADS, 0, s>>>(a);
  else
    conv3x3_wgrad_kernel<false, false><<<grid, THREADS, 0, s>>>(a);
  const int n = 9 * Ci * Co;
  reduce_splits_kernel<<<(n + 255) / 256, 256, 0, s>>>(
      (const float*)part, (float*)dw, splits, n);
  return (int)cudaGetLastError();
}

}  // extern "C"
