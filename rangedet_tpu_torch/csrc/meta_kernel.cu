// Kernel 7: the Meta-Kernel's weighted neighbourhood, materialized, over
// (B, H, C, W) -> (B, H, 9C, W) bf16, tap-major and channel-minor.
// Replaces _meta_kernel_fused_impl (rangedet_tpu/ops/meta_kernel_pallas.py,
// its _kernel): per pixel and tap t = (dy, dx),
//   rel = coords[h+dy-1, w+dx-1] - coords[h, w]   (zero padding)
//   wt  = W1^T relu(W0^T rel + b0) + b1
//   out[b, h, t*C + c, w] = bf16(feat[b, h+dy-1, c, w+dx-1] * wt[c])
// rel, the hidden layer and wt in f32 from the bf16 operands, rounded once
// at the product: the tap stage of meta_block.cu, shared through
// meta_taps.cuh (the TPU kernel rounds rel and h to bf16 instead).
//
// What bounds it on Hopper: at the recipe's widths (C = 64, Cm = 32) a
// pixel writes 9C bf16 = 1152 bytes and reads ~140, and costs 9 taps x
// (2 C Cm + 7 Cm + 2 C) ~ 39 kFLOP of f32 FFMA. At B = 4 (679,936 pixels)
// that is 783 MB written (0.23 ms at 3.35 TB/s) against 27 GFLOP (0.40 ms
// at 67 TFLOP/s): operations, in f32, by a little. This first version is
// plain f32 FFMA (no tensor cores for the Cm -> C layer).
//
// Design: a persistent grid; each block walks tiles of P = 32 pixels of one
// row, stages the three feature and coordinate rows around the tile, and
// for each tap rebuilds h1 and the products (thread (c, g): channel c,
// pixels g*8 .. g*8+7), stages the (C, P) tile of products in shared
// memory, and stores it row by row: a warp writes the 32 consecutive pixels
// of one (tap, channel) row, 64 contiguous bytes, since W is the
// contiguous axis of the output.

#include "meta_taps.cuh"

namespace {

constexpr int TAPS_KIND = 4;  // the shared-memory carve of meta_taps.cuh

__global__ void __launch_bounds__(THREADS) meta_taps_kernel(Args p) {
  extern __shared__ __align__(16) float smem[];
  const Smem s = carve<TAPS_KIND>(smem);
  const int tid = threadIdx.x;
  const int c = tid % C;
  const int g = tid / C;
  const int H = p.H, W = p.W;
  const int ntw = (W + P - 1) / P;
  load_constants(p, s);
  const int t_begin = (int)((long long)p.tiles * blockIdx.x / gridDim.x);
  const int t_end = (int)((long long)p.tiles * (blockIdx.x + 1) / gridDim.x);

  for (int tile = t_begin; tile < t_end; ++tile) {
    const int bh = tile / ntw;
    const int w0 = (tile - bh * ntw) * P;
    const int b = bh / H;
    const int h = bh - b * H;
    __syncthreads();  // the previous tile is done with the buffers
    load_halo(p, s, b, h, w0);
#pragma unroll 1
    for (int t = 0; t < NT; ++t) {
      const int dy = t / 3, dx = t % 3;
      __syncthreads();  // halo staged; the last tap's h1 and t0 readers done
      tap_hidden(s, dy, dx);
      __syncthreads();
      float wt[PP], nb[PP], a[PP];
      tap_products(p, s, c, g, dy, dx, wt, nb, a);
#pragma unroll
      for (int i = 0; i < PP; ++i) s.t0[c * LDP + g * PP + i] = a[i];
      __syncthreads();
      __nv_bfloat16* row = p.out + ((size_t)(b * H + h) * NT + t) * C * W + w0;
      for (int e = tid; e < C * P; e += THREADS) {
        const int cc = e / P, q = e % P;
        if (w0 + q < W)
          row[(size_t)cc * W + q] = __float2bfloat16(s.t0[cc * LDP + q]);
      }
    }
  }
}

int tiles_of(int B, int H, int W) { return B * H * ((W + P - 1) / P); }

}  // namespace

extern "C" {

// Blocks of a launch on the current device; negative on error.
int meta_kernel_grid(int B, int H, int W) {
  return grid_for<TAPS_KIND>(meta_taps_kernel, tiles_of(B, H, W));
}

// feat (B, H, C, W) bf16, cb (B, H, 3, W) bf16, f32 weights w0 (3, Cm), b0
// (Cm), w1 (Cm, C), b1 (C); out (B, H, 9C, W) bf16.
int meta_kernel_taps(const void* feat, const void* cb, const void* w0,
                     const void* b0, const void* w1, const void* b1,
                     void* out, int B, int H, int W, int blocks,
                     void* stream) {
  Args a = make_args(feat, cb, w0, b0, w1, b1, B, H, W);
  a.out = (__nv_bfloat16*)out;
  a.tiles = tiles_of(B, H, W);
  meta_taps_kernel<<<blocks, THREADS,
                     smem_floats<TAPS_KIND>() * sizeof(float),
                     (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
