// The f32-FFMA tap stage of the Meta-Kernel at the recipe's widths, shared
// by meta_block.cu (kernel 3, meta_stats) and meta_kernel.cu (kernel 7, the
// materialized taps): the widths, the block's shared-memory regions, and
// the code that stages a tile's halo and rebuilds its 9 taps. (Kernels 4
// and 5 in meta_block.cu rebuild the taps on the tensor cores.)
//
// A tile is P = 32 pixels of one image row. load_halo stages the feature and
// coordinate rows h-1 .. h+1 around it (zero outside the image); per tap,
// tap_hidden writes h1 = relu(W0^T rel + b0) for the tile in f32, and
// tap_products gives thread (c, g) wt = W1^T h1 + b1 and the tap product
// a = bf16(nb * wt) of channel c for pixels g*8 .. g*8+7, in f32 FFMA.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int C = 64;    // feature channels (the MLP's output)
constexpr int CM = 32;   // MLP hidden width
constexpr int CO = 64;   // aggregation outputs
constexpr int NT = 9;    // taps
constexpr int P = 32;    // pixels per tile
constexpr int PH = P + 2;  // tile + halo columns
constexpr int LDP = P + 4;  // pitch of (channel, pixel) tiles in smem
constexpr int THREADS = 256;
constexpr int G = THREADS / C;  // pixel groups
constexpr int PP = P / G;       // pixels per thread
static_assert(PP == 8 && CM % G == 0, "tiling");

__device__ __forceinline__ float bf(const __nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}
__device__ __forceinline__ void load8(const float* s, float* v) {
  const float4 a = *reinterpret_cast<const float4*>(s);
  const float4 b = *reinterpret_cast<const float4*>(s + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

struct Args {
  const __nv_bfloat16* feat;  // (B, H, C, W)
  const __nv_bfloat16* cb;    // (B, H, 3, W)
  const float* w0;            // (3, CM)
  const float* b0;            // (CM)
  const float* w1;            // (CM, C)
  const float* b1;            // (C)
  __nv_bfloat16* out;         // the taps (B, H, 9C, W), kernel 7
  float* part;                // (blocks, per-block floats), kernel 3
  int B, H, W, tiles;
};

// Shared-memory regions (float offsets, each a multiple of 4).
struct Smem {
  float* fh;   // [3][C][PH] feature rows around the tile, f32
  float* ch;   // [3][3][PH] coordinate rows
  float* h1;   // [CM][LDP]
  float* rel;  // [3][P]
  float* w0;   // [3][CM], then b0 [CM]
  float* w1;   // [CM][C]
  float* t0;   // [C][LDP] output staging (kernel 7)
  float* red;  // block sums (kernel 3)
};

constexpr int round4(int n) { return (n + 3) / 4 * 4; }
constexpr int S_FH = 3 * C * PH;
constexpr int S_CH = round4(9 * PH);
constexpr int S_H1 = CM * LDP;
constexpr int S_REL = 3 * P;
constexpr int S_W0 = 4 * CM;
constexpr int S_W1 = CM * C;
constexpr int S_T = C * LDP;
constexpr int S_RED_STATS = G * 2 * NT * C;

// 0 stats (meta_block.cu), 4 taps (meta_kernel.cu)
template <int KIND>
constexpr size_t smem_floats() {
  size_t n = S_FH + S_CH + S_H1 + S_REL + S_W0 + S_W1;
  if (KIND == 0) n += S_RED_STATS;
  if (KIND == 4) n += S_T;
  return n;
}

template <int KIND>
__device__ Smem carve(float* base) {
  Smem s;
  float* p = base;
  s.fh = p; p += S_FH;
  s.ch = p; p += S_CH;
  s.h1 = p; p += S_H1;
  s.rel = p; p += S_REL;
  s.w0 = p; p += S_W0;
  s.w1 = p; p += S_W1;
  s.t0 = s.red = nullptr;
  if (KIND == 0) s.red = p;
  if (KIND == 4) s.t0 = p;
  return s;
}

// Constants every tile uses: the MLP weights.
__device__ void load_constants(const Args& p, const Smem& s) {
  const int tid = threadIdx.x;
  for (int e = tid; e < 3 * CM; e += THREADS) s.w0[e] = p.w0[e];
  for (int e = tid; e < CM; e += THREADS) s.w0[3 * CM + e] = p.b0[e];
  for (int e = tid; e < CM * C; e += THREADS) s.w1[e] = p.w1[e];
}

// Stage feature and coordinate rows hs-1 .. hs+1, columns ws0-1 .. ws0+P
// of image b; zero outside the image.
__device__ void load_halo(const Args& p, const Smem& s, int b, int hs,
                          int ws0) {
  const int H = p.H, W = p.W;
  for (int e = threadIdx.x; e < 3 * C * PH; e += THREADS) {
    const int col = e % PH;
    const int rc = e / PH;
    const int c = rc % C;
    const int hh = hs + rc / C - 1;
    const int ww = ws0 - 1 + col;
    float v = 0.f;
    if (hh >= 0 && hh < H && ww >= 0 && ww < W)
      v = bf(p.feat[((size_t)(b * H + hh) * C + c) * W + ww]);
    s.fh[e] = v;
  }
  for (int e = threadIdx.x; e < 9 * PH; e += THREADS) {
    const int col = e % PH;
    const int rj = e / PH;
    const int j = rj % 3;
    const int hh = hs + rj / 3 - 1;
    const int ww = ws0 - 1 + col;
    float v = 0.f;
    if (hh >= 0 && hh < H && ww >= 0 && ww < W)
      v = bf(p.cb[((size_t)(b * H + hh) * 3 + j) * W + ww]);
    s.ch[e] = v;
  }
}

// h1[k][q] of tap (dy, dx) for the tile's P pixels; rel[j][q] too.
__device__ void tap_hidden(const Smem& s, int dy, int dx) {
  for (int e = threadIdx.x; e < CM * P; e += THREADS) {
    const int k = e / P;
    const int q = e % P;
    float r[3];
#pragma unroll
    for (int j = 0; j < 3; ++j)
      r[j] = s.ch[(dy * 3 + j) * PH + q + dx] - s.ch[(3 + j) * PH + q + 1];
    float h = s.w0[k] * r[0];
    h = h + s.w0[CM + k] * r[1];
    h = h + s.w0[2 * CM + k] * r[2];
    h = h + s.w0[3 * CM + k];
    s.h1[k * LDP + q] = fmaxf(h, 0.f);
    if (k == 0)
#pragma unroll
      for (int j = 0; j < 3; ++j) s.rel[j * P + q] = r[j];
  }
}

// wt and the rounded tap product a for channel c, pixels g*PP .. +PP-1.
__device__ __forceinline__ void tap_products(const Args& p, const Smem& s,
                                             int c, int g, int dy, int dx,
                                             float* wt, float* nb, float* a) {
#pragma unroll
  for (int i = 0; i < PP; ++i) wt[i] = 0.f;
#pragma unroll 8
  for (int k = 0; k < CM; ++k) {
    const float w = s.w1[k * C + c];
    float hv[PP];
    load8(&s.h1[k * LDP + g * PP], hv);
#pragma unroll
    for (int i = 0; i < PP; ++i) wt[i] = fmaf(w, hv[i], wt[i]);
  }
  const float bias = p.b1[c];
#pragma unroll
  for (int i = 0; i < PP; ++i) {
    wt[i] += bias;
    nb[i] = s.fh[(dy * C + c) * PH + g * PP + i + dx];
    a[i] = round_bf16(nb[i] * wt[i]);
  }
}

// Blocks of a persistent launch: as many as fit on every SM at once,
// at most one per tile; negative on error.
template <int KIND>
int grid_for(void (*kernel)(Args), int tiles) {
  const int bytes = (int)(smem_floats<KIND>() * sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return -(int)err;
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      THREADS, bytes);
  if (err != cudaSuccess) return -(int)err;
  if (per_sm < 1) return -1;
  const int blocks = per_sm * sms;
  return blocks < tiles ? blocks : tiles;
}

Args make_args(const void* feat, const void* cb, const void* w0,
               const void* b0, const void* w1, const void* b1, int B, int H,
               int W) {
  Args a = {};
  a.feat = (const __nv_bfloat16*)feat;
  a.cb = (const __nv_bfloat16*)cb;
  a.w0 = (const float*)w0;
  a.b0 = (const float*)b0;
  a.w1 = (const float*)w1;
  a.b1 = (const float*)b1;
  a.B = B;
  a.H = H;
  a.W = W;
  return a;
}

}  // namespace
