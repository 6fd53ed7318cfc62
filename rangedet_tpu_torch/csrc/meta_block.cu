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
// meta_agg_fwd replaces meta_agg_pallas (_fwd_kernel, mode "agg"):
//   y[co] = sum_t sum_c A[t*C+c, co] * relu(a_t[c] * s9 + b9), in f32
//   (relu(z) is not rounded: the contraction is f32 FFMA, as the TPU's).
// meta_block_bwd replaces _bwd_call (_bwd_kernel), both modes:
//   "agg":   dz = (A_t gy) [z > 0]; dA += relu(z) gy^T, ds9 += dz a,
//            db9 += dz, da = dz s9;
//   "stats": da = e0 + e1 a (e0 = ds1, e1 = 2 ds2);
//   both:    dnb = da wt goes to dfeat at the neighbour; dwt = da nb feeds
//            the MLP backward (dW1, db1, dW0, db0).
//
// What bounds them on Hopper: operations. At the recipe's widths (C = 64,
// Cm = 32, Co = 64) a pixel costs ~39 kFLOP of taps, 74 kFLOP of agg
// contraction, and the backward about 2.5x the forward, against a few
// hundred bytes of input. This first version is plain f32 FFMA from shared
// memory (no tensor cores, no TMA): each block walks tiles of P = 32 pixels
// of one row, stages the three feature and coordinate rows around them,
// and loops over the 9 taps; thread (c, g) owns channel c for pixels
// g*8 .. g*8+7.
//
// Sums over all pixels (s1/s2, dA, ds9/db9, the MLP gradients): no block
// can carry a sum to the next, so each block adds its tiles in a fixed
// order into per-thread or per-owner slots, writes one f32 partial, and a
// second kernel adds the partials in block order. No float atomics: two
// runs give the same bits.
//
// dfeat is a 3x3 scatter on the TPU (a lagged accumulation slab that needs
// the grid in order). Here it is a gather: the backward walks OUTPUT
// positions q of the zero-padded grid [-1, H] x [-1, W], and for tap t
// processes the source pixel s = q - (dy-1, dx-1), whose tap-t neighbour is
// q. Every (source, tap) pair is visited exactly once, so the sums are
// complete, and each output element is owned by one thread of one block,
// which adds the 9 taps' contributions in tap order (taps are the outer
// loop, so the running f32 sum lives in a (B, H, C, W) f32 scratch that
// only its owner touches; the last tap writes bf16 dfeat).

#include "meta_taps.cuh"

namespace {

constexpr int NA = CO / G;      // dA columns per thread (backward)
constexpr int KI = CM * P / THREADS;  // dh1 rows per thread (backward)
static_assert(NA == 16 && KI == 4, "tiling");

// per-block partial layout of the backward (floats)
constexpr int OFF_A = 0;                    // (9C, CO)
constexpr int OFF_S9 = OFF_A + NT * C * CO;  // (9C)
constexpr int OFF_B9 = OFF_S9 + NT * C;      // (9C)
constexpr int AGG_SUMS = OFF_B9 + NT * C;
constexpr int MLP_W0 = 0;                 // (3, CM)
constexpr int MLP_B0 = MLP_W0 + 3 * CM;   // (CM)
constexpr int MLP_W1 = MLP_B0 + CM;       // (CM, C)
constexpr int MLP_B1 = MLP_W1 + CM * C;   // (C)
constexpr int MLP_SUMS = MLP_B1 + C;

// ------------------------------------------------------------- forward
template <int KIND>
__global__ void __launch_bounds__(THREADS) meta_fwd_kernel(Args p) {
  extern __shared__ __align__(16) float smem[];
  const Smem s = carve<KIND>(smem);
  const int tid = threadIdx.x;
  const int c = tid % C;
  const int g = tid / C;
  const int H = p.H, W = p.W;
  const int ntw = (W + P - 1) / P;
  load_constants(p, s, KIND == 1);
  if (KIND == 0)
    for (int e = tid; e < S_RED_STATS; e += THREADS) s.red[e] = 0.f;
  if (KIND == 1)
    for (int e = tid; e < NT * C * CO; e += THREADS) s.a[e] = p.agg[e];
  const int t_begin = (int)((long long)p.tiles * blockIdx.x / gridDim.x);
  const int t_end = (int)((long long)p.tiles * (blockIdx.x + 1) / gridDim.x);

  for (int tile = t_begin; tile < t_end; ++tile) {
    const int bh = tile / ntw;
    const int w0 = (tile - bh * ntw) * P;
    const int b = bh / H;
    const int h = bh - b * H;
    __syncthreads();  // the previous tile is done with the buffers
    load_halo(p, s, b, h, w0);
    float acc[PP];
#pragma unroll
    for (int i = 0; i < PP; ++i) acc[i] = 0.f;
#pragma unroll 1
    for (int t = 0; t < NT; ++t) {
      const int dy = t / 3, dx = t % 3;
      __syncthreads();  // halo staged; last tap's readers of h1/t0 done
      tap_hidden(s, dy, dx);
      __syncthreads();
      float wt[PP], nb[PP], a[PP];
      tap_products(p, s, c, g, dy, dx, wt, nb, a);
      if (KIND == 0) {
        float s1 = 0.f, s2 = 0.f;
#pragma unroll
        for (int i = 0; i < PP; ++i)
          if (w0 + g * PP + i < W) {
            s1 += a[i];
            s2 += a[i] * a[i];
          }
        s.red[(g * 2) * NT * C + t * C + c] += s1;
        s.red[(g * 2 + 1) * NT * C + t * C + c] += s2;
      } else {
        const float s9 = s.e[t * C + c], b9 = s.e[NT * C + t * C + c];
#pragma unroll
        for (int i = 0; i < PP; ++i)
          s.t0[c * LDP + g * PP + i] = fmaxf(fmaf(a[i], s9, b9), 0.f);
        __syncthreads();
        // thread (co = c, g): acc[i] += sum_c' A[t, c', co] r[c'][i]
        const __nv_bfloat16* at = s.a + t * C * CO + c;
#pragma unroll 4
        for (int cc = 0; cc < C; ++cc) {
          const float av = bf(at[cc * CO]);
          float rv[PP];
          load8(&s.t0[cc * LDP + g * PP], rv);
#pragma unroll
          for (int i = 0; i < PP; ++i) acc[i] = fmaf(av, rv[i], acc[i]);
        }
      }
    }
    if (KIND == 1) {  // stage y, then coalesced bf16 stores
      __syncthreads();
#pragma unroll
      for (int i = 0; i < PP; ++i) s.t0[c * LDP + g * PP + i] = acc[i];
      __syncthreads();
      for (int e = tid; e < CO * P; e += THREADS) {
        const int co = e / P, q = e % P;
        if (w0 + q < W)
          p.out[((size_t)(b * H + h) * CO + co) * W + w0 + q] =
              __float2bfloat16(s.t0[co * LDP + q]);
      }
    }
  }
  if (KIND == 0) {
    __syncthreads();
    for (int e = tid; e < 2 * NT * C; e += THREADS) {
      const int m = e / (NT * C), j = e % (NT * C);
      float v = 0.f;
      for (int gg = 0; gg < G; ++gg) v += s.red[(gg * 2 + m) * NT * C + j];
      p.part[(size_t)blockIdx.x * 2 * NT * C + e] = v;
    }
  }
}

// ------------------------------------------------------------ backward
template <int KIND>  // 2 stats, 3 agg
__global__ void __launch_bounds__(THREADS, 2) meta_bwd_kernel(Args p) {
  constexpr bool AGG = KIND == 3;
  extern __shared__ __align__(16) float smem[];
  const Smem s = carve<KIND>(smem);
  const int tid = threadIdx.x;
  const int c = tid % C;
  const int g = tid / C;
  const int lane = tid % 32, warp = tid / 32;
  const int H = p.H, W = p.W;
  const int Hp = H + 2;          // output rows -1 .. H
  const int ntw = W / P + 2;     // output column tiles from -P
  load_constants(p, s, true);
  const int t_begin = (int)((long long)p.tiles * blockIdx.x / gridDim.x);
  const int t_end = (int)((long long)p.tiles * (blockIdx.x + 1) / gridDim.x);
  float* part = p.part + (size_t)blockIdx.x * ((AGG ? AGG_SUMS : 0) +
                                               MLP_SUMS);
  float* mlp = part + (AGG ? AGG_SUMS : 0);

  // dW1[k][c] for k = g*NK .. +NK-1, summed over every pixel by this thread
  constexpr int NK = CM / G;
  float db1 = 0.f, dw1[NK];
#pragma unroll
  for (int j = 0; j < NK; ++j) dw1[j] = 0.f;
  float db0[KI], dw0[3][KI];
#pragma unroll
  for (int i = 0; i < KI; ++i) {
    db0[i] = 0.f;
    dw0[0][i] = dw0[1][i] = dw0[2][i] = 0.f;
  }

#pragma unroll 1
  for (int t = 0; t < NT; ++t) {
    const int dy = t / 3, dx = t % 3;
    float ds9 = 0.f, db9 = 0.f, dA[NA];
#pragma unroll
    for (int j = 0; j < NA; ++j) dA[j] = 0.f;
    __syncthreads();
    if (AGG)  // this tap's A transposed: a[co][c] = agg[t*C + c][co]
      for (int e = tid; e < C * CO; e += THREADS) {
        const int cc = e / CO, co = e % CO;
        s.a[co * C + cc] = p.agg[(size_t)(t * C + cc) * CO + co];
      }
    const float e0 = s.e[t * C + c], e1 = s.e[NT * C + t * C + c];

    for (int tile = t_begin; tile < t_end; ++tile) {
      const int kc = tile % ntw - 1;
      const int rest = tile / ntw;
      const int hq = rest % Hp - 1;
      const int b = rest / Hp;
      const int wq0 = kc * P;
      const int hs = hq - dy + 1;   // source row
      const int ws0 = wq0 - dx + 1;  // source column of pixel 0
      const bool row_ok = hs >= 0 && hs < H;
      __syncthreads();
      load_halo(p, s, b, hs, ws0);
      if (AGG)
        for (int e = tid; e < CO * P; e += THREADS) {
          const int co = e / P, q = e % P;
          const int ww = ws0 + q;
          float v = 0.f;
          if (row_ok && ww >= 0 && ww < W)
            v = bf(p.gy[((size_t)(b * H + hs) * CO + co) * W + ww]);
          s.gy[co * LDP + q] = v;
        }
      __syncthreads();
      tap_hidden(s, dy, dx);
      __syncthreads();

      float wt[PP], nb[PP], a[PP], da[PP];
      tap_products(p, s, c, g, dy, dx, wt, nb, a);
      bool valid[PP];
#pragma unroll
      for (int i = 0; i < PP; ++i) {
        const int ww = ws0 + g * PP + i;
        valid[i] = row_ok && ww >= 0 && ww < W;
      }
      if (AGG) {
        float dr[PP];
#pragma unroll
        for (int i = 0; i < PP; ++i) dr[i] = 0.f;
#pragma unroll 4
        for (int co = 0; co < CO; ++co) {
          const float av = bf(s.a[co * C + c]);
          float gv[PP];
          load8(&s.gy[co * LDP + g * PP], gv);
#pragma unroll
          for (int i = 0; i < PP; ++i) dr[i] = fmaf(av, gv[i], dr[i]);
        }
#pragma unroll
        for (int i = 0; i < PP; ++i) {
          const float z = fmaf(a[i], e0, e1);
          const bool on = valid[i] && z > 0.f;
          const float dz = on ? dr[i] : 0.f;
          s.t0[c * LDP + g * PP + i] = on ? z : 0.f;
          ds9 = fmaf(dz, a[i], ds9);
          db9 += dz;
          da[i] = dz * e0;
        }
      } else {
#pragma unroll
        for (int i = 0; i < PP; ++i)
          da[i] = valid[i] ? fmaf(e1, a[i], e0) : 0.f;
      }
      float dwt[PP];
#pragma unroll
      for (int i = 0; i < PP; ++i) {
        dwt[i] = da[i] * nb[i];
        s.t1[c * LDP + g * PP + i] = dwt[i];
        s.t2[c * LDP + g * PP + i] = da[i] * wt[i];
        db1 += dwt[i];
      }
      __syncthreads();

#pragma unroll 2
      for (int q = 0; q < P; q += 4) {  // dW1 of the owned (k, c)
        const float4 d = *reinterpret_cast<const float4*>(&s.t1[c * LDP + q]);
#pragma unroll
        for (int j = 0; j < NK; ++j) {
          const float4 h = *reinterpret_cast<const float4*>(
              &s.h1[(g * NK + j) * LDP + q]);
          dw1[j] = fmaf(d.x, h.x, dw1[j]);
          dw1[j] = fmaf(d.y, h.y, dw1[j]);
          dw1[j] = fmaf(d.z, h.z, dw1[j]);
          dw1[j] = fmaf(d.w, h.w, dw1[j]);
        }
      }

      if (AGG) {  // dA[c][g*NA + j] += sum_q relu(z)[c][q] gy[co][q]
#pragma unroll 2
        for (int q = 0; q < P; q += 4) {
          const float4 r = *reinterpret_cast<const float4*>(
              &s.t0[c * LDP + q]);
#pragma unroll
          for (int j = 0; j < NA; ++j) {
            const float4 gv = *reinterpret_cast<const float4*>(
                &s.gy[(g * NA + j) * LDP + q]);
            dA[j] = fmaf(r.x, gv.x, dA[j]);
            dA[j] = fmaf(r.y, gv.y, dA[j]);
            dA[j] = fmaf(r.z, gv.z, dA[j]);
            dA[j] = fmaf(r.w, gv.w, dA[j]);
          }
        }
      }
      // dh1[k][lane] for k = warp + 8i; then db0, dW0
      float acc[KI];
#pragma unroll
      for (int i = 0; i < KI; ++i) acc[i] = 0.f;
#pragma unroll 2
      for (int cc = 0; cc < C; cc += 4) {
        float d[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) d[u] = s.t1[(cc + u) * LDP + lane];
#pragma unroll
        for (int i = 0; i < KI; ++i) {
          const float4 w = *reinterpret_cast<const float4*>(
              &s.w1[(warp + 8 * i) * C + cc]);
          acc[i] = fmaf(w.x, d[0], acc[i]);
          acc[i] = fmaf(w.y, d[1], acc[i]);
          acc[i] = fmaf(w.z, d[2], acc[i]);
          acc[i] = fmaf(w.w, d[3], acc[i]);
        }
      }
#pragma unroll
      for (int i = 0; i < KI; ++i) {
        const int k = warp + 8 * i;
        const float dh = s.h1[k * LDP + lane] > 0.f ? acc[i] : 0.f;
        db0[i] += dh;
#pragma unroll
        for (int j = 0; j < 3; ++j)
          dw0[j][i] = fmaf(dh, s.rel[j * P + lane], dw0[j][i]);
      }
      // dfeat: the owner of (c', q) adds this tap's dnb, in tap order
      if (hq >= 0 && hq < H)
        for (int e = tid; e < C * P; e += THREADS) {
          const int cc = e / P, q = e % P;
          const int ww = wq0 + q;
          if (ww < 0 || ww >= W) continue;
          const size_t idx = ((size_t)(b * H + hq) * C + cc) * W + ww;
          const float v = s.t2[cc * LDP + q];
          if (t == 0)
            p.scratch[idx] = v;
          else if (t < NT - 1)
            p.scratch[idx] += v;
          else
            p.out[idx] = __float2bfloat16(p.scratch[idx] + v);
        }
    }

    if (AGG) {  // this tap's dA, ds9, db9 partials
#pragma unroll
      for (int j = 0; j < NA; ++j)
        part[OFF_A + (t * C + c) * CO + g * NA + j] = dA[j];
      __syncthreads();
      s.red[g * C + c] = ds9;
      s.red[(G + g) * C + c] = db9;
      __syncthreads();
      if (tid < 2 * C) {
        const int m = tid / C, cc = tid % C;
        float v = 0.f;
        for (int gg = 0; gg < G; ++gg) v += s.red[(m * G + gg) * C + cc];
        part[(m ? OFF_B9 : OFF_S9) + t * C + cc] = v;
      }
    }
  }

  // MLP partials: dW1 as owned, db1 over the pixel groups in order
#pragma unroll
  for (int j = 0; j < NK; ++j) mlp[MLP_W1 + (g * NK + j) * C + c] = dw1[j];
  __syncthreads();
  s.red[g * C + c] = db1;
  __syncthreads();
  if (tid < C) {
    float v = 0.f;
    for (int gg = 0; gg < G; ++gg) v += s.red[gg * C + tid];
    mlp[MLP_B1 + tid] = v;
  }
  __syncthreads();
  // db0, dW0 over the 32 lanes (pixels), in order
#pragma unroll
  for (int i = 0; i < KI; ++i) {
    const int k = warp + 8 * i;
    s.red[(0 * CM + k) * 32 + lane] = db0[i];
#pragma unroll
    for (int j = 0; j < 3; ++j) s.red[((1 + j) * CM + k) * 32 + lane] = dw0[j][i];
  }
  __syncthreads();
  if (tid < 4 * CM) {
    float v = 0.f;
    for (int l = 0; l < 32; ++l) v += s.red[tid * 32 + l];
    const int m = tid / CM, k = tid % CM;
    if (m == 0)
      mlp[MLP_B0 + k] = v;
    else
      mlp[MLP_W0 + (m - 1) * CM + k] = v;
  }
}

// out[e] = sum_b part[b][e], b = 0 .. blocks-1 in order.
__global__ void reduce_blocks_kernel(const float* __restrict__ part,
                                     float* __restrict__ out, int blocks,
                                     int n) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  float v = 0.f;
  for (int b = 0; b < blocks; ++b) v += part[(size_t)b * n + e];
  out[e] = v;
}

int tiles_of(int kind, int B, int H, int W) {
  if (kind < 2) return B * H * ((W + P - 1) / P);
  return B * (H + 2) * (W / P + 2);
}

}  // namespace

extern "C" {

// The widths the kernels are built for: C, Cm, Co.
int meta_block_widths(int i) { return i == 0 ? C : i == 1 ? CM : CO; }

// Blocks of a launch (kind 0 stats, 1 agg, 2 stats backward, 3 agg
// backward) on the current device; negative on error.
int meta_block_grid(int kind, int B, int H, int W) {
  const int tiles = tiles_of(kind, B, H, W);
  switch (kind) {
    case 0: return grid_for<0>(meta_fwd_kernel<0>, tiles);
    case 1: return grid_for<1>(meta_fwd_kernel<1>, tiles);
    case 2: return grid_for<2>(meta_bwd_kernel<2>, tiles);
    default: return grid_for<3>(meta_bwd_kernel<3>, tiles);
  }
}

// f32 partials per block: the caller allocates blocks * this, and the
// reduced sums of this size.
int meta_block_part_floats(int kind) {
  switch (kind) {
    case 0: return 2 * NT * C;
    case 1: return 0;
    case 2: return MLP_SUMS;
    default: return AGG_SUMS + MLP_SUMS;
  }
}

// sums: (2, 9C) f32 = (sum a, sum a^2).
int meta_stats_fwd(const void* feat, const void* cb, const void* w0,
                   const void* b0, const void* w1, const void* b1, void* part,
                   void* sums, int B, int H, int W, int blocks,
                   void* stream) {
  Args a = make_args(feat, cb, w0, b0, w1, b1, B, H, W);
  a.part = (float*)part;
  a.tiles = tiles_of(0, B, H, W);
  cudaStream_t s = (cudaStream_t)stream;
  meta_fwd_kernel<0><<<blocks, THREADS, smem_floats<0>() * sizeof(float),
                       s>>>(a);
  const int n = 2 * NT * C;
  reduce_blocks_kernel<<<(n + 255) / 256, 256, 0, s>>>(
      (const float*)part, (float*)sums, blocks, n);
  return (int)cudaGetLastError();
}

// y: (B, H, Co, W) bf16.
int meta_agg_fwd(const void* feat, const void* cb, const void* w0,
                 const void* b0, const void* w1, const void* b1,
                 const void* s9, const void* b9, const void* agg, void* y,
                 int B, int H, int W, int blocks, void* stream) {
  Args a = make_args(feat, cb, w0, b0, w1, b1, B, H, W);
  a.e0 = (const float*)s9;
  a.e1 = (const float*)b9;
  a.agg = (const __nv_bfloat16*)agg;
  a.out = (__nv_bfloat16*)y;
  a.tiles = tiles_of(1, B, H, W);
  meta_fwd_kernel<1><<<blocks, THREADS, smem_floats<1>() * sizeof(float),
                       (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// mode 0 "stats" (e0 = ds1, e1 = 2 ds2), 1 "agg" (e0 = s9, e1 = b9, agg,
// gy). dfeat (B, H, C, W) bf16; scratch (B, H, C, W) f32; sums: the
// reduced partials, [dA (9C, Co), ds9, db9] (agg only) then [dW0 (3, Cm),
// db0, dW1 (Cm, C), db1].
int meta_block_bwd(const void* feat, const void* cb, const void* w0,
                   const void* b0, const void* w1, const void* b1,
                   const void* e0, const void* e1, const void* agg,
                   const void* gy, void* scratch, void* dfeat, void* part,
                   void* sums, int B, int H, int W, int blocks, int mode,
                   void* stream) {
  Args a = make_args(feat, cb, w0, b0, w1, b1, B, H, W);
  a.e0 = (const float*)e0;
  a.e1 = (const float*)e1;
  a.agg = (const __nv_bfloat16*)agg;
  a.gy = (const __nv_bfloat16*)gy;
  a.scratch = (float*)scratch;
  a.out = (__nv_bfloat16*)dfeat;
  a.part = (float*)part;
  a.tiles = tiles_of(2, B, H, W);
  cudaStream_t s = (cudaStream_t)stream;
  int n;
  if (mode == 1) {
    meta_bwd_kernel<3><<<blocks, THREADS, smem_floats<3>() * sizeof(float),
                         s>>>(a);
    n = AGG_SUMS + MLP_SUMS;
  } else {
    meta_bwd_kernel<2><<<blocks, THREADS, smem_floats<2>() * sizeof(float),
                         s>>>(a);
    n = MLP_SUMS;
  }
  reduce_blocks_kernel<<<(n + 255) / 256, 256, 0, s>>>(
      (const float*)part, (float*)sums, blocks, n);
  return (int)cudaGetLastError();
}

}  // extern "C"
