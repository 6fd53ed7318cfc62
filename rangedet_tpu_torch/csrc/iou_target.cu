// IoU-aware classification target: per pixel, decode the predicted box
// and take its max rotated BEV IoU over a per-block list of GT candidates.
//
// Replaces the TPU kernel rangedet_tpu/ops/iou_target_pallas.py:
// iou_target_fused / _kernel (skip mode "gate8") together with its XLA
// candidate prep, under its candidate contract: pixels in column-major
// order (n = w*H + h), 2048-pixel blocks, per block the G GT rows ordered
// by circumcircle clearance (index as tie-break) and a trip count
// nv = #(clearance <= 0) capped at G. The clip runs over ceil(nv/8)*8
// candidates as the TPU kernel's loop does; rows past nv are real rows
// with clearance > 0 or zero-area padding, so they add IoU 0.
//
// Two kernels and a clean pass, all reading the caller's tensors through
// their strides (class k's 8 channels of the head's (B, H, W, K*8) deltas
// are a strided view; nothing is copied into planes):
//
// iou_prep_kernel, one block per (2048-pixel block, batch element):
// computes the frame's per-GT quantities (CCW corners, |area|, centre,
// circumradius) and the block's decoded centres into shared memory and
// the block max of the predicted circumradius, takes per GT of nonzero
// area the block min of the squared centre distance (zero-area rows get
// clearance +inf without it),
// ranks the clearances as a stable sort with NaN last would
// (#(key_j < key_i) + #(key_j == key_i, j < i)), scatters the rows of rank
// < G into the block's candidate table (zero rows up to Gk), writes nv, and
// zeroes the block's pixels of the output. Its arithmetic is the plain
// prep's (ops/iou_target.py:prepare_candidates) operation for operation
// (min and max are exact in any order), except that the four terms of a
// GT's shoelace area and centre are added in corner order, where torch
// picks the order of its reduction: a candidate row's area can then differ
// from the plain prep's by an ulp.
//
// iou_clip_kernel, on a grid of (block x sub-tile, batch element,
// candidate chunk): one pixel per thread in the production schedule (8
// sub-tiles of 256 pixels a block, chunks of 8 candidates), so a level of
// the B=2 step launches thousands of blocks instead of one per 2048-pixel
// block; a block whose chunk starts past ceil(nv/8)*8 exits at once. Each
// thread decodes its pixel and runs the clip over the chunk's candidates,
// staged in shared memory; the chunks' maxima meet by atomicMax on their
// float bits. Every per-pair IoU is >= 0 or NaN (the intersection is
// clamped at 0 and the union at EPS), so a chunk's max is too; with the
// sign bit cleared, the bits order as the values do and any NaN sorts
// above +inf, so the combine equals the single loop's NaN-propagating max.
// iou_clean_kernel then maps what is not a finite value in [0, 1] to 0,
// as the single loop's end did.
//
// Per (pixel, GT) the intersection area is the Green's-theorem clip of
// _green_inter_scalar_gt: the parts of each quad's edges inside the other,
// by Liang-Barsky clipping against four half-planes; no sort, no
// transcendentals. The decode needs no trig either: cos/sin of the azimuth
// are x/r and y/r, and the predicted (cos, sin) pair is normalised and
// angle-added directly.
//
// What bounds it on Hopper: f32 arithmetic, about 600 operations per
// (pixel, candidate) against 44 bytes per pixel read and 4 written, far
// above the f32 ridge of the CUDA cores (67 TFLOP/s over 3.35 TB/s, ~20
// FLOP/byte): compute-bound, a long dependent chain (32 IEEE divisions per
// pair) that needs many warps in flight, and work that depends on the data
// (nv per block), which the chunk axis spreads over the SMs. Compiled with
// -fmad=false and with max/min that pass NaN on, so it computes what the
// plain version computes operation for operation.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int TILE = 2048;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int GTQ = 12;  // per GT: 8 CCW corners, |area|, centre x, y, r
constexpr float EPS = 1e-8f;

// jnp.maximum / jnp.minimum: NaN in, NaN out
__device__ __forceinline__ float jmax(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fmaxf(a, b);
}
__device__ __forceinline__ float jmin(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fminf(a, b);
}

// A (B, H, W, C) f32 view: element (b, h, w, c) at p[b*sb + h*sh + w*sw +
// c*sc].
struct View {
  const float* p;
  long long sb, sh, sw, sc;
  __device__ __forceinline__ float at(int b, int h, int w, int c) const {
    return p[b * sb + h * sh + w * sw + c * sc];
  }
};

// Block-local pixel of the j-th thread slot: the transpose of a 64 x 32
// grid, a bijection of [0, TILE). At H = 64 a block is 32 columns, so the
// 32 lanes of a warp take one row of 32 neighbouring columns: pixels 32
// bytes apart in the head's (B, H, W, 8) deltas, where a column-major walk
// would put them a row (W * 32 bytes) apart.
__device__ __forceinline__ int local_index(int j) {
  return (j & 31) * 64 + (j >> 5);
}

// The decoded centre and the azimuth's (cos, sin) of one pixel, as the
// plain prep and the clip's decode compute them.
__device__ __forceinline__ void centre(float pcx, float pcy, float d0,
                                       float d1, float& cx, float& cy,
                                       float& cos_a, float& sin_a) {
  const float r = sqrtf(pcx * pcx + pcy * pcy);
  const float safe_r = r > EPS ? r : 1.f;
  cos_a = r > EPS ? pcx / safe_r : 1.f;
  sin_a = r > EPS ? pcy / safe_r : 0.f;
  const float dx = d0 * fabsf(d0);
  const float dy = d1 * fabsf(d1);
  cx = pcx + dx * cos_a - dy * sin_a;
  cy = pcy + dx * sin_a + dy * cos_a;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = jmax(v, __shfl_xor_sync(~0u, v, o));
  return v;
}
__device__ __forceinline__ float warp_min(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = jmin(v, __shfl_xor_sync(~0u, v, o));
  return v;
}

// key_j sorts before key_i in a stable ascending sort with NaN last
__device__ __forceinline__ bool before(float kj, int j, float ki, int i) {
  const bool nj = kj != kj, ni = ki != ki;
  const bool less = ni ? !nj : kj < ki;
  const bool same = (nj && ni) || kj == ki;
  return less || (same && j < i);
}

// Signed area of a quad, the terms added in corner order
__device__ __forceinline__ float shoelace(const float* x, const float* y) {
  float c[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    c[i] = x[i] * y[(i + 1) % 4] - x[(i + 1) % 4] * y[i];
  return 0.5f * (((c[0] + c[1]) + c[2]) + c[3]);
}

// gt: (B, M, 4, 2) contiguous; cand: (B*nb, Gk, 9); nv: (B*nb,); out:
// (B, H, W)
__global__ void __launch_bounds__(THREADS)
iou_prep_kernel(View d, View p, int H, int W, const float* __restrict__ gt,
                int M, int G, int Gk, float* __restrict__ cand,
                int* __restrict__ nv, float* __restrict__ out) {
  // cx[TILE], cy[TILE], per GT GTQ quantities, clearance[M]
  extern __shared__ float sm[];
  float* scx = sm;
  float* scy = sm + TILE;
  float* gq = sm + 2 * TILE;
  float* clr = gq + M * GTQ;
  __shared__ float wmax[WARPS];
  const int blk = blockIdx.x, b = blockIdx.y, nb = gridDim.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nvalid = min(TILE, H * W - blk * TILE);

  // the per-GT quantities of frame b, the plain prep's with the 4-term
  // sums in corner order: CCW corners, |area|, centre, corner-to-centre
  // circumradius
  for (int m = threadIdx.x; m < M; m += THREADS) {
    const float* q = gt + ((size_t)b * M + m) * 8;
    float x[4], y[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) x[i] = q[2 * i], y[i] = q[2 * i + 1];
    if (shoelace(x, y) < 0.f) {  // reverse to [0, 3, 2, 1]
      float t = x[1];
      x[1] = x[3], x[3] = t;
      t = y[1];
      y[1] = y[3], y[3] = t;
    }
    float* g = gq + m * GTQ;
#pragma unroll
    for (int i = 0; i < 4; ++i) g[2 * i] = x[i], g[2 * i + 1] = y[i];
    g[8] = fabsf(shoelace(x, y));
    const float gx = (((x[0] + x[1]) + x[2]) + x[3]) * 0.25f;
    const float gy = (((y[0] + y[1]) + y[2]) + y[3]) * 0.25f;
    float r2 = -INFINITY;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float dx = x[i] - gx, dy = y[i] - gy;
      r2 = jmax(r2, dx * dx + dy * dy);
    }
    g[9] = gx;
    g[10] = gy;
    g[11] = sqrtf(r2);
  }

  float rp = 0.f;  // the plain prep pads r_pred with 0 before its max
  for (int j = threadIdx.x; j < TILE; j += THREADS) {
    const int li = local_index(j);
    if (li >= nvalid) continue;
    const int n = blk * TILE + li, h = n % H, w = n / H;
    const float pcx = p.at(b, h, w, 0), pcy = p.at(b, h, w, 1);
    float cx, cy, cos_a, sin_a;
    centre(pcx, pcy, d.at(b, h, w, 0), d.at(b, h, w, 1), cx, cy, cos_a,
           sin_a);
    scx[j] = cx;
    scy[j] = cy;
    const float wd = expf(d.at(b, h, w, 2));
    const float ld = expf(d.at(b, h, w, 3));
    rp = jmax(rp, 0.5f * sqrtf(wd * wd + ld * ld));
    out[((size_t)b * H + h) * W + w] = 0.f;
  }
  rp = warp_max(rp);
  if (lane == 0) wmax[warp] = rp;
  __syncthreads();
  rp = wmax[0];
#pragma unroll
  for (int k = 1; k < WARPS; ++k) rp = jmax(rp, wmax[k]);

  // one warp per GT: the block min of the squared centre distance
  for (int m = warp; m < M; m += WARPS) {
    const float* g = gq + m * GTQ;
    float c = INFINITY;
    if (!(g[8] < EPS)) {
      const float gx = g[9], gy = g[10];
      float bm = INFINITY;  // the plain prep pads d2 with +inf
#pragma unroll 8
      for (int a = 0; a < TILE / 32; ++a) {
        if (lane * 64 + a >= nvalid) continue;  // local_index(a*32 + lane)
        const float dx = scx[a * 32 + lane] - gx;
        const float dy = scy[a * 32 + lane] - gy;
        bm = jmin(bm, dx * dx + dy * dy);
      }
      c = sqrtf(warp_min(bm)) - rp - g[11];
    }
    if (lane == 0) clr[m] = c;
  }
  __syncthreads();

  const int row0 = (b * nb + blk) * Gk;
  int live = 0;
  for (int m0 = 0; m0 < M; m0 += THREADS) {
    const int i = m0 + threadIdx.x;
    const float key = i < M ? clr[i] : 0.f;
    live += __syncthreads_count(i < M && key <= 0.f);
    if (i >= M) continue;
    int rank = 0;
    for (int j = 0; j < M; ++j) rank += before(clr[j], j, key, i);
    if (rank < G) {
      const float* g = gq + i * GTQ;
      float* row = cand + (size_t)(row0 + rank) * 9;
#pragma unroll
      for (int e = 0; e < 9; ++e) row[e] = g[e];
    }
  }
  for (int e = threadIdx.x; e < (Gk - G) * 9; e += THREADS)
    cand[(size_t)(row0 + G) * 9 + e] = 0.f;
  if (threadIdx.x == 0) nv[b * nb + blk] = min(live, G);
}

// Sum over the parts of P's edges (per-pixel or scalar endpoints) inside
// Q of cross(s0, s1); f[j][i] = cross(e_j, P_i - Q_j), e_j Q's edges.
__device__ __forceinline__ float pieces(const float* px, const float* py,
                                        const float* qx, const float* qy) {
  float f[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float ex = qx[(j + 1) % 4] - qx[j];
    const float ey = qy[(j + 1) % 4] - qy[j];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      f[j][i] = ex * (py[i] - qy[j]) - ey * (px[i] - qx[j]);
  }
  float total = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int i1 = (i + 1) % 4;
    float t0 = 0.f, t1 = 1.f;
    bool empty = false;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float f0 = f[j][i], f1 = f[j][i1];
      const float denom = f0 - f1;
      const float t_star = f0 / (fabsf(denom) > EPS ? denom : 1.f);
      empty = empty || (f0 < 0.f && f1 < 0.f);
      t0 = jmax(t0, (f0 < 0.f && f1 >= 0.f) ? t_star : 0.f);
      t1 = jmin(t1, (f0 >= 0.f && f1 < 0.f) ? t_star : 1.f);
    }
    empty = empty || (t1 <= t0);
    const float dx = px[i1] - px[i];
    const float dy = py[i1] - py[i];
    const float s0x = px[i] + t0 * dx;
    const float s0y = py[i] + t0 * dy;
    const float s1x = px[i] + t1 * dx;
    const float s1y = py[i] + t1 * dy;
    total = total + (empty ? 0.f : s0x * s1y - s0y * s1x);
  }
  return total;
}

// Block (blk, sub) of blockIdx.x = blk * subs + sub takes the thread slots
// [sub, sub + 1) * TILE / subs of its 2048-pixel block; blockIdx.z the
// candidates [z, z + 1) * chunk. out holds 0 (the prep wrote it) and
// receives each chunk's max bits.
__global__ void __launch_bounds__(THREADS)
iou_clip_kernel(View d, View p, int H, int W, int nb, int subs, int chunk,
                const float* __restrict__ cand, const int* __restrict__ nv,
                int Gk, unsigned* __restrict__ out) {
  extern __shared__ float sc[];  // chunk * 9
  const int blk = blockIdx.x / subs, sub = blockIdx.x % subs;
  const int b = blockIdx.y, k0 = blockIdx.z * chunk;
  const int blkg = b * nb + blk;
  const int n8 = min((nv[blkg] + 7) / 8 * 8, Gk);
  if (k0 >= n8) return;
  const int nk = min(chunk, n8 - k0);
  for (int e = threadIdx.x; e < nk * 9; e += THREADS)
    sc[e] = cand[((size_t)blkg * Gk + k0) * 9 + e];
  __syncthreads();

  const int nvalid = min(TILE, H * W - blk * TILE);
  const int per = TILE / subs;
  for (int j = sub * per + threadIdx.x; j < (sub + 1) * per; j += THREADS) {
    const int li = local_index(j);
    if (li >= nvalid) continue;
    const int n = blk * TILE + li, h = n % H, w = n / H;
    const float pcx = p.at(b, h, w, 0), pcy = p.at(b, h, w, 1);
    float cx, cy, cos_a, sin_a;
    centre(pcx, pcy, d.at(b, h, w, 0), d.at(b, h, w, 1), cx, cy, cos_a,
           sin_a);
    const float width = expf(d.at(b, h, w, 2));
    const float length = expf(d.at(b, h, w, 3));
    const float d4 = d.at(b, h, w, 4), d5 = d.at(b, h, w, 5);
    const float nn = sqrtf(d4 * d4 + d5 * d5);
    const float safe_n = nn > EPS ? nn : 1.f;
    const float cos_rel = nn > EPS ? d4 / safe_n : 1.f;
    const float sin_rel = nn > EPS ? d5 / safe_n : 0.f;
    const float cyw = cos_rel * cos_a - sin_rel * sin_a;
    const float sy = sin_rel * cos_a + cos_rel * sin_a;
    const float hl = 0.5f * length, hw = 0.5f * width;
    // CCW corners: D(+l,+w) C(-l,+w) B(-l,-w) A(+l,-w)
    const float lx[4] = {hl, -hl, -hl, hl};
    const float wy[4] = {hw, hw, -hw, -hw};
    float ax[4], ay[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      ax[i] = lx[i] * cyw - wy[i] * sy + cx;
      ay[i] = lx[i] * sy + wy[i] * cyw + cy;
    }
    const float sa = length * width;

    float best = 0.f;
    for (int k = 0; k < nk; ++k) {
      const float* row = sc + k * 9;
      const float gx[4] = {row[0], row[2], row[4], row[6]};
      const float gy[4] = {row[1], row[3], row[5], row[7]};
      const float sb = row[8];
      const float inter =
          jmax(pieces(ax, ay, gx, gy) + pieces(gx, gy, ax, ay), 0.f) * 0.5f;
      float one = inter / jmax(sa + sb - inter, EPS);
      one = (sa < EPS || sb < EPS) ? 0.f : one;
      best = jmax(best, one);
    }
    // best is +-0, > 0 or NaN: without its sign bit it orders as a uint
    atomicMax(out + ((size_t)b * H + h) * W + w,
              __float_as_uint(best) & 0x7fffffffu);
  }
}

__global__ void iou_clean_kernel(float* __restrict__ out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float v = out[i];
  if (!isfinite(v) || v < 0.f || v > 1.f) out[i] = 0.f;
}

View view(const void* ptr, const long long* s) {
  return View{(const float*)ptr, s[0], s[1], s[2], s[3]};
}

}  // namespace

// deltas, pc: (B, H, W, >= 6) and (B, H, W, >= 2) f32 through their four
// strides each (in elements); gt (B, M, 4, 2) contiguous -> cand
// (B*nb, Gk, 9), nv (B*nb,) and out (B, H, W) zeroed, nb = ceil(H*W/2048)
extern "C" int iou_prep(const void* deltas, const long long* ds,
                        const void* pc, const long long* ps, int B, int H,
                        int W, const void* gt, int M, int G, int Gk,
                        void* cand, void* nv, void* out, void* stream) {
  const int nb = (H * W + TILE - 1) / TILE;
  if (nb == 0 || B == 0) return 0;
  const int smem = (2 * TILE + M * (GTQ + 1)) * sizeof(float);
  if (smem > 48 * 1024) {
    const int err = (int)cudaFuncSetAttribute(
        iou_prep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != 0) return err;
  }
  iou_prep_kernel<<<dim3(nb, B), THREADS, smem, (cudaStream_t)stream>>>(
      view(deltas, ds), view(pc, ps), H, W, (const float*)gt, M, G, Gk,
      (float*)cand, (int*)nv, (float*)out);
  return (int)cudaGetLastError();
}

// the clip over iou_prep's cand and nv into its zeroed out, then the clean
extern "C" int iou_clip(const void* deltas, const long long* ds,
                        const void* pc, const long long* ps, int B, int H,
                        int W, const void* cand, const void* nv, int Gk,
                        int subs, int chunk, void* out, void* stream) {
  const int nb = (H * W + TILE - 1) / TILE;
  if (nb == 0 || B == 0) return 0;
  const dim3 grid(nb * subs, B, (Gk + chunk - 1) / chunk);
  if (Gk > 0) {
    iou_clip_kernel<<<grid, THREADS, chunk * 9 * sizeof(float),
                      (cudaStream_t)stream>>>(
        view(deltas, ds), view(pc, ps), H, W, nb, subs, chunk,
        (const float*)cand, (const int*)nv, Gk, (unsigned*)out);
    const int err = (int)cudaGetLastError();
    if (err != 0) return err;
  }
  const int n = B * H * W;
  iou_clean_kernel<<<(n + THREADS - 1) / THREADS, THREADS, 0,
                     (cudaStream_t)stream>>>((float*)out, n);
  return (int)cudaGetLastError();
}
