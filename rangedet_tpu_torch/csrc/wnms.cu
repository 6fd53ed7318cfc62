// Weighted NMS (WNMS) of F frames in one launch: the blocked greedy sweep
// of ops/nms.py:weighted_nms_plain, rounds included, on the card.
//
// Replaces no Pallas kernel. JAX runs this loop as one lax.while_loop in
// rangedet_tpu/ops/nms.py:weighted_nms; the port's eager form of it was a
// host loop (~378 small launches and three waits for the card a round).
// One block a row (a frame's class) owns the whole loop, so the host
// launches once an eval step, every class's rows together, and reads
// nothing back.
//
// Semantics (ops/nms.py's docstring): candidates in descending score order
// (stable; invalid ones carry -inf), a round takes the next `block` alive
// candidates; each member, in order, survives if no earlier survivor of
// the round killed it; a survivor kills the alive candidates of IoU >=
// thresh and itself; its voters are itself and the candidates alive at its
// turn with IoU > thresh_vote; voters whose yaw lies >= 0.3 rad (mod
// 2 * 3.1415926) from the voters' median yaw (the reference's tie-breaks,
// ranks in the stable yaw order) are dropped; its row is the voters'
// score-weighted mean of the 11 values plus its own score, at its greedy
// rank. A frame stops at its keep cap or when nothing is alive.
//
// Rows of several classes (ops/nms.py): the rows' keep caps come by
// value, one a class, row f taking entry f % n; the output has max_keep
// rows a frame, the rows past a frame's cap zero and invalid.
//
// Schedule, per frame (one block of THREADS threads):
//   A. the stable score order and the stable yaw order as bitonic sorts of
//      unique 64-bit keys (an order-preserving u32 of the float, NaN last,
//      -0 as +0; the index below it), in shared memory; then a record of
//      32 floats a candidate in score order (global scratch, read from
//      L2): raw and CCW corners, their |areas|, circumcircle, yaw, bottom,
//      height, weight, score; each candidate's rank in the yaw order, the
//      yaws by that rank, and the alive bits.
//   B. a round: `lim` = the block-th alive candidate; its members are
//      processed in chunks of CH (16, a member mask in 16 bits): select
//      the next alive ones <= lim; for every alive candidate, pairs whose
//      circumcircles are apart by more than a margin (a thousandth of the
//      radii and the member's centre) are taken as IoU 0, which for convex
//      quads that far apart is what the plain version computes; the
//      others are listed and their IoU computed by the whole block, one
//      pair a thread, setting kill and vote bits in shared memory. The
//      filter is on only where IoU 0 kills and votes nothing (thresh > 0,
//      thresh_vote >= 0); otherwise every pair is computed. Warp 0 runs
//      the chain on the members' kill bits; warp b then votes for survivor
//      b: its voters' bits, their count, their yaw ranks set in a bitmap
//      (the median is the k-th set bit), the weighted sums; then the alive
//      bits lose what the survivors killed.
//
// Exactness. The IoU follows ops/rotated_iou.py:iou_bev_corners,
// quad_intersection_area and _pieces operation for operation (this file
// is built with -fmad=false, so nothing contracts into an FMA), with the
// CPU's order for torch's 4-term sums: ((c0 + c1) + c2) + c3 for the
// shoelace area and the four edge contributions; max and min pass NaN on,
// as amax and amin do. The kill, vote and yaw decisions are the plain
// version's. The weighted sums are not: the plain version adds its f32
// products w * v in f32, in the order of torch's reduction; here they are
// added in float64 in a fixed order (a lane adds its voters in index
// order, the warp combines the lanes by the xor tree of offsets 16, 8, 4,
// 2, 1) and rounded once to f32. A double sum of m f32 terms is exact
// only while their magnitudes span less than 2^(29 - log2 m) (2^17 at
// m = 4096); past that its error, at most (m - 1) * 2^-53 of the sum of
// the terms' magnitudes, rarely moves the f32 rounding. So a row may
// differ from the plain version's in its last bits: by at most twice the
// f32 sum's error bound, which tests/test_torch_wnms_plan.py states and
// holds. Products 0 * inf / NaN of the non-voters, which make the plain
// sum NaN, are counted per column.
//
// Bound: the latency of the rounds, not operations or bytes. At the eval
// shapes (F = 4, K = 4096, block 16, max_keep 200, 2D) 7-17 rounds a frame
// need up to 16 x 4096 pair IoUs each in the blocked form, ~600 f32
// operations a pair: ~2.2 GFLOP for four frames, 0.03 ms at 67 TFLOP/s;
// the records are ~2 MB. A frame's block meets 2 x 78 barriers in the sorts
// and ~24 a round (2 a pass of THREADS candidates, 8 passes at K = 4096,
// plus 8), ~520 at 15 rounds, and computes its pairs' IoUs on one SM; on an
// H100 a call takes ~1 ms, most of it the first rounds' IoUs, whose
// members meet hundreds of candidates each. The filter keeps the pair work
// to the pairs whose circumcircles meet.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr int CH = 16;  // members a chunk: WARPS voters, a 16-bit mask
constexpr int REC = 32;  // floats a candidate record
// floats of global scratch a candidate: its record, its yaw rank, the
// yaw at its rank
constexpr int SCRATCH = REC + 2;
static_assert(SCRATCH * 4 == REC * 4 + sizeof(int) + sizeof(float),
              "the scratch layout of wnms_kernel");
constexpr int MAX_K = 16384;
constexpr int MAX_CLASSES = 16;
constexpr float EPS = 1e-8f;
constexpr float YAW_REJECT = 0.3f;
constexpr float SAME = 1e-6f;
constexpr float WSUM_MIN = 1e-12f;
static_assert(CH == WARPS, "one voting warp a member");

// record fields: float4-aligned groups
constexpr int R_RAW = 0;    // 8 corners as given
constexpr int R_CCW = 8;    // 8 corners counter-clockwise
constexpr int R_CX = 16;    // circumcircle centre x, y, radius; yaw
constexpr int R_YAW = 19;
constexpr int R_SA = 20;    // |area| of the raw corners, of the CCW ones
constexpr int R_SCCW = 21;
constexpr int R_BOT = 22;   // bottom, height
constexpr int R_HGT = 23;
constexpr int R_W = 24;     // weight max(score, 0), masked score, valid
constexpr int R_SCORE = 25;
constexpr int R_VALID = 26;

// the 11 values a row averages: 8 corners, yaw, bottom, height
__device__ __forceinline__ int value_field(int c) {
  return c < 8 ? R_RAW + c : (c == 8 ? R_YAW : (c == 9 ? R_BOT : R_HGT));
}

// torch.maximum / amax and torch.minimum / amin: NaN in, NaN out
__device__ __forceinline__ float jmax(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fmaxf(a, b);
}
__device__ __forceinline__ float jmin(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fminf(a, b);
}
// torch.clamp(x, min=lo): NaN stays
__device__ __forceinline__ float clamp_min(float x, float lo) {
  return x < lo ? lo : x;
}

// An unsigned key that orders as torch.sort orders floats: NaN last, -0
// equal to +0.
__device__ __forceinline__ uint32_t order_key(float x) {
  if (x != x) return 0xffffffffu;
  if (x == 0.f) x = 0.f;
  const uint32_t b = __float_as_uint(x);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

// polygon_area: 0.5 * (((c0 + c1) + c2) + c3), c_i = x_i y_i+1 - x_i+1 y_i
__device__ __forceinline__ float shoelace(const float* q) {
  float c[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int n = (i + 1) & 3;
    c[i] = q[2 * i] * q[2 * n + 1] - q[2 * n] * q[2 * i + 1];
  }
  return 0.5f * (((c[0] + c[1]) + c[2]) + c[3]);
}

// rotated_iou._pieces: the sum of cross(s0, s1) over the parts of P's
// edges inside Q (both CCW)
__device__ float pieces(const float* P, const float* Q) {
  float ex[4], ey[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int n = (j + 1) & 3;
    ex[j] = Q[2 * n] - Q[2 * j];
    ey[j] = Q[2 * n + 1] - Q[2 * j + 1];
  }
  float total = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int i1 = (i + 1) & 3;
    const float px = P[2 * i], py = P[2 * i + 1];
    const float qx = P[2 * i1], qy = P[2 * i1 + 1];
    float t0 = 0.f, t1 = 1.f;
    bool empty = false;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float f0 = ex[j] * (py - Q[2 * j + 1]) - ey[j] * (px - Q[2 * j]);
      const float f1 = ex[j] * (qy - Q[2 * j + 1]) - ey[j] * (qx - Q[2 * j]);
      const float denom = f0 - f1;
      const float ts = f0 / (fabsf(denom) > EPS ? denom : 1.f);
      const float a = (f0 < 0.f && f1 >= 0.f) ? ts : 0.f;
      const float b = (f0 >= 0.f && f1 < 0.f) ? ts : 1.f;
      t0 = j == 0 ? a : jmax(t0, a);
      t1 = j == 0 ? b : jmin(t1, b);
      empty = empty || (f0 < 0.f && f1 < 0.f);
    }
    empty = empty || (t1 <= t0);
    const float dx = qx - px, dy = qy - py;
    const float s0x = px + t0 * dx, s0y = py + t0 * dy;
    const float s1x = px + t1 * dx, s1y = py + t1 * dy;
    const float contrib = s0x * s1y - s0y * s1x;
    total = total + (empty ? 0.f : contrib);
  }
  return total;
}

// ops/nms.py:_det_iou of member a against candidate b (records)
__device__ float pair_iou(const float* a, const float* b, bool iou_3d) {
  // quad_intersection_area on the CCW corners
  float m = 0.f;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const float d = fabsf(a[R_CCW + k] - b[R_CCW + k]);
    m = k == 0 ? d : jmax(m, d);
  }
  float inter;
  if (m < SAME) {
    inter = a[R_SCCW];
  } else {
    const float s = pieces(a + R_CCW, b + R_CCW) + pieces(b + R_CCW,
                                                          a + R_CCW);
    inter = clamp_min(s, 0.f) / 2.0f;
  }
  const float sa = a[R_SA], sb = b[R_SA];
  float iou = inter / clamp_min((sa + sb) - inter, EPS);
  const float bev = (sa < EPS || sb < EPS) ? 0.f : iou;
  if (!iou_3d) return bev;
  // volumetric IoU with z extents [bottom, bottom + height]
  const float a0 = a[R_BOT], h0 = a[R_HGT], a1 = b[R_BOT], h1 = b[R_HGT];
  const float z_ov = clamp_min(jmin(a0 + h0, a1 + h1) - jmax(a0, a1), 0.f);
  const float inter3 = ((bev * (sa + sb)) / (1.0f + bev)) * z_ov;
  const float uni = (sa * h0 + sb * h1) - inter3;
  return inter3 / clamp_min(uni, EPS);
}

// circumcircles of a and b apart by more than a margin: IoU 0
__device__ __forceinline__ bool apart(const float* a, float4 b) {
  const float dx = a[R_CX] - b.x, dy = a[R_CX + 1] - b.y;
  const float rr = a[R_CX + 2] + b.z;
  const float reach = rr + 1e-3f * (rr + fabsf(a[R_CX]) + fabsf(a[R_CX + 1]));
  return dx * dx + dy * dy > reach * reach;
}

__device__ void bitonic(unsigned long long* s, int n) {
  for (int k = 2; k <= n; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = threadIdx.x; i < n; i += THREADS) {
        const int ixj = i ^ j;
        if (ixj > i) {
          const unsigned long long a = s[i], b = s[ixj];
          if ((a > b) == ((i & k) == 0)) {
            s[i] = b;
            s[ixj] = a;
          }
        }
      }
      __syncthreads();
    }
  }
}

// Warp-wide: the index of the n-th (1-based) set bit of `bits` at or after
// `start`; the last set bit if there are fewer; -1 if none.
__device__ int warp_nth(const uint32_t* bits, int Kw, int start, int n,
                        int lane) {
  int last = -1, remaining = n;
  for (int w0 = start >> 5; w0 < Kw; w0 += 32) {
    const int w = w0 + lane;
    uint32_t b = 0;
    if (w < Kw) {
      b = bits[w];
      if (w == (start >> 5)) b &= ~0u << (start & 31);
    }
    const int c = __popc(b);
    int inc = c;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int t = __shfl_up_sync(~0u, inc, o);
      if (lane >= o) inc += t;
    }
    const int total = __shfl_sync(~0u, inc, 31);
    if (total >= remaining) {
      const unsigned hit = __ballot_sync(~0u, inc >= remaining &&
                                                  inc - c < remaining);
      const int L = __ffs(hit) - 1;
      int idx = -1;
      if (lane == L) {
        uint32_t v = b;
        for (int q = remaining - (inc - c); q > 1; --q) v &= v - 1;
        idx = w * 32 + __ffs(v) - 1;
      }
      return __shfl_sync(~0u, idx, L);
    }
    remaining -= total;
    const unsigned nz = __ballot_sync(~0u, b != 0);
    if (nz) {
      const int L = 31 - __clz(nz);
      const int idx = lane == L ? w * 32 + 31 - __clz(b) : 0;
      last = __shfl_sync(~0u, idx, L);
    }
  }
  return last;
}

// Warp-wide: the first up to `want` set bits of `bits` in [start, lim],
// in order, into out; returns how many.
__device__ int warp_collect(const uint32_t* bits, int start, int lim,
                            int want, int* out, int lane) {
  int got = 0;
  for (int w0 = start >> 5; w0 <= (lim >> 5) && got < want; w0 += 32) {
    const int w = w0 + lane;
    uint32_t b = 0;
    if (w <= (lim >> 5)) {
      b = bits[w];
      if (w == (start >> 5)) b &= ~0u << (start & 31);
      if (w == (lim >> 5) && (lim & 31) != 31)
        b &= (1u << ((lim & 31) + 1)) - 1;
    }
    const int c = __popc(b);
    int inc = c;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int t = __shfl_up_sync(~0u, inc, o);
      if (lane >= o) inc += t;
    }
    int at = got + inc - c;
    while (b && at < want) {
      out[at++] = w * 32 + __ffs(b) - 1;
      b &= b - 1;
    }
    got = min(want, got + __shfl_sync(~0u, inc, 31));
  }
  __syncwarp();
  return got;
}

// Warp-wide: the position of the (q+1)-th set bit of bm[0, Kw)
__device__ int warp_select(const uint32_t* bm, int Kw, int q, int lane) {
  const int per = (Kw + 31) >> 5;
  const int w0 = min(Kw, lane * per), w1 = min(Kw, w0 + per);
  int c = 0;
  for (int w = w0; w < w1; ++w) c += __popc(bm[w]);
  int inc = c;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int t = __shfl_up_sync(~0u, inc, o);
    if (lane >= o) inc += t;
  }
  const unsigned hit = __ballot_sync(~0u, inc > q && inc - c <= q);
  const int L = __ffs(hit) - 1;
  int pos = -1;
  if (lane == L) {
    int k = q - (inc - c);
    for (int w = w0; w < w1; ++w) {
      const int n = __popc(bm[w]);
      if (k < n) {
        uint32_t v = bm[w];
        for (; k > 0; --k) v &= v - 1;
        pos = w * 32 + __ffs(v) - 1;
        break;
      }
      k -= n;
    }
  }
  return __shfl_sync(~0u, pos, L);
}

__device__ __forceinline__ bool bit(const uint32_t* bits, int j) {
  return (bits[j >> 5] >> (j & 31)) & 1u;
}

// each class's keep cap; n = 0: every row keeps max_keep rows
struct RowCaps {
  int n;
  int keep[MAX_CLASSES];
};

// scratch: F * K records, then F * K yaw ranks (int), then F * K yaws
// by rank
__global__ void __launch_bounds__(THREADS, 1)
wnms_kernel(const float* __restrict__ dets, const float* __restrict__ scores,
            const uint8_t* __restrict__ valid, int K, int Kp, float thresh,
            float thresh_vote, int max_keep, int block, int iou_3d,
            RowCaps caps, float* __restrict__ scratch, float* __restrict__ out,
            uint8_t* __restrict__ out_valid, int* __restrict__ rounds) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int f = blockIdx.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int Kw = (K + 31) >> 5;
  const size_t FK = (size_t)gridDim.x * K;
  float* rec = scratch + (size_t)f * K * REC;  // 128-byte records
  int* ypos = reinterpret_cast<int*>(scratch + FK * REC) + (size_t)f * K;
  float* yaw_by_pos = scratch + FK * (REC + 1) + (size_t)f * K;
  const float* fd = dets + (size_t)f * K * 11;
  const int keep = caps.n ? caps.keep[f % caps.n] : max_keep;

  __shared__ int s_nf[11];
  __shared__ int s_r, s_cur, s_lim, s_nm, s_rounds;
  __shared__ int s_nnear[2];
  __shared__ unsigned s_S;
  __shared__ int s_mem[CH];

  // ---- A: the score order, the records, the yaw order, the alive bits
  unsigned long long* keys = reinterpret_cast<unsigned long long*>(smem);
  if (tid < 11) s_nf[tid] = 0;
  for (int i = tid; i < Kp; i += THREADS) {
    unsigned long long k = 0xffffffffull << 32;
    if (i < K) {
      const float s = valid[(size_t)f * K + i] ? scores[(size_t)f * K + i]
                                               : -INFINITY;
      k = (unsigned long long)order_key(-s) << 32;
    }
    keys[i] = k | (unsigned)i;
  }
  __syncthreads();
  bitonic(keys, Kp);
  for (int i = tid; i < K; i += THREADS) {
    const int o = (int)(keys[i] & 0xffffffffu);
    const float* d = fd + (size_t)o * 11;
    float* r = rec + (size_t)i * REC;
    float q[8];
#pragma unroll
    for (int c = 0; c < 8; ++c) q[c] = d[c];
#pragma unroll
    for (int c = 0; c < 11; ++c)
      if (!isfinite(d[c])) atomicAdd(&s_nf[c], 1);
    const float area = shoelace(q);
#pragma unroll
    for (int c = 0; c < 8; ++c) r[R_RAW + c] = q[c];
    if (area < 0.f) {  // the corners as [0, 3, 2, 1]
      float t = q[2];
      q[2] = q[6], q[6] = t;
      t = q[3];
      q[3] = q[7], q[7] = t;
    }
#pragma unroll
    for (int c = 0; c < 8; ++c) r[R_CCW + c] = q[c];
    const float cx = (((q[0] + q[2]) + q[4]) + q[6]) * 0.25f;
    const float cy = (((q[1] + q[3]) + q[5]) + q[7]) * 0.25f;
    float r2 = 0.f;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const float dx = q[2 * c] - cx, dy = q[2 * c + 1] - cy;
      r2 = jmax(r2, dx * dx + dy * dy);
    }
    const bool v = valid[(size_t)f * K + o];
    const float s = v ? scores[(size_t)f * K + o] : -INFINITY;
    r[R_CX] = cx;
    r[R_CX + 1] = cy;
    r[R_CX + 2] = sqrtf(r2);
    r[R_YAW] = d[8];
    r[R_SA] = fabsf(area);
    r[R_SCCW] = fabsf(shoelace(q));
    r[R_BOT] = d[9];
    r[R_HGT] = d[10];
    r[R_W] = clamp_min(s, 0.f);
    r[R_SCORE] = s;
    r[R_VALID] = v ? 1.f : 0.f;
  }
  __syncthreads();
  for (int i = tid; i < Kp; i += THREADS) {
    unsigned long long k = 0xffffffffull << 32;
    if (i < K)  // this thread wrote record i above
      k = (unsigned long long)order_key(rec[(size_t)i * REC + R_YAW]) << 32;
    keys[i] = k | (unsigned)i;
  }
  __syncthreads();
  bitonic(keys, Kp);
  for (int p = tid; p < K; p += THREADS) {
    const int i = (int)(keys[p] & 0xffffffffu);
    ypos[i] = p;
    yaw_by_pos[p] = rec[(size_t)i * REC + R_YAW];
  }
  __syncthreads();  // the keys are dead from here: the round buffers
  uint32_t* alive = reinterpret_cast<uint32_t*>(smem);
  uint32_t* kill = alive + Kw;
  uint32_t* vote = kill + CH * Kw;
  uint32_t* near = vote + CH * Kw;  // pairs (j << 4 | b); voting bitmaps
  float* mrec = reinterpret_cast<float*>(
      near + max(THREADS * CH, CH * Kw));
  for (int w = tid; w < Kw; w += THREADS) {
    uint32_t b = 0;
    for (int k = 0; k < 32 && w * 32 + k < K; ++k)
      if (rec[(size_t)(w * 32 + k) * REC + R_VALID] != 0.f) b |= 1u << k;
    alive[w] = b;
  }
  if (tid == 0) {
    s_r = 0;
    s_cur = 0;
    s_rounds = 0;
    s_nnear[0] = s_nnear[1] = 0;
  }
  __syncthreads();

  // ---- B: the rounds
  const bool filter = thresh > 0.f && thresh_vote >= 0.f;
  const float two_pi = (float)(2.0 * 3.1415926);
  int parity = 0;
  while (true) {
    if (warp == 0) {
      const int lim = s_r < keep ? warp_nth(alive, Kw, s_cur, block, lane)
                                 : -1;
      if (lane == 0) {
        s_lim = lim;
        if (lim >= 0) ++s_rounds;
      }
    }
    __syncthreads();
    const int lim = s_lim;
    if (lim < 0) break;
    while (true) {  // the round's members, CH at a time
      if (warp == 0) {
        const int nm = warp_collect(alive, s_cur, lim, CH, s_mem, lane);
        if (lane == 0) {
          s_nm = nm;
          if (nm) s_cur = s_mem[nm - 1] + 1;
        }
      }
      __syncthreads();
      const int nm = s_nm;
      if (nm == 0) break;
      for (int t = tid; t < nm * REC; t += THREADS)
        mrec[t] = rec[(size_t)s_mem[t / REC] * REC + t % REC];
      for (int t = tid; t < 2 * CH * Kw; t += THREADS) kill[t] = 0u;
      __syncthreads();

      // the IoU rows of the members against the alive candidates
      for (int base = (s_mem[0] / THREADS) * THREADS; base < K;
           base += THREADS) {
        const int j = base + tid, wj = base + warp * 32;
        const uint32_t word = wj < K ? alive[wj >> 5] : 0u;
        if (word != 0u) {  // uniform over the warp: one alive word
          const bool al = (word >> lane) & 1u;
          const float4 cj =
              al ? *reinterpret_cast<const float4*>(rec + (size_t)j * REC +
                                                    R_CX)
                 : make_float4(0.f, 0.f, 0.f, 0.f);
          for (int b = 0; b < nm; ++b) {
            const bool want = al && j != s_mem[b] &&
                              (!filter || !apart(mrec + b * REC, cj));
            const unsigned m = __ballot_sync(~0u, want);
            if (!m) continue;
            int at = 0;
            if (lane == 0) at = atomicAdd(&s_nnear[parity], __popc(m));
            at = __shfl_sync(~0u, at, 0);
            if (want) near[at + __popc(m & ((1u << lane) - 1))] =
                ((uint32_t)j << 4) | b;
          }
        }
        __syncthreads();
        const int n = s_nnear[parity];
        for (int e = tid; e < n; e += THREADS) {
          const int j = near[e] >> 4, b = near[e] & 15;
          const float iou = pair_iou(mrec + b * REC, rec + (size_t)j * REC,
                                     iou_3d);
          const uint32_t m = 1u << (j & 31);
          if (iou >= thresh) atomicOr(&kill[b * Kw + (j >> 5)], m);
          if (iou > thresh_vote) atomicOr(&vote[b * Kw + (j >> 5)], m);
        }
        __syncthreads();
        if (tid == 0) s_nnear[parity] = 0;
        parity ^= 1;
      }

      // the greedy chain
      if (warp == 0) {
        unsigned killed_by = 0;
        if (lane < nm) {
          const int mj = s_mem[lane];
          for (int b = 0; b < lane; ++b)
            if (bit(kill + b * Kw, mj)) killed_by |= 1u << b;
        }
        unsigned S = 0;
        for (int b = 0; b < nm; ++b) {
          const unsigned k = __shfl_sync(~0u, killed_by, b);
          if (!(k & S)) S |= 1u << b;
        }
        if (lane == 0) s_S = S;
      }
      __syncthreads();
      const unsigned S = s_S;
      const int r0 = s_r;

      // voting, warp b for survivor b
      if (warp < nm && ((S >> warp) & 1u) &&
          r0 + __popc(S & ((1u << warp) - 1)) < keep) {
        const int b = warp, mj = s_mem[b];
        const float* me = mrec + b * REC;
        const float yaw_i = me[R_YAW];
        const unsigned low = S & ((1u << b) - 1);
        uint32_t* bm = near + b * Kw;
        for (int w = lane; w < Kw; w += 32) bm[w] = 0u;
        __syncwarp();
        int n = 0, t = 0;
        for (int w = lane; w < Kw; w += 32) {
          uint32_t dead = 0;
          for (unsigned l = low; l; l &= l - 1) {
            const int c = __ffs(l) - 1;
            dead |= kill[c * Kw + w];
            if ((s_mem[c] >> 5) == w) dead |= 1u << (s_mem[c] & 31);
          }
          uint32_t v = vote[b * Kw + w];
          if ((mj >> 5) == w) v |= 1u << (mj & 31);
          v &= alive[w] & ~dead;
          for (; v; v &= v - 1) {
            const int j = w * 32 + __ffs(v) - 1;
            const int p = ypos[j];
            atomicOr(&bm[p >> 5], 1u << (p & 31));
            ++n;
            if (rec[(size_t)j * REC + R_YAW] < yaw_i) ++t;
          }
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) {
          n += __shfl_xor_sync(~0u, n, o);
          t += __shfl_xor_sync(~0u, t, o);
        }
        __syncwarp();
        float med = yaw_i;
        if (n > 2) {
          const int k = n / 2;
          int q = -1;
          if (n & 1) q = k;
          else if (k < t) q = k;
          else if (k > t) q = k - 1;
          // pick(): the selected yaw summed with zeros
          if (q >= 0) med = yaw_by_pos[warp_select(bm, Kw, q, lane)] + 0.f;
        }
        double acc[11], wsum = 0.0;
        int nfv[11];
#pragma unroll
        for (int c = 0; c < 11; ++c) acc[c] = 0.0, nfv[c] = 0;
        for (int w = lane; w < Kw; w += 32) {
          uint32_t dead = 0;
          for (unsigned l = low; l; l &= l - 1) {
            const int c = __ffs(l) - 1;
            dead |= kill[c * Kw + w];
            if ((s_mem[c] >> 5) == w) dead |= 1u << (s_mem[c] & 31);
          }
          uint32_t v = vote[b * Kw + w];
          if ((mj >> 5) == w) v |= 1u << (mj & 31);
          v &= alive[w] & ~dead;
          for (; v; v &= v - 1) {
            const float* rj = rec + (size_t)(w * 32 + __ffs(v) - 1) * REC;
            const bool ok = fmodf(fabsf(rj[R_YAW] - med), two_pi) < YAW_REJECT;
            const float wt = ok ? rj[R_W] : 0.f;
            if (wt == 0.f) continue;  // 0 * finite adds nothing
            wsum += (double)wt;
#pragma unroll
            for (int c = 0; c < 11; ++c) {
              const float x = rj[value_field(c)];
              acc[c] += (double)(wt * x);
              if (!isfinite(x)) ++nfv[c];
            }
          }
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) {
          wsum += __shfl_xor_sync(~0u, wsum, o);
#pragma unroll
          for (int c = 0; c < 11; ++c) {
            acc[c] += __shfl_xor_sync(~0u, acc[c], o);
            nfv[c] += __shfl_xor_sync(~0u, nfv[c], o);
          }
        }
        if (lane == 0) {
          const int row = r0 + __popc(S & ((1u << b) - 1));
          float* o = out + ((size_t)f * max_keep + row) * 12;
          const float ws = clamp_min((float)wsum, WSUM_MIN);
#pragma unroll
          for (int c = 0; c < 11; ++c) {
            // a non-voter's 0 * inf or 0 * NaN makes the plain sum NaN
            const float s = s_nf[c] > nfv[c] ? __int_as_float(0x7fc00000)
                                             : (float)acc[c];
            o[c] = s / ws;
          }
          o[11] = me[R_SCORE];
          out_valid[(size_t)f * max_keep + row] = 1;
        }
      }
      __syncthreads();
      for (int w = tid; w < Kw; w += THREADS) {
        uint32_t dead = 0;
        for (unsigned l = S; l; l &= l - 1) {
          const int c = __ffs(l) - 1;
          dead |= kill[c * Kw + w];
          if ((s_mem[c] >> 5) == w) dead |= 1u << (s_mem[c] & 31);
        }
        alive[w] &= ~dead;
      }
      __syncthreads();
      if (tid == 0) s_r = min(keep, r0 + __popc(S));
      __syncthreads();
      if (s_r >= keep) break;
    }
    if (tid == 0) s_cur = lim + 1;
    __syncthreads();
  }

  // the rows past the last survivor, and past the frame's cap
  const int r = s_r;
  for (int t = tid; t < (max_keep - r) * 12; t += THREADS)
    out[((size_t)f * max_keep + r) * 12 + t] = 0.f;
  for (int t = r + tid; t < max_keep; t += THREADS)
    out_valid[(size_t)f * max_keep + t] = 0;
  if (tid == 0) rounds[f] = s_rounds;
}

size_t smem_bytes(int K, int Kp) {
  const size_t Kw = (K + 31) / 32;
  const size_t sort = (size_t)Kp * 8;
  const size_t near = Kw * CH > (size_t)THREADS * CH ? Kw * CH
                                                     : (size_t)THREADS * CH;
  const size_t round = (Kw + 2 * CH * Kw + near) * 4 + CH * REC * 4;
  return sort > round ? sort : round;
}

}  // namespace

extern "C" {

// dets (F, K, 11), scores (F, K) f32, valid (F, K) bool, contiguous;
// scratch F * K * SCRATCH floats; out (F, max_keep, 12), out_valid
// (F, max_keep), rounds (F,) int32; keep: n_caps ints on the host (a
// class's keep cap, at most max_keep), or none with n_caps 0.
int wnms_launch(const float* dets, const float* scores, const void* valid,
                int F, int K, float thresh, float thresh_vote, int max_keep,
                int block, int iou_3d, const int* keep, int n_caps,
                float* scratch, float* out,
                void* out_valid, int* rounds, void* stream) {
  if (F < 1 || K < 1 || K > MAX_K || max_keep < 0 || block < 1 ||
      n_caps < 0 || n_caps > MAX_CLASSES)
    return (int)cudaErrorInvalidValue;
  RowCaps caps{};
  caps.n = n_caps;
  for (int c = 0; c < n_caps; ++c) {
    if (keep[c] < 0 || keep[c] > max_keep) return (int)cudaErrorInvalidValue;
    caps.keep[c] = keep[c];
  }
  int Kp = 32;
  while (Kp < K) Kp <<= 1;
  const size_t smem = smem_bytes(K, Kp);
  cudaError_t err = cudaFuncSetAttribute(
      wnms_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  wnms_kernel<<<F, THREADS, smem, (cudaStream_t)stream>>>(
      dets, scores, static_cast<const uint8_t*>(valid), K, Kp, thresh,
      thresh_vote, max_keep, block, iou_3d, caps, scratch, out,
      static_cast<uint8_t*>(out_valid), rounds);
  return (int)cudaGetLastError();
}

}  // extern "C"
