// Hopper plumbing shared by the conv3x3 kernels (conv3x3_bhcw.cu,
// conv3x3_wgrad.cu) and the Meta-Kernel kernels (meta_block.cu): mbarriers,
// TMA tile loads and stores, wgmma descriptors and fences, the transposing
// fragment store, tensor-map encoding, and the transposing ingest prologue
// that writes the GEMMs' channel-innermost operand.
//
// Each .cu file includes this header into its own anonymous namespace, so
// the kernels below are compiled once per file (no relocatable device code).

#pragma once

#include <cuda.h>  // CUtensorMap and its enums (the encoder is looked up)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// a wait longer than this many clocks (~10 s) is a deadlock: trap, so the
// launch fails instead of hanging the card
constexpr long long WAIT_LIMIT = 20000000000ll;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// wait until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  const long long t0 = clock64();
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - t0 > WAIT_LIMIT) __trap();
  }
}

// a box of the tensor map at coordinates (c0, c1, c2, c3), innermost
// first; c0 must start on 16 bytes, the others may be any int (out of
// range reads zeros)
__device__ __forceinline__ void tma_load_4d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// orders this thread's generic-proxy shared-memory writes before later
// asynchronous-proxy (TMA, wgmma) accesses of them
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// stores the box at coordinates (c0, c1, c2, c3), innermost first, from
// shared memory at src into the tensor map's tensor; elements out of range
// are not written. c0 must start on 16 bytes. The writes of src must be
// fenced (fence_async_smem) and synchronised before the store is issued.
__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map,
                                             uint32_t src, int c0, int c1,
                                             int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// closes the group of the bulk stores this thread issued since the last one
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// until at most N of this thread's store groups have not yet read their
// shared memory (the source may then be rewritten)
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

// until at most N of this thread's store groups are incomplete
template <int N>
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group %0;\n" ::"n"(N) : "memory");
}

// four 8 x 8 bf16 matrices held as mma fragments (lane l: row l / 4,
// columns 2 (l % 4) and + 1 in one register, r_q for matrix q), stored
// transposed: lane l gives the address of row l % 8 of the transpose of
// matrix l / 8 (16 bytes: that column of the matrix)
__device__ __forceinline__ void stmatrix_x4_trans(uint32_t addr, uint32_t r0,
                                                  uint32_t r1, uint32_t r2,
                                                  uint32_t r3) {
  asm volatile(
      "stmatrix.sync.aligned.m8n8.x4.trans.shared.b16 [%0], {%1, %2, %3, "
      "%4};\n" ::"r"(addr),
      "r"(r0), "r"(r1), "r"(r2), "r"(r3)
      : "memory");
}

// wgmma shared-memory descriptor of bf16 tiles written by TMA with
// 128-byte swizzle: rows of 128 B in 8-row atoms of 1024 B (the stride
// offset, SBO). For a K-major tile (64 K values a row) the leading offset
// is unused and a 16-deep k-step is 32 B along the row (+2 in the address
// field); for an N-major operand made of several 64-wide boxes the
// leading offset (LBO) is the distance from one box to the next.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// wait until at most N committed groups are still running
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmma
template <int N>
__device__ __forceinline__ void acc_fence(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled looked up through the runtime, so the
// library needs no -lcuda
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000,
                                     cudaEnableDefault, &q);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault,
                            &q);
#endif
    if (q == cudaDriverEntryPointSuccess) fn = (EncodeTiled)ptr;
  }
  return fn;
}

// a bf16 tensor (d3, d2, d1, d0) with row pitch p0 >= d0 elements as the
// 4-D map (d0, d1, d2, d3); boxes of box0 x box1 (x 1 x 1) elements,
// 128-byte swizzle (box0 * 2 <= 128), zeros out of range
int encode_map(CUtensorMap* map, const void* ptr, int d0, int d1, int d2,
               int d3, int p0, int box0, int box1) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return -1;
  const cuuint64_t dims[4] = {(cuuint64_t)d0, (cuuint64_t)d1, (cuuint64_t)d2,
                              (cuuint64_t)d3};
  const cuuint64_t strides[3] = {(cuuint64_t)p0 * 2,
                                 (cuuint64_t)p0 * 2 * d1,
                                 (cuuint64_t)p0 * 2 * d1 * d2};
  const cuuint32_t box[4] = {(cuuint32_t)box0, (cuuint32_t)box1, 1, 1};
  const cuuint32_t estride[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                        const_cast<void*>(ptr), dims, strides, box, estride,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : -1;
}

// ---------------------------------------------------------- the prologue
constexpr int PRO_THREADS = 256;
constexpr int PRO_TILE = 64;  // channels x pixels of a block

enum Ingest { INGEST_NONE = 0, INGEST_AFFINE = 1, INGEST_COT = 2 };

// a' (B*H, Wq, Cp) from src (B*H, C, W), transposed so that channels are
// innermost, with the exact f32 operations of the fused load it replaces
// (conv_pallas.py:_ingest, _ingest_cot), so the GEMM's operands are
// bit-identical to the plain version's:
//   INGEST_NONE    a = src
//   INGEST_AFFINE  a = bf16(relu(f32(src) * p1[c] + p2[c]))
//   INGEST_COT     a = bf16(f32(src) + p1[c] + 2 * f32(y) * p2[c])
// Without `phase`, a'[bh, w, c] = a[bh, c, w] (Wq = W) and the channels
// C <= c < Cp are written 0. With `phase` (stride 2: W even, C % 8 == 0,
// Cp = 2C) the two column phases become channels:
// a'[bh, u, f*C + c] = a[bh, c, 2u + f], Wq = W / 2.
// A block moves 64 channels x 64 source columns through shared memory: a
// thread reads 8 columns of one channel (one 16-byte load where the rows
// allow it, `vec`) and writes 8 channels of one pixel (one 16-byte
// store), so eight threads cover a 128-byte row on both sides; the
// 66-element pitch keeps the tile's accesses at most 2-way
// bank-conflicted. Grid: (ceil(W / 64), channel tiles, B*H) with
// ceil(Cp / 64) channel tiles, or ceil(C / 64) with `phase`.
template <int MODE>
__global__ void __launch_bounds__(PRO_THREADS)
    ingest_t_kernel(const __nv_bfloat16* __restrict__ src,
                    const __nv_bfloat16* __restrict__ y,
                    const float* __restrict__ p1,
                    const float* __restrict__ p2,
                    __nv_bfloat16* __restrict__ dst, int C, int Cp, int W,
                    int phase, int vec) {
  __shared__ __align__(16) __nv_bfloat16 tile[PRO_TILE][PRO_TILE + 2];
  const int w0 = blockIdx.x * PRO_TILE;
  const int c0 = blockIdx.y * PRO_TILE;
  const size_t bh = blockIdx.z;
  const __nv_bfloat16 zero = __float2bfloat16(0.f);
#pragma unroll
  for (int pass = 0; pass < 2; ++pass) {
    const int cl = pass * 32 + threadIdx.x / 8;
    const int wl = (threadIdx.x % 8) * 8;
    const int c = c0 + cl, w = w0 + wl;
    const size_t i = (bh * C + c) * W + w;
    alignas(16) __nv_bfloat16 v[8];
    alignas(16) __nv_bfloat16 yv[8];
    if (c < C && vec && w < W) {
      *reinterpret_cast<uint4*>(v) = *reinterpret_cast<const uint4*>(src + i);
      if (MODE == INGEST_COT)
        *reinterpret_cast<uint4*>(yv) = *reinterpret_cast<const uint4*>(y + i);
    } else {
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const bool ok = c < C && w + k < W;
        v[k] = ok ? src[i + k] : zero;
        yv[k] = (ok && MODE == INGEST_COT) ? y[i + k] : zero;
      }
    }
    if (MODE == INGEST_COT && c < C) {
      const float a1 = p1[c], a2 = p2[c];
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const float t = __fmul_rn(2.f * __bfloat162float(yv[k]), a2);
        v[k] = __float2bfloat16(
            __fadd_rn(__fadd_rn(__bfloat162float(v[k]), a1), t));
      }
    }
    if (MODE == INGEST_AFFINE && c < C) {
      const float s = p1[c], b = p2[c];
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const float f = __fadd_rn(__fmul_rn(__bfloat162float(v[k]), s), b);
        v[k] = __float2bfloat16(fmaxf(f, 0.f));
      }
    }
    // zero outside the image: the padding is in the activated domain
#pragma unroll
    for (int k = 0; k < 8; k += 2) {
      __nv_bfloat162 pair;
      pair.x = w + k < W ? v[k] : zero;
      pair.y = w + k + 1 < W ? v[k + 1] : zero;
      *reinterpret_cast<__nv_bfloat162*>(&tile[cl][wl + k]) = pair;
    }
  }
  __syncthreads();
  const int Wq = phase ? W / 2 : W;
#pragma unroll
  for (int pass = 0; pass < 2; ++pass) {
    const int r = pass * 32 + threadIdx.x / 8;  // output pixel of the tile
    const int cg = (threadIdx.x % 8) * 8;
    const int wl = phase ? 2 * (r % 32) + r / 32 : r;  // its source column
    if (w0 + wl >= W) continue;
    if (phase ? c0 + cg >= C : c0 + cg >= Cp) continue;
    const int u = phase ? w0 / 2 + r % 32 : w0 + r;
    const int ch = (phase ? (r / 32) * C : 0) + c0 + cg;
    alignas(16) __nv_bfloat16 o[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) o[j] = tile[cg + j][wl];
    *reinterpret_cast<uint4*>(dst + (bh * Wq + u) * Cp + ch) =
        *reinterpret_cast<const uint4*>(o);
  }
}

// launches ingest_t_kernel for x (B*H rows of C x W); y is read only by
// INGEST_COT, and p1 / p2 are (scale, bias) or (g1, g2)
inline void ingest_t(int mode, const void* src, const void* y, const void* p1,
                     const void* p2, void* dst, int BH, int C, int Cp, int W,
                     int phase, cudaStream_t s) {
  const bool vec = W % 8 == 0 && (uintptr_t)src % 16 == 0 &&
                   (uintptr_t)y % 16 == 0;
  const dim3 grid((W + PRO_TILE - 1) / PRO_TILE,
                  ((phase ? C : Cp) + PRO_TILE - 1) / PRO_TILE, BH);
  const __nv_bfloat16* a = (const __nv_bfloat16*)src;
  const __nv_bfloat16* b = (const __nv_bfloat16*)y;
  const float* f1 = (const float*)p1;
  const float* f2 = (const float*)p2;
  __nv_bfloat16* d = (__nv_bfloat16*)dst;
  if (mode == INGEST_COT)
    ingest_t_kernel<INGEST_COT><<<grid, PRO_THREADS, 0, s>>>(
        a, b, f1, f2, d, C, Cp, W, phase, vec ? 1 : 0);
  else if (mode == INGEST_AFFINE)
    ingest_t_kernel<INGEST_AFFINE><<<grid, PRO_THREADS, 0, s>>>(
        a, b, f1, f2, d, C, Cp, W, phase, vec ? 1 : 0);
  else
    ingest_t_kernel<INGEST_NONE><<<grid, PRO_THREADS, 0, s>>>(
        a, b, f1, f2, d, C, Cp, W, phase, vec ? 1 : 0);
}

}  // namespace
