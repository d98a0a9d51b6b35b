// Fused ResNet identity bottleneck, backward, for Hopper (sm_90a).
//
// Replaces the TPU kernel detjax/kernels/bottleneck.py::_bottleneck_bwd
// (line 270; body _bwd_kernel, line 156). Same function: from x, the output's
// gradient dy and the BN-folded weights of the forward (bottleneck.cu),
// recompute y1 and y2 on chip and produce
//   dy3 = dy * ((y2 @ w3 + b3) + x > 0)                 fp32
//   dc2 = (bf16(dy3) @ w3^T) * (y2 > 0)                 fp32
//   dy1 = sum_k shift_k(bf16(dc2)) @ w2[k]^T            the transposed 3x3
//   dc1 = dy1 * (y1 > 0)                                fp32
//   dx  = bf16(dy3 + bf16(dc1) @ w1^T)                  residual term unrounded
//   dw3 = sum y2^T bf16(dy3), dw2[k] = sum shift_k(y1)^T bf16(dc2),
//   dw1 = sum x^T bf16(dc1), db3/db2/db1 = sum dy3 / dc2 / dc1   all fp32
// with every product a bf16 x bf16 -> fp32 product, as _bwd_kernel rounds.
// y1, y2, dy3, dc2 and dc1 never reach device memory.
//
// Design. A persistent grid of P blocks (P = the SM count, or fewer tiles);
// block p walks the (image, row, column block) tiles p, p + P, ... one
// output row at a time, with 8 warps. A column block owns the image columns
// [cb, ce) of its row, Wc = ce - cb wide (Wc a multiple of 16; the last
// block of a row may be narrower); a row that fits shared memory whole is
// one column block. Per tile, in shared memory:
//   Y1  5 rows (r-2 .. r+2) of y1;
//   DC2 3 rows (r-1 .. r+1) of bf16(dc2);
// each row a window of image columns o .. o + 16 nw - 1 computed in nw
// 16-pixel tiles, plus a zeroed border column on each side; a row outside
// the image stays all zero (the 3x3's padding). dy1 at the owned pixels
// needs dc2 one column beyond them, so y2 there, so y1 two columns beyond:
// o = cb - 2 (or 0 at the image's left edge) and the window reaches ce + 2
// (or W), rounded up to whole tiles. Pixels at or beyond W (a row's masked
// tail, or window tiles past it) load x and dy as zeros and get y1 = 0, so
// dy3, dc2 and dc1 are exactly 0 there: they add nothing to any sum, and
// they are never stored. Halo pixels (window pixels outside [cb, ce)) are
// recomputed by every block that needs them and counted by none: phases 3
// and 4 run over the owned tiles only, and db2's column sums are masked to
// the owned pixels.
// Phase 1 computes y1 on the 5 rows (conv1 recomputed on 4 halo rows and
// the halo columns). Phase 2 gives each warp 16-pixel tiles of rows r-1,
// r+1 (then r): y2 of the tile, y3 one 16-channel chunk at a time, the dy3
// mask and its bf16 rounding, and dc2 accumulated over the chunks in
// fragments. The halo rows' y2 goes where their dc2 will go; row r's y2 is
// kept (for dw3) in y1 row r-2, dead by then. Phase 3: dy1 and dc1 per
// owned 16-pixel tile, bf16(dc1) kept in y1 row r+2, also dead. Phase 4
// switches from pixels to outputs: each warp owns whole 16x16 tiles of dw1
// / dw2 / dw3 (dw3's owner also recomputes dy3 for its 16 channels of the
// owned pixels, and writes dx for them) and sums the tile's pixels into the
// block's own fp32 slice of a workspace with plain loads and stores. Bias
// sums: per 16-pixel tile into shared memory, then one thread per channel.
//
// Why one row a tile, and column blocks: with the forward's pad of 16 bf16
// a pixel, 8 whole rows (5 of y1, 3 of dc2) at W = 160, M = 64 take 207 KB,
// and at W = 80, M = 128 take 189 KB, of the 227 KB a block may have. Two
// rows a tile would need 10 rows (259 and 236 KB). Wider rows (W = 256 at
// M = 64, W = 104 or 128 at M = 128) do not fit whole: the launcher splits
// them into the fewest column blocks of equal whole tiles that fit (Wc =
// 128 at W = 256, M = 64; Wc = 64 at W = 128, M = 128), which costs one or
// two halo tiles of y1 and dc2 work a block.
//
// The reduction across blocks, and determinism. The TPU kernel kept the six
// gradients resident across its sequential grid. Here every block owns a
// workspace slice of S = 2 C M + 9 M^2 + 2 M + C floats (C = 4 M), which it
// zeroes first and then updates in a fixed order, element by element from
// one thread or one fragment at a time; a second kernel sums the P slices in
// slice order. No atomics: the bits are equal from run to run on one card
// (P is the SM count). Output layout of the sum, fp32: dw1 [C, M], dw2
// [3, 3, M, M], dw3 [M, C], db1 [M], db2 [M], db3 [C].
//
// What bounds it on an H100: at R50's training shapes (bs 16) bytes at
// layer1 (x and dy read once, dx written once: 629 MB, 0.188 ms at 3.35
// TB/s) and operations at layer2 (3x the forward's multiply-adds, 171
// GFLOP, 0.173 ms at 989 TFLOP/s). This kernel does about twice the
// necessary products (conv1 on 5 rows, conv2 and conv3 on 3 rows, conv3
// twice more for dw3 and dx), through wmma (mma.sync) rather than wgmma,
// and moves each block's workspace slice through L2 (or HBM, at layer2's
// 147 MB) once per row: it is far from that bound; times are in PERF.md.
//
// Requirements (the wrapper checks them): M in {16, 32, 64, 128}, C = 4 M,
// any W >= 1, contiguous 32-byte-aligned bf16 tensors, fp32 biases.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

namespace {

using namespace nvcuda;
using bf16 = __nv_bfloat16;
using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>;
using FragAt = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major>;
using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>;
using FragBt = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kPad = 16;  // extra bf16 per pixel in shared memory: keeps
                          // 32-byte alignment, spreads banks
constexpr int kWarpBytes = 256 * 4 + 256 * 2;  // fp32 stage + bf16 dy3 tile

union Pack8 {
  uint4 v;
  __nv_bfloat162 h[4];
};

// The columns of column block j of a row, at block width wc: it owns image
// columns [cb, ce), np 16-pixel tiles from cb; its shared rows hold the
// window of nw tiles from image column o, shared index i being image column
// o - 1 + i (index 0 and 16 nw + 1 are the zeroed borders). nw also covers
// the owned tiles and one column past them, which phase 3 reads.
struct Cols {
  int cb, ce, np, o, nw;
};

__host__ __device__ inline Cols col_block(int j, int wc, int w) {
  Cols g;
  g.cb = j * wc;
  g.ce = g.cb + wc < w ? g.cb + wc : w;
  g.np = (g.ce - g.cb + 15) / 16;
  g.o = g.cb > 0 ? g.cb - 2 : 0;
  const int hi = g.ce < w ? g.ce + 2 : g.ce;
  const int need = (hi - g.o + 15) / 16, own = g.np + (g.cb > 0 ? 1 : 0);
  g.nw = need > own ? need : own;
  return g;
}

// Shared memory of one block: 8 rows of 16 nwmax + 2 pixels (5 of y1, 3 of
// dc2), per warp a staging tile and a dy3 tile, and the per-tile bias sums
// of dc1 (npmax owned tiles) and dc2 (nwmax window tiles).
template <int M>
__host__ __device__ size_t rows_bytes(int nwmax) {
  return static_cast<size_t>(8) * (16 * nwmax + 2) * (M + kPad) * sizeof(bf16);
}

template <int M>
size_t smem_bytes(int nwmax, int npmax) {
  return rows_bytes<M>(nwmax) + static_cast<size_t>(kWarps) * kWarpBytes +
         static_cast<size_t>(npmax + nwmax) * M * sizeof(float);
}

// How a row of width w is tiled under `limit` bytes of shared memory: the
// fewest column blocks of equal whole tiles that fit. wc = 0 when none do.
struct Plan {
  int wc, nwmax;
  size_t smem;
};

template <int M>
Plan plan(int w, size_t limit) {
  const int tiles = (w + 15) / 16;
  Plan p = {0, 0, 0};
  for (int nb = 1; nb <= tiles; ++nb) {
    const int wc = 16 * ((tiles + nb - 1) / nb);
    int nwmax = 0;
    for (int j = 0; j * wc < w; ++j) {
      const int nw = col_block(j, wc, w).nw;
      nwmax = nw > nwmax ? nw : nwmax;
    }
    p = {wc, nwmax, smem_bytes<M>(nwmax, wc / 16)};
    if (p.smem <= limit) return p;
  }
  p.wc = 0;
  return p;
}

template <int M>
__host__ __device__ constexpr size_t slice_floats() {
  return 2 * (4 * M) * M + 9 * M * M + 2 * M + 4 * M;
}

// Bias, ReLU and bf16 rounding of one 16x16 fp32 tile staged in `stage`
// (row-major), written to `dst` (row stride ld); rows (pixels) at or beyond
// `valid` are written as zeros. Lane: row lane / 2, columns (lane % 2) * 8
// .. + 7.
__device__ __forceinline__ void store_relu_bf16(const float* stage,
                                                const float* bias, bf16* dst,
                                                int ld, int lane,
                                                int valid = 16) {
  const int r = lane >> 1, c = (lane & 1) * 8;
  const float* s = stage + r * 16 + c;
  Pack8 pack;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float a = fmaxf(s[2 * i] + bias[c + 2 * i], 0.0f);
    const float b = fmaxf(s[2 * i + 1] + bias[c + 2 * i + 1], 0.0f);
    pack.h[i] = __floats2bfloat162_rn(a, b);
  }
  if (r >= valid) pack.v = make_uint4(0u, 0u, 0u, 0u);
  *reinterpret_cast<uint4*>(dst + r * ld + c) = pack.v;
}

// Copies a 16-pixel x 16-channel bf16 tile (pixel stride ld) into `dst`
// (pixel stride 16), pixels at or beyond `valid` as zeros: an operand of a
// masked tile, read from x.
__device__ __forceinline__ void stage_tile(const bf16* src, int ld, int valid,
                                           bf16* dst, int lane) {
  const int p = lane >> 1, c = (lane & 1) * 8;
  uint4 v = make_uint4(0u, 0u, 0u, 0u);
  if (p < valid)
    v = *reinterpret_cast<const uint4*>(src + static_cast<size_t>(p) * ld + c);
  *reinterpret_cast<uint4*>(dst + p * 16 + c) = v;
  __syncwarp();
}

// Pixels of the 16-pixel tile from image column c0 that lie in the image.
__device__ __forceinline__ int valid_pixels(int c0, int w) {
  return w - c0 >= 16 ? 16 : (w - c0 > 0 ? w - c0 : 0);
}

// dy3 = dy * ((y3 + b3) + x > 0) for the lane's 8 elements of a staged
// 16x16 y3 tile: written as fp32 to `d3` and to the stage, as bf16 to the
// warp's dy3 tile. `pix` indexes the lane's first element in x and dy; a
// lane whose pixel is not `live` (at or beyond W) gets 0, from a `pix` the
// caller clamps into the row (the loads stay unconditional).
__device__ __forceinline__ void dy3_chunk(float* stage, bf16* dy3t,
                                          const bf16* x, const bf16* dy,
                                          const float* b3, size_t pix, int ch,
                                          int lane, bool live, float* d3) {
  const int pr = lane >> 1, pc = (lane & 1) * 8;
  float* s = stage + pr * 16 + pc;
  Pack8 xv, dv, pack;
  xv.v = *reinterpret_cast<const uint4*>(x + pix);
  dv.v = *reinterpret_cast<const uint4*>(dy + pix);
  if (!live) xv.v = dv.v = make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 xr = __bfloat1622float2(xv.h[i]);
    const float2 g = __bfloat1622float2(dv.h[i]);
    d3[2 * i] = (s[2 * i] + b3[ch + 2 * i]) + xr.x > 0.0f ? g.x : 0.0f;
    d3[2 * i + 1] =
        (s[2 * i + 1] + b3[ch + 2 * i + 1]) + xr.y > 0.0f ? g.y : 0.0f;
    pack.h[i] = __floats2bfloat162_rn(d3[2 * i], d3[2 * i + 1]);
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) s[i] = d3[i];
  *reinterpret_cast<uint4*>(dy3t + pr * 16 + pc) = pack.v;
}

// Masks a staged 16x16 fp32 tile by `ref > 0` (bf16, row stride ld; the
// lane's elements as in store_relu_bf16), writes the masked values back to
// the stage and, rounded, to `dst` (row stride ld; may be `ref` itself).
__device__ __forceinline__ void mask_store(float* stage, const bf16* ref,
                                           bf16* dst, int ld, int lane) {
  const int r = lane >> 1, c = (lane & 1) * 8;
  float* s = stage + r * 16 + c;
  Pack8 rv, pack;
  rv.v = *reinterpret_cast<const uint4*>(ref + r * ld + c);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 y = __bfloat1622float2(rv.h[i]);
    const float a = y.x > 0.0f ? s[2 * i] : 0.0f;
    const float b = y.y > 0.0f ? s[2 * i + 1] : 0.0f;
    s[2 * i] = a;
    s[2 * i + 1] = b;
    pack.h[i] = __floats2bfloat162_rn(a, b);
  }
  *reinterpret_cast<uint4*>(dst + r * ld + c) = pack.v;
}

// Sum of column `lane` (< 16) of a staged 16x16 tile over rows lo .. hi - 1,
// in order.
__device__ __forceinline__ float column_sum(const float* stage, int lane,
                                            int lo = 0, int hi = 16) {
  float s = 0.0f;
  for (int q = lo; q < hi; ++q) s += stage[q * 16 + lane];
  return s;
}

// Phase 2 for one 16-pixel window tile of image row rr, the j-th row of
// DC2: the tile starts at shared index s0 + 1 and image column c0. y2 from
// y1 rows j .. j + 2 into y2dst, then dc2 over all C channels into dc2dst
// (which may be y2dst); with `colsum`, the tile's column sums of the fp32
// dc2 over its rows (pixels) lo .. hi - 1.
template <int M>
__device__ void dc2_tile(const bf16* Y1, int j, int s0, int c0, int wp, int w,
                         int rr, bf16* y2dst, bf16* dc2dst, float* colsum,
                         int lo, int hi, const bf16* ximg, const bf16* dyimg,
                         const bf16* w2, const float* b2, const bf16* w3,
                         const float* b3, float* stage, bf16* dy3t, int lane) {
  constexpr int C = 4 * M, LD = M + kPad, NT = M / 16;
  FragC acc[NT];
#pragma unroll
  for (int n = 0; n < NT; ++n) wmma::fill_fragment(acc[n], 0.0f);
  for (int ky = 0; ky < 3; ++ky) {
    for (int kx = 0; kx < 3; ++kx) {
      const bf16* ya = Y1 + (static_cast<size_t>(j + ky) * wp + s0 + kx) * LD;
      const bf16* wt = w2 + static_cast<size_t>(ky * 3 + kx) * M * M;
      for (int k = 0; k < M; k += 16) {
        FragA a;
        wmma::load_matrix_sync(a, ya + k, LD);
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          FragB b;
          wmma::load_matrix_sync(b, wt + static_cast<size_t>(k) * M + n * 16, M);
          wmma::mma_sync(acc[n], a, b, acc[n]);
        }
      }
    }
  }
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    wmma::store_matrix_sync(stage, acc[n], 16, wmma::mem_row_major);
    __syncwarp();
    store_relu_bf16(stage, b2 + n * 16, y2dst + n * 16, LD, lane);
    __syncwarp();
  }

  // y2's fragments are read from shared memory per chunk: held in
  // registers beside d2 they would spill at M = 128
  FragC d2[NT];
#pragma unroll
  for (int n = 0; n < NT; ++n) wmma::fill_fragment(d2[n], 0.0f);
  const int pr = lane >> 1, pc = (lane & 1) * 8;
  const bool live = c0 + pr < w;
  const size_t pix =
      (static_cast<size_t>(rr) * w + (live ? c0 + pr : w - 1)) * C + pc;
  for (int n3 = 0; n3 < C / 16; ++n3) {
    FragC acc3;
    wmma::fill_fragment(acc3, 0.0f);
#pragma unroll
    for (int k = 0; k < NT; ++k) {
      FragA a;
      wmma::load_matrix_sync(a, y2dst + k * 16, LD);
      FragB b;
      wmma::load_matrix_sync(b, w3 + static_cast<size_t>(k) * 16 * C + n3 * 16,
                             C);
      wmma::mma_sync(acc3, a, b, acc3);
    }
    wmma::store_matrix_sync(stage, acc3, 16, wmma::mem_row_major);
    __syncwarp();
    float d3[8];
    dy3_chunk(stage, dy3t, ximg, dyimg, b3, pix + n3 * 16, n3 * 16 + pc, lane,
              live, d3);
    __syncwarp();
    FragA ad;
    wmma::load_matrix_sync(ad, dy3t, 16);
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      // w3^T: element (c, o) is w3[o, c]
      FragBt bt;
      wmma::load_matrix_sync(bt, w3 + static_cast<size_t>(n) * 16 * C + n3 * 16,
                             C);
      wmma::mma_sync(d2[n], ad, bt, d2[n]);
    }
    __syncwarp();
  }
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    wmma::store_matrix_sync(stage, d2[n], 16, wmma::mem_row_major);
    __syncwarp();
    mask_store(stage, y2dst + n * 16, dc2dst + n * 16, LD, lane);
    __syncwarp();
    if (colsum != nullptr && lane < 16)
      colsum[n * 16 + lane] = column_sum(stage, lane, lo, hi);
    __syncwarp();
  }
}

template <int M>
__global__ void __launch_bounds__(kThreads)
    bottleneck_bwd_kernel(const bf16* __restrict__ x,    // [B, H, W, C]
                          const bf16* __restrict__ dy,   // [B, H, W, C]
                          const bf16* __restrict__ w1,   // [C, M]
                          const float* __restrict__ b1,  // [M]
                          const bf16* __restrict__ w2,   // [3, 3, M, M]
                          const float* __restrict__ b2,  // [M]
                          const bf16* __restrict__ w3,   // [M, C]
                          const float* __restrict__ b3,  // [C]
                          bf16* __restrict__ dx,         // [B, H, W, C]
                          float* __restrict__ ws,        // [gridDim.x, S]
                          int batch, int h, int w, int wc, int nwmax) {
  constexpr int C = 4 * M, LD = M + kPad, NT = M / 16, CT = C / 16;
  constexpr size_t S = slice_floats<M>();
  constexpr int kVecPix = LD * 2 / 16;  // uint4 per shared pixel

  extern __shared__ __align__(128) unsigned char smem[];
  const int wp = 16 * nwmax + 2;  // pixels a shared row, borders included
  const int nb = (w + wc - 1) / wc;  // column blocks a row
  const size_t rowe = static_cast<size_t>(wp) * LD;
  bf16* Y1 = reinterpret_cast<bf16*>(smem);  // rows r-2 .. r+2
  bf16* DC2 = Y1 + 5 * rowe;                 // rows r-1 .. r+1
  bf16* Y2I = Y1;             // y2 of row r, in y1 row r-2 after phase 2a
  bf16* DC1 = Y1 + 4 * rowe;  // bf16(dc1) of row r, in y1 row r+2
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  unsigned char* wbase = smem + rows_bytes<M>(nwmax) + warp * kWarpBytes;
  float* stage = reinterpret_cast<float*>(wbase);
  bf16* dy3t = reinterpret_cast<bf16*>(wbase + 1024);
  float* colsum1 = reinterpret_cast<float*>(smem + rows_bytes<M>(nwmax) +
                                            kWarps * kWarpBytes);
  float* colsum2 = colsum1 + (wc / 16) * M;

  float* g_dw1 = ws + blockIdx.x * S;
  float* g_dw2 = g_dw1 + C * M;
  float* g_dw3 = g_dw2 + 9 * M * M;
  float* g_db1 = g_dw3 + M * C;
  float* g_db2 = g_db1 + M;
  float* g_db3 = g_db2 + M;
  for (size_t i = threadIdx.x; i < S; i += kThreads) g_dw1[i] = 0.0f;
  // (seen by the block's threads after the first __syncthreads below)

  const int pr = lane >> 1, pc = (lane & 1) * 8;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  for (int t = blockIdx.x; t < batch * h * nb; t += gridDim.x) {
    const Cols g = col_block(t % nb, wc, w);
    const int r = (t / nb) % h;
    const size_t img_off = static_cast<size_t>(t / nb / h) * h * w * C;
    const bf16* ximg = x + img_off;
    const bf16* dyimg = dy + img_off;
    const int a0 = g.cb - g.o + 1;  // shared index of the first owned pixel

    // -- zero the border columns of the 8 shared rows, and whole rows
    // outside the image (y1 rows q < 5 are image rows r-2+q, dc2 rows
    // q >= 5 image rows r-6+q).
    for (int q = 0; q < 8; ++q) {
      const int rr = q < 5 ? r - 2 + q : r - 6 + q;
      uint4* row = reinterpret_cast<uint4*>(Y1 + q * rowe);
      if (rr < 0 || rr >= h) {
        for (int i = threadIdx.x; i < wp * kVecPix; i += kThreads) row[i] = zero;
      } else {
        for (int i = threadIdx.x; i < 2 * kVecPix; i += kThreads) {
          const int col = i < kVecPix ? 0 : 16 * g.nw + 1;
          row[col * kVecPix + i % kVecPix] = zero;
        }
      }
    }

    // -- phase 1: y1 = bf16(relu(x @ w1 + b1)) on rows r-2 .. r+2, over the
    // window; 0 at pixels at or beyond W.
    for (int u = warp; u < 5 * g.nw; u += kWarps) {
      const int q = u / g.nw, k = u % g.nw;
      const int rr = r - 2 + q, c0 = g.o + 16 * k;
      if (rr < 0 || rr >= h) continue;
      const int valid = valid_pixels(c0, w);
      FragC acc[NT];
#pragma unroll
      for (int n = 0; n < NT; ++n) wmma::fill_fragment(acc[n], 0.0f);
      const bf16* xa = ximg + (static_cast<size_t>(rr) * w + c0) * C;
      for (int kc = 0; kc < C; kc += 16) {
        FragA a;
        if (valid == 16) {
          wmma::load_matrix_sync(a, xa + kc, C);
        } else {  // staged through the warp's (idle) dy3 tile
          stage_tile(xa + kc, C, valid, dy3t, lane);
          wmma::load_matrix_sync(a, dy3t, 16);
          __syncwarp();
        }
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          FragB b;
          wmma::load_matrix_sync(b, w1 + static_cast<size_t>(kc) * M + n * 16,
                                 M);
          wmma::mma_sync(acc[n], a, b, acc[n]);
        }
      }
      bf16* dst = Y1 + (q * wp + 16 * k + 1) * static_cast<size_t>(LD);
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        wmma::store_matrix_sync(stage, acc[n], 16, wmma::mem_row_major);
        __syncwarp();
        store_relu_bf16(stage, b1 + n * 16, dst + n * 16, LD, lane, valid);
        __syncwarp();
      }
    }
    __syncthreads();

    // -- phase 2a: dc2 on the halo rows r-1 and r+1 (y2 where dc2 goes).
    for (int u = warp; u < 2 * g.nw; u += kWarps) {
      const int j = (u / g.nw) * 2, k = u % g.nw;
      const int rr = r - 1 + j;
      if (rr < 0 || rr >= h) continue;  // stays zero
      bf16* dst = DC2 + (j * wp + 16 * k + 1) * static_cast<size_t>(LD);
      dc2_tile<M>(Y1, j, 16 * k, g.o + 16 * k, wp, w, rr, dst, dst, nullptr,
                  0, 0, ximg, dyimg, w2, b2, w3, b3, stage, dy3t, lane);
    }
    __syncthreads();

    // -- phase 2b: dc2 on row r, its y2 kept in Y2I, db2's column sums over
    // the owned pixels of each window tile.
    for (int k = warp; k < g.nw; k += kWarps) {
      const int c0 = g.o + 16 * k;
      const int lo = g.cb - c0 > 0 ? g.cb - c0 : 0;
      const int hi = g.ce - c0 < 16 ? g.ce - c0 : 16;
      dc2_tile<M>(Y1, 1, 16 * k, c0, wp, w, r,
                  Y2I + (16 * k + 1) * static_cast<size_t>(LD),
                  DC2 + (wp + 16 * k + 1) * static_cast<size_t>(LD),
                  colsum2 + k * M, lo, hi, ximg, dyimg, w2, b2, w3, b3, stage,
                  dy3t, lane);
    }
    __syncthreads();

    // -- phase 3: dy1 = sum_k shift_k(dc2) @ w2[k]^T on the owned tiles of
    // row r; dc1 = dy1 * (y1 > 0) into DC1 (bf16) and db1's column sums.
    // dy1[r, c] takes dc2[r + 1 - ky, c + 1 - kx]: DC2 row 2 - ky, one
    // shared index right of c's, less kx.
    for (int p = warp; p < g.np; p += kWarps) {
      const int sa = a0 + 16 * p;  // shared index of the tile's first pixel
      FragC acc[NT];
#pragma unroll
      for (int n = 0; n < NT; ++n) wmma::fill_fragment(acc[n], 0.0f);
      for (int ky = 0; ky < 3; ++ky) {
        for (int kx = 0; kx < 3; ++kx) {
          const bf16* da =
              DC2 + (static_cast<size_t>(2 - ky) * wp + sa + 1 - kx) * LD;
          const bf16* wt = w2 + static_cast<size_t>(ky * 3 + kx) * M * M;
          for (int kc = 0; kc < M; kc += 16) {
            FragA a;
            wmma::load_matrix_sync(a, da + kc, LD);
#pragma unroll
            for (int n = 0; n < NT; ++n) {
              // w2[k]^T: element (o, i) is w2[k][i, o]
              FragBt bt;
              wmma::load_matrix_sync(
                  bt, wt + static_cast<size_t>(n) * 16 * M + kc, M);
              wmma::mma_sync(acc[n], a, bt, acc[n]);
            }
          }
        }
      }
      const bf16* y1r = Y1 + (2 * wp + sa) * static_cast<size_t>(LD);
      bf16* dst = DC1 + sa * static_cast<size_t>(LD);
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        wmma::store_matrix_sync(stage, acc[n], 16, wmma::mem_row_major);
        __syncwarp();
        mask_store(stage, y1r + n * 16, dst + n * 16, LD, lane);
        __syncwarp();
        if (lane < 16) colsum1[p * M + n * 16 + lane] = column_sum(stage, lane);
        __syncwarp();
      }
    }
    __syncthreads();

    // -- phase 4: sums owned by output, over the owned tiles. db1 and db2:
    // one thread a channel.
    for (int i = threadIdx.x; i < 2 * M; i += kThreads) {
      float s = 0.0f;
      if (i < M) {
        for (int p = 0; p < g.np; ++p) s += colsum1[p * M + i];
        g_db1[i] += s;
      } else {
        for (int k = 0; k < g.nw; ++k) s += colsum2[k * M + i - M];
        g_db2[i - M] += s;
      }
    }
    const bf16* xrow = ximg + static_cast<size_t>(r) * w * C;
    bf16* dxrow = dx + img_off + static_cast<size_t>(r) * w * C;
    const bf16* dyrow = dyimg + static_cast<size_t>(r) * w * C;
    for (int u = warp; u < CT + 9 * NT * NT + CT * NT; u += kWarps) {
      if (u < CT) {
        // 16 channels jc of dw3, db3 and dx: y3 again from Y2I, dy3.
        const int jc = u;
        FragC dw3[NT];
#pragma unroll
        for (int n = 0; n < NT; ++n)
          wmma::load_matrix_sync(dw3[n], g_dw3 + n * 16 * C + jc * 16, C,
                                 wmma::mem_row_major);
        float db3s = 0.0f;
        for (int p = 0; p < g.np; ++p) {
          const int sa = a0 + 16 * p, c0 = g.cb + 16 * p;
          const bf16* y2p = Y2I + sa * static_cast<size_t>(LD);
          FragC acc3;
          wmma::fill_fragment(acc3, 0.0f);
#pragma unroll
          for (int k = 0; k < NT; ++k) {
            FragA a;
            wmma::load_matrix_sync(a, y2p + k * 16, LD);
            FragB b;
            wmma::load_matrix_sync(
                b, w3 + static_cast<size_t>(k) * 16 * C + jc * 16, C);
            wmma::mma_sync(acc3, a, b, acc3);
          }
          wmma::store_matrix_sync(stage, acc3, 16, wmma::mem_row_major);
          __syncwarp();
          const bool live = c0 + pr < w;
          const size_t pix =
              static_cast<size_t>(live ? c0 + pr : w - 1) * C + jc * 16 + pc;
          float d3[8];
          dy3_chunk(stage, dy3t, xrow, dyrow, b3, pix, jc * 16 + pc, lane,
                    live, d3);
          __syncwarp();
          if (lane < 16) db3s += column_sum(stage, lane);
          FragB bd;
          wmma::load_matrix_sync(bd, dy3t, 16);
#pragma unroll
          for (int n = 0; n < NT; ++n) {
            FragAt at;  // y2^T: element (i, pixel)
            wmma::load_matrix_sync(at, y2p + n * 16, LD);
            wmma::mma_sync(dw3[n], at, bd, dw3[n]);
          }
          FragC ax;
          wmma::fill_fragment(ax, 0.0f);
          const bf16* d1p = DC1 + sa * static_cast<size_t>(LD);
#pragma unroll
          for (int k = 0; k < NT; ++k) {
            FragA a;
            wmma::load_matrix_sync(a, d1p + k * 16, LD);
            FragBt bt;  // w1^T: element (o, c) is w1[c, o]
            wmma::load_matrix_sync(
                bt, w1 + static_cast<size_t>(jc) * 16 * M + k * 16, M);
            wmma::mma_sync(ax, a, bt, ax);
          }
          __syncwarp();  // the column sums have read the stage
          wmma::store_matrix_sync(stage, ax, 16, wmma::mem_row_major);
          __syncwarp();
          const float* s = stage + pr * 16 + pc;
          Pack8 pack;
#pragma unroll
          for (int i = 0; i < 4; ++i)
            pack.h[i] = __floats2bfloat162_rn(d3[2 * i] + s[2 * i],
                                              d3[2 * i + 1] + s[2 * i + 1]);
          if (live) *reinterpret_cast<uint4*>(dxrow + pix) = pack.v;
          __syncwarp();
        }
#pragma unroll
        for (int n = 0; n < NT; ++n)
          wmma::store_matrix_sync(g_dw3 + n * 16 * C + jc * 16, dw3[n], C,
                                  wmma::mem_row_major);
        if (lane < 16) g_db3[jc * 16 + lane] += db3s;
      } else if (u < CT + 9 * NT * NT) {
        // a 16x16 tile (i0, o0) of dw2[ky, kx] += shift(y1)^T dc2, row r
        const int v = u - CT, k = v / (NT * NT);
        const int i0 = (v % (NT * NT)) / NT * 16, o0 = (v % NT) * 16;
        const int ky = k / 3, kx = k % 3;
        float* gp = g_dw2 + static_cast<size_t>(k) * M * M + i0 * M + o0;
        FragC acc;
        wmma::load_matrix_sync(acc, gp, M, wmma::mem_row_major);
        for (int p = 0; p < g.np; ++p) {
          const int sa = a0 + 16 * p;
          FragAt at;  // element (i, pixel c) is y1[r + ky - 1, c + kx - 1, i]
          wmma::load_matrix_sync(
              at, Y1 + ((ky + 1) * wp + sa + kx - 1) * static_cast<size_t>(LD) +
                      i0,
              LD);
          FragB b;
          wmma::load_matrix_sync(
              b, DC2 + (wp + sa) * static_cast<size_t>(LD) + o0, LD);
          wmma::mma_sync(acc, at, b, acc);
        }
        wmma::store_matrix_sync(gp, acc, M, wmma::mem_row_major);
      } else {
        // a 16x16 tile (ci, o0) of dw1 += x^T dc1, row r
        const int v = u - CT - 9 * NT * NT;
        const int ci = v / NT, o0 = (v % NT) * 16;
        float* gp = g_dw1 + static_cast<size_t>(ci) * 16 * M + o0;
        FragC acc;
        wmma::load_matrix_sync(acc, gp, M, wmma::mem_row_major);
        for (int p = 0; p < g.np; ++p) {
          const int c0 = g.cb + 16 * p, valid = valid_pixels(c0, w);
          const bf16* xa = xrow + static_cast<size_t>(c0) * C + ci * 16;
          FragAt at;  // element (c, pixel) is x[r, pixel, c]
          if (valid == 16) {
            wmma::load_matrix_sync(at, xa, C);
          } else {  // staged through the warp's (idle) dy3 tile
            stage_tile(xa, C, valid, dy3t, lane);
            wmma::load_matrix_sync(at, dy3t, 16);
            __syncwarp();
          }
          FragB b;
          wmma::load_matrix_sync(
              b, DC1 + (a0 + 16 * p) * static_cast<size_t>(LD) + o0, LD);
          wmma::mma_sync(acc, at, b, acc);
        }
        wmma::store_matrix_sync(gp, acc, M, wmma::mem_row_major);
      }
    }
    __syncthreads();  // the next tile rewrites the shared rows
  }
}

// out[i] = sum over the workspace's slices, in slice order.
__global__ void sum_slices(const float* __restrict__ ws,
                           float* __restrict__ out, int parts, size_t s) {
  const size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x;
  if (i >= s) return;
  float acc = 0.0f;
  for (int p = 0; p < parts; ++p) acc += ws[p * s + i];
  out[i] = acc;
}

template <int M>
int launch(const void* x, const void* dy, const void* w1, const float* b1,
           const void* w2, const float* b2, const void* w3, const float* b3,
           void* dx, float* ws, float* grads, int batch, int h, int w,
           int parts, size_t limit, cudaStream_t stream) {
  const Plan p = plan<M>(w, limit);
  if (p.wc == 0) return static_cast<int>(cudaErrorInvalidValue);
  // fails (cudaErrorInvalidValue) past the card's per-block limit
  cudaError_t err = cudaFuncSetAttribute(
      bottleneck_bwd_kernel<M>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(p.smem));
  if (err != cudaSuccess) {
    cudaGetLastError();  // not left for the next launch's check to find
    return static_cast<int>(err);
  }
  bottleneck_bwd_kernel<M><<<parts, kThreads, p.smem, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(dy),
      static_cast<const bf16*>(w1), b1, static_cast<const bf16*>(w2), b2,
      static_cast<const bf16*>(w3), b3, static_cast<bf16*>(dx), ws, batch, h,
      w, p.wc, p.nwmax);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t s = slice_floats<M>();
  sum_slices<<<static_cast<unsigned>((s + 255) / 256), 256, 0, stream>>>(
      ws, grads, parts, s);
  return static_cast<int>(cudaGetLastError());
}

// The shared memory a block of `device` may take, or < 0 (a cudaError_t).
long long smem_limit(int device) {
  int limit = 0;
  const cudaError_t err = cudaDeviceGetAttribute(
      &limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  return err == cudaSuccess ? limit : -static_cast<long long>(err);
}

}  // namespace

// Launches the backward and the slice sum on `stream` of `device`; returns
// a cudaError_t (0 = ok). ws holds parts x S floats (uninitialised), grads
// S floats in the layout above. The caller guarantees batch, h, w >= 1,
// 1 <= parts and the requirements above.
extern "C" int detjax_bottleneck_bwd_launch(
    const void* x, const void* dy, const void* w1, const float* b1,
    const void* w2, const float* b2, const void* w3, const float* b3, void* dx,
    float* ws, float* grads, int batch, int h, int w, int m, int parts,
    int device, void* stream) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long limit = smem_limit(device);
  if (limit < 0) return static_cast<int>(-limit);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define DETJAX_BWD(MM)                                                      \
  case MM:                                                                  \
    return launch<MM>(x, dy, w1, b1, w2, b2, w3, b3, dx, ws, grads, batch, \
                      h, w, parts, static_cast<size_t>(limit), s);
  switch (m) {
    DETJAX_BWD(16)
    DETJAX_BWD(32)
    DETJAX_BWD(64)
    DETJAX_BWD(128)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef DETJAX_BWD
}

// How the launcher tiles a row of width w at M = m on `device`: writes the
// column-block width (w rounded up to whole tiles when the row fits whole;
// 0 when nothing fits) and the dynamic shared memory of a block; returns a
// cudaError_t.
extern "C" int detjax_bottleneck_bwd_plan(int w, int m, int device, int* wc,
                                          int* smem) {
  const long long limit = smem_limit(device);
  if (limit < 0) return static_cast<int>(-limit);
  Plan p = {0, 0, 0};
  switch (m) {
    case 16: p = plan<16>(w, static_cast<size_t>(limit)); break;
    case 32: p = plan<32>(w, static_cast<size_t>(limit)); break;
    case 64: p = plan<64>(w, static_cast<size_t>(limit)); break;
    case 128: p = plan<128>(w, static_cast<size_t>(limit)); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  *wc = p.wc;
  *smem = static_cast<int>(p.smem);
  return 0;
}

// Floats in one workspace slice (and in the summed gradients) at M = m.
extern "C" int detjax_bottleneck_bwd_slice_floats(int m) {
  switch (m) {
    case 16: return static_cast<int>(slice_floats<16>());
    case 32: return static_cast<int>(slice_floats<32>());
    case 64: return static_cast<int>(slice_floats<64>());
    case 128: return static_cast<int>(slice_floats<128>());
    default: return 0;
  }
}
