// Fused ResNet identity bottleneck, forward, for Hopper (sm_90a).
//
// Replaces the TPU kernel detjax/kernels/bottleneck.py::_bottleneck_fwd
// (line 131; body _fwd_kernel). Same function: for a stride-1 identity block
// with its frozen BatchNorms folded into the convs,
//   y1  = bf16(relu(x @ w1 + b1))                 1x1, C -> M
//   y2  = bf16(relu(conv3x3(y1, w2, pad 1) + b2))  3x3, M -> M
//   out = bf16(relu((y2 @ w3 + b3) + x))          1x1, M -> C, residual
// with fp32 accumulation throughout, x and out NHWC bf16, w1 [C, M], w2
// [3, 3, M, M] (HWIO), w3 [M, C] bf16, biases fp32. y1 and y2 never reach
// device memory.
//
// Design: one block per (kRows output rows, image); grid (ceil(H / kRows),
// B), kWarps warps. Phase 1 computes y1 for the block's rows plus one halo
// row above and below into shared memory, laid out as (kRows + 2) rows of
// 16 ceil(W / 16) + 2 pixels with zeroed border columns; a halo row outside
// the image is left all zero, which is exactly the 3x3's zero padding. When
// W is not a multiple of 16 the last tile of a row is a masked tail: its
// pixels at or beyond W load x as zeros (staged through the warp's y2
// tile), get y1 = 0 (so column W still acts as the padding) and are never
// stored. Phase 2 gives each
// warp 16-pixel tiles of the output rows: the 3x3 as nine shifted products
// read straight from the shared y1 (a shift by kx is a pointer offset of one
// pixel), y2 for the tile into the warp's own shared tile, then the second
// 1x1, the bias, the residual and the ReLU, stored as 16-byte vectors. All
// products are nvcuda::wmma 16x16x16 bf16 fragments with fp32 accumulators;
// the A operand comes from x in global memory (phase 1) or from shared
// memory (phase 2), the B operand (the weights) from global memory, where
// L1 and the 50 MB L2 hold them (layer2's w2 alone is 288 KB).
//
// What bounds it: bytes, at the main path's shapes. Reading x and writing
// out once is 210 MB for layer1 at B=8 (0.063 ms at 3.35 TB/s) against 28.5
// GFLOP of tensor-core work (0.029 ms at 989 TFLOP/s); layer2 is 105 MB
// (0.031 ms) against the same operations. What this design does about it:
// the intermediates stay on chip, so device memory sees x (once, its halo
// rows again from L2, the residual again from L2) and out only. What it
// leaves: conv1 is recomputed on the two halo rows of every block (2x conv1
// work at kRows = 2), wmma through mma.sync reaches only part of Hopper's
// tensor-core rate (wgmma is needed for the rest), fragments of the weights
// are reloaded from L1/L2 by every warp, and one block fills an SM (about
// 140-150 KB of shared memory). wgmma, TMA and a persistent schedule belong
// to a later PR.
//
// Requirements (the wrapper checks them): M in {16, 32, 64, 128}, C = 4 M,
// contiguous 32-byte-aligned bf16 tensors. Any W >= 1 up to the widest row
// whose shared memory fits a block (detjax_bottleneck_max_width).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

namespace {

using namespace nvcuda;
using bf16 = __nv_bfloat16;
using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>;
using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

constexpr int kRows = 2;    // output rows per block
constexpr int kWarps = 10;  // 20 (layer1) or 10 (layer2) 16-pixel tiles
constexpr int kThreads = 32 * kWarps;
constexpr int kPad = 16;  // extra bf16 per pixel in shared memory: keeps
                          // 32-byte alignment, spreads banks

// Bias, ReLU and bf16 rounding of one 16x16 fp32 tile staged in `stage`
// (row-major), written to `dst` (row stride ld elements); rows (pixels) at
// or beyond `valid` are written as zeros. Each lane takes 8 consecutive
// columns of one row: row lane / 2, columns (lane % 2) * 8.
__device__ __forceinline__ void store_relu_bf16(const float* stage,
                                                const float* bias, bf16* dst,
                                                int ld, int lane,
                                                int valid = 16) {
  const int r = lane >> 1, c = (lane & 1) * 8;
  const float* s = stage + r * 16 + c;
  union {
    uint4 v;
    __nv_bfloat162 h[4];
  } pack;
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
// (pixel stride 16), pixels at or beyond `valid` as zeros: the A operand of
// a masked tail tile.
__device__ __forceinline__ void stage_tile(const bf16* src, int ld, int valid,
                                           bf16* dst, int lane) {
  const int p = lane >> 1, c = (lane & 1) * 8;
  uint4 v = make_uint4(0u, 0u, 0u, 0u);
  if (p < valid)
    v = *reinterpret_cast<const uint4*>(src + static_cast<size_t>(p) * ld + c);
  *reinterpret_cast<uint4*>(dst + p * 16 + c) = v;
  __syncwarp();
}

template <int M>
__global__ void __launch_bounds__(kThreads)
    bottleneck_fwd_kernel(const bf16* __restrict__ x,    // [B, H, W, C]
                          const bf16* __restrict__ w1,   // [C, M]
                          const float* __restrict__ b1,  // [M]
                          const bf16* __restrict__ w2,   // [3, 3, M, M]
                          const float* __restrict__ b2,  // [M]
                          const bf16* __restrict__ w3,   // [M, C]
                          const float* __restrict__ b3,  // [C]
                          bf16* __restrict__ out,        // [B, H, W, C]
                          int h, int w) {
  constexpr int C = 4 * M;
  constexpr int LD = M + kPad;  // bf16 per pixel in shared memory
  constexpr int NT = M / 16;    // 16-column tiles of y1 and y2
  constexpr int kVecPix = LD * 2 / 16;  // uint4 per shared pixel

  extern __shared__ __align__(128) unsigned char smem[];
  const int tiles_per_row = (w + 15) / 16;  // the last one may be a tail
  const int wp = 16 * tiles_per_row + 2;  // y1 pixels a row, with borders
  bf16* y1p = reinterpret_cast<bf16*>(smem);
  const size_t y1_elems = static_cast<size_t>(kRows + 2) * wp * LD;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  bf16* y2t = y1p + y1_elems + static_cast<size_t>(warp) * 16 * LD;
  float* stage = reinterpret_cast<float*>(y1p + y1_elems +
                                          static_cast<size_t>(kWarps) * 16 *
                                              LD) +
                 warp * 256;

  const int img = blockIdx.y;
  const int r0 = blockIdx.x * kRows;  // first output row of the block
  const size_t img_off = static_cast<size_t>(img) * h * w * C;
  const bf16* ximg = x + img_off;
  bf16* oimg = out + img_off;

  // -- zero the border columns, and whole halo rows outside the image.
  uint4* y1v = reinterpret_cast<uint4*>(y1p);
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  for (int j = 0; j < kRows + 2; ++j) {
    const int r = r0 - 1 + j;
    uint4* row = y1v + static_cast<size_t>(j) * wp * kVecPix;
    if (r < 0 || r >= h) {
      for (int i = threadIdx.x; i < wp * kVecPix; i += kThreads) row[i] = zero;
    } else {
      for (int i = threadIdx.x; i < 2 * kVecPix; i += kThreads) {
        const int col = i < kVecPix ? 0 : wp - 1;
        row[col * kVecPix + i % kVecPix] = zero;
      }
    }
  }

  // -- phase 1: y1 = bf16(relu(x @ w1 + b1)) on rows r0 - 1 .. r0 + kRows.
  for (int t = warp; t < (kRows + 2) * tiles_per_row; t += kWarps) {
    const int j = t / tiles_per_row, c0 = (t % tiles_per_row) * 16;
    const int r = r0 - 1 + j;
    if (r < 0 || r >= h) continue;  // stays zero: the 3x3's padding
    const int valid = w - c0 < 16 ? w - c0 : 16;  // pixels in the image
    FragC acc[NT];
#pragma unroll
    for (int n = 0; n < NT; ++n) wmma::fill_fragment(acc[n], 0.0f);
    const bf16* xa = ximg + (static_cast<size_t>(r) * w + c0) * C;
    for (int k = 0; k < C; k += 16) {
      FragA a;
      if (valid == 16) {
        wmma::load_matrix_sync(a, xa + k, C);
      } else {  // the tail: staged through the warp's (idle) y2 tile
        stage_tile(xa + k, C, valid, y2t, lane);
        wmma::load_matrix_sync(a, y2t, 16);
        __syncwarp();
      }
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        FragB b;
        wmma::load_matrix_sync(b, w1 + static_cast<size_t>(k) * M + n * 16,
                               M);
        wmma::mma_sync(acc[n], a, b, acc[n]);
      }
    }
    bf16* dst = y1p + (static_cast<size_t>(j) * wp + c0 + 1) * LD;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      wmma::store_matrix_sync(stage, acc[n], 16, wmma::mem_row_major);
      __syncwarp();
      store_relu_bf16(stage, b1 + n * 16, dst + n * 16, LD, lane, valid);
      __syncwarp();
    }
  }
  __syncthreads();

  // -- phase 2: per 16-pixel tile of the output rows, the 3x3 into the
  // warp's y2 tile, then the second 1x1, the residual and the ReLU.
  for (int t = warp; t < kRows * tiles_per_row; t += kWarps) {
    const int j = t / tiles_per_row, c0 = (t % tiles_per_row) * 16;
    const int r = r0 + j;
    if (r >= h) continue;  // the ragged last row tile
    FragC acc[NT];
#pragma unroll
    for (int n = 0; n < NT; ++n) wmma::fill_fragment(acc[n], 0.0f);
    for (int ky = 0; ky < 3; ++ky) {
      for (int kx = 0; kx < 3; ++kx) {
        // output pixel (r, c) reads y1 at (r + ky - 1, c + kx - 1), which
        // is shared row j + ky, shared column c + kx
        const bf16* ya = y1p + (static_cast<size_t>(j + ky) * wp + c0 + kx) *
                                   LD;
        const bf16* wt = w2 + static_cast<size_t>(ky * 3 + kx) * M * M;
        for (int k = 0; k < M; k += 16) {
          FragA a;
          wmma::load_matrix_sync(a, ya + k, LD);
#pragma unroll
          for (int n = 0; n < NT; ++n) {
            FragB b;
            wmma::load_matrix_sync(b, wt + static_cast<size_t>(k) * M + n * 16,
                                   M);
            wmma::mma_sync(acc[n], a, b, acc[n]);
          }
        }
      }
    }
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      wmma::store_matrix_sync(stage, acc[n], 16, wmma::mem_row_major);
      __syncwarp();
      store_relu_bf16(stage, b2 + n * 16, y2t + n * 16, LD, lane);
      __syncwarp();
    }

    FragA a2[NT];
#pragma unroll
    for (int k = 0; k < NT; ++k) wmma::load_matrix_sync(a2[k], y2t + k * 16, LD);
    const int pr = lane >> 1, pc = (lane & 1) * 8;
    const bool live = c0 + pr < w;  // the lane's pixel is in the image
    // a pixel past W reads the row's last one (unconditional loads) and is
    // not stored
    const size_t pix =
        (static_cast<size_t>(r) * w + (live ? c0 + pr : w - 1)) * C;
    for (int n3 = 0; n3 < C / 16; ++n3) {
      FragC acc3;
      wmma::fill_fragment(acc3, 0.0f);
#pragma unroll
      for (int k = 0; k < NT; ++k) {
        FragB b;
        wmma::load_matrix_sync(
            b, w3 + static_cast<size_t>(k) * 16 * C + n3 * 16, C);
        wmma::mma_sync(acc3, a2[k], b, acc3);
      }
      wmma::store_matrix_sync(stage, acc3, 16, wmma::mem_row_major);
      __syncwarp();
      const int ch = n3 * 16 + pc;
      const float* s = stage + pr * 16 + pc;
      union {
        uint4 v;
        __nv_bfloat162 h[4];
      } res, pack;
      res.v = *reinterpret_cast<const uint4*>(ximg + pix + ch);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 xr = __bfloat1622float2(res.h[i]);
        const float a = fmaxf((s[2 * i] + b3[ch + 2 * i]) + xr.x, 0.0f);
        const float b = fmaxf((s[2 * i + 1] + b3[ch + 2 * i + 1]) + xr.y, 0.0f);
        pack.h[i] = __floats2bfloat162_rn(a, b);
      }
      if (live) *reinterpret_cast<uint4*>(oimg + pix + ch) = pack.v;
      __syncwarp();
    }
  }
}

// Dynamic shared memory of one block: y1 for the block's rows plus two halo
// rows (whole 16-pixel tiles and two border columns, LD bf16 a pixel), and
// per warp a 16-pixel y2 tile and a 16x16 fp32 staging tile.
template <int M>
size_t smem_bytes(int w) {
  constexpr int LD = M + kPad;
  return static_cast<size_t>(kRows + 2) * (16 * ((w + 15) / 16) + 2) * LD *
             sizeof(bf16) +
         static_cast<size_t>(kWarps) * (16 * LD * sizeof(bf16) + 256 * 4);
}

template <int M>
int launch(const void* x, const void* w1, const float* b1, const void* w2,
           const float* b2, const void* w3, const float* b3, void* out,
           int batch, int h, int w, cudaStream_t stream) {
  const size_t smem = smem_bytes<M>(w);
  if (smem > 48 * 1024) {
    // fails (cudaErrorInvalidValue) past the card's per-block limit
    const cudaError_t err = cudaFuncSetAttribute(
        bottleneck_fwd_kernel<M>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((h + kRows - 1) / kRows, batch);
  bottleneck_fwd_kernel<M><<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w1), b1,
      static_cast<const bf16*>(w2), b2, static_cast<const bf16*>(w3), b3,
      static_cast<bf16*>(out), h, w);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches on `stream` of `device`; returns a cudaError_t (0 = ok). The
// caller guarantees batch, h >= 1 and the requirements above.
extern "C" int detjax_bottleneck_fwd_launch(const void* x, const void* w1,
                                            const float* b1, const void* w2,
                                            const float* b2, const void* w3,
                                            const float* b3, void* out,
                                            int batch, int h, int w, int m,
                                            int device, void* stream) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (m) {
    case 16:
      return launch<16>(x, w1, b1, w2, b2, w3, b3, out, batch, h, w, s);
    case 32:
      return launch<32>(x, w1, b1, w2, b2, w3, b3, out, batch, h, w, s);
    case 64:
      return launch<64>(x, w1, b1, w2, b2, w3, b3, out, batch, h, w, s);
    case 128:
      return launch<128>(x, w1, b1, w2, b2, w3, b3, out, batch, h, w, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Dynamic shared memory a block takes at width w and M = m; 0 for an M the
// kernel is not instantiated for.
extern "C" int detjax_bottleneck_smem_bytes(int w, int m);

// The widest W whose block fits the shared memory a block of `device` may
// take at M = m (a multiple of 16); 0 for an unknown M, < 0 a cudaError_t.
extern "C" int detjax_bottleneck_max_width(int m, int device) {
  int limit = 0;
  const cudaError_t err = cudaDeviceGetAttribute(
      &limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return -static_cast<int>(err);
  if (detjax_bottleneck_smem_bytes(16, m) <= 0) return 0;
  int w = 0;
  while (detjax_bottleneck_smem_bytes(w + 16, m) <= limit) w += 16;
  return w;
}

extern "C" int detjax_bottleneck_smem_bytes(int w, int m) {
  switch (m) {
    case 16:
      return static_cast<int>(smem_bytes<16>(w));
    case 32:
      return static_cast<int>(smem_bytes<32>(w));
    case 64:
      return static_cast<int>(smem_bytes<64>(w));
    case 128:
      return static_cast<int>(smem_bytes<128>(w));
    default:
      return 0;
  }
}
