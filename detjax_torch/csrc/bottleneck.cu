// Fused ResNet identity bottleneck, forward, for Hopper (sm_90a).
//
// Replaces the TPU kernel detjax/kernels/bottleneck.py::_bottleneck_fwd
// (line 131; body _fwd_kernel). Same function: for a stride-1 identity block
// with its frozen BatchNorms folded into the convs,
//   y1  = bf16(relu(x @ w1 + b1))                 1x1, C -> M
//   y2  = bf16(relu(conv3x3(y1, w2, pad 1) + b2))  3x3, M -> M
//   out = bf16(relu((y2 @ w3 + b3) + x))          1x1, M -> C, residual
// with fp32 accumulation throughout, x and out NHWC bf16, w1 [C, M], w2
// [3, 3, M, M] (HWIO), w3 [M, C] bf16, biases fp32. y2 never reaches device
// memory.
//
// Design: two kernels a call on the caller's stream, over the B H W pixels
// cut into flat 128-pixel tiles (one image after another; a tile may
// straddle rows and images), as the backward's activation kernels cut them:
//   1. y1_kernel (bottleneck_common.cuh, the backward's own): y1 to a
//      transient bf16 scratch [B H W, M] (the wrapper's torch.empty, freed
//      after the call).
//   2. fwd_tile_kernel: per tile, y2 (tile_y2: the 3x3 as nine shifted
//      K-major A tiles of y1 read back with their halo, zero outside the
//      image, against w2's rows staged once a tile) into shared memory;
//      then C in 64-channel chunks: y3 = y2 @ w3's staged chunk
//      (chunk_y3), and the epilogue on the accumulator registers (+ b3, +
//      the chunk of x, ReLU, bf16), stored as 16-byte vectors. Each chunk
//      of w3 and of x arrives by cp.async while the chunk before it is
//      computed.
// No pixel is recomputed: halo rows of y1 come back from L2. Every product
// is wgmma.m64n64k16 from 128-byte-swizzled shared tiles (the layout is at
// "wgmma" in bottleneck_common.cuh), two warpgroups of 64 pixel rows a
// tile; shared memory does not depend on W, and the tile kernel asks for
// two blocks an SM where its shared memory allows (M <= 64). The backward
// runs the same y1_kernel, tile_y2 and chunk_y3, so the pre-activation
// (y2 @ w3 + b3) + x here equals, bit for bit, the one its ReLU mask reads.
//
// What bounds it: bytes, at the main path's shapes. Reading x and writing
// out once is 210 MB for layer1 at B=8 (0.063 ms at 3.35 TB/s) against 28.5
// GFLOP of tensor-core work (0.029 ms at 989 TFLOP/s); layer2 is 105 MB
// (0.031 ms) against the same operations. What this design does about it:
// y2 stays on chip and x is read twice (by y1_kernel, then as the residual,
// often from L2); the y1 scratch adds 2 B H W M bf16 of traffic (written
// once, read once with its halo rows from L2): 52 MB at layer1, B=8, a
// quarter over the bound's bytes. What it leaves: each stage's products
// are waited out before the next copy (one wgmma group in flight), and
// the y1 round trip; times are in PERF.md.
//
// Requirements (the wrapper checks them): M in {16, 32, 64, 128}, C = 4 M,
// contiguous 32-byte-aligned bf16 tensors, fp32 biases, any W >= 1.

#include "bottleneck_common.cuh"

namespace {

// From the 1024-byte boundary: region_tile (the 3x3's stages, then w3
// [2][atoms][64 rows x 128 bytes], out [kAtom] and x [2][kTP][kNC + kPad]),
// y2 [atoms][kAtom] and the tile's coordinates.
template <int M>
__host__ __device__ constexpr size_t smem_fwd() {
  return 1024 + region_tile<M>() + atoms<M>() * kAtom + 2 * kTP * sizeof(int);
}

// One 128-pixel tile, two warpgroups of 64 pixel rows: y2 by tile_y2, then
// out chunk by chunk.
template <int M>
__global__ void __launch_bounds__(kThreads, M <= 64 ? 2 : 1)
    fwd_tile_kernel(const bf16* __restrict__ x, const bf16* __restrict__ y1,
                    const bf16* __restrict__ w2, const float* __restrict__ b2,
                    const bf16* __restrict__ w3, const float* __restrict__ b3,
                    bf16* __restrict__ out, int np, int h, int w) {
  constexpr int C = 4 * M, NA = atoms<M>(), LDN = kNC + kPad;
  constexpr int NCH = C / kNC, STAGE = NA * 64 * 128;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* sm = smem_1k(smem_raw);
  unsigned char* W3s = sm;              // [2][STAGE]: w3 rows, after the 3x3
  unsigned char* Os = sm + 2 * STAGE;   // [kAtom]: out of a chunk
  bf16* Xs = reinterpret_cast<bf16*>(Os + kAtom);  // [2][kTP][LDN]
  unsigned char* Y2s = sm + region_tile<M>();      // [NA][kAtom]
  int* prow = reinterpret_cast<int*>(Y2s + NA * kAtom);
  int* pcol = prow + kTP;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const uint32_t grow = (warp >> 2) * 64 * 128;  // the warpgroup's 64 rows
  const int row0 = 16 * warp + (lane >> 2);      // rows row0, row0 + 8
  const int q2 = 2 * (lane & 3);                 // columns 8 j + q2, + 1
  const int p0 = blockIdx.x * kTP;

  tile_coords(prow, pcol, p0, np, h, w);
  __syncthreads();

  // -- y2 = bf16(relu(sum_k shift_k(y1) @ w2[k] + b2)), into Y2s
  tile_y2<M>(sm, Y2s, y1, w2, b2, p0, prow, pcol, h, w);

  // -- per 64-channel chunk of C: out = bf16(relu((y2 @ w3 + b3) + x)); the
  // chunk's rows of w3 and its x arrive one chunk ahead
  auto load_c = [&](int n, int s) {
    load_w3_chunk<M>(W3s + s * STAGE, w3, n);
    load_chunk(Xs + s * kTP * LDN, x, C, n * kNC, p0, np);
    cp_commit();
  };
  load_c(0, 0);
  for (int n = 0; n < NCH; ++n) {
    if (n + 1 < NCH) {
      load_c(n + 1, (n + 1) & 1);
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    proxy_fence();
    __syncthreads();  // the chunk's w3 and x landed
    float acc3[32];
    chunk_y3<M>(acc3, saddr(Y2s), saddr(W3s + (n & 1) * STAGE), grow);
    const bf16* xs = Xs + (n & 1) * kTP * LDN;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int cl = 8 * j + q2, ch = n * kNC + cl;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int r = row0 + 8 * e;
        const float2 xf = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(xs + r * LDN + cl));
        put2(Os, r, cl,
             fmaxf((acc3[4 * j + 2 * e] + b3[ch]) + xf.x, 0.0f),
             fmaxf((acc3[4 * j + 2 * e + 1] + b3[ch + 1]) + xf.y, 0.0f));
      }
    }
    __syncthreads();  // this chunk of out complete
    store_tile<kNC>(out, C, n * kNC, Os, p0, np);
    __syncthreads();  // before the next chunk's copy rewrites this stage
  }
}

template <int M>
int launch(const bf16* x, const bf16* w1, const float* b1, const bf16* w2,
           const float* b2, const bf16* w3, const float* b3, bf16* y1,
           bf16* out, int batch, int h, int w, cudaStream_t stream,
           int* launched) {
  const int np = batch * h * w, tiles = (np + kTP - 1) / kTP;
  cudaError_t err;
  if ((err = allow_smem(y1_kernel<M>, smem_y1<M>())) != cudaSuccess ||
      (err = allow_smem(fwd_tile_kernel<M>, smem_fwd<M>())) != cudaSuccess)
    return static_cast<int>(err);
  // each launch the runtime accepted adds one to *launched
  auto accepted = [&]() {
    err = cudaGetLastError();
    if (err == cudaSuccess) ++*launched;
    return err == cudaSuccess;
  };
  y1_kernel<M><<<tiles, kThreads, smem_y1<M>(), stream>>>(x, w1, b1, y1, np);
  if (!accepted()) return static_cast<int>(err);
  fwd_tile_kernel<M><<<tiles, kThreads, smem_fwd<M>(), stream>>>(
      x, y1, w2, b2, w3, b3, out, np, h, w);
  accepted();
  return static_cast<int>(err);
}

}  // namespace

// Launches the two kernels on `stream` of `device`, adding one to *launched
// for each launch the runtime accepted; returns a cudaError_t (0 = ok: both
// launched). y1: scratch [B H W, M] bf16 (uninitialised). The caller
// guarantees batch, h, w >= 1 and the requirements above.
extern "C" int detjax_bottleneck_fwd_launch(
    const void* x, const void* w1, const float* b1, const void* w2,
    const float* b2, const void* w3, const float* b3, void* y1, void* out,
    int batch, int h, int w, int m, int device, void* stream, int* launched) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define DETJAX_FWD(MM)                                                       \
  case MM:                                                                   \
    return launch<MM>(static_cast<const bf16*>(x),                           \
                      static_cast<const bf16*>(w1), b1,                      \
                      static_cast<const bf16*>(w2), b2,                      \
                      static_cast<const bf16*>(w3), b3,                      \
                      static_cast<bf16*>(y1), static_cast<bf16*>(out), batch, \
                      h, w, s, launched);
  switch (m) {
    DETJAX_FWD(16)
    DETJAX_FWD(32)
    DETJAX_FWD(64)
    DETJAX_FWD(128)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef DETJAX_FWD
}

// The launcher's geometry at M = m, for the wrapper to check its own copy
// against once: out[0..2] = pixels a tile, and the dynamic shared memory of
// y1_kernel and of fwd_tile_kernel. Returns 0, or cudaErrorInvalidValue for
// another m.
extern "C" int detjax_bottleneck_fwd_geometry(int m, int* out) {
#define DETJAX_GEOM(MM)                         \
  case MM:                                      \
    out[1] = static_cast<int>(smem_y1<MM>());   \
    out[2] = static_cast<int>(smem_fwd<MM>());  \
    break;
  switch (m) {
    DETJAX_GEOM(16)
    DETJAX_GEOM(32)
    DETJAX_GEOM(64)
    DETJAX_GEOM(128)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef DETJAX_GEOM
  out[0] = kTP;
  return 0;
}
