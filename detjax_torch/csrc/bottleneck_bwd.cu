// Fused ResNet identity bottleneck, backward, for Hopper (sm_90a).
//
// Replaces the TPU kernel detjax/kernels/bottleneck.py::_bottleneck_bwd
// (line 270; body _bwd_kernel, line 156). Same function: from x, the output's
// gradient dy and the BN-folded weights of the forward (bottleneck.cu),
// recompute y1 and y2 and produce
//   dy3 = dy * ((y2 @ w3 + b3) + x > 0)                 fp32
//   dc2 = (bf16(dy3) @ w3^T) * (y2 > 0)                 fp32
//   dy1 = sum_k shift_k(bf16(dc2)) @ w2[k]^T            the transposed 3x3
//   dc1 = dy1 * (y1 > 0)                                fp32
//   dx  = bf16(dy3 + bf16(dc1) @ w1^T)                  residual term unrounded
//   dw3 = sum y2^T bf16(dy3), dw2[k] = sum shift_k(y1)^T bf16(dc2),
//   dw1 = sum x^T bf16(dc1), db3/db2/db1 = sum dy3 / dc2 / dc1   all fp32
// with every product a bf16 x bf16 -> fp32 product, as _bwd_kernel rounds.
//
// Design: two passes. Every operand of a weight gradient is a bf16 tensor
// (x, y1, y2, bf16(dy3), bf16(dc2), bf16(dc1)), so the activation pass
// writes them to scratch in device memory (the wrapper's torch.empty, freed
// after the call) without changing a bit, and the weight gradients become
// plain GEMMs over all B H W pixels. dy3 is dy masked, so bf16(dy3) = dy3:
// dx and db3 read either. Five launches, all on the caller's stream:
//   1. y1_kernel:  y1 = bf16(relu(x @ w1 + b1)), per 128-pixel tile.
//   2. dc2_kernel: per 128-pixel tile, y2 (the 3x3 over y1 read back with
//      its halo; zero outside the image), then C in 64-channel chunks:
//      y3, the dy3 mask, bf16(dy3) and dc2 += bf16(dy3) @ w3^T, the chunk
//      of w3 staged once and used for both products; writes y2, bf16(dy3)
//      and bf16(dc2), and the tile's column sums of dy3 and dc2.
//   3. dc1_kernel: per tile, dy1 (the transposed 3x3 over bf16(dc2) read
//      back with its halo), dc1, then dx chunk by chunk; writes bf16(dc1)
//      and dx, and the tile's column sums of dc1.
//   4. wgrad_kernel: split-K GEMMs for dw1, dw2 (one job per tap and
//      64x64 tile: the shift is an address offset, zero at the image's
//      borders) and dw3, on wgmma. Grid (jobs, parts): part j reduces its
//      contiguous pixel range with the sums in registers and writes its
//      fp32 partial once, to its own slice of a workspace.
//   5. sum_rows: the parts' slices, and the tiles' bias sums, in a fixed
//      order. No atomics: two runs give equal bits.
// y1_kernel, dc2_kernel's y2 (tile_y2) and its y3 (chunk_y3) are the
// forward's own code, in bottleneck_common.cuh: the dy3 mask is taken on the
// forward's pre-activation (y2 @ w3 + b3) + x, bit for bit.
// No pixel is recomputed: each tile owns its pixels, halos are read from
// scratch. Halo pixels come back from L2 (the 3x3 reads y1 or bf16(dc2)
// three rows wide). y1 goes to scratch whatever the split (dw2 and dc1's
// mask read it), so folding y1_kernel into dc2_kernel would save one read
// of y1 and its halo, against conv1 recomputed over the halo; that variant
// has not been timed.
//
// What the one-kernel design before this one (a persistent block per SM,
// one image row a tile, the products on 16-pixel wmma tiles) spent its
// time on, and what this one does about each:
//   1. Weight gradients flushed per row through a per-block fp32 workspace
//      slice (1.4 GB of traffic a launch at layer1, 2.9 GB at layer2; on
//      an H100 at 700 W, skipping it saved only 1.0 of 10.0 ms at layer1
//      and 0.4 of 9.8 at layer2, so items 2-4 held the rest): here each
//      part's partial sits in registers over its whole pixel range and is
//      written once a launch.
//   2. Weights streamed from L2 for every 16-pixel tile: here a weight
//      chunk is staged in shared memory once per 128-pixel tile (cp.async,
//      two stages) and serves all 128 pixels; w3's chunk serves y3 and dc2.
//   3. One-row tiles redid ~2.1x the products: here 1.0x.
//   4. Small tiles, no overlap: 128-pixel tiles, every weight copy a
//      cp.async two stages deep behind the products (dc1_kernel's
//      bf16(dy3) chunks too; four stages of 64 pixels in the weight
//      gradients), and the tile kernels ask for two blocks an SM where
//      their shared memory allows (M <= 64).
// Products: wgmma (m64n64k16, bf16 operands from 128-byte-swizzled shared
// tiles, fp32 sums in registers; the layout is at "wgmma" in
// bottleneck_common.cuh), in every kernel but sum_rows. A pixel's 64
// channels are one 128-byte swizzle row, so the 3x3's shifted rows land by
// 16-byte cp.async like any other row, as A (K-major: pixels x channels) in
// the tile kernels and as both operands (MN-major) in the weight
// gradients; each weight is read K-major or MN-major as its product needs,
// so w3's staged rows serve y3 and dc2 alike. A tile kernel's two
// warpgroups take 64 pixel rows each, and its epilogues (bias, ReLU masks,
// column sums by warp shuffles in a fixed order, bf16) work on the
// accumulator registers.
// y1_kernel's 1x1 product is wgmma the same way.
//
// What bounds it on an H100: at R50's training shapes (bs 16) bytes at
// layer1 (x and dy read once, dx written once: 629 MB, 0.188 ms at 3.35
// TB/s) and operations at layer2 (3x the forward's multiply-adds, 171
// GFLOP, 0.173 ms at 989 TFLOP/s). The scratch adds about 4 B H W M bf16
// written and read (y1, y2, bf16(dc2), bf16(dc1)) and B H W C of bf16(dy3):
// about 1.3 GB of extra traffic at layer1; times are in PERF.md.
//
// Requirements (the wrapper checks them): M in {16, 32, 64, 128}, C = 4 M,
// contiguous 32-byte-aligned bf16 tensors, fp32 biases.

#include "bottleneck_common.cuh"

namespace {

constexpr int kWThreads = 128;  // weight-gradient kernel: one warpgroup
constexpr int kKP = 64;         // pixels a stage of the weight gradients

// In an accumulator of m64nNk16 (warp w of a warpgroup, lane l),
// d[4 j + 2 e + i] is row 16 w + l / 4 + 8 e, column 8 j + 2 (l % 4) + i.
// The sum of a column over the warp's 16 rows, in a fixed order: v is this
// thread's two rows' sum; the xor steps add the warp's 8 row groups.
__device__ __forceinline__ float warp_rows_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 4);
  v += __shfl_xor_sync(0xffffffffu, v, 8);
  v += __shfl_xor_sync(0xffffffffu, v, 16);
  return v;
}

// ---- 1: y1 = bf16(relu(x @ w1 + b1)): y1_kernel, bottleneck_common.cuh ---

// ---- 2: y2, dy3, dc2 -----------------------------------------------------

// The shared memory of both tile kernels, from the 1024-byte boundary: the
// region of bottleneck_common.cuh's region_tile, then an [atoms][kAtom]
// tile, the column sums [kWarps][max(M, kNC)] fp32 and the tile's
// coordinates.
template <int M>
__host__ __device__ constexpr size_t smem_tile() {
  return 1024 + region_tile<M>() + atoms<M>() * kAtom +
         kWarps * (M > kNC ? M : kNC) * sizeof(float) + 2 * kTP * sizeof(int);
}

// One 128-pixel tile, two warpgroups of 64 pixel rows; every product is
// wgmma from SW128 tiles. Shared memory (region_tile): the 3x3's stages
// (tile_y2), then w3 [2][atoms][64 rows x 128 bytes], bf16(dy3) [kAtom],
// the x and dy chunks and, after the last chunk, bf16(dc2) [atoms][kAtom];
// then y2 [atoms][kAtom], the column sums and the tile's coordinates. M < 64
// runs the same 64-wide products: the columns past M hold whatever the
// unused shared memory held and are never stored or summed (a column of a
// product depends only on its own column of B), and the K steps stop at M.
template <int M>
__global__ void __launch_bounds__(kThreads, M <= 64 ? 2 : 1)
    dc2_kernel(const bf16* __restrict__ x, const bf16* __restrict__ dy,
               const bf16* __restrict__ y1, const bf16* __restrict__ w2,
               const float* __restrict__ b2, const bf16* __restrict__ w3,
               const float* __restrict__ b3, bf16* __restrict__ y2,
               bf16* __restrict__ d3, bf16* __restrict__ dc2,
               float* __restrict__ wsb, int np, int h, int w) {
  constexpr int C = 4 * M, NA = atoms<M>();
  constexpr int SB = 2 * M + C, RED = M > kNC ? M : kNC, LDN = kNC + kPad;
  constexpr int NCH = C / kNC, STAGE = NA * 64 * 128;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* sm = smem_1k(smem_raw);
  unsigned char* W3s = sm;                // [2][STAGE]: w3 rows, after the 3x3
  unsigned char* D3s = sm + 2 * STAGE;    // [kAtom]: bf16(dy3) of a chunk
  bf16* Xs = reinterpret_cast<bf16*>(D3s + kAtom);  // [kTP][LDN]
  bf16* Gs = Xs + kTP * LDN;                        // [kTP][LDN]
  unsigned char* Ds = sm;                 // [NA][kAtom]: bf16(dc2), at the end
  unsigned char* Y2s = sm + region_tile<M>();  // [NA][kAtom]
  float* red = reinterpret_cast<float*>(Y2s + NA * kAtom);  // [kWarps][RED]
  int* prow = reinterpret_cast<int*>(red + kWarps * RED);
  int* pcol = prow + kTP;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const uint32_t grow = (warp >> 2) * 64 * 128;  // the warpgroup's 64 rows
  const int row0 = 16 * warp + (lane >> 2);      // rows row0, row0 + 8
  const int q2 = 2 * (lane & 3);                 // columns 8 j + q2, + 1
  const int p0 = blockIdx.x * kTP;
  float* bias = wsb + static_cast<size_t>(blockIdx.x) * SB;

  tile_coords(prow, pcol, p0, np, h, w);
  __syncthreads();

  // -- y2 = bf16(relu(sum_k shift_k(y1) @ w2[k] + b2)), into Y2s
  tile_y2<M>(sm, Y2s, y1, w2, b2, p0, prow, pcol, h, w);
  store_tile<M>(y2, M, 0, Y2s, p0, np);

  // -- per 64-channel chunk of C: y3 = y2 @ w3[:, chunk], dy3 and its column
  // sums, then dc2 += bf16(dy3) @ w3[:, chunk]^T from the same staged rows
  // of w3 (MN-major B for y3, K-major B for dc2)
  float accd[NA][32];
#pragma unroll
  for (int a = 0; a < NA; ++a)
#pragma unroll
    for (int i = 0; i < 32; ++i) accd[a][i] = 0.0f;
  auto load_w3 = [&](int n, int s) {
    load_w3_chunk<M>(W3s + s * STAGE, w3, n);
    cp_commit();
  };
  load_w3(0, 0);
  for (int n = 0; n < NCH; ++n) {
    load_chunk(Xs, x, C, n * kNC, p0, np);
    load_chunk(Gs, dy, C, n * kNC, p0, np);
    cp_commit();
    if (n + 1 < NCH) {
      load_w3(n + 1, (n + 1) & 1);
      cp_wait<2>();
    } else {
      cp_wait<1>();
    }
    proxy_fence();
    __syncthreads();  // w3's chunk landed; x and dy may still be in flight
    const uint32_t w3c = saddr(W3s + (n & 1) * STAGE);
    float acc3[32];
    chunk_y3<M>(acc3, saddr(Y2s), w3c, grow);
    if (n + 1 < NCH)
      cp_wait<1>();
    else
      cp_wait<0>();
    __syncthreads();  // x and dy of the chunk landed
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int cl = 8 * j + q2, ch = n * kNC + cl;
      float s0 = 0.0f, s1 = 0.0f;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int r = row0 + 8 * e;
        const float2 xf = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(Xs + r * LDN + cl));
        const float2 g = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(Gs + r * LDN + cl));
        const float a =
            (acc3[4 * j + 2 * e] + b3[ch]) + xf.x > 0.0f ? g.x : 0.0f;
        const float b =
            (acc3[4 * j + 2 * e + 1] + b3[ch + 1]) + xf.y > 0.0f ? g.y : 0.0f;
        s0 += a;
        s1 += b;
        put2(D3s, r, cl, a, b);
      }
      s0 = warp_rows_sum(s0);
      s1 = warp_rows_sum(s1);
      if (lane < 4) {
        red[warp * RED + cl] = s0;
        red[warp * RED + cl + 1] = s1;
      }
    }
    proxy_fence();
    __syncthreads();  // bf16(dy3) and the column sums complete
    if (threadIdx.x < kNC) {
      float s = 0.0f;
      for (int g = 0; g < kWarps; ++g) s += red[g * RED + threadIdx.x];
      bias[2 * M + n * kNC + threadIdx.x] = s;
    }
#pragma unroll
    for (int a = 0; a < NA; ++a) pin(accd[a]);
    wg_fence();
#pragma unroll
    for (int k = 0; k < kNC / 16; ++k)
#pragma unroll
      for (int a = 0; a < NA; ++a)
        wgmma64<0, 0>(accd[a], sw128_desc(saddr(D3s) + grow + 32 * k),
                      sw128_desc(w3c + a * 8192 + 32 * k));
    wg_commit_wait();
#pragma unroll
    for (int a = 0; a < NA; ++a) pin(accd[a]);
    store_tile<kNC>(d3, C, n * kNC, D3s, p0, np);
    __syncthreads();  // before the next chunk rewrites x, dy, dy3, the sums
                      // and this stage of w3
  }

  // -- dc2 = mask(y2 > 0): its column sums, bf16(dc2)
#pragma unroll
  for (int a = 0; a < NA; ++a)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = 64 * a + 8 * j + q2;
      if (col < M) {
        float s0 = 0.0f, s1 = 0.0f;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int r = row0 + 8 * e;
          const float2 y = get2(Y2s, r, col);
          const float u = y.x > 0.0f ? accd[a][4 * j + 2 * e] : 0.0f;
          const float v = y.y > 0.0f ? accd[a][4 * j + 2 * e + 1] : 0.0f;
          s0 += u;
          s1 += v;
          put2(Ds, r, col, u, v);
        }
        s0 = warp_rows_sum(s0);
        s1 = warp_rows_sum(s1);
        if (lane < 4) {
          red[warp * RED + col] = s0;
          red[warp * RED + col + 1] = s1;
        }
      }
    }
  __syncthreads();
  if (threadIdx.x < M) {
    float s = 0.0f;
    for (int g = 0; g < kWarps; ++g) s += red[g * RED + threadIdx.x];
    bias[M + threadIdx.x] = s;
  }
  store_tile<M>(dc2, M, 0, Ds, p0, np);
}

// ---- 3: dy1, dc1, dx -----------------------------------------------------

// One 128-pixel tile, two warpgroups, every product wgmma, as dc2_kernel.
// Shared memory (region_tile): the 3x3's stages (A [2][kAtom], B [2][atoms]
// [64 rows x 128 bytes]), then the C chunks (w1 [2][atoms][64 rows x 128
// bytes], dx [kAtom], bf16(dy3) [2][kTP][kNC + kPad]); then bf16(dc1)
// [atoms][kAtom], the column sums and the tile's coordinates.
template <int M>
__global__ void __launch_bounds__(kThreads, M <= 64 ? 2 : 1)
    dc1_kernel(const bf16* __restrict__ d3, const bf16* __restrict__ y1,
               const bf16* __restrict__ dc2, const bf16* __restrict__ w1,
               const bf16* __restrict__ w2, bf16* __restrict__ dx,
               bf16* __restrict__ dc1, float* __restrict__ wsb, int np, int h,
               int w) {
  constexpr int C = 4 * M, KC = k_chunk<M>(), NA = atoms<M>();
  constexpr int SB = 2 * M + C, RED = M > kNC ? M : kNC, LDN = kNC + kPad;
  constexpr int T = 9 * M / KC, NCH = C / kNC, STAGE = NA * 64 * 128;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* sm = smem_1k(smem_raw);
  unsigned char* As = sm;                 // [2][kAtom]: shifted bf16(dc2)
  unsigned char* Bs = sm + 2 * kAtom;     // [2][STAGE]: w2[k] rows, K-major
  unsigned char* W1s = sm;                // [2][STAGE]: w1 rows, after dy1
  unsigned char* Os = sm + 2 * STAGE;     // [kAtom]: dx of a chunk
  bf16* D3c = reinterpret_cast<bf16*>(Os + kAtom);  // [2][kTP][LDN]
  unsigned char* D1s = sm + region_tile<M>();       // [NA][kAtom]
  float* red = reinterpret_cast<float*>(D1s + NA * kAtom);  // [kWarps][RED]
  int* prow = reinterpret_cast<int*>(red + kWarps * RED);
  int* pcol = prow + kTP;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const uint32_t grow = (warp >> 2) * 64 * 128;
  const int row0 = 16 * warp + (lane >> 2);
  const int q2 = 2 * (lane & 3);
  const int p0 = blockIdx.x * kTP;

  tile_coords(prow, pcol, p0, np, h, w);
  __syncthreads();

  // -- dy1[p] = sum_k bf16(dc2)[p - shift_k] @ w2[k]^T: tap (ky, kx) reads
  // dc2 at row + 1 - ky, column + 1 - kx. B is w2[k]'s rows i (its N),
  // channels o0 .. o0 + KC of each (its K).
  float acc[NA][32];
#pragma unroll
  for (int a = 0; a < NA; ++a)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[a][i] = 0.0f;
  auto load = [&](int t, int s) {
    const int tap = t / (M / KC), o0 = (t % (M / KC)) * KC;
    load_shifted_sw<KC>(As + s * kAtom, dc2, M, o0, 1 - tap / 3, 1 - tap % 3,
                        p0, prow, pcol, h, w);
    const bf16* src = w2 + static_cast<size_t>(tap) * M * M + o0;
    for (int i = threadIdx.x; i < M * (KC / 8); i += kThreads) {
      const int r = i / (KC / 8), v = i % (KC / 8);
      cp_async16(Bs + s * STAGE + (r >> 6) * 8192 + sw(r & 63, v),
                 src + static_cast<size_t>(r) * M + v * 8, true);
    }
    cp_commit();
  };
  load(0, 0);
  for (int t = 0; t < T; ++t) {
    if (t + 1 < T) {
      load(t + 1, (t + 1) & 1);
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    proxy_fence();
    __syncthreads();
    const uint32_t a = saddr(As + (t & 1) * kAtom) + grow;
    const uint32_t b = saddr(Bs + (t & 1) * STAGE);
#pragma unroll
    for (int n = 0; n < NA; ++n) pin(acc[n]);
    wg_fence();
#pragma unroll
    for (int k = 0; k < KC / 16; ++k)
#pragma unroll
      for (int n = 0; n < NA; ++n)
        wgmma64<0, 0>(acc[n], sw128_desc(a + 32 * k),
                      sw128_desc(b + n * 8192 + 32 * k));
    wg_commit_wait();
#pragma unroll
    for (int n = 0; n < NA; ++n) pin(acc[n]);
    __syncthreads();  // before the next load rewrites this stage
  }

  // -- dc1 = dy1 * (y1 > 0): column sums, bf16 into D1s and out
#pragma unroll
  for (int a = 0; a < NA; ++a)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = 64 * a + 8 * j + q2;
      if (col < M) {
        float s0 = 0.0f, s1 = 0.0f;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int r = row0 + 8 * e, p = p0 + r;
          const float2 y =
              p < np ? __bfloat1622float2(*reinterpret_cast<
                           const __nv_bfloat162*>(
                           y1 + static_cast<size_t>(p) * M + col))
                     : make_float2(0.0f, 0.0f);
          const float u = y.x > 0.0f ? acc[a][4 * j + 2 * e] : 0.0f;
          const float v = y.y > 0.0f ? acc[a][4 * j + 2 * e + 1] : 0.0f;
          s0 += u;
          s1 += v;
          put2(D1s, r, col, u, v);
        }
        s0 = warp_rows_sum(s0);
        s1 = warp_rows_sum(s1);
        if (lane < 4) {
          red[warp * RED + col] = s0;
          red[warp * RED + col + 1] = s1;
        }
      }
    }
  proxy_fence();
  __syncthreads();  // bf16(dc1) and the column sums complete
  if (threadIdx.x < M) {
    float s = 0.0f;
    for (int g = 0; g < kWarps; ++g) s += red[g * RED + threadIdx.x];
    wsb[static_cast<size_t>(blockIdx.x) * SB + threadIdx.x] = s;
  }
  store_tile<M>(dc1, M, 0, D1s, p0, np);

  // -- dx = bf16(dy3 + bf16(dc1) @ w1^T), 64 channels of C a chunk: B is
  // w1's rows n0 .. n0 + 63 (its N), M channels each (its K, in atoms); the
  // chunk's bf16(dy3) arrives with it (cp.async, one chunk ahead)
  auto load_c = [&](int n, int s) {
    for (int i = threadIdx.x; i < kNC * (M / 8); i += kThreads) {
      const int r = i / (M / 8), v = i % (M / 8);
      cp_async16(W1s + s * STAGE + (v >> 3) * 8192 + sw(r, v & 7),
                 w1 + (static_cast<size_t>(n) * kNC + r) * M + v * 8, true);
    }
    load_chunk(D3c + s * kTP * LDN, d3, C, n * kNC, p0, np);
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
    __syncthreads();
    const uint32_t wc = saddr(W1s + (n & 1) * STAGE);
    float acc3[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) acc3[i] = 0.0f;
    pin(acc3);
    wg_fence();
#pragma unroll
    for (int k = 0; k < M / 16; ++k)
      wgmma64<0, 0>(acc3,
                    sw128_desc(saddr(D1s) + (k >> 2) * kAtom + grow +
                               32 * (k & 3)),
                    sw128_desc(wc + (k >> 2) * 8192 + 32 * (k & 3)));
    wg_commit_wait();
    pin(acc3);
    const bf16* dc = D3c + (n & 1) * kTP * LDN;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int cl = 8 * j + q2;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int r = row0 + 8 * e;
        const float2 g = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(dc + r * LDN + cl));
        put2(Os, r, cl, g.x + acc3[4 * j + 2 * e],
             g.y + acc3[4 * j + 2 * e + 1]);
      }
    }
    __syncthreads();  // this chunk of dx complete
    store_tile<kNC>(dx, C, n * kNC, Os, p0, np);
    __syncthreads();  // before the next chunk's copy rewrites this stage
  }
}

// ---- 4: weight gradients, split-K over pixel ranges -------------------------

template <int M>
__host__ __device__ constexpr int weight_tile() {
  return M < 64 ? M : 64;
}

template <int M>
__host__ __device__ constexpr int weight_jobs() {
  constexpr int NTM = M / weight_tile<M>(), NTC = 4 * M / weight_tile<M>();
  return NTC * NTM + 9 * NTM * NTM + NTM * NTC;
}

// dw1 [C, M], dw2 [9, M, M], dw3 [M, C]
template <int M>
__host__ __device__ constexpr size_t weight_floats() {
  return 2 * static_cast<size_t>(4 * M) * M + 9 * static_cast<size_t>(M) * M;
}

// The weight-gradient products read both operands transposed ("MN-major",
// which bf16 allows): a stage holds kKP pixel rows of 64 channels in
// 128-byte swizzle, which is how the operands lie in device memory,
// [pixel, channel], so a cp.async of 16 bytes lands each chunk and the
// 3x3's shift stays an address offset.
constexpr int kWStageBytes = 2 * kKP * 128;  // A and B, one stage
constexpr int kWStages = 4;

__host__ __device__ constexpr size_t smem_wgrad() {
  return static_cast<size_t>(kWStages) * kWStageBytes + 1024;  // + alignment
}

// Block (job, part), one warpgroup: job is one T x T tile of dw1, of one
// tap of dw2, or of dw3 (in that order); part reduces pixels [part * pp,
// part * pp + pp) in steps of kKP through a ring of four cp.async stages,
// with the sums in registers, and writes its tile of slice `part` of wsw
// once. A tile narrower than 64 (T = M < 64) fills the rest of the 64 x 64
// product with zero channels and stores its T x T corner.
template <int M>
__global__ void __launch_bounds__(kWThreads)
    wgrad_kernel(const bf16* __restrict__ x, const bf16* __restrict__ y1,
                 const bf16* __restrict__ y2, const bf16* __restrict__ d3,
                 const bf16* __restrict__ dc1, const bf16* __restrict__ dc2,
                 float* __restrict__ wsw, int np, int h, int w, int pp) {
  constexpr int C = 4 * M, T = weight_tile<M>();
  constexpr int NTM = M / T, NTC = C / T;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* sm = smem_1k(smem_raw);

  int job = blockIdx.x, dyy = 0, dxx = 0, lda, ldb, ldo;
  const bf16 *A, *B;
  size_t out;
  if (job < NTC * NTM) {  // dw1 = x^T bf16(dc1)
    const int a0 = job / NTM * T, b0 = job % NTM * T;
    A = x + a0, lda = C, B = dc1 + b0, ldb = M;
    out = static_cast<size_t>(a0) * M + b0, ldo = M;
  } else if ((job -= NTC * NTM) < 9 * NTM * NTM) {  // dw2[tap]
    const int tap = job / (NTM * NTM), rem = job % (NTM * NTM);
    const int a0 = rem / NTM * T, b0 = rem % NTM * T;
    dyy = tap / 3 - 1, dxx = tap % 3 - 1;
    A = y1 + a0, lda = M, B = dc2 + b0, ldb = M;
    out = static_cast<size_t>(C) * M + static_cast<size_t>(tap) * M * M +
          static_cast<size_t>(a0) * M + b0,
    ldo = M;
  } else {  // dw3 = y2^T bf16(dy3)
    job -= 9 * NTM * NTM;
    const int a0 = job / NTC * T, b0 = job % NTC * T;
    A = y2 + a0, lda = M, B = d3 + b0, ldb = C;
    out = static_cast<size_t>(C) * M + 9 * static_cast<size_t>(M) * M +
          static_cast<size_t>(a0) * C + b0,
    ldo = C;
  }
  const int pb = blockIdx.y * pp;
  const int pe = pb + pp < np ? pb + pp : np;
  const int steps = pe > pb ? (pe - pb + kKP - 1) / kKP : 0;
  const bool shifted = dyy != 0 || dxx != 0;
  // each thread copies chunk v (channels 8 v .. 8 v + 7) of rows r0, r0 +
  // 16, ...; chunks past the tile's T channels are zeros
  const int v = threadIdx.x & 7, r0 = threadIdx.x >> 3;
  const bool live = v * 8 < T;

  auto load = [&](int t, int s) {
    const int q0 = pb + t * kKP;
    unsigned char* sa = sm + s * kWStageBytes;
    unsigned char* sb = sa + kKP * 128;
#pragma unroll
    for (int k = 0; k < kKP * 8 / kWThreads; ++k) {
      const int r = r0 + k * (kWThreads / 8), p = q0 + r;
      const bool ok = live && p < pe;
      bool oka = ok;
      if (shifted && ok) {
        const int rr = (p / w) % h + dyy, cc = p % w + dxx;
        oka = rr >= 0 && rr < h && cc >= 0 && cc < w;
      }
      const int at = sw(r, v);
      cp_async16(sb + at, ok ? B + static_cast<size_t>(p) * ldb + v * 8 : B,
                 ok);
      cp_async16(sa + at,
                 oka ? A + static_cast<size_t>(p + dyy * w + dxx) * lda + v * 8
                     : A,
                 oka);
    }
  };

  float d[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) d[i] = 0.0f;

#pragma unroll
  for (int s = 0; s < kWStages - 1; ++s) {
    if (s < steps) load(s, s);
    cp_commit();
  }
  for (int t = 0; t < steps; ++t) {
    cp_wait<kWStages - 2>();
    proxy_fence();
    __syncthreads();  // stage t landed; stage t - 1's products are done
    if (t + kWStages - 1 < steps)
      load(t + kWStages - 1, (t + kWStages - 1) % kWStages);
    cp_commit();
    const uint32_t sa = saddr(sm + (t % kWStages) * kWStageBytes);
    const uint32_t sb = sa + kKP * 128;
    pin(d);
    wg_fence();
#pragma unroll
    for (int k = 0; k < kKP / 16; ++k)
      wgmma64<1, 1>(d, sw128_desc(sa + k * 2048), sw128_desc(sb + k * 2048));
    wg_commit_wait();
    pin(d);
  }
  cp_wait<0>();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* o = wsw + blockIdx.y * weight_floats<M>() + out;
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int row = warp * 16 + (lane >> 2) + 8 * e;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = 8 * j + 2 * (lane & 3);
      if (row < T && col < T)
        *reinterpret_cast<float2*>(o + static_cast<size_t>(row) * ldo + col) =
            make_float2(d[4 * j + 2 * e], d[4 * j + 2 * e + 1]);
    }
  }
}

// ---- 5: the ordered sums ----------------------------------------------------

// out[col] = the sum of rows of a [rows, cols] fp32 array: 32 row groups
// (group g takes rows g, g + 32, ... in order), then the groups in order.
// Blocks [0, nba) sum a into oa, the rest b into ob; block (32, 32).
__global__ void sum_rows(const float* __restrict__ a, float* __restrict__ oa,
                         int ra, int ca, int nba, const float* __restrict__ b,
                         float* __restrict__ ob, int rb, int cb) {
  __shared__ float part[32][33];
  const bool first = blockIdx.x < nba;
  const float* src = first ? a : b;
  float* dst = first ? oa : ob;
  const int rows = first ? ra : rb, cols = first ? ca : cb;
  const int col = (first ? blockIdx.x : blockIdx.x - nba) * 32 + threadIdx.x;
  float s = 0.0f;
  if (col < cols) {
#pragma unroll 8
    for (int r = threadIdx.y; r < rows; r += 32)
      s += src[static_cast<size_t>(r) * cols + col];
  }
  part[threadIdx.y][threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.y == 0 && col < cols) {
    float t = 0.0f;
    for (int g = 0; g < 32; ++g) t += part[g][threadIdx.x];
    dst[col] = t;
  }
}

template <int M>
int launch(const bf16* x, const bf16* dy, const bf16* w1, const float* b1,
           const bf16* w2, const float* b2, const bf16* w3, const float* b3,
           bf16* dx, bf16* y1, bf16* y2, bf16* d3, bf16* dc2, bf16* dc1,
           float* wsw, float* wsb, float* grads, int batch, int h, int w,
           int parts, int pp, cudaStream_t stream, int* launched) {
  const int np = batch * h * w, tiles = (np + kTP - 1) / kTP;
  cudaError_t err;
  if ((err = allow_smem(y1_kernel<M>, smem_y1<M>())) != cudaSuccess ||
      (err = allow_smem(dc2_kernel<M>, smem_tile<M>())) != cudaSuccess ||
      (err = allow_smem(dc1_kernel<M>, smem_tile<M>())) != cudaSuccess ||
      (err = allow_smem(wgrad_kernel<M>, smem_wgrad())) != cudaSuccess)
    return static_cast<int>(err);
  // each launch the runtime accepted adds one to *launched
  auto accepted = [&]() {
    err = cudaGetLastError();
    if (err == cudaSuccess) ++*launched;
    return err == cudaSuccess;
  };
  y1_kernel<M><<<tiles, kThreads, smem_y1<M>(), stream>>>(x, w1, b1, y1, np);
  if (!accepted()) return static_cast<int>(err);
  dc2_kernel<M><<<tiles, kThreads, smem_tile<M>(), stream>>>(
      x, dy, y1, w2, b2, w3, b3, y2, d3, dc2, wsb, np, h, w);
  if (!accepted()) return static_cast<int>(err);
  dc1_kernel<M><<<tiles, kThreads, smem_tile<M>(), stream>>>(
      d3, y1, dc2, w1, w2, dx, dc1, wsb, np, h, w);
  if (!accepted()) return static_cast<int>(err);
  wgrad_kernel<M><<<dim3(weight_jobs<M>(), parts), kWThreads, smem_wgrad(),
                    stream>>>(x, y1, y2, d3, dc1, dc2, wsw, np, h, w, pp);
  if (!accepted()) return static_cast<int>(err);
  const int sw = static_cast<int>(weight_floats<M>()), sb = 6 * M;
  const int nba = (sw + 31) / 32, nbb = (sb + 31) / 32;
  sum_rows<<<nba + nbb, dim3(32, 32), 0, stream>>>(wsw, grads, parts, sw, nba,
                                                   wsb, grads + sw, tiles, sb);
  accepted();
  return static_cast<int>(err);
}

}  // namespace

// Launches the five kernels on `stream` of `device`, adding one to
// *launched for each launch the runtime accepted; returns a cudaError_t (0 =
// ok: all five launched). Scratch (uninitialised): y1, y2, dc2, dc1 [B H W,
// M] bf16, d3 [B H W, C] bf16, wsw [parts, 2 C M + 9 M^2] fp32 (part j
// reduces pixels [j pp, j pp + pp)), wsb [ceil(B H W / 128), 6 M] fp32.
// grads: the 2 C M + 9 M^2 + 6 M summed floats, dw1 [C, M], dw2 [3, 3, M,
// M], dw3 [M, C], db1 [M], db2 [M], db3 [C]. The caller guarantees batch,
// h, w >= 1, parts = ceil(B H W / pp) and the requirements above.
extern "C" int detjax_bottleneck_bwd_launch(
    const void* x, const void* dy, const void* w1, const float* b1,
    const void* w2, const float* b2, const void* w3, const float* b3, void* dx,
    void* y1, void* y2, void* d3, void* dc2, void* dc1, float* wsw, float* wsb,
    float* grads, int batch, int h, int w, int m, int parts, int pp,
    int device, void* stream, int* launched) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define DETJAX_BWD(MM)                                                        \
  case MM:                                                                    \
    return launch<MM>(                                                        \
        static_cast<const bf16*>(x), static_cast<const bf16*>(dy),            \
        static_cast<const bf16*>(w1), b1, static_cast<const bf16*>(w2), b2,   \
        static_cast<const bf16*>(w3), b3, static_cast<bf16*>(dx),             \
        static_cast<bf16*>(y1), static_cast<bf16*>(y2),                       \
        static_cast<bf16*>(d3), static_cast<bf16*>(dc2),                      \
        static_cast<bf16*>(dc1), wsw, wsb, grads, batch, h, w, parts, pp, s,  \
        launched);
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

// The launcher's geometry at M = m, for the wrapper to check its own copy
// against once: out[0..6] = pixels a tile, pixels a weight-gradient stage,
// the weight-gradient tile, its jobs, and the dynamic shared memory of
// y1_kernel, of dc2_kernel and dc1_kernel (each), and of wgrad_kernel.
// Returns 0, or cudaErrorInvalidValue for another m.
extern "C" int detjax_bottleneck_bwd_geometry(int m, int* out) {
#define DETJAX_GEOM(MM)                          \
  case MM:                                       \
    out[2] = weight_tile<MM>();                  \
    out[3] = weight_jobs<MM>();                  \
    out[4] = static_cast<int>(smem_y1<MM>());    \
    out[5] = static_cast<int>(smem_tile<MM>());  \
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
  out[1] = kKP;
  out[6] = static_cast<int>(smem_wgrad());
  return 0;
}
