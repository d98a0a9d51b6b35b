// Timing reference only: detjax_torch/csrc/bottleneck_bwd.cu as it stood
// with every product on wmma (mma.sync) fragments, before its kernels moved
// to wgmma; the same five kernels, the same partition and the same C
// interface. Built by chip_smoke.py as the library detjax_bottleneck_bwd_wmma
// and timed in turns against the current backward. No code path of
// detjax_torch calls it.
//
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
//      borders) and dw3. Grid (jobs, parts): part j reduces its contiguous
//      pixel range with the sums in registers and writes its fp32 partial
//      once, to its own slice of a workspace.
//   5. sum_rows: the parts' slices, and the tiles' bias sums, in a fixed
//      order. No atomics: two runs give equal bits.
// No pixel is recomputed: each tile owns its pixels, halos are read from
// scratch. Halo pixels come back from L2 (the 3x3 reads y1 or bf16(dc2)
// three rows wide).
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
//   4. Small tiles, no overlap: 128-pixel tiles (64-pixel steps in the
//      weight gradients), every copy a cp.async two stages deep behind the
//      products (dc1_kernel's bf16(dy3) chunks too), and dc2_kernel asks
//      for two blocks an SM where its shared memory allows (M <= 64).
// The products are wmma (mma.sync) on 16x16x16 bf16 fragments from padded
// shared rows, not wgmma: wgmma reads its shared operands in a swizzled
// core-matrix layout, which the copies of the shifted 3x3 rows (each row
// its own address, or zeros) would have to write element group by group.
// This design removes the traffic and the recompute first and keeps the
// products on the instruction the one-kernel design used; wgmma is the
// next step.
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

constexpr int kThreads = 256;   // activation kernels: 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kTP = 128;        // pixels a tile of the activation kernels
constexpr int kNC = 64;         // channels a chunk of C
constexpr int kPad = 8;         // bf16 a shared row holds beyond its width
constexpr int kWThreads = 128;  // weight-gradient kernel: 4 warps
constexpr int kKP = 64;         // pixels a stage of the weight gradients
constexpr int kWStages = 2;

union Pack8 {
  uint4 v;
  __nv_bfloat162 h[4];
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  // 16 bytes, or 16 zero bytes when !valid (src is then not read)
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// How the 8 warps of an activation kernel split a 128-pixel x N tile: WM
// along the pixels, WN along N; each warp holds FM x FN 16x16 fragments.
template <int N>
struct Layout {
  static constexpr int WN = N >= 64 ? 2 : 1;
  static constexpr int WM = kWarps / WN;
  static constexpr int FM = kTP / WM / 16;
  static constexpr int FN = N / WN / 16;
};

template <int M>
__host__ __device__ constexpr int k_chunk() {  // channels a 3x3 stage
  return M < 64 ? M : 64;
}

// acc += A[kTP x K] (row-major, lda) @ B[K x N]: B row-major (ldb) or, with
// BCOL, B^T stored row-major (element (k, n) at Bs[n * ldb + k]).
template <int N, int K, bool BCOL>
__device__ __forceinline__ void mma_chunk(
    FragC (&acc)[Layout<N>::FM][Layout<N>::FN], const bf16* As, int lda,
    const bf16* Bs, int ldb, int wm, int wn) {
  using L = Layout<N>;
#pragma unroll
  for (int k = 0; k < K; k += 16) {
    FragA a[L::FM];
#pragma unroll
    for (int i = 0; i < L::FM; ++i)
      wmma::load_matrix_sync(a[i], As + (wm * L::FM + i) * 16 * lda + k, lda);
#pragma unroll
    for (int j = 0; j < L::FN; ++j) {
      const int n = (wn * L::FN + j) * 16;
      if constexpr (BCOL) {
        FragBt b;
        wmma::load_matrix_sync(b, Bs + n * ldb + k, ldb);
#pragma unroll
        for (int i = 0; i < L::FM; ++i)
          wmma::mma_sync(acc[i][j], a[i], b, acc[i][j]);
      } else {
        FragB b;
        wmma::load_matrix_sync(b, Bs + k * ldb + n, ldb);
#pragma unroll
        for (int i = 0; i < L::FM; ++i)
          wmma::mma_sync(acc[i][j], a[i], b, acc[i][j]);
      }
    }
  }
}

template <int N>
__device__ __forceinline__ void zero(
    FragC (&acc)[Layout<N>::FM][Layout<N>::FN]) {
#pragma unroll
  for (int i = 0; i < Layout<N>::FM; ++i)
#pragma unroll
    for (int j = 0; j < Layout<N>::FN; ++j)
      wmma::fill_fragment(acc[i][j], 0.0f);
}

// rows x COLS bf16 (COLS a multiple of 8) from src (row stride lds) into
// shared dst (row stride ldd), by the NT threads of the block.
template <int COLS, int NT>
__device__ __forceinline__ void load_rows(bf16* dst, int ldd, const bf16* src,
                                          size_t lds, int rows) {
  constexpr int VEC = COLS / 8;
  for (int i = threadIdx.x; i < rows * VEC; i += NT) {
    const int r = i / VEC, v = i % VEC;
    cp_async16(dst + r * ldd + v * 8, src + r * lds + v * 8, true);
  }
}

// Image row and column of each pixel of the tile from p0; pixels at or
// beyond np get -4, so that every 3x3 shift of them lands outside.
__device__ __forceinline__ void tile_coords(int* prow, int* pcol, int p0,
                                            int np, int h, int w) {
  for (int i = threadIdx.x; i < kTP; i += kThreads) {
    const int p = p0 + i;
    prow[i] = p < np ? (p / w) % h : -4;
    pcol[i] = p < np ? p % w : -4;
  }
}

// KC channels from ch0 of the tile's pixels shifted by (dyy, dxx) inside
// their image, from src [np, M]; zeros where the shifted pixel is outside.
template <int KC>
__device__ __forceinline__ void load_shifted(bf16* dst, const bf16* src, int m,
                                             int ch0, int dyy, int dxx, int p0,
                                             const int* prow, const int* pcol,
                                             int h, int w) {
  constexpr int VEC = KC / 8;
  for (int i = threadIdx.x; i < kTP * VEC; i += kThreads) {
    const int r = i / VEC, v = i % VEC;
    const int rr = prow[r] + dyy, cc = pcol[r] + dxx;
    const bool ok = rr >= 0 && rr < h && cc >= 0 && cc < w;
    const bf16* s =
        ok ? src + (static_cast<size_t>(p0 + r + dyy * w + dxx)) * m + ch0 +
                 v * 8
           : src;
    cp_async16(dst + r * (KC + kPad) + v * 8, s, ok);
  }
}

// Channels n0 .. n0 + 63 of the tile's pixels from src [np, C] into dst
// (row stride kNC + kPad); zeros for pixels at or beyond np.
__device__ __forceinline__ void load_chunk(bf16* dst, const bf16* src, int c,
                                           int n0, int p0, int np) {
  constexpr int VEC = kNC / 8;
  for (int i = threadIdx.x; i < kTP * VEC; i += kThreads) {
    const int r = i / VEC, v = i % VEC;
    const bool ok = p0 + r < np;
    cp_async16(dst + r * (kNC + kPad) + v * 8,
               ok ? src + static_cast<size_t>(p0 + r) * c + n0 + v * 8 : src,
               ok);
  }
}

// Sum of column `lane` (< 16) of a staged 16x16 tile, rows in order.
__device__ __forceinline__ float column_sum(const float* stage, int lane) {
  float s = 0.0f;
#pragma unroll
  for (int q = 0; q < 16; ++q) s += stage[q * 16 + lane];
  return s;
}

__device__ __forceinline__ uint4 load8(const bf16* p, bool ok) {
  return ok ? *reinterpret_cast<const uint4*>(p) : make_uint4(0u, 0u, 0u, 0u);
}

// ---- 1: y1 = bf16(relu(x @ w1 + b1)) ----------------------------------------

template <int M>
__host__ __device__ constexpr size_t smem_y1() {
  return (2 * kTP * (kNC + kPad) + 2 * kNC * (M + kPad)) * sizeof(bf16) +
         kWarps * 256 * sizeof(float);
}

template <int M>
__global__ void __launch_bounds__(kThreads)
    y1_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w1,
              const float* __restrict__ b1, bf16* __restrict__ y1, int np) {
  constexpr int C = 4 * M, LDA = kNC + kPad, LDB = M + kPad, T = C / kNC;
  using L = Layout<M>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* As = reinterpret_cast<bf16*>(smem);  // [2][kTP][LDA]
  bf16* Bs = As + 2 * kTP * LDA;              // [2][kNC][LDB]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* stage = reinterpret_cast<float*>(Bs + 2 * kNC * LDB) + warp * 256;
  const int wm = warp / L::WN, wn = warp % L::WN;
  const int p0 = blockIdx.x * kTP;

  auto load = [&](int t, int s) {
    const int k0 = t * kNC;
    bf16* a = As + s * kTP * LDA;
    for (int i = threadIdx.x; i < kTP * (kNC / 8); i += kThreads) {
      const int r = i / (kNC / 8), v = i % (kNC / 8);
      const bool ok = p0 + r < np;
      cp_async16(a + r * LDA + v * 8,
                 ok ? x + static_cast<size_t>(p0 + r) * C + k0 + v * 8 : x, ok);
    }
    load_rows<M, kThreads>(Bs + s * kNC * LDB, LDB,
                           w1 + static_cast<size_t>(k0) * M, M, kNC);
    cp_commit();
  };

  FragC acc[L::FM][L::FN];
  zero<M>(acc);
  load(0, 0);
  for (int t = 0; t < T; ++t) {
    if (t + 1 < T) {
      load(t + 1, (t + 1) & 1);
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    mma_chunk<M, kNC, false>(acc, As + (t & 1) * kTP * LDA, LDA,
                             Bs + (t & 1) * kNC * LDB, LDB, wm, wn);
    __syncthreads();
  }

  const int r = lane >> 1, c = (lane & 1) * 8;
#pragma unroll
  for (int i = 0; i < L::FM; ++i) {
#pragma unroll
    for (int j = 0; j < L::FN; ++j) {
      wmma::store_matrix_sync(stage, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const int p = p0 + (wm * L::FM + i) * 16 + r;
      const int ch = (wn * L::FN + j) * 16 + c;
      const float* s = stage + r * 16 + c;
      Pack8 pk;
#pragma unroll
      for (int q = 0; q < 4; ++q)
        pk.h[q] = __floats2bfloat162_rn(fmaxf(s[2 * q] + b1[ch + 2 * q], 0.0f),
                                        fmaxf(s[2 * q + 1] + b1[ch + 2 * q + 1],
                                              0.0f));
      if (p < np)
        *reinterpret_cast<uint4*>(y1 + static_cast<size_t>(p) * M + ch) = pk.v;
      __syncwarp();
    }
  }
}

// ---- 2: y2, dy3, dc2 -----------------------------------------------------

// Bytes of the shared region the 3x3 stages use, then the C chunks reuse.
template <int M>
__host__ __device__ constexpr size_t region_dc2() {
  constexpr int KC = k_chunk<M>();
  constexpr size_t conv = 2 * kTP * (KC + kPad) + 2 * KC * (M + kPad);
  constexpr size_t chunks = 2 * M * (kNC + kPad) + kTP * (kNC + kPad);
  return (conv > chunks ? conv : chunks) * sizeof(bf16);
}

template <int M>
__host__ __device__ constexpr size_t region_dc1() {
  constexpr int KC = k_chunk<M>();
  constexpr size_t conv = 2 * kTP * (KC + kPad) + 2 * M * (KC + kPad);
  // w1's chunks, then the bf16(dy3) chunks (two stages each)
  constexpr size_t chunks = 2 * kNC * (M + kPad) + 2 * kTP * (kNC + kPad);
  return (conv > chunks ? conv : chunks) * sizeof(bf16);
}

// The shared memory both tile kernels add to their region: a [kTP, M] bf16
// tile (y2, or bf16(dc1)), per-warp fp32 stages, the cross-warp column-sum
// buffer and the tile's pixel coordinates.
template <int M>
__host__ __device__ constexpr size_t smem_tail() {
  return kTP * (M + kPad) * sizeof(bf16) + kWarps * 256 * sizeof(float) +
         kWarps * (M > kNC ? M : kNC) * sizeof(float) + 2 * kTP * sizeof(int);
}

template <int M>
__host__ __device__ constexpr size_t smem_dc2() {
  return region_dc2<M>() + smem_tail<M>();
}

template <int M>
__host__ __device__ constexpr size_t smem_dc1() {
  return region_dc1<M>() + smem_tail<M>();
}

template <int M>
__global__ void __launch_bounds__(kThreads, M <= 64 ? 2 : 1)
    dc2_kernel(const bf16* __restrict__ x, const bf16* __restrict__ dy,
               const bf16* __restrict__ y1, const bf16* __restrict__ w2,
               const float* __restrict__ b2, const bf16* __restrict__ w3,
               const float* __restrict__ b3, bf16* __restrict__ y2,
               bf16* __restrict__ d3, bf16* __restrict__ dc2,
               float* __restrict__ wsb, int np, int h, int w) {
  constexpr int C = 4 * M, KC = k_chunk<M>(), LDA = KC + kPad;
  constexpr int LDB = M + kPad, LDY = M + kPad, LDN = kNC + kPad;
  constexpr int SB = 2 * M + C, RED = M > kNC ? M : kNC;
  constexpr int T = 9 * M / KC, NCH = C / kNC;
  using L = Layout<M>;
  using L3 = Layout<kNC>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* As = reinterpret_cast<bf16*>(smem);  // [2][kTP][LDA]
  bf16* Bs = As + 2 * kTP * LDA;              // [2][KC][LDB]
  bf16* W3s = As;                             // [2][M][LDN], after the 3x3
  bf16* D3s = W3s + 2 * M * LDN;              // [kTP][LDN]
  bf16* Y2s = reinterpret_cast<bf16*>(smem + region_dc2<M>());  // [kTP][LDY]
  float* stages = reinterpret_cast<float*>(Y2s + kTP * LDY);
  float* red = stages + kWarps * 256;  // [WM][RED]
  int* prow = reinterpret_cast<int*>(red + kWarps * RED);
  int* pcol = prow + kTP;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* stage = stages + warp * 256;
  const int wm = warp / L::WN, wn = warp % L::WN;
  const int wm3 = warp / L3::WN, wn3 = warp % L3::WN;
  const int p0 = blockIdx.x * kTP;
  const int r = lane >> 1, c = (lane & 1) * 8;
  float* bias = wsb + static_cast<size_t>(blockIdx.x) * SB;

  tile_coords(prow, pcol, p0, np, h, w);
  __syncthreads();

  // -- y2 = bf16(relu(sum_k shift_k(y1) @ w2[k] + b2)), K = 9 M in chunks
  auto load = [&](int t, int s) {
    const int tap = t / (M / KC), ch0 = (t % (M / KC)) * KC;
    load_shifted<KC>(As + s * kTP * LDA, y1, M, ch0, tap / 3 - 1, tap % 3 - 1,
                     p0, prow, pcol, h, w);
    load_rows<M, kThreads>(Bs + s * KC * LDB, LDB,
                           w2 + (static_cast<size_t>(tap) * M + ch0) * M, M,
                           KC);
    cp_commit();
  };
  {
    FragC acc[L::FM][L::FN];
    zero<M>(acc);
    load(0, 0);
    for (int t = 0; t < T; ++t) {
      if (t + 1 < T) {
        load(t + 1, (t + 1) & 1);
        cp_wait<1>();
      } else {
        cp_wait<0>();
      }
      __syncthreads();
      mma_chunk<M, KC, false>(acc, As + (t & 1) * kTP * LDA, LDA,
                              Bs + (t & 1) * KC * LDB, LDB, wm, wn);
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < L::FM; ++i) {
#pragma unroll
      for (int j = 0; j < L::FN; ++j) {
        wmma::store_matrix_sync(stage, acc[i][j], 16, wmma::mem_row_major);
        __syncwarp();
        const int row = (wm * L::FM + i) * 16 + r, p = p0 + row;
        const int ch = (wn * L::FN + j) * 16 + c;
        const float* s = stage + r * 16 + c;
        Pack8 pk;
#pragma unroll
        for (int q = 0; q < 4; ++q)
          pk.h[q] = __floats2bfloat162_rn(
              fmaxf(s[2 * q] + b2[ch + 2 * q], 0.0f),
              fmaxf(s[2 * q + 1] + b2[ch + 2 * q + 1], 0.0f));
        *reinterpret_cast<uint4*>(Y2s + row * LDY + ch) = pk.v;
        if (p < np)
          *reinterpret_cast<uint4*>(y2 + static_cast<size_t>(p) * M + ch) =
              pk.v;
        __syncwarp();
      }
    }
  }
  __syncthreads();  // Y2s written; the region is free for w3's chunks

  // -- per 64-channel chunk of C: y3, dy3 (and its column sums), then
  // dc2 += bf16(dy3) @ w3[:, chunk]^T with the same staged chunk
  FragC accd[L::FM][L::FN];
  zero<M>(accd);
  load_rows<kNC, kThreads>(W3s, LDN, w3, C, M);
  cp_commit();
  for (int n = 0; n < NCH; ++n) {
    bf16* w3c = W3s + (n & 1) * M * LDN;
    if (n + 1 < NCH) {
      load_rows<kNC, kThreads>(W3s + ((n + 1) & 1) * M * LDN, LDN,
                               w3 + (n + 1) * kNC, C, M);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    FragC acc3[L3::FM][L3::FN];
    zero<kNC>(acc3);
    mma_chunk<kNC, M, false>(acc3, Y2s, LDY, w3c, LDN, wm3, wn3);
#pragma unroll
    for (int j = 0; j < L3::FN; ++j) {
      float cs = 0.0f;
#pragma unroll
      for (int i = 0; i < L3::FM; ++i) {
        wmma::store_matrix_sync(stage, acc3[i][j], 16, wmma::mem_row_major);
        __syncwarp();
        const int row = (wm3 * L3::FM + i) * 16 + r, p = p0 + row;
        const int chl = (wn3 * L3::FN + j) * 16 + c, ch = n * kNC + chl;
        const size_t at = static_cast<size_t>(p) * C + ch;
        Pack8 xv, gv, pk;
        xv.v = load8(x + at, p < np);
        gv.v = load8(dy + at, p < np);
        float* s = stage + r * 16 + c;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float2 xf = __bfloat1622float2(xv.h[q]);
          const float2 g = __bfloat1622float2(gv.h[q]);
          const float a =
              (s[2 * q] + b3[ch + 2 * q]) + xf.x > 0.0f ? g.x : 0.0f;
          const float b =
              (s[2 * q + 1] + b3[ch + 2 * q + 1]) + xf.y > 0.0f ? g.y : 0.0f;
          s[2 * q] = a;
          s[2 * q + 1] = b;
          pk.h[q] = __floats2bfloat162_rn(a, b);
        }
        *reinterpret_cast<uint4*>(D3s + row * LDN + chl) = pk.v;
        if (p < np) *reinterpret_cast<uint4*>(d3 + at) = pk.v;
        __syncwarp();
        if (lane < 16) cs += column_sum(stage, lane);
        __syncwarp();
      }
      if (lane < 16) red[wm3 * RED + (wn3 * L3::FN + j) * 16 + lane] = cs;
    }
    __syncthreads();  // D3s and the column sums complete
    if (threadIdx.x < kNC) {
      float s = 0.0f;
      for (int g = 0; g < L3::WM; ++g) s += red[g * RED + threadIdx.x];
      bias[2 * M + n * kNC + threadIdx.x] = s;
    }
    mma_chunk<M, kNC, true>(accd, D3s, LDN, w3c, LDN, wm, wn);
    __syncthreads();  // before the next chunk rewrites D3s, red and w3c
  }

  // -- dc2 = mask(y2 > 0), its column sums, bf16(dc2)
#pragma unroll
  for (int j = 0; j < L::FN; ++j) {
    float cs = 0.0f;
#pragma unroll
    for (int i = 0; i < L::FM; ++i) {
      wmma::store_matrix_sync(stage, accd[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const int row = (wm * L::FM + i) * 16 + r, p = p0 + row;
      const int ch = (wn * L::FN + j) * 16 + c;
      Pack8 yv, pk;
      yv.v = *reinterpret_cast<const uint4*>(Y2s + row * LDY + ch);
      float* s = stage + r * 16 + c;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float2 y = __bfloat1622float2(yv.h[q]);
        const float a = y.x > 0.0f ? s[2 * q] : 0.0f;
        const float b = y.y > 0.0f ? s[2 * q + 1] : 0.0f;
        s[2 * q] = a;
        s[2 * q + 1] = b;
        pk.h[q] = __floats2bfloat162_rn(a, b);
      }
      if (p < np)
        *reinterpret_cast<uint4*>(dc2 + static_cast<size_t>(p) * M + ch) = pk.v;
      __syncwarp();
      if (lane < 16) cs += column_sum(stage, lane);
      __syncwarp();
    }
    if (lane < 16) red[wm * RED + (wn * L::FN + j) * 16 + lane] = cs;
  }
  __syncthreads();
  if (threadIdx.x < M) {
    float s = 0.0f;
    for (int g = 0; g < L::WM; ++g) s += red[g * RED + threadIdx.x];
    bias[M + threadIdx.x] = s;
  }
}

// ---- 3: dy1, dc1, dx -----------------------------------------------------

template <int M>
__global__ void __launch_bounds__(kThreads)
    dc1_kernel(const bf16* __restrict__ d3, const bf16* __restrict__ y1,
               const bf16* __restrict__ dc2, const bf16* __restrict__ w1,
               const bf16* __restrict__ w2, bf16* __restrict__ dx,
               bf16* __restrict__ dc1, float* __restrict__ wsb, int np, int h,
               int w) {
  constexpr int C = 4 * M, KC = k_chunk<M>(), LDA = KC + kPad;
  constexpr int LDW = KC + kPad, LDD = M + kPad, LDW1 = M + kPad;
  constexpr int SB = 2 * M + C, RED = M > kNC ? M : kNC;
  constexpr int T = 9 * M / KC, NCH = C / kNC;
  using L = Layout<M>;
  using L3 = Layout<kNC>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* As = reinterpret_cast<bf16*>(smem);  // [2][kTP][LDA]
  bf16* W2s = As + 2 * kTP * LDA;             // [2][M][LDW]: w2[k]^T chunks
  bf16* W1s = As;                             // [2][kNC][LDW1], after dy1
  bf16* D3c = W1s + 2 * kNC * LDW1;           // [2][kTP][kNC + kPad]
  bf16* D1s = reinterpret_cast<bf16*>(smem + region_dc1<M>());  // [kTP][LDD]
  float* stages = reinterpret_cast<float*>(D1s + kTP * LDD);
  float* red = stages + kWarps * 256;
  int* prow = reinterpret_cast<int*>(red + kWarps * RED);
  int* pcol = prow + kTP;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* stage = stages + warp * 256;
  const int wm = warp / L::WN, wn = warp % L::WN;
  const int wm3 = warp / L3::WN, wn3 = warp % L3::WN;
  const int p0 = blockIdx.x * kTP;
  const int r = lane >> 1, c = (lane & 1) * 8;

  tile_coords(prow, pcol, p0, np, h, w);
  __syncthreads();

  // -- dy1[p] = sum_k bf16(dc2)[p - shift_k] @ w2[k]^T: tap (ky, kx) reads
  // dc2 at row + 1 - ky, column + 1 - kx. The staged B chunk is w2[k]'s
  // rows i, columns o0 .. o0 + KC: element (o, i) of w2[k]^T.
  auto load = [&](int t, int s) {
    const int tap = t / (M / KC), o0 = (t % (M / KC)) * KC;
    load_shifted<KC>(As + s * kTP * LDA, dc2, M, o0, 1 - tap / 3, 1 - tap % 3,
                     p0, prow, pcol, h, w);
    load_rows<KC, kThreads>(W2s + s * M * LDW, LDW,
                            w2 + static_cast<size_t>(tap) * M * M + o0, M, M);
    cp_commit();
  };
  {
    FragC acc[L::FM][L::FN];
    zero<M>(acc);
    load(0, 0);
    for (int t = 0; t < T; ++t) {
      if (t + 1 < T) {
        load(t + 1, (t + 1) & 1);
        cp_wait<1>();
      } else {
        cp_wait<0>();
      }
      __syncthreads();
      mma_chunk<M, KC, true>(acc, As + (t & 1) * kTP * LDA, LDA,
                             W2s + (t & 1) * M * LDW, LDW, wm, wn);
      __syncthreads();
    }
    // dc1 = dy1 * (y1 > 0): column sums, bf16 into D1s and scratch
#pragma unroll
    for (int j = 0; j < L::FN; ++j) {
      float cs = 0.0f;
#pragma unroll
      for (int i = 0; i < L::FM; ++i) {
        wmma::store_matrix_sync(stage, acc[i][j], 16, wmma::mem_row_major);
        __syncwarp();
        const int row = (wm * L::FM + i) * 16 + r, p = p0 + row;
        const int ch = (wn * L::FN + j) * 16 + c;
        const size_t at = static_cast<size_t>(p) * M + ch;
        Pack8 yv, pk;
        yv.v = load8(y1 + at, p < np);
        float* s = stage + r * 16 + c;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float2 y = __bfloat1622float2(yv.h[q]);
          const float a = y.x > 0.0f ? s[2 * q] : 0.0f;
          const float b = y.y > 0.0f ? s[2 * q + 1] : 0.0f;
          s[2 * q] = a;
          s[2 * q + 1] = b;
          pk.h[q] = __floats2bfloat162_rn(a, b);
        }
        *reinterpret_cast<uint4*>(D1s + row * LDD + ch) = pk.v;
        if (p < np) *reinterpret_cast<uint4*>(dc1 + at) = pk.v;
        __syncwarp();
        if (lane < 16) cs += column_sum(stage, lane);
        __syncwarp();
      }
      if (lane < 16) red[wm * RED + (wn * L::FN + j) * 16 + lane] = cs;
    }
  }
  __syncthreads();  // D1s and the column sums complete; the region is free
  if (threadIdx.x < M) {
    float s = 0.0f;
    for (int g = 0; g < L::WM; ++g) s += red[g * RED + threadIdx.x];
    wsb[static_cast<size_t>(blockIdx.x) * SB + threadIdx.x] = s;
  }

  // -- dx = bf16(dy3 + bf16(dc1) @ w1^T), 64 channels of C a chunk; the
  // staged chunk is w1's rows n0 .. n0 + 63: element (m, c) of w1^T. The
  // chunk's bf16(dy3) arrives with it (cp.async, one chunk ahead).
  constexpr int LDN = kNC + kPad;
  auto load_c = [&](int n, int s) {
    load_rows<M, kThreads>(W1s + s * kNC * LDW1, LDW1,
                           w1 + static_cast<size_t>(n) * kNC * M, M, kNC);
    load_chunk(D3c + s * kTP * LDN, d3, C, n * kNC, p0, np);
    cp_commit();
  };
  load_c(0, 0);
  for (int n = 0; n < NCH; ++n) {
    const bf16* dc = D3c + (n & 1) * kTP * LDN;
    if (n + 1 < NCH) {
      load_c(n + 1, (n + 1) & 1);
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    FragC acc[L3::FM][L3::FN];
    zero<kNC>(acc);
    mma_chunk<kNC, M, true>(acc, D1s, LDD, W1s + (n & 1) * kNC * LDW1, LDW1,
                            wm3, wn3);
#pragma unroll
    for (int i = 0; i < L3::FM; ++i) {
#pragma unroll
      for (int j = 0; j < L3::FN; ++j) {
        wmma::store_matrix_sync(stage, acc[i][j], 16, wmma::mem_row_major);
        __syncwarp();
        const int row = (wm3 * L3::FM + i) * 16 + r, p = p0 + row;
        const int chl = (wn3 * L3::FN + j) * 16 + c;
        const size_t at = static_cast<size_t>(p) * C + n * kNC + chl;
        if (p < np) {
          Pack8 dv, pk;
          dv.v = *reinterpret_cast<const uint4*>(dc + row * LDN + chl);
          const float* s = stage + r * 16 + c;
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const float2 g = __bfloat1622float2(dv.h[q]);
            pk.h[q] = __floats2bfloat162_rn(g.x + s[2 * q], g.y + s[2 * q + 1]);
          }
          *reinterpret_cast<uint4*>(dx + at) = pk.v;
        }
        __syncwarp();
      }
    }
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

// Block (job, part): job is one T x T tile of dw1, of one tap of dw2, or of
// dw3 (in that order); part reduces pixels [part * pp, part * pp + pp) and
// writes its tile of slice `part` of wsw once.
template <int M>
__global__ void __launch_bounds__(kWThreads)
    wgrad_kernel(const bf16* __restrict__ x, const bf16* __restrict__ y1,
                 const bf16* __restrict__ y2, const bf16* __restrict__ d3,
                 const bf16* __restrict__ dc1, const bf16* __restrict__ dc2,
                 float* __restrict__ wsw, int np, int h, int w, int pp) {
  constexpr int C = 4 * M, T = weight_tile<M>(), LD = T + kPad;
  constexpr int NTM = M / T, NTC = C / T, VEC = T / 8;
  constexpr int FW = T >= 32 ? T / 32 : 1;  // fragments a warp, each way
  __shared__ __align__(128) bf16 As[kWStages][kKP][LD];
  __shared__ __align__(128) bf16 Bs[kWStages][kKP][LD];

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

  auto load = [&](int t, int s) {
    const int q0 = pb + t * kKP;
    for (int i = threadIdx.x; i < kKP * VEC; i += kWThreads) {
      const int r = i / VEC, v = i % VEC, p = q0 + r;
      const bool ok = p < pe;
      cp_async16(&Bs[s][r][v * 8],
                 ok ? B + static_cast<size_t>(p) * ldb + v * 8 : B, ok);
      bool oka = ok;
      if (shifted && ok) {
        const int rr = (p / w) % h + dyy, cc = p % w + dxx;
        oka = rr >= 0 && rr < h && cc >= 0 && cc < w;
      }
      cp_async16(&As[s][r][v * 8],
                 oka ? A + static_cast<size_t>(p + dyy * w + dxx) * lda + v * 8
                     : A,
                 oka);
    }
  };

  const int warp = threadIdx.x >> 5;
  const int wa = T >= 32 ? warp / 2 : 0, wb = T >= 32 ? warp % 2 : 0;
  const bool active = T >= 32 || warp == 0;
  FragC acc[FW][FW];
#pragma unroll
  for (int i = 0; i < FW; ++i)
#pragma unroll
    for (int j = 0; j < FW; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

#pragma unroll
  for (int s = 0; s < kWStages - 1; ++s) {
    if (s < steps) load(s, s);
    cp_commit();
  }
  for (int t = 0; t < steps; ++t) {
    cp_wait<kWStages - 2>();
    __syncthreads();  // stage t landed; stage t - 1 is no longer read
    if (t + kWStages - 1 < steps)
      load(t + kWStages - 1, (t + kWStages - 1) % kWStages);
    cp_commit();
    const int s = t % kWStages;
    if (active) {
#pragma unroll
      for (int k = 0; k < kKP; k += 16) {
        FragAt a[FW];
#pragma unroll
        for (int i = 0; i < FW; ++i)
          wmma::load_matrix_sync(a[i], &As[s][k][(wa * FW + i) * 16], LD);
#pragma unroll
        for (int j = 0; j < FW; ++j) {
          FragB b;
          wmma::load_matrix_sync(b, &Bs[s][k][(wb * FW + j) * 16], LD);
#pragma unroll
          for (int i = 0; i < FW; ++i)
            wmma::mma_sync(acc[i][j], a[i], b, acc[i][j]);
        }
      }
    }
  }
  cp_wait<0>();
  if (active) {
    float* o = wsw + blockIdx.y * weight_floats<M>() + out;
#pragma unroll
    for (int i = 0; i < FW; ++i)
#pragma unroll
      for (int j = 0; j < FW; ++j)
        wmma::store_matrix_sync(
            o + static_cast<size_t>((wa * FW + i) * 16) * ldo +
                (wb * FW + j) * 16,
            acc[i][j], ldo, wmma::mem_row_major);
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

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) cudaGetLastError();  // not left for the next check
  return err;
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
      (err = allow_smem(dc2_kernel<M>, smem_dc2<M>())) != cudaSuccess ||
      (err = allow_smem(dc1_kernel<M>, smem_dc1<M>())) != cudaSuccess)
    return static_cast<int>(err);
  // each launch the runtime accepted adds one to *launched
  auto accepted = [&]() {
    err = cudaGetLastError();
    if (err == cudaSuccess) ++*launched;
    return err == cudaSuccess;
  };
  y1_kernel<M><<<tiles, kThreads, smem_y1<M>(), stream>>>(x, w1, b1, y1, np);
  if (!accepted()) return static_cast<int>(err);
  dc2_kernel<M><<<tiles, kThreads, smem_dc2<M>(), stream>>>(
      x, dy, y1, w2, b2, w3, b3, y2, d3, dc2, wsb, np, h, w);
  if (!accepted()) return static_cast<int>(err);
  dc1_kernel<M><<<tiles, kThreads, smem_dc1<M>(), stream>>>(
      d3, y1, dc2, w1, w2, dx, dc1, wsb, np, h, w);
  if (!accepted()) return static_cast<int>(err);
  wgrad_kernel<M><<<dim3(weight_jobs<M>(), parts), kWThreads, 0, stream>>>(
      x, y1, y2, d3, dc1, dc2, wsw, np, h, w, pp);
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
// y1_kernel, dc2_kernel and dc1_kernel. Returns 0, or
// cudaErrorInvalidValue for another m.
extern "C" int detjax_bottleneck_bwd_geometry(int m, int* out) {
#define DETJAX_GEOM(MM)                                                    \
  case MM:                                                                 \
    out[2] = weight_tile<MM>();                                            \
    out[3] = weight_jobs<MM>();                                            \
    out[4] = static_cast<int>(smem_y1<MM>());                              \
    out[5] = static_cast<int>(smem_dc2<MM>());                             \
    out[6] = static_cast<int>(smem_dc1<MM>());                             \
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
  return 0;
}
