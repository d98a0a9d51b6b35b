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
// tiles, fp32 sums in registers; the layout is at "wgmma" below), in every
// kernel but sum_rows. A pixel's 64 channels are one
// 128-byte swizzle row, so the 3x3's shifted rows land by 16-byte cp.async
// like any other row, as A (K-major: pixels x channels) in the tile
// kernels and as both operands (MN-major) in the weight gradients; each
// weight is read K-major or MN-major as its product needs, so w3's staged
// rows serve y3 and dc2 alike. A tile kernel's two warpgroups take 64
// pixel rows each, and its epilogues (bias, ReLU masks, column sums by warp
// shuffles in a fixed order, bf16) work on the accumulator registers.
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

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;   // activation kernels: 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kTP = 128;        // pixels a tile of the activation kernels
constexpr int kNC = 64;         // channels a chunk of C
constexpr int kPad = 8;         // bf16 a shared row holds beyond its width
constexpr int kWThreads = 128;  // weight-gradient kernel: one warpgroup
constexpr int kKP = 64;         // pixels a stage of the weight gradients

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

template <int M>
__host__ __device__ constexpr int k_chunk() {  // channels a 3x3 stage
  return M < 64 ? M : 64;
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

// ---- wgmma: the shared operand layout and the instruction -------------------

// A SW128 tile: rows of 128 bytes (64 bf16 channels), 16-byte chunk c of row
// r at chunk c ^ (r % 8), from a 1024-byte boundary, 8-row groups 1024
// bytes apart. wgmma reads it as a K-major operand (rows are its M or N,
// channels its K; a k16 step moves 32 bytes) or as an MN-major one (rows
// are K; a k16 step moves 16 rows, 2048 bytes). Every operand a product
// reads spans one 64-channel swizzle atom along M or N, so the
// descriptor's leading offset is never used; it is set to the group stride
// as well. Wider tiles are atoms of 128 rows, kAtom bytes apart.
constexpr int kAtom = kTP * 128;

__device__ __forceinline__ int sw(int r, int c) {
  return r * 128 + ((c ^ (r & 7)) << 4);
}

// Byte offset of channel col (even) of row r in a tile of 128-row atoms.
__device__ __forceinline__ int at2(int r, int col) {
  return (col >> 6) * kAtom + sw(r, (col & 63) >> 3) + (col & 7) * 2;
}

__device__ __forceinline__ void put2(unsigned char* tile, int r, int col,
                                     float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(tile + at2(r, col)) =
      __floats2bfloat162_rn(a, b);
}

__device__ __forceinline__ float2 get2(const unsigned char* tile, int r,
                                       int col) {
  return __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(tile + at2(r, col)));
}

__device__ __forceinline__ uint32_t saddr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The block's dynamic shared memory from its first 1024-byte boundary (the
// launch asks for 1024 bytes more).
__device__ __forceinline__ unsigned char* smem_1k(unsigned char* raw) {
  const uint32_t a = saddr(raw);
  return raw + (((a + 1023u) & ~1023u) - a);
}

__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1024 >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

// d[64 x 64] += A[64 x 16] B[16 x 64], bf16 products, fp32 sums; TA / TB:
// that operand is stored MN-major.
template <int TA, int TB>
__device__ __forceinline__ void wgmma64(float (&d)[32], uint64_t da,
                                        uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, %32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

// Keeps the compiler from moving reads or writes of the accumulators across
// the wgmma fence and wait (they are written behind its back).
__device__ __forceinline__ void pin(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wg_commit_wait() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// This thread's shared writes (st.shared, cp.async) made visible to wgmma,
// which reads through the async proxy; a barrier follows.
__device__ __forceinline__ void proxy_fence() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

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

// KC channels from ch0 of the tile's pixels shifted by (dyy, dxx) inside
// their image, from src [np, M], into a SW128 tile; zeros where the
// shifted pixel is outside.
template <int KC>
__device__ __forceinline__ void load_shifted_sw(unsigned char* dst,
                                                const bf16* src, int m,
                                                int ch0, int dyy, int dxx,
                                                int p0, const int* prow,
                                                const int* pcol, int h,
                                                int w) {
  constexpr int VEC = KC / 8;
  for (int i = threadIdx.x; i < kTP * VEC; i += kThreads) {
    const int r = i / VEC, v = i % VEC;
    const int rr = prow[r] + dyy, cc = pcol[r] + dxx;
    const bool ok = rr >= 0 && rr < h && cc >= 0 && cc < w;
    const bf16* s =
        ok ? src + (static_cast<size_t>(p0 + r + dyy * w + dxx)) * m + ch0 +
                 v * 8
           : src;
    cp_async16(dst + sw(r, v), s, ok);
  }
}

// COLS channels of the tile's pixels below np from a tile of 128-row atoms
// to dst [np, ld] from column col0, 16 bytes a copy.
template <int COLS>
__device__ __forceinline__ void store_tile(bf16* dst, int ld, int col0,
                                           const unsigned char* tile, int p0,
                                           int np) {
  constexpr int VEC = COLS / 8;
  for (int i = threadIdx.x; i < kTP * VEC; i += kThreads) {
    const int r = i / VEC, v = i % VEC;
    if (p0 + r < np)
      *reinterpret_cast<uint4*>(dst + static_cast<size_t>(p0 + r) * ld +
                                col0 + v * 8) =
          *reinterpret_cast<const uint4*>(tile + (v >> 3) * kAtom +
                                          sw(r, v & 7));
  }
}

// ---- 1: y1 = bf16(relu(x @ w1 + b1)) ----------------------------------------

template <int M>
__host__ __device__ constexpr int atoms() {  // 64-channel atoms of M
  return M > 64 ? M / 64 : 1;
}

// From the 1024-byte boundary: x's chunks [2][kAtom], then w1's rows
// [2][atoms][64 rows x 128 bytes]; y1 [atoms][kAtom] takes x's place after
// the last chunk.
template <int M>
__host__ __device__ constexpr size_t smem_y1() {
  return 1024 + 2 * kAtom + 2 * atoms<M>() * 64 * 128;
}

// One 128-pixel tile, two warpgroups of 64 pixel rows: A is x's chunk
// (K-major), B w1's rows of the chunk (MN-major).
template <int M>
__global__ void __launch_bounds__(kThreads)
    y1_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w1,
              const float* __restrict__ b1, bf16* __restrict__ y1, int np) {
  constexpr int C = 4 * M, NA = atoms<M>(), STAGE = NA * 64 * 128;
  constexpr int T = C / kNC;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* sm = smem_1k(smem_raw);
  unsigned char* As = sm;              // [2][kAtom]
  unsigned char* Bs = sm + 2 * kAtom;  // [2][STAGE]
  unsigned char* Ys = sm;              // [NA][kAtom], after the last chunk
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const uint32_t grow = (warp >> 2) * 64 * 128;
  const int row0 = 16 * warp + (lane >> 2);
  const int q2 = 2 * (lane & 3);
  const int p0 = blockIdx.x * kTP;

  float acc[NA][32];
#pragma unroll
  for (int a = 0; a < NA; ++a)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[a][i] = 0.0f;
  auto load = [&](int t, int s) {
    for (int i = threadIdx.x; i < kTP * 8; i += kThreads) {
      const int r = i >> 3, v = i & 7;
      const bool ok = p0 + r < np;
      cp_async16(As + s * kAtom + sw(r, v),
                 ok ? x + static_cast<size_t>(p0 + r) * C + t * kNC + v * 8
                    : x,
                 ok);
    }
    for (int i = threadIdx.x; i < kNC * (M / 8); i += kThreads) {
      const int k = i / (M / 8), v = i % (M / 8);
      cp_async16(Bs + s * STAGE + (v >> 3) * 8192 + sw(k, v & 7),
                 w1 + static_cast<size_t>(t * kNC + k) * M + v * 8, true);
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
    for (int k = 0; k < kNC / 16; ++k)
#pragma unroll
      for (int n = 0; n < NA; ++n)
        wgmma64<0, 1>(acc[n], sw128_desc(a + 32 * k),
                      sw128_desc(b + n * 8192 + 2048 * k));
    wg_commit_wait();
#pragma unroll
    for (int n = 0; n < NA; ++n) pin(acc[n]);
    __syncthreads();  // before the next load rewrites this stage
  }
#pragma unroll
  for (int n = 0; n < NA; ++n)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = 64 * n + 8 * j + q2;
      if (col < M) {
#pragma unroll
        for (int e = 0; e < 2; ++e)
          put2(Ys, row0 + 8 * e, col,
               fmaxf(acc[n][4 * j + 2 * e] + b1[col], 0.0f),
               fmaxf(acc[n][4 * j + 2 * e + 1] + b1[col + 1], 0.0f));
      }
    }
  __syncthreads();
  store_tile<M>(y1, M, 0, Ys, p0, np);
}

// ---- 2: y2, dy3, dc2 -----------------------------------------------------

// The shared memory of both tile kernels, from the 1024-byte boundary: a
// region that the 3x3's stages use (A [2][kAtom], B [2][atoms][64 rows x
// 128 bytes]) and then the C chunks (a weight [2][atoms][64 rows x 128
// bytes], a 64-channel tile [kAtom], two [kTP][kNC + kPad] bf16 tiles);
// then an [atoms][kAtom] tile, the column sums [kWarps][max(M, kNC)] fp32
// and the tile's coordinates.
template <int M>
__host__ __device__ constexpr size_t region_tile() {
  constexpr size_t stage = atoms<M>() * 64 * 128;
  constexpr size_t conv = 2 * kAtom + 2 * stage;
  constexpr size_t chunks =
      2 * stage + kAtom + 2 * kTP * (kNC + kPad) * sizeof(bf16);
  return conv > chunks ? conv : chunks;
}

template <int M>
__host__ __device__ constexpr size_t smem_tile() {
  return 1024 + region_tile<M>() + atoms<M>() * kAtom +
         kWarps * (M > kNC ? M : kNC) * sizeof(float) + 2 * kTP * sizeof(int);
}

// One 128-pixel tile, two warpgroups of 64 pixel rows; every product is
// wgmma from SW128 tiles. Shared memory (region_tile): the 3x3's stages,
// then w3 [2][atoms][64 rows x 128 bytes], bf16(dy3) [kAtom], the x and dy
// chunks and, after the last chunk, bf16(dc2) [atoms][kAtom]; then y2
// [atoms][kAtom], the column sums and the tile's coordinates. M < 64 runs the same 64-wide products: the
// columns past M hold whatever the unused shared memory held and are never
// stored or summed (a column of a product depends only on its own column of
// B), and the K steps stop at M.
template <int M>
__global__ void __launch_bounds__(kThreads, M <= 64 ? 2 : 1)
    dc2_kernel(const bf16* __restrict__ x, const bf16* __restrict__ dy,
               const bf16* __restrict__ y1, const bf16* __restrict__ w2,
               const float* __restrict__ b2, const bf16* __restrict__ w3,
               const float* __restrict__ b3, bf16* __restrict__ y2,
               bf16* __restrict__ d3, bf16* __restrict__ dc2,
               float* __restrict__ wsb, int np, int h, int w) {
  constexpr int C = 4 * M, KC = k_chunk<M>(), NA = atoms<M>();
  constexpr int SB = 2 * M + C, RED = M > kNC ? M : kNC, LDN = kNC + kPad;
  constexpr int T = 9 * M / KC, NCH = C / kNC, STAGE = NA * 64 * 128;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* sm = smem_1k(smem_raw);
  unsigned char* As = sm;                 // [2][kAtom]: shifted y1
  unsigned char* Bs = sm + 2 * kAtom;     // [2][STAGE]: w2 rows, MN-major
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

  // -- y2 = bf16(relu(sum_k shift_k(y1) @ w2[k] + b2)), K = 9 M in chunks
  float acc[NA][32];
#pragma unroll
  for (int a = 0; a < NA; ++a)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[a][i] = 0.0f;
  auto load = [&](int t, int s) {
    const int tap = t / (M / KC), ch0 = (t % (M / KC)) * KC;
    load_shifted_sw<KC>(As + s * kAtom, y1, M, ch0, tap / 3 - 1, tap % 3 - 1,
                        p0, prow, pcol, h, w);
    const bf16* src = w2 + (static_cast<size_t>(tap) * M + ch0) * M;
    unsigned char* dst = Bs + s * STAGE;
    for (int i = threadIdx.x; i < KC * (M / 8); i += kThreads) {
      const int k = i / (M / 8), v = i % (M / 8);
      cp_async16(dst + (v >> 3) * 8192 + sw(k, v & 7),
                 src + static_cast<size_t>(k) * M + v * 8, true);
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
        wgmma64<0, 1>(acc[n], sw128_desc(a + 32 * k),
                      sw128_desc(b + n * 8192 + 2048 * k));
    wg_commit_wait();
#pragma unroll
    for (int n = 0; n < NA; ++n) pin(acc[n]);
    __syncthreads();  // before the next load rewrites this stage
  }
#pragma unroll
  for (int n = 0; n < NA; ++n)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = 64 * n + 8 * j + q2;
      if (col < M) {
#pragma unroll
        for (int e = 0; e < 2; ++e)
          put2(Y2s, row0 + 8 * e, col,
               fmaxf(acc[n][4 * j + 2 * e] + b2[col], 0.0f),
               fmaxf(acc[n][4 * j + 2 * e + 1] + b2[col + 1], 0.0f));
      }
    }
  proxy_fence();
  __syncthreads();  // y2 complete
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
    for (int i = threadIdx.x; i < M * 8; i += kThreads) {
      const int k = i >> 3, v = i & 7;
      cp_async16(W3s + s * STAGE + sw(k, v),
                 w3 + static_cast<size_t>(k) * C + n * kNC + v * 8, true);
    }
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
#pragma unroll
    for (int i = 0; i < 32; ++i) acc3[i] = 0.0f;
    pin(acc3);
    wg_fence();
#pragma unroll
    for (int k = 0; k < M / 16; ++k)
      wgmma64<0, 1>(acc3,
                    sw128_desc(saddr(Y2s) + (k >> 2) * kAtom + grow +
                               32 * (k & 3)),
                    sw128_desc(w3c + 2048 * k));
    wg_commit_wait();
    pin(acc3);
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
