// Device code that the fused bottleneck's forward (bottleneck.cu) and
// backward (bottleneck_bwd.cu) share: the 128-pixel tiles, the cp.async
// copies, the wgmma operand layout and instruction, and the products both
// run on a tile: y1 (y1_kernel), the 3x3 to y2 (tile_y2) and a 64-channel
// chunk of y3 (chunk_y3). Both kernels call these in the same tap, chunk
// and k order, so the forward's pre-activation (y2 @ w3 + b3) + x equals,
// bit for bit, the one the backward recomputes for its ReLU mask.
//
// Each source that includes this header builds into its own library; the
// anonymous namespace keeps the two copies apart.

#pragma once

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;  // activation kernels: 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kTP = 128;  // pixels a tile of the activation kernels
constexpr int kNC = 64;   // channels a chunk of C
constexpr int kPad = 8;   // bf16 a shared row holds beyond its width

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

template <int M>
__host__ __device__ constexpr int atoms() {  // 64-channel atoms of M
  return M > 64 ? M / 64 : 1;
}

// ---- y1 = bf16(relu(x @ w1 + b1)) -------------------------------------------

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

// ---- a tile's y2, a chunk's y3 ----------------------------------------------

// The shared memory of the tile kernels that run tile_y2, from the 1024-byte
// boundary, starts with a region that the 3x3's stages use (A [2][kAtom], B
// [2][atoms][64 rows x 128 bytes]) and after them each kernel's C chunks: a
// weight [2][atoms][64 rows x 128 bytes], a 64-channel tile [kAtom] and two
// [kTP][kNC + kPad] bf16 tiles.
template <int M>
__host__ __device__ constexpr size_t region_tile() {
  constexpr size_t stage = atoms<M>() * 64 * 128;
  constexpr size_t conv = 2 * kAtom + 2 * stage;
  constexpr size_t chunks =
      2 * stage + kAtom + 2 * kTP * (kNC + kPad) * sizeof(bf16);
  return conv > chunks ? conv : chunks;
}

// y2 = bf16(relu(sum_k shift_k(y1) @ w2[k] + b2)) of the tile's pixels into
// Y2s [atoms][kAtom], K = 9 M in stages of k_chunk<M>() channels of one tap:
// A (K-major) the tap's shifted rows of y1 [np, M], zeros outside the
// image; B (MN-major) the stage's rows of w2[tap]; cp.async two stages deep
// in sm's region (A [2][kAtom], then B [2][atoms][64 rows x 128 bytes]).
// Returns with y2 complete and visible to every thread and to wgmma, and
// the region free. M < 64 runs the same 64-wide products: the columns past M
// hold whatever the unused shared memory held and are never written (a
// column of a product depends only on its own column of B), and the K steps
// stop at M.
template <int M>
__device__ __forceinline__ void tile_y2(unsigned char* sm, unsigned char* Y2s,
                                        const bf16* __restrict__ y1,
                                        const bf16* __restrict__ w2,
                                        const float* __restrict__ b2, int p0,
                                        const int* prow, const int* pcol,
                                        int h, int w) {
  constexpr int KC = k_chunk<M>(), NA = atoms<M>();
  constexpr int T = 9 * M / KC, STAGE = NA * 64 * 128;
  unsigned char* As = sm;              // [2][kAtom]: shifted y1
  unsigned char* Bs = sm + 2 * kAtom;  // [2][STAGE]: w2 rows, MN-major
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const uint32_t grow = (warp >> 2) * 64 * 128;  // the warpgroup's 64 rows
  const int row0 = 16 * warp + (lane >> 2);      // rows row0, row0 + 8
  const int q2 = 2 * (lane & 3);                 // columns 8 j + q2, + 1

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
}

// Rows 0 .. M - 1 of w3 [M, C], channels n kNC .. n kNC + 63, into dst
// (one 128-byte swizzle row each): B of chunk_y3 (MN-major). Not committed.
template <int M>
__device__ __forceinline__ void load_w3_chunk(unsigned char* dst,
                                              const bf16* __restrict__ w3,
                                              int n) {
  for (int i = threadIdx.x; i < M * 8; i += kThreads) {
    const int k = i >> 3, v = i & 7;
    cp_async16(dst + sw(k, v),
               w3 + static_cast<size_t>(k) * 4 * M + n * kNC + v * 8, true);
  }
}

// acc3 = y2 @ w3[:, chunk] on the warpgroup's 64 rows (grow): A is y2
// (K-major, M channels in atoms, at shared address y2s), B the chunk's
// staged rows of w3 (at w3c). The caller adds b3 and the residual.
template <int M>
__device__ __forceinline__ void chunk_y3(float (&acc3)[32], uint32_t y2s,
                                         uint32_t w3c, uint32_t grow) {
#pragma unroll
  for (int i = 0; i < 32; ++i) acc3[i] = 0.0f;
  pin(acc3);
  wg_fence();
#pragma unroll
  for (int k = 0; k < M / 16; ++k)
    wgmma64<0, 1>(acc3,
                  sw128_desc(y2s + (k >> 2) * kAtom + grow + 32 * (k & 3)),
                  sw128_desc(w3c + 2048 * k));
  wg_commit_wait();
  pin(acc3);
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) cudaGetLastError();  // not left for the next check
  return err;
}

}  // namespace
