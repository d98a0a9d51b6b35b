// Stem max-pool backward (3x3 window, stride 2, pad 1), for Hopper (sm_90a).
//
// Replaces the TPU kernel detjax/kernels/stem.py::_maxpool_bwd (line 163;
// body _bwd_kernel, line 63). Same function: for every window (r, c) of the
// pool, m is the NaN-propagating max of its 9 taps z[2r+d-1, 2c+e-1] (an
// out-of-range tap reads as -inf), and the window's dp goes to the first tap
// in scan order (d, then e) that equals m. A window holding NaN matches no
// tap, and a border window whose real taps are all -inf matches its padding
// tap first: both route nowhere. Each dz pixel sums in fp32, from +0.0, the
// dp of the windows that route to it, in tap scan order:
//   dz(2k,   2j)   <- (k, j)
//   dz(2k,   2j+1) <- (k, j+1), (k, j)
//   dz(2k+1, 2j)   <- (k+1, j), (k, j)
//   dz(2k+1, 2j+1) <- (k+1, j+1), (k+1, j), (k, j+1), (k, j)
// and rounds once to dp's dtype. That is the Pallas kernel's order (it adds
// each tap's routed dp onto four parity planes in tap order), so the result
// is bit-equal to the plain twin kernels/stem.py::maxpool_bwd_reference. No
// fmaxf / __hmax: they drop NaN.
//
// Two instances, both the gather form with no atomics, so two runs give
// equal bits.
//
// The strip instance (bf16, C a multiple of 64, 16-byte-aligned buffers:
// the stem's case). A block owns a run of kCols pool columns of kSeg pool
// rows of one image, for 64 channels, one thread a (column, 8-channel
// group) and one more column of threads for the run's right halo window.
// It walks its rows one window row a step; each step's z rows 2k and
// 2k + 1 (with a column of halo on each side; -inf outside z) and dp row k
// arrive in shared memory by 16-byte cp.async, three steps in a ring, so
// the next two steps' loads overlap this step's compute; z row 2k - 1 is
// the previous step's 2k + 1, kept in registers. Each thread finds its
// window's first max for 8 channels at once on bf16x2 pairs (max.NaN,
// which propagates NaN; set.eq, which equals -0 to +0 and never NaN) and
// routes dp as 9 masked values, one a tap; the three taps that land in
// the column left of the window go to the left neighbour through shared
// memory. A dz pixel then sums its routed values in the tap order above:
// one or two terms in bf16x2 (the fp32 sum of two bf16 values rounds to
// bf16 as their exact sum does, and +0.0 + -0.0 is +0.0 in both), four in
// fp32, rounded once; 16-byte stores. z comes from device memory about
// once (the next block's halo column and the next segment's first row
// come from L2), dp once, dz is written once.
//
// The gather instance (fp32, other C, unaligned views; the first port's
// kernel). One
// thread owns the 2x2 dz block (2k..2k+1, 2j..2j+1) of one channel, or of a
// channel pair as bf16x2. It loads the 5x5 patch of z that the four windows
// (k, j), (k, j+1), (k+1, j), (k+1, j+1) cover, finds each window's first
// max, and adds their dp in the order above. Channels are the fastest index
// (NHWC, the port's channels-last NCHW), so a warp's loads coalesce: C = 64
// bf16 is one 128-byte line a pixel. The Pallas kernel splits z into four
// parity planes because Mosaic has no stride-2 slices; here every tap is an
// address, and no relayout runs. Grid: x walks a row's (pixel, channel)
// threads, y the row k, z the image; offsets are 64-bit.
//
// What bounds it: bytes. z and dp read once, dz written once: 471.9 MB at the
// R50-640 training stem ([16, 320, 320, 64] bf16), 0.141 ms at 3.35 TB/s.
// The gather instance's threads read 25 taps for 4 outputs, 4 bytes a
// load; the other 21 are its neighbours' and come from L1/L2, and its
// narrow loads hold it at under a fifth of that rate (PERF.md). The strip
// instance reaches about four fifths of it.
//
// Requirements (the wrapper checks them): z [B, 2H, 2W, C], dp [B, H, W, C]
// and dz [B, 2H, 2W, C], contiguous, one dtype (fp32 or bf16); H, B <= 65535.
// Build with -fmad=false (nothing here multiplies; it keeps the sums'
// order as written).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

// V consecutive channels of one pixel, widened to fp32 (bf16 -> fp32 is
// exact, so comparing in fp32 routes as comparing in bf16).
template <typename T, int V>
struct Pack {
  float v[V];
};

__device__ __forceinline__ void load(const float* p, Pack<float, 1>& out) {
  out.v[0] = *p;
}

__device__ __forceinline__ void load(const __nv_bfloat16* p,
                                     Pack<__nv_bfloat16, 1>& out) {
  out.v[0] = __bfloat162float(*p);
}

__device__ __forceinline__ void load(const __nv_bfloat16* p,
                                     Pack<__nv_bfloat16, 2>& out) {
  const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
  out.v[0] = f.x;
  out.v[1] = f.y;
}

__device__ __forceinline__ void store(float* p, const float (&v)[1]) {
  *p = v[0];
}

__device__ __forceinline__ void store(__nv_bfloat16* p, const float (&v)[1]) {
  *p = __float2bfloat16_rn(v[0]);
}

__device__ __forceinline__ void store(__nv_bfloat16* p, const float (&v)[2]) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v[0], v[1]);
}

// jnp.maximum: NaN if either side is NaN, else the larger.
__device__ __forceinline__ float nan_max(float m, float t) {
  return (t > m || t != t) ? t : m;
}

// Index (d * 3 + e) of the first tap of window (dk, dj) of the patch that
// equals the window's max, or -1 (NaN max). p[y][x] is z[2k-1+y, 2j-1+x].
__device__ __forceinline__ int first_max(const float (&p)[5][5], int dk,
                                         int dj) {
  const int y0 = 2 * dk, x0 = 2 * dj;
  float m = p[y0][x0];
#pragma unroll
  for (int t = 1; t < 9; ++t) m = nan_max(m, p[y0 + t / 3][x0 + t % 3]);
  int first = -1;
#pragma unroll
  for (int t = 8; t >= 0; --t)
    if (p[y0 + t / 3][x0 + t % 3] == m) first = t;
  return first;
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    maxpool_bwd_kernel(const T* __restrict__ z,   // [B, 2H, 2W, C]
                       const T* __restrict__ dp,  // [B, H, W, C]
                       T* __restrict__ dz,        // [B, 2H, 2W, C]
                       int h, int w, int c) {
  const int groups = c / V;  // channel groups a pixel
  const int t = blockIdx.x * kThreads + threadIdx.x;
  if (t >= w * groups) return;
  const int j = t / groups;
  const int ch = (t - j * groups) * V;
  const int k = blockIdx.y;
  const int b = blockIdx.z;
  const int hz = 2 * h, wz = 2 * w;
  const long long zimg = static_cast<long long>(b) * hz * wz;
  const long long pimg = static_cast<long long>(b) * h * w;

  // the 5x5 patch z[2k-1 .. 2k+3, 2j-1 .. 2j+3], -inf outside z
  float patch[V][5][5];
#pragma unroll
  for (int y = 0; y < 5; ++y) {
    const int zy = 2 * k - 1 + y;
#pragma unroll
    for (int x = 0; x < 5; ++x) {
      const int zx = 2 * j - 1 + x;
      Pack<T, V> v;
      if (zy >= 0 && zy < hz && zx >= 0 && zx < wz) {
        load(z + ((zimg + static_cast<long long>(zy) * wz + zx) * c + ch), v);
      } else {
#pragma unroll
        for (int q = 0; q < V; ++q) v.v[q] = -__int_as_float(0x7f800000);
      }
#pragma unroll
      for (int q = 0; q < V; ++q) patch[q][y][x] = v.v[q];
    }
  }

  // dp of the four windows, 0 where a window does not exist
  const bool down = k + 1 < h, right = j + 1 < w;
  float g[2][2][V];
#pragma unroll
  for (int dk = 0; dk < 2; ++dk) {
#pragma unroll
    for (int dj = 0; dj < 2; ++dj) {
      Pack<T, V> v;
      if ((dk == 0 || down) && (dj == 0 || right)) {
        load(dp + ((pimg + static_cast<long long>(k + dk) * w + j + dj) * c +
                   ch), v);
      } else {
#pragma unroll
        for (int q = 0; q < V; ++q) v.v[q] = 0.0f;
      }
#pragma unroll
      for (int q = 0; q < V; ++q) g[dk][dj][q] = v.v[q];
    }
  }

  float o00[V], o01[V], o10[V], o11[V];
#pragma unroll
  for (int q = 0; q < V; ++q) {
    const int r00 = first_max(patch[q], 0, 0);
    const int r01 = right ? first_max(patch[q], 0, 1) : -1;
    const int r10 = down ? first_max(patch[q], 1, 0) : -1;
    const int r11 = down && right ? first_max(patch[q], 1, 1) : -1;
    float a = 0.0f;
    if (r00 == 4) a += g[0][0][q];  // tap (1, 1)
    o00[q] = a;
    a = 0.0f;
    if (r01 == 3) a += g[0][1][q];  // (k, j+1) at tap (1, 0)
    if (r00 == 5) a += g[0][0][q];  // (k, j) at tap (1, 2)
    o01[q] = a;
    a = 0.0f;
    if (r10 == 1) a += g[1][0][q];  // (k+1, j) at tap (0, 1)
    if (r00 == 7) a += g[0][0][q];  // (k, j) at tap (2, 1)
    o10[q] = a;
    a = 0.0f;
    if (r11 == 0) a += g[1][1][q];  // (k+1, j+1) at tap (0, 0)
    if (r10 == 2) a += g[1][0][q];  // (k+1, j) at tap (0, 2)
    if (r01 == 6) a += g[0][1][q];  // (k, j+1) at tap (2, 0)
    if (r00 == 8) a += g[0][0][q];  // (k, j) at tap (2, 2)
    o11[q] = a;
  }
  const long long row0 = (zimg + static_cast<long long>(2 * k) * wz + 2 * j) *
                             c + ch;
  const long long row1 = row0 + static_cast<long long>(wz) * c;
  store(dz + row0, o00);
  store(dz + row0 + c, o01);
  store(dz + row1, o10);
  store(dz + row1 + c, o11);
}

// -- the strip instance ------------------------------------------------------

// A block: 33 x 8 threads (9 warps), 101 KB of shared memory, two blocks
// an SM; 16 rows a segment keep the grid near 1,600 blocks at the 640
// stem and the redone halo row near 6 %.
constexpr int kCols = 32;             // pool columns a block finalizes
constexpr int kSeg = 16;              // pool rows a block finalizes
constexpr int kGroups = 8;            // 8-channel groups a block: C = 64
constexpr int kStages = 3;            // steps in the shared-memory ring
constexpr int kWinCols = kCols + 1;   // windows a step: the run and halo
constexpr int kZCols = 2 * kCols + 3;  // z columns 2j0 - 1 .. 2j0 + 2kCols + 1
constexpr int kStripThreads = (kWinCols * kGroups + 31) / 32 * 32;
// a stage: z rows 2k - 1 (the first step only), 2k and 2k + 1, then dp row
// k; 16-byte chunks, [row][column][group]
constexpr int kZChunks = 3 * kZCols * kGroups;
constexpr int kDpChunks = kWinCols * kGroups;
constexpr int kStageChunks = kZChunks + kDpChunks;
constexpr size_t kStripSmem =
    sizeof(uint4) * (kStages * kStageChunks + 3 * kStripThreads);

__device__ __forceinline__ unsigned max_nan2(unsigned a, unsigned b) {
  unsigned d;
  asm("max.NaN.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

// 0xffff in each half where a == b (-0 equals +0; NaN equals nothing)
__device__ __forceinline__ unsigned eq_mask2(unsigned a, unsigned b) {
  unsigned d;
  asm("set.eq.u32.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

// RN(a + b) per bf16 half
__device__ __forceinline__ unsigned add2(unsigned a, unsigned b) {
  unsigned d;
  asm("add.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

// bf16 pairs -> ((0 + a) + b), rounded once to bf16: for two bf16 terms
// the fp32 sum rounds to bf16 as the exact sum does
__device__ __forceinline__ uint4 sum2(uint4 a, uint4 b) {
  return make_uint4(add2(add2(0u, a.x), b.x), add2(add2(0u, a.y), b.y),
                    add2(add2(0u, a.z), b.z), add2(add2(0u, a.w), b.w));
}

__device__ __forceinline__ uint4 sum1(uint4 a) {
  return make_uint4(add2(0u, a.x), add2(0u, a.y), add2(0u, a.z),
                    add2(0u, a.w));
}

// (((0 + a) + b) + c) + d in fp32 for each bf16 half, rounded once
__device__ __forceinline__ unsigned sum4_pair(unsigned a, unsigned b,
                                              unsigned c, unsigned d) {
  float lo = 0.0f, hi = 0.0f;
  lo += __uint_as_float(a << 16);
  hi += __uint_as_float(a & 0xffff0000u);
  lo += __uint_as_float(b << 16);
  hi += __uint_as_float(b & 0xffff0000u);
  lo += __uint_as_float(c << 16);
  hi += __uint_as_float(c & 0xffff0000u);
  lo += __uint_as_float(d << 16);
  hi += __uint_as_float(d & 0xffff0000u);
  const __nv_bfloat162 r = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&r);
}

__device__ __forceinline__ uint4 sum4(uint4 a, uint4 b, uint4 c, uint4 d) {
  return make_uint4(sum4_pair(a.x, b.x, c.x, d.x),
                    sum4_pair(a.y, b.y, c.y, d.y),
                    sum4_pair(a.z, b.z, c.z, d.z),
                    sum4_pair(a.w, b.w, c.w, d.w));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// One thread's 8-channel window: the 9 taps (tap t = 3d + e is p[d][e]),
// dp g; out[t] is g where tap t is the first in scan order that equals the
// window's NaN-propagating max, else +0, per channel.
__device__ __forceinline__ void route(const uint4 (&p)[3][3], uint4 g,
                                      uint4 (&out)[9]) {
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    unsigned t[9];
#pragma unroll
    for (int u = 0; u < 9; ++u) {
      const uint4 v = p[u / 3][u % 3];
      t[u] = q == 0 ? v.x : q == 1 ? v.y : q == 2 ? v.z : v.w;
    }
    const unsigned gq = q == 0 ? g.x : q == 1 ? g.y : q == 2 ? g.z : g.w;
    unsigned m = t[0];
#pragma unroll
    for (int u = 1; u < 9; ++u) m = max_nan2(m, t[u]);
    unsigned taken = 0;
#pragma unroll
    for (int u = 0; u < 9; ++u) {
      const unsigned e = eq_mask2(t[u], m);
      const unsigned x = e & ~taken & gq;
      taken |= e;
      if (q == 0) out[u].x = x;
      if (q == 1) out[u].y = x;
      if (q == 2) out[u].z = x;
      if (q == 3) out[u].w = x;
    }
  }
}

__global__ void __launch_bounds__(kStripThreads, 2)
    maxpool_bwd_strip_kernel(const __nv_bfloat16* __restrict__ z,
                             const __nv_bfloat16* __restrict__ dp,
                             __nv_bfloat16* __restrict__ dz, int h, int w,
                             int c) {
  extern __shared__ uint4 sm[];
  uint4* stages = sm;                           // [kStages][kStageChunks]
  uint4* xch = sm + kStages * kStageChunks;     // [3][kStripThreads]
  const int tid = threadIdx.x;
  const int col = tid / kGroups, grp = tid % kGroups;
  const int j0 = blockIdx.x * kCols;
  const int k0 = blockIdx.y * kSeg;
  const int k1 = min(k0 + kSeg, h);  // the block finalizes rows [k0, k1)
  const int steps = k1 - k0 + 1;     // windows k0 .. k1 (k1: the halo row)
  const int blocks_c = c / (8 * kGroups);
  const int b = blockIdx.z / blocks_c;
  const int ch = (blockIdx.z % blocks_c) * 8 * kGroups;
  const int hz = 2 * h, wz = 2 * w;
  const __nv_bfloat16* zimg = z + static_cast<size_t>(b) * hz * wz * c + ch;
  const __nv_bfloat16* pimg = dp + static_cast<size_t>(b) * h * w * c + ch;
  __nv_bfloat16* dimg = dz + static_cast<size_t>(b) * hz * wz * c + ch;
  const uint4 neg_inf = make_uint4(0xff80ff80u, 0xff80ff80u, 0xff80ff80u,
                                   0xff80ff80u);
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);

  // step i's z rows and dp row into stage buffer i % kStages
  auto load = [&](int i) {
    uint4* st = stages + (i % kStages) * kStageChunks;
    const int k = k0 + i;
    for (int e = (i == 0 ? 0 : kZCols * kGroups) + tid; e < kStageChunks;
         e += kStripThreads) {
      if (e < kZChunks) {
        const int row = e / (kZCols * kGroups);
        const int rem = e - row * (kZCols * kGroups);
        const int zr = 2 * k - 1 + row;
        const int zc = 2 * j0 - 1 + rem / kGroups;
        if (zr >= 0 && zr < hz && zc >= 0 && zc < wz) {
          cp_async16(st + e, zimg + (static_cast<size_t>(zr) * wz + zc) * c +
                                 rem % kGroups * 8);
        } else {
          st[e] = neg_inf;
        }
      } else {
        const int d = e - kZChunks;
        const int j = j0 + d / kGroups;
        if (k < h && j < w) {
          cp_async16(st + e, pimg + (static_cast<size_t>(k) * w + j) * c +
                                 d % kGroups * 8);
        } else {
          st[e] = zero;
        }
      }
    }
  };

  load(0);
  cp_async_commit();
  if (steps > 1) load(1);
  cp_async_commit();

  const int j = j0 + col;
  const bool active = col < kWinCols;        // a window of the step
  const bool owner = col < kCols && j < w;   // finalizes dz columns 2j, 2j+1
  uint4 top[3];                              // z row 2k - 1
  uint4 prev7 = zero, prev8 = zero, prev_nb6 = zero;
  for (int i = 0; i < steps; ++i) {
    if (i + 2 < steps) load(i + 2);
    cp_async_commit();
    cp_async_wait<kStages - 1>();
    __syncthreads();  // step i's stage landed, for every thread
    const int k = k0 + i;
    const uint4* st = stages + (i % kStages) * kStageChunks;
    uint4 x[9];
    if (active) {
      uint4 p[3][3];
#pragma unroll
      for (int e = 0; e < 3; ++e) {
        const int cc = (2 * col + e) * kGroups + grp;
        p[0][e] = i == 0 ? st[cc] : top[e];
        p[1][e] = st[kZCols * kGroups + cc];
        p[2][e] = st[2 * kZCols * kGroups + cc];
        top[e] = p[2][e];
      }
      const bool valid = k < h && j < w;
      const uint4 g = valid ? st[kZChunks + col * kGroups + grp] : zero;
      route(p, g, x);
      xch[tid] = x[0];
      xch[kStripThreads + tid] = x[3];
      xch[2 * kStripThreads + tid] = x[6];
    }
    __syncthreads();  // the left-column taps of every window
    if (owner) {
      const int nb = tid + kGroups;  // the window to the right
      const uint4 nb0 = xch[nb], nb3 = xch[kStripThreads + nb],
                  nb6 = xch[2 * kStripThreads + nb];
      if (i > 0) {  // dz row 2k - 1: windows (k, .) and (k - 1, .)
        uint4* out = reinterpret_cast<uint4*>(
            dimg + (static_cast<size_t>(2 * k - 1) * wz + 2 * j) * c) + grp;
        out[0] = sum2(x[1], prev7);
        out[c / 8] = sum4(nb0, x[2], prev_nb6, prev8);
      }
      if (k < k1) {  // dz row 2k: window row k
        uint4* out = reinterpret_cast<uint4*>(
            dimg + (static_cast<size_t>(2 * k) * wz + 2 * j) * c) + grp;
        out[0] = sum1(x[4]);
        out[c / 8] = sum2(nb3, x[5]);
      }
      prev7 = x[7];
      prev8 = x[8];
      prev_nb6 = nb6;
    }
  }
}

template <typename T, int V>
int launch(const void* z, const void* dp, void* dz, int batch, int h, int w,
           int c, cudaStream_t stream) {
  const long long threads = static_cast<long long>(w) * (c / V);
  const dim3 grid(static_cast<unsigned>((threads + kThreads - 1) / kThreads),
                  h, batch);
  maxpool_bwd_kernel<T, V><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(z), static_cast<const T*>(dp), static_cast<T*>(dz),
      h, w, c);
  return static_cast<int>(cudaGetLastError());
}

int launch_strip(const void* z, const void* dp, void* dz, int batch, int h,
                 int w, int c, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      maxpool_bwd_strip_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kStripSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((w + kCols - 1) / kCols, (h + kSeg - 1) / kSeg,
                  batch * (c / (8 * kGroups)));
  maxpool_bwd_strip_kernel<<<grid, kStripThreads, kStripSmem, stream>>>(
      static_cast<const __nv_bfloat16*>(z),
      static_cast<const __nv_bfloat16*>(dp), static_cast<__nv_bfloat16*>(dz),
      h, w, c);
  return static_cast<int>(cudaGetLastError());
}

bool aligned_to(const void* p, unsigned bytes) {
  return reinterpret_cast<unsigned long long>(p) % bytes == 0;
}

}  // namespace

// Which instance a call with these arguments launches: 1 the strip
// instance, 0 the gather one.
extern "C" int detjax_maxpool_bwd_instance(const void* z, const void* dp,
                                           const void* dz, int batch, int c,
                                           int bf16) {
  return bf16 && c % (8 * kGroups) == 0 &&
         batch * (c / (8 * kGroups)) <= 65535 && aligned_to(z, 16) &&
         aligned_to(dp, 16) && aligned_to(dz, 16);
}

// Launches on `stream` of `device`; returns a cudaError_t (0 = ok).
// z [B, 2H, 2W, C], dp [B, H, W, C], dz [B, 2H, 2W, C], NHWC contiguous.
// bf16: 0 for fp32, 1 for bf16. The strip instance runs where
// detjax_maxpool_bwd_instance says so; otherwise the gather one, whose bf16
// channel pairs load as one bf16x2 when C is even and z and dp start on 4
// bytes. The caller guarantees B, H, W, C >= 1 and B, H <= 65535.
extern "C" int detjax_maxpool_bwd_launch(const void* z, const void* dp,
                                         void* dz, int batch, int h, int w,
                                         int c, int bf16, int device,
                                         void* stream) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (detjax_maxpool_bwd_instance(z, dp, dz, batch, c, bf16))
    return launch_strip(z, dp, dz, batch, h, w, c, s);
  if (!bf16) return launch<float, 1>(z, dp, dz, batch, h, w, c, s);
  const bool aligned = aligned_to(z, 4) && aligned_to(dp, 4);
  if (aligned && c % 2 == 0)
    return launch<__nv_bfloat16, 2>(z, dp, dz, batch, h, w, c, s);
  return launch<__nv_bfloat16, 1>(z, dp, dz, batch, h, w, c, s);
}
