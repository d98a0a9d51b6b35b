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
// Design: the gather form, no atomics, so two runs give equal bits. One
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
// Each thread reads 25 taps for 4 outputs; the other 21 are its neighbours'
// and come from L1/L2, not device memory.
//
// Requirements (the wrapper checks them): z [B, 2H, 2W, C], dp [B, H, W, C]
// and dz [B, 2H, 2W, C], contiguous, one dtype (fp32 or bf16); H, B <= 65535.

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

}  // namespace

// Launches on `stream` of `device`; returns a cudaError_t (0 = ok).
// z [B, 2H, 2W, C], dp [B, H, W, C], dz [B, 2H, 2W, C], NHWC contiguous.
// bf16: 0 for fp32, 1 for bf16. aligned: z and dp start on 4 bytes, so that
// bf16 channel pairs load as one bf16x2 when C is even. The caller guarantees
// B, H, W, C >= 1 and B, H <= 65535.
extern "C" int detjax_maxpool_bwd_launch(const void* z, const void* dp,
                                         void* dz, int batch, int h, int w,
                                         int c, int bf16, int aligned,
                                         int device, void* stream) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!bf16) return launch<float, 1>(z, dp, dz, batch, h, w, c, s);
  if (aligned && c % 2 == 0)
    return launch<__nv_bfloat16, 2>(z, dp, dz, batch, h, w, c, s);
  return launch<__nv_bfloat16, 1>(z, dp, dz, batch, h, w, c, s);
}
