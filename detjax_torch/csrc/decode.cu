// Full-anchor-set box decode (+ clip), for Hopper (sm_90a).
//
// Replaces the TPU kernel detjax/kernels/postprocess.py::decode_boxes_pallas
// (line 214; body _decode_kernel, line 180). Same function, in the same
// order of fp32 operations: for every (image, anchor),
//   d = delta * std;  aw = ax2 - ax1;  acx = ax1 + 0.5 * aw
//   px = dx * aw + acx;  pw = expf(dw) * aw        (dw not clamped)
//   box = (px - 0.5 * pw, py - 0.5 * ph, px + 0.5 * pw, py + 0.5 * ph)
// then, when asked, each corner clamped to [0, W] (x) or [0, H] (y) with
// NaN kept, as jnp.clip and torch.clamp keep it. It builds with -fmad=false:
// otherwise nvcc would contract dx * aw + acx into one FMA and round once
// where the reference rounds twice.
//
// Design: one thread per (image, anchor) in a grid-stride loop, one 16-byte
// load of the deltas (8 bytes for bf16, converted exactly to fp32), one of
// the anchor and one 16-byte store. The Pallas version pads the anchor axis
// with unit boxes to whole tiles; here the loop's index guard does that job.
//
// What bounds it: bytes. At R50-640 (B = 8, N = 76,725) it reads 9.82 MB of
// fp32 deltas and 1.23 MB of anchors and writes 9.82 MB: 6.2 us at 3.35
// TB/s, less than a launch costs.
//
// Requirements (the wrapper checks them): deltas [B, N, 4] fp32 (16-byte
// aligned) or bf16 (8-byte aligned), anchors [N, 4] fp32, out [B, N, 4] fp32,
// all contiguous, anchors and out 16-byte aligned.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float4 load_deltas(const float* d, long long i) {
  return reinterpret_cast<const float4*>(d)[i];
}

__device__ __forceinline__ float4 load_deltas(const __nv_bfloat16* d,
                                              long long i) {
  union {
    uint2 v;
    __nv_bfloat162 h[2];
  } u;
  u.v = reinterpret_cast<const uint2*>(d)[i];
  const float2 a = __bfloat1622float2(u.h[0]);
  const float2 b = __bfloat1622float2(u.h[1]);
  return make_float4(a.x, a.y, b.x, b.y);
}

// v clamped to [0, hi]; NaN stays NaN (fmaxf / fminf alone would return the
// bound).
__device__ __forceinline__ float clip(float v, float hi) {
  return v != v ? v : fminf(fmaxf(v, 0.0f), hi);
}

template <typename T, bool kClip>
__global__ void __launch_bounds__(kThreads)
    decode_kernel(const T* __restrict__ deltas,         // [B, N, 4]
                  const float4* __restrict__ anchors,  // [N] xyxy
                  float4* __restrict__ out,            // [B, N] xyxy
                  long long total, int n, float4 std, float w, float h) {
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i = blockIdx.x * static_cast<long long>(kThreads) +
                     threadIdx.x;
       i < total; i += stride) {
    const float4 d = load_deltas(deltas, i);
    const float4 a = anchors[i % n];
    const float dx = d.x * std.x, dy = d.y * std.y;
    const float dw = d.z * std.z, dh = d.w * std.w;
    const float aw = a.z - a.x, ah = a.w - a.y;
    const float acx = a.x + 0.5f * aw, acy = a.y + 0.5f * ah;
    const float px = dx * aw + acx, py = dy * ah + acy;
    const float pw = expf(dw) * aw, ph = expf(dh) * ah;
    float4 b = make_float4(px - 0.5f * pw, py - 0.5f * ph, px + 0.5f * pw,
                           py + 0.5f * ph);
    if (kClip) {
      b.x = clip(b.x, w);
      b.y = clip(b.y, h);
      b.z = clip(b.z, w);
      b.w = clip(b.w, h);
    }
    out[i] = b;
  }
}

template <typename T>
int launch(const void* deltas, const void* anchors, void* out, int batch,
           int n, const float* std, int clip, float w, float h,
           cudaStream_t stream) {
  const long long total = static_cast<long long>(batch) * n;
  const long long want = (total + kThreads - 1) / kThreads;
  const int blocks = static_cast<int>(want < 8192 ? want : 8192);
  const float4 s = make_float4(std[0], std[1], std[2], std[3]);
  const T* d = static_cast<const T*>(deltas);
  const float4* a = static_cast<const float4*>(anchors);
  float4* o = static_cast<float4*>(out);
  if (clip) {
    decode_kernel<T, true><<<blocks, kThreads, 0, stream>>>(d, a, o, total, n,
                                                            s, w, h);
  } else {
    decode_kernel<T, false><<<blocks, kThreads, 0, stream>>>(d, a, o, total,
                                                             n, s, w, h);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches on `stream` of `device`; returns a cudaError_t (0 = ok).
// bf16_deltas: 0 for fp32 deltas, 1 for bf16. std: 4 floats. clip: 0 or 1,
// with the canvas width w and height h. The caller guarantees batch, n >= 1
// and the requirements above.
extern "C" int detjax_decode_launch(const void* deltas, const void* anchors,
                                    void* out, int batch, int n,
                                    int bf16_deltas, const float* std,
                                    int clip, float w, float h, int device,
                                    void* stream) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16_deltas)
    return launch<__nv_bfloat16>(deltas, anchors, out, batch, n, std, clip, w,
                                 h, s);
  return launch<float>(deltas, anchors, out, batch, n, std, clip, w, h, s);
}
