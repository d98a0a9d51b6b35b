// Batched class-aware greedy NMS for Hopper (sm_90a).
//
// Replaces the TPU kernel detjax/kernels/postprocess.py::nms_pallas (body
// _nms_kernel). Same function: per image, each of max_det steps takes the
// best live score (lowest index on ties), keeps it while it is above
// NEG_INF/2, and suppresses itself and every candidate whose IoU with it
// exceeds the threshold. Candidates are translated by label * class_offset
// first, so one class-agnostic pass equals per-class NMS.
//
// Design: one block per image. The offset boxes, their areas and the live
// scores sit in dynamic shared memory (24 bytes a candidate), a few
// candidates per thread for any N. Each step is one pass over the thread's
// own candidates that suppresses against the previous winner and finds the
// thread's best remaining (score, index); a warp-shuffle argmax and a
// cross-warp pass through shared memory then pick the block's winner,
// which one thread writes out. Once no valid candidate is left the block
// fills the rest of the output with -1 / 0 and stops.
//
// What bounds it: max_det sequential block-wide reductions, two barriers
// each, on B blocks of the card's 132 SMs. It is latency-bound; the bytes
// (about 200 KB of candidates at B=8, N=1000) and the IoU arithmetic are
// far below the card's rates. A later design would build the IoU > thr
// bitmask matrix in parallel and leave only one serial sweep over it.
//
// Numerics: build with -fmad=false. Otherwise the compiler contracts
// label * offset + x and area + barea - iw * ih into FMAs, whose single
// rounding can flip an IoU > thr decision against the plain twin.

#include <cuda_runtime.h>

#include <climits>
#include <cmath>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr float kNegInf = -1e10f;

// (score, index) order: higher score first, then the lower index.
__device__ __forceinline__ bool better(float s, int i, float s_other,
                                       int i_other) {
  return s > s_other || (s == s_other && i < i_other);
}

__device__ __forceinline__ void warp_argmax(float& s, int& i) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float s2 = __shfl_down_sync(0xffffffffu, s, o);
    const int i2 = __shfl_down_sync(0xffffffffu, i, o);
    if (better(s2, i2, s, i)) {
      s = s2;
      i = i2;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
    nms_kernel(const float* __restrict__ boxes,   // [B, N, 4] xyxy
               const float* __restrict__ scores,  // [B, N]
               const int* __restrict__ labels,    // [B, N]
               int* __restrict__ keep_idx,        // [B, max_det]
               float* __restrict__ keep_scores,   // [B, max_det]
               int n, int max_det, float iou_threshold, float class_offset) {
  extern __shared__ float smem[];
  float* x1 = smem;
  float* y1 = x1 + n;
  float* x2 = y1 + n;
  float* y2 = x2 + n;
  float* area = y2 + n;
  float* live = area + n;
  __shared__ float warp_s[kWarps];
  __shared__ int warp_i[kWarps];
  __shared__ float best_s;
  __shared__ int best_i;

  const int img = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const float4* box4 = reinterpret_cast<const float4*>(boxes) +
                       static_cast<size_t>(img) * n;
  const float* img_scores = scores + static_cast<size_t>(img) * n;
  const int* img_labels = labels + static_cast<size_t>(img) * n;
  int* out_idx = keep_idx + static_cast<size_t>(img) * max_det;
  float* out_scores = keep_scores + static_cast<size_t>(img) * max_det;

  // Load, offset by class, and find each thread's best candidate.
  float ls = -INFINITY;
  int li = INT_MAX;
  for (int j = tid; j < n; j += kThreads) {
    const float4 b = box4[j];
    const float off = static_cast<float>(img_labels[j]) * class_offset;
    const float a1 = b.x + off, b1 = b.y + off, a2 = b.z + off,
                b2 = b.w + off;
    x1[j] = a1;
    y1[j] = b1;
    x2[j] = a2;
    y2[j] = b2;
    area[j] = fmaxf(a2 - a1, 0.0f) * fmaxf(b2 - b1, 0.0f);
    const float s = img_scores[j];
    live[j] = s;
    if (better(s, j, ls, li)) {
      ls = s;
      li = j;
    }
  }
  __syncthreads();

  int it = 0;
  for (; it < max_det; ++it) {
    warp_argmax(ls, li);
    if (lane == 0) {
      warp_s[warp] = ls;
      warp_i[warp] = li;
    }
    __syncthreads();
    if (warp == 0) {
      ls = lane < kWarps ? warp_s[lane] : -INFINITY;
      li = lane < kWarps ? warp_i[lane] : INT_MAX;
      warp_argmax(ls, li);
      if (lane == 0) {
        best_s = ls;
        best_i = li;
      }
    }
    __syncthreads();
    const float bs = best_s;
    const int bi = best_i;
    if (!(bs > kNegInf * 0.5f)) break;  // the same value in every thread
    if (tid == 0) {
      out_idx[it] = bi;
      out_scores[it] = bs;
    }
    const float bx1 = x1[bi], by1 = y1[bi], bx2 = x2[bi], by2 = y2[bi];
    const float barea = area[bi];
    ls = -INFINITY;
    li = INT_MAX;
    for (int j = tid; j < n; j += kThreads) {
      float s = live[j];
      const float iw = fmaxf(fminf(x2[j], bx2) - fmaxf(x1[j], bx1), 0.0f);
      const float ih = fmaxf(fminf(y2[j], by2) - fmaxf(y1[j], by1), 0.0f);
      const float inter = iw * ih;
      const float iou = inter / fmaxf(area[j] + barea - inter, 1e-8f);
      if (iou > iou_threshold || j == bi) {
        s = kNegInf;
        live[j] = s;
      }
      if (better(s, j, ls, li)) {
        ls = s;
        li = j;
      }
    }
  }
  for (int k = it + tid; k < max_det; k += kThreads) {
    out_idx[k] = -1;
    out_scores[k] = 0.0f;
  }
}

}  // namespace

// Launches on `stream` of `device`; returns cudaGetLastError() (0 = ok).
// The caller guarantees batch >= 1, n >= 1, max_det >= 1, contiguous
// buffers, and 24 * n bytes of dynamic shared memory within the card's
// per-block limit.
extern "C" int detjax_nms_launch(const float* boxes, const float* scores,
                                 const int* labels, int* keep_idx,
                                 float* keep_scores, int batch, int n,
                                 int max_det, float iou_threshold,
                                 float class_offset, int device,
                                 void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = static_cast<size_t>(6) * n * sizeof(float);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(nms_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  nms_kernel<<<batch, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      boxes, scores, labels, keep_idx, keep_scores, n, max_det,
      iou_threshold, class_offset);
  return static_cast<int>(cudaGetLastError());
}
