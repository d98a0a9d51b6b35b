// Fused anchor <-> GT IoU matching for Hopper (sm_90a).
//
// Replaces the TPU kernel detjax/kernels/matching.py::match_iou_pallas
// (body _match_kernel). Same function: for every (image, anchor), the IoU
// against each of the image's G padded GT boxes, with invalid GTs at -1,
// reduced to the best IoU and its GT index (the lowest index among equal
// IoUs), plus the winner's box and raw label. The [B, A, G] IoU tensor is
// never stored, and no gather runs afterwards.
//
// Design: one thread per anchor; grid (ceil(A / 256), B). Each block first
// stages its image's G boxes, areas, labels and validity flags in dynamic
// shared memory (28 bytes a GT), then every thread loops over G in
// ascending order and keeps the best (IoU, index) with a strict '>', so the
// first of equal IoUs wins. The winner's box and label come straight from
// shared memory.
//
// What bounds it: operations. At the training shape (B=16, A=76,725,
// G=100) there are 122.8 M (anchor, GT) pairs at about 15 fp32 operations
// and one IEEE division each, about 2 GFLOP: 0.03 ms at the card's 67
// TFLOP/s outside the tensor cores. The bytes are 1.2 MB of anchors (read
// once per image, from L2 after the first), 34 KB of GT and 34 MB of
// outputs: 0.01 ms at 3.35 TB/s. The division is a multi-instruction IEEE
// sequence here (no --use_fast_math), so the loop is issue-bound well
// above that floor; a faster design would compare inter * union_best
// against inter_best * union without dividing, which is not bit-safe
// against the plain twin and is left for later.
//
// Numerics: build with -fmad=false and IEEE division. The order is
// detjax's: areas clamped at 0, (area_a + area_g) - inter, max(union,
// 1e-8), then inter / union; a contracted or reordered IoU flips the
// >= 0.5 and < 0.4 decisions against the plain twin.

#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
    match_kernel(const float4* __restrict__ anchors,   // [A, 4] xyxy
                 const float4* __restrict__ gt_boxes,  // [B, G, 4] xyxy
                 const unsigned char* __restrict__ gt_valid,  // [B, G]
                 const int* __restrict__ gt_labels,           // [B, G]
                 float* __restrict__ max_iou,                 // [B, A]
                 int* __restrict__ argmax,                    // [B, A]
                 float4* __restrict__ boxes_out,              // [B, A, 4]
                 int* __restrict__ labels_out,                // [B, A]
                 int num_anchors, int num_gt) {
  extern __shared__ float4 smem[];
  float4* gbox = smem;
  float* garea = reinterpret_cast<float*>(gbox + num_gt);
  int* glabel = reinterpret_cast<int*>(garea + num_gt);
  int* gvalid = glabel + num_gt;

  const int img = blockIdx.y;
  const size_t g0 = static_cast<size_t>(img) * num_gt;
  for (int g = threadIdx.x; g < num_gt; g += kThreads) {
    const float4 b = gt_boxes[g0 + g];
    gbox[g] = b;
    garea[g] = fmaxf(b.z - b.x, 0.0f) * fmaxf(b.w - b.y, 0.0f);
    glabel[g] = gt_labels[g0 + g];
    gvalid[g] = gt_valid[g0 + g] != 0;
  }
  __syncthreads();

  const int a = blockIdx.x * kThreads + threadIdx.x;
  if (a >= num_anchors) return;
  const float4 an = anchors[a];
  const float aarea = fmaxf(an.z - an.x, 0.0f) * fmaxf(an.w - an.y, 0.0f);
  float best = -INFINITY;
  int bi = 0;
  for (int g = 0; g < num_gt; ++g) {
    const float4 b = gbox[g];
    const float iw = fmaxf(fminf(an.z, b.z) - fmaxf(an.x, b.x), 0.0f);
    const float ih = fmaxf(fminf(an.w, b.w) - fmaxf(an.y, b.y), 0.0f);
    const float inter = iw * ih;
    const float iou =
        gvalid[g] ? inter / fmaxf(aarea + garea[g] - inter, 1e-8f) : -1.0f;
    if (iou > best) {  // strict: the lowest index among equal IoUs wins
      best = iou;
      bi = g;
    }
  }
  const size_t o = static_cast<size_t>(img) * num_anchors + a;
  max_iou[o] = best;
  argmax[o] = bi;
  boxes_out[o] = gbox[bi];
  labels_out[o] = glabel[bi];
}

}  // namespace

// Launches on `stream` of `device`; returns cudaGetLastError() (0 = ok).
// The caller guarantees batch >= 1, num_anchors >= 1, num_gt >= 1,
// contiguous 16-byte-aligned anchor and GT boxes, and 28 * num_gt bytes of
// dynamic shared memory within the card's per-block limit.
extern "C" int detjax_match_launch(const float* anchors,
                                   const float* gt_boxes,
                                   const unsigned char* gt_valid,
                                   const int* gt_labels, float* max_iou,
                                   int* argmax, float* boxes_out,
                                   int* labels_out, int batch,
                                   int num_anchors, int num_gt, int device,
                                   void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem =
      static_cast<size_t>(num_gt) * (sizeof(float4) + 3 * sizeof(int));
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(match_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((num_anchors + kThreads - 1) / kThreads, batch);
  match_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(anchors),
      reinterpret_cast<const float4*>(gt_boxes), gt_valid, gt_labels,
      max_iou, argmax, reinterpret_cast<float4*>(boxes_out), labels_out,
      num_anchors, num_gt);
  return static_cast<int>(cudaGetLastError());
}
