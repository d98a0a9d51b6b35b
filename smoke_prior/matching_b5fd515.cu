// Fused anchor <-> GT IoU matching for Hopper (sm_90a).
//
// Replaces the TPU kernel detjax/kernels/matching.py::match_iou_pallas
// (body _match_kernel). Same function: for every (image, anchor), the IoU
// against each of the image's G padded GT boxes, with invalid GTs at -1,
// reduced to the best IoU and its GT index (the lowest index among equal
// IoUs), plus the winner's box and raw label. The [B, A, G] IoU tensor is
// never stored, and no gather runs afterwards.
//
// Design: a block takes 128 consecutive anchors (one a thread) of one
// image. The anchor layout (ops/anchors.py: positions, then cell anchors)
// keeps such a run in one strip of one level, so the block first builds
// its anchors' union box. It then lists in shared memory, in ascending
// order, the valid GTs whose box can overlap that union; a GT is dropped
// only when min(union x2, gt x2) <= max(union x1, gt x1) (or the same in
// y). Since every anchor lies inside the union, that GT then has iw (or
// ih) exactly 0 against every anchor of the block: its IoU is exactly 0.
// Each thread scans only the listed GTs, with the IEEE division, and
// merges its best (value desc, index asc) with (0, the lowest dropped
// valid index) and (-1, the lowest invalid index): the full scan's result
// bit for bit, including images with no valid GT (-1, first invalid) and
// anchors that touch no GT (0 at the first dropped valid GT). Culling is
// skipped for a block with a coordinate beyond 1e30 in magnitude or not a
// number (and a GT is never dropped for such a coordinate), where an
// overflowing or NaN extent could make the skipped IoU something other
// than 0. The block (128 anchors, one a thread, one image) was chosen by
// timing launch shapes on an H100: more anchors a block widen the union
// box and list more GTs.
//
// What bounds it on an H100: its floor is bytes once the culling works.
// The four outputs are 28 bytes an anchor (34 MB at the training shape,
// B=16, A=76,725), 0.0106 ms at 3.35 TB/s with the anchors and GTs; the
// pairs left to divide are the anchors' pairs with the few GTs near
// their strip (training batches hold 1-20 objects padded to 100 slots),
// not all B * A * G = 122.8 M pairs the previous one-thread-per-anchor
// scan divided. What holds it above that floor is each block's fixed
// latency: the union box, the GT list and their barriers before any
// anchor's scan.
//
// Numerics: build with -fmad=false and IEEE division. The order is
// detjax's: areas clamped at 0, (area_a + area_g) - inter, max(union,
// 1e-8), then inter / union; a contracted or reordered IoU flips the
// >= 0.5 and < 0.4 decisions against the plain twin.

#include <cuda_runtime.h>

#include <climits>
#include <cmath>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr float kTame = 1e30f;

__device__ __forceinline__ float box_area(float4 b) {
  return fmaxf(b.z - b.x, 0.0f) * fmaxf(b.w - b.y, 0.0f);
}

// Every coordinate a number of magnitude <= 1e30: extents and areas of
// such boxes never overflow to inf * 0 (false for NaN).
__device__ __forceinline__ bool tame(float4 b) {
  return fabsf(b.x) <= kTame && fabsf(b.y) <= kTame && fabsf(b.z) <= kTame &&
         fabsf(b.w) <= kTame;
}

constexpr int kThreads = 128;  // anchors a block, one a thread
constexpr int kWarps = kThreads / 32;

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
  extern __shared__ float4 smem[];  // the listed GTs of the image
  float4* lbox = smem;
  float* larea = reinterpret_cast<float*>(lbox + num_gt);
  int* lidx = reinterpret_cast<int*>(larea + num_gt);
  __shared__ float4 s_union;
  __shared__ int s_tame;
  __shared__ float red[4][kWarps];
  __shared__ int warp_count[kWarps];
  __shared__ int s_dropped, s_invalid;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int a = blockIdx.x * kThreads + tid;
  const int img = blockIdx.y;
  const bool in = a < num_anchors;

  // the block's union box
  const float4 an = in ? anchors[a]
                       : make_float4(INFINITY, INFINITY, -INFINITY, -INFINITY);
  float ux1 = an.x, uy1 = an.y, ux2 = an.z, uy2 = an.w;
  for (int o = 16; o > 0; o >>= 1) {
    ux1 = fminf(ux1, __shfl_xor_sync(kFull, ux1, o));
    uy1 = fminf(uy1, __shfl_xor_sync(kFull, uy1, o));
    ux2 = fmaxf(ux2, __shfl_xor_sync(kFull, ux2, o));
    uy2 = fmaxf(uy2, __shfl_xor_sync(kFull, uy2, o));
  }
  if (lane == 0) {
    red[0][warp] = ux1;
    red[1][warp] = uy1;
    red[2][warp] = ux2;
    red[3][warp] = uy2;
  }
  const int all_tame = __syncthreads_and(!in || tame(an));
  if (tid == 0) {
    for (int w = 1; w < kWarps; ++w) {
      ux1 = fminf(ux1, red[0][w]);
      uy1 = fminf(uy1, red[1][w]);
      ux2 = fmaxf(ux2, red[2][w]);
      uy2 = fmaxf(uy2, red[3][w]);
    }
    s_union = make_float4(ux1, uy1, ux2, uy2);
    s_tame = all_tame;
    s_dropped = INT_MAX;
    s_invalid = INT_MAX;
  }
  __syncthreads();
  const float4 un = s_union;
  const bool cull = s_tame;
  const size_t g0 = static_cast<size_t>(img) * num_gt;

  // the listed GTs, in ascending order, a chunk of kThreads at a time
  int count = 0, dropped = INT_MAX, invalid = INT_MAX;
  for (int c0 = 0; c0 < num_gt; c0 += kThreads) {
    const int g = c0 + tid;
    bool listed = false;
    float4 gb = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (g < num_gt) {
      if (gt_valid[g0 + g]) {
        gb = gt_boxes[g0 + g];
        const bool apart =
            cull && tame(gb) &&
            (fminf(un.z, gb.z) <= fmaxf(un.x, gb.x) ||
             fminf(un.w, gb.w) <= fmaxf(un.y, gb.y));
        listed = !apart;
        if (apart) dropped = min(dropped, g);
      } else {
        invalid = min(invalid, g);
      }
    }
    const unsigned ballot = __ballot_sync(kFull, listed);
    if (lane == 0) warp_count[warp] = __popc(ballot);
    __syncthreads();
    int before = count, chunk = 0;
    for (int w = 0; w < kWarps; ++w) {
      before += w < warp ? warp_count[w] : 0;
      chunk += warp_count[w];
    }
    if (listed) {
      const int pos = before + __popc(ballot & ((1u << lane) - 1));
      lbox[pos] = gb;
      larea[pos] = box_area(gb);
      lidx[pos] = g;
    }
    count += chunk;
    __syncthreads();  // warp_count read by every thread
  }
  dropped = __reduce_min_sync(kFull, dropped);
  invalid = __reduce_min_sync(kFull, invalid);
  if (lane == 0) {
    atomicMin(&s_dropped, dropped);
    atomicMin(&s_invalid, invalid);
  }
  __syncthreads();
  if (!in) return;
  dropped = s_dropped;
  invalid = s_invalid;

  const float aarea = box_area(an);
  float best = -INFINITY;
  int bi = 0;
#pragma unroll 4
  for (int t = 0; t < count; ++t) {
    const float4 b = lbox[t];
    const float iw = fmaxf(fminf(an.z, b.z) - fmaxf(an.x, b.x), 0.0f);
    const float ih = fmaxf(fminf(an.w, b.w) - fmaxf(an.y, b.y), 0.0f);
    const float inter = iw * ih;
    // the union is >= 1e-8 and never NaN (fmaxf): a zero inter divides to
    // itself, and dividing 1 there keeps the division off its slow path
    // with the same bits
    const bool zero = inter == 0.0f;
    const float q =
        (zero ? 1.0f : inter) / fmaxf(aarea + larea[t] - inter, 1e-8f);
    const float iou = zero ? inter : q;
    if (iou > best) {  // strict: the lowest index among equal IoUs
      best = iou;
      bi = lidx[t];
    }
  }
  // every dropped valid GT scores exactly 0, every invalid one -1
  if (dropped != INT_MAX && (0.0f > best || (0.0f == best && dropped < bi))) {
    best = 0.0f;
    bi = dropped;
  }
  if (invalid != INT_MAX &&
      (-1.0f > best || (-1.0f == best && invalid < bi))) {
    best = -1.0f;
    bi = invalid;
  }
  const size_t o = static_cast<size_t>(img) * num_anchors + a;
  max_iou[o] = best;
  argmax[o] = bi;
  boxes_out[o] = gt_boxes[g0 + bi];
  labels_out[o] = gt_labels[g0 + bi];
}

}  // namespace

// Launches on `stream` of `device`, adding one to *launched when the
// runtime accepted the launch; returns the error (0 = ok). The caller
// guarantees batch >= 1, num_anchors >= 1, num_gt >= 1, contiguous
// 16-byte-aligned anchor and GT boxes, and 24 * num_gt bytes of dynamic
// shared memory within the card's per-block limit.
extern "C" int detjax_match_launch(const float* anchors,
                                   const float* gt_boxes,
                                   const unsigned char* gt_valid,
                                   const int* gt_labels, float* max_iou,
                                   int* argmax, float* boxes_out,
                                   int* labels_out, int batch,
                                   int num_anchors, int num_gt, int device,
                                   void* stream, int* launched) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = static_cast<size_t>(num_gt) *
                      (sizeof(float4) + sizeof(float) + sizeof(int));
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
  err = cudaGetLastError();
  if (err == cudaSuccess) ++*launched;
  return static_cast<int>(err);
}
