// Batched class-aware greedy NMS for Hopper (sm_90a).
//
// Replaces the TPU kernel detjax/kernels/postprocess.py::nms_pallas (body
// _nms_kernel). Same function: per row, each of max_det steps takes the
// best live score (lowest index on ties), keeps it while it is above
// NEG_INF/2, and suppresses itself and every candidate whose IoU with it
// exceeds the threshold. Candidates are translated by label * class_offset
// first, so one class-agnostic pass equals per-class NMS.
//
// Design: the greedy loop equals one sweep over the live candidates in
// (score desc, index asc) order, keeping each one that no earlier keep
// suppresses: the best live candidate is always the first unremoved one in
// that order. One kernel, one block per row:
//   order  the block checks in parallel that the row is already in that
//          order with its live candidates first (the port's callers pass
//          rows from a stable descending sort) and counts the live prefix
//          L; only a row out of order is sorted, as 64-bit (score, index)
//          keys in shared memory with a bitonic network. A row of more
//          than kSelect = 16384 candidates that is out of order takes the
//          kernel's large instance: a block-wide radix select (8-bit
//          digits of the key, high to low, a shared histogram a pass,
//          stopping at the first digit whose bin holds exactly the keys
//          still needed) finds the next batch of the order, the smallest
//          keys at or above a lower bound (1024 of them, doubling at
//          each refill up to kSelect), gathers them into shared memory
//          and sorts them there; the rounds walk them, and only when
//          that batch runs out before max_det keeps does the next select
//          start above the batch's last key. The keys are unique (the
//          index is in the low word), so a batch holds exactly the next
//          keys of the order. No global scratch, no library sort, one
//          launch.
//   rounds the sweep then walks the live prefix 64 candidates at a time,
//          and stops as soon as max_det are kept. Per round: (a) each of
//          the round's candidates against every keep so far, all threads
//          at once; (b) the round's own upper triangle, the IoU > thr
//          bits of q > p in one 64-bit word a row, for the rows (a) left
//          open, a few columns a thread; (c) one warp finds the round's
//          keeps without a serial pass: the greedy keep set of the round
//          is the one fixed point of K = open \ (bits removed by K's
//          rows), reached from K = open in as many warp-wide
//          OR-reductions as the round's removal chains are deep (plus
//          one). The kept boxes go to shared memory (past the first 512
//          keeps, to a global scratch), which (a) reads in later rounds.
// The greedy loop stops after max_det keeps; at the port's shapes that is
// within the first 100-500 candidates of 1000, so only the pairs among
// those and the keeps' rows are compared, not the N x N / 2 of a full IoU
// mask built over many blocks and then swept (that design was built and
// timed first, and lost: see PERF.md, PR 10).
//
// What bounds it on an H100: latency. The IoU work (about 20 operations a
// pair) and the bytes (24 bytes a candidate read once, 8 a keep written)
// would take well under a microsecond spread over the card; a row's rounds
// run in order, each with four barriers, a global load of its candidates
// and a few warp-wide reductions. A block has 512 threads for a few rows,
// so a round's pairs spread wide, and 256 from two rows an SM on, so that
// every row runs in one wave.
//
// Numerics: build with -fmad=false. Each decision is the plain twin's
// RN(inter / max((area_p + area_q) - inter, 1e-8)) > thr on the offset
// boxes (fp32 addition commutes, so the order of p and q does not matter),
// taken without the division: RN(x) > t exactly when x lies above the
// midpoint m of t and the next float, or on it with t odd (ties to even).
// The launcher computes m in fp64; m * union is exact in fp64 (25- and
// 24-bit significands), so inter > m * union decides as the division
// does, bit for bit. A contracted FMA in label * offset + x or in the
// union would flip decisions against the twin.

#include <cuda_runtime.h>

#include <cmath>
#include <cstring>

namespace {

typedef unsigned long long u64;

constexpr float kNegInf = -1e10f;
constexpr int kKeptInShared = 512;  // keeps whose boxes (a) reads from shared
constexpr int kTile = 64;  // candidates a round: one 64-bit word
// Keys sorted in shared memory at once: a row of up to kSelect candidates
// is sorted whole, a longer one kSelect at a time (the large instance).
constexpr int kSelect = 16384;
// The large instance's first batch; each refill doubles it, up to kSelect.
// The rounds usually reach max_det within the first few hundred of the
// order, so a small first batch spares sorting thousands of keys.
constexpr int kFirstBatch = 1024;
constexpr int kBins = 256;  // the radix select's digit: 8 bits
constexpr int kUnroll = 8;  // row elements a thread loads at once
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ bool is_live(float s) {
  return s > kNegInf * 0.5f;  // false for NaN
}

// Ascending key order = (score desc, index asc); -0 reads as +0.
__device__ __forceinline__ u64 sort_key(float s, int j) {
  s = s == 0.0f ? 0.0f : s;
  unsigned u = __float_as_uint(s);
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);  // ascending in s
  return (static_cast<u64>(~u) << 32) | static_cast<unsigned>(j);
}

__device__ __forceinline__ float box_area(float4 b) {
  return fmaxf(b.z - b.x, 0.0f) * fmaxf(b.w - b.y, 0.0f);
}

// The twin's RN(IoU) > thr, from thr's upper midpoint `mid` and its
// parity `odd` (see the note above).
__device__ __forceinline__ bool overlaps(float4 p, float ap, float4 q,
                                         float aq, double mid, bool odd) {
  const float iw = fmaxf(fminf(p.z, q.z) - fmaxf(p.x, q.x), 0.0f);
  const float ih = fmaxf(fminf(p.w, q.w) - fmaxf(p.y, q.y), 0.0f);
  const float inter = iw * ih;
  const double bound =
      mid * static_cast<double>(fmaxf(ap + aq - inter, 1e-8f));
  const double x = static_cast<double>(inter);
  return x > bound || (x == bound && odd);
}

// Sorts keys[0, pow2) ascending with a bitonic network, all threads.
template <int kThreads>
__device__ __forceinline__ void bitonic_sort(u64* keys, int pow2, int tid) {
  for (int k = 2; k <= pow2; k <<= 1) {
    for (int d = k >> 1; d > 0; d >>= 1) {
      for (int t = tid; t < pow2 / 2; t += kThreads) {
        const int i = ((t & ~(d - 1)) << 1) | (t & (d - 1));
        const u64 a = keys[i], b = keys[i + d];
        if ((a > b) == ((i & k) == 0)) {
          keys[i] = b;
          keys[i + d] = a;
        }
      }
      __syncthreads();
    }
  }
}

// The large instance's batch: the `need` smallest live keys of the row that
// are >= lo, sorted into keys[0, need) (the rest of the sort's power of two
// padded with ~0). `hist` is kBins + 4 ints of shared memory after the
// keys. A radix select over the key's 8-bit digits, high to low: each pass
// counts, in a shared histogram (a warp's lanes of one digit add once; a
// warp none of whose keys counts skips), the digit of every live key >= lo
// whose higher digits equal the prefix found so far; the bin that holds
// the need-th key extends the prefix. It stops at the first bin that holds
// exactly the keys still needed (at the last digit, the bin of one key),
// so every live key from lo to the prefix's largest completion is taken.
template <int kThreads>
__device__ void select_batch(const float* __restrict__ s, int n, u64 lo,
                             int need, u64* keys, int* hist, int tid) {
  const int lane = tid & 31, warp = tid >> 5;
  u64 prefix = 0, hi = ~0ull;
  for (int shift = 56;; shift -= 8) {
    for (int i = tid; i < kBins; i += kThreads) hist[i] = 0;
    __syncthreads();
    for (int j0 = warp * 32 * kUnroll; j0 < n; j0 += kThreads * kUnroll) {
      float sv[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int j = j0 + 32 * u + lane;
        sv[u] = j < n ? s[j] : kNegInf;
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        int bin = kBins;  // no count
        if (is_live(sv[u])) {
          const u64 key = sort_key(sv[u], j0 + 32 * u + lane);
          if (key >= lo && (shift == 56 || (key >> (shift + 8)) == prefix))
            bin = static_cast<int>((key >> shift) & (kBins - 1));
        }
        if (!__any_sync(kFull, bin != kBins)) continue;  // none counts
        const unsigned peers = __match_any_sync(kFull, bin);
        if (bin != kBins && lane == __ffs(peers) - 1)
          atomicAdd(&hist[bin], __popc(peers));
      }
    }
    __syncthreads();
    if (warp == 0) {  // the bin of the need-th key: lane l holds 8l..8l+7
      int c[8], sum = 0;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        c[i] = hist[8 * lane + i];
        sum += c[i];
      }
      int incl = sum;
      for (int o = 1; o < 32; o <<= 1) {
        const int v = __shfl_up_sync(kFull, incl, o);
        if (lane >= o) incl += v;
      }
      const int src = __ffs(__ballot_sync(kFull, incl >= need)) - 1;
      if (lane == src) {
        int before = incl - sum, pick = -1, cnt = 0;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          if (pick < 0) {
            if (before + c[i] >= need) {
              pick = 8 * lane + i;
              cnt = c[i];
            } else {
              before += c[i];
            }
          }
        }
        hist[kBins] = pick;
        hist[kBins + 1] = need - before;
        hist[kBins + 2] = cnt;
      }
    }
    __syncthreads();
    prefix = (prefix << 8) | static_cast<u64>(hist[kBins]);
    need = hist[kBins + 1];
    if (hist[kBins + 2] == need) {  // the whole bin: done
      hi = shift == 0 ? prefix : (prefix << shift) | ((1ull << shift) - 1);
      break;
    }
  }
  // gather the keys in [lo, hi], in no order, then sort them
  if (tid == 0) hist[kBins + 3] = 0;
  __syncthreads();
  for (int j0 = warp * 32 * kUnroll; j0 < n; j0 += kThreads * kUnroll) {
    float sv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = j0 + 32 * u + lane;
      sv[u] = j < n ? s[j] : kNegInf;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      u64 key = 0;
      bool take = false;
      if (is_live(sv[u])) {
        key = sort_key(sv[u], j0 + 32 * u + lane);
        take = key >= lo && key <= hi;
      }
      const unsigned ballot = __ballot_sync(kFull, take);
      int base = 0;
      if (lane == 0 && ballot) {
        base = atomicAdd(&hist[kBins + 3], __popc(ballot));
      }
      base = __shfl_sync(kFull, base, 0);
      if (take) keys[base + __popc(ballot & ((1u << lane) - 1))] = key;
    }
  }
  __syncthreads();
  const int got = hist[kBins + 3];
  int pow2 = 1;
  while (pow2 < got) pow2 <<= 1;
  for (int j = got + tid; j < pow2; j += kThreads) keys[j] = ~0ull;
  __syncthreads();
  bitonic_sort<kThreads>(keys, pow2, tid);
}

// Built with -DDETJAX_NMS_PROFILE (chip_smoke.py builds that library
// beside the port's), thread 0 of each row reads clock64 at the barriers
// and writes the row's cycles by phase to g_phase_cycles [R, kPhases]:
// order, then summed over rounds: load, (a), (b), (c)'s keeps and its
// outputs; the whole row; and the rounds walked.
constexpr int kPhases = 8;
#ifdef DETJAX_NMS_PROFILE
constexpr bool kProfile = true;
__device__ long long* g_phase_cycles;
#else
constexpr bool kProfile = false;
#endif

// A block of 256 threads is for many rows: five such blocks an SM (at
// most 51 registers a thread) hold 660 rows at once. kLarge: rows of more
// than kSelect candidates (512 threads, one block an SM: its keys take
// 128 KB of shared memory).
template <int kThreads, bool kLarge>
__global__ void __launch_bounds__(kThreads, kThreads == 256 ? 5 : 1)
    nms_kernel(const float4* __restrict__ boxes,  // [R, N] xyxy
               const float* __restrict__ scores,  // [R, N]
               const int* __restrict__ labels,    // [R, N]
               int* __restrict__ keep_idx,        // [R, max_det]
               float* __restrict__ keep_scores,   // [R, max_det]
               float4* __restrict__ kept_boxes,   // scratch, see below
               int n, int pow2, int max_det, double mid, int odd,
               float class_offset) {
  // [pow2], used when the row is unsorted; the large instance: [kSelect]
  // keys, then its select's histogram
  extern __shared__ u64 keys[];
  __shared__ float4 cbox[kTile];  // the round's candidates
  __shared__ float carea[kTile];
  __shared__ float cscore[kTile];
  __shared__ int cidx[kTile];
  __shared__ int removed[kTile];
  __shared__ u64 blk[kTile];  // the round's triangle: row p's bits q > p
  __shared__ int kept[kTile];
  __shared__ float4 kbox[kKeptInShared];  // the first keeps' boxes
  __shared__ float karea[kKeptInShared];
  __shared__ int s_live, s_nkept;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t base = static_cast<size_t>(blockIdx.x) * n;
  const float4* rboxes = boxes + base;
  const float* s = scores + base;
  const int* rlabels = labels + base;
  const size_t obase = static_cast<size_t>(blockIdx.x) * max_det;
  int* out_idx = keep_idx + obase;
  float* out_scores = keep_scores + obase;
  // the boxes of keeps kKeptInShared.. of the row: [R, max_det - 512]
  float4* kextra = kept_boxes + static_cast<size_t>(blockIdx.x) *
                                    max(max_det - kKeptInShared, 0);
  long long cyc[kPhases] = {};
  long long t_mark = kProfile ? clock64() : 0;
  [[maybe_unused]] const long long t_start = t_mark;
  auto mark = [&](int phase) {  // thread 0, after a barrier
    if (kProfile && tid == 0) {
      const long long t = clock64();
      cyc[phase] += t - t_mark;
      t_mark = t;
    }
  };
  if (tid == 0) s_live = 0;
  __syncthreads();

  // order: every live candidate before every dead one, live scores
  // non-increasing (equal scores are in index order already)
  int bad = 0, live = 0;
  for (int j = tid; j < n; j += kThreads) {
    const float sj = s[j];
    const bool lj = is_live(sj);
    live += lj;
    if (j + 1 < n) {
      const float s1 = s[j + 1];
      bad |= is_live(s1) && (!lj || sj < s1);
    }
  }
  for (int o = 16; o > 0; o >>= 1) live += __shfl_xor_sync(kFull, live, o);
  if (lane == 0) atomicAdd(&s_live, live);
  const bool unsorted = __syncthreads_or(bad);
  const int count = s_live;
  if (!kLarge && unsorted) {
    for (int j = tid; j < pow2; j += kThreads)
      keys[j] = j < n && is_live(s[j]) ? sort_key(s[j], j) : ~0ull;
    __syncthreads();
    bitonic_sort<kThreads>(keys, pow2, tid);
  }
  mark(0);

  int k = 0;  // keeps so far, the same in every thread
  // the candidates the rounds walk: the live prefix, or (large instance,
  // unsorted row) the batch of the order that select_batch sorted
  int batch = count;
  [[maybe_unused]] int walked = 0;  // candidates of earlier batches
  [[maybe_unused]] u64 lo = 0;      // the next batch's keys are >= lo
  [[maybe_unused]] int cap = kFirstBatch;  // the next batch's size
  for (;;) {
    if constexpr (kLarge) {
      if (unsorted) {
        batch = min(cap, count - walked);
        cap = min(2 * cap, kSelect);
        select_batch<kThreads>(s, n, lo, batch, keys,
                               reinterpret_cast<int*>(keys + kSelect), tid);
        mark(0);
      }
    }
    for (int r0 = 0; r0 < batch && k < max_det; r0 += kTile) {
      const int ncols = min(kTile, batch - r0);
      // the round's candidates, offset by class, in sorted order
      for (int c = tid; c < kTile; c += kThreads) {
        if (c < ncols) {
          const int j = unsorted
                            ? static_cast<int>(keys[r0 + c] & 0xffffffffu)
                            : r0 + c;
          const float4 b = rboxes[j];
          const float off = static_cast<float>(rlabels[j]) * class_offset;
          const float4 ob =
              make_float4(b.x + off, b.y + off, b.z + off, b.w + off);
          cbox[c] = ob;
          carea[c] = box_area(ob);
          cscore[c] = s[j];
          cidx[c] = j;
        }
        removed[c] = c >= ncols;
        blk[c] = 0;
      }
      __syncthreads();
      mark(1);

      // (a) each candidate against every keep so far; the threads of a
      // candidate split the keeps
      if (k > 0) {
        constexpr int kSplit = kThreads / kTile;
        const int c = tid % kTile;
        if (c < ncols) {
          const float4 q = cbox[c];
          const float aq = carea[c];
          bool hit = false;
          const int ks = min(k, kKeptInShared);
          for (int t0 = tid / kTile; t0 < ks && !hit; t0 += 4 * kSplit) {
  #pragma unroll
            for (int u = 0; u < 4; ++u) {
              const int t = t0 + u * kSplit;
              if (t < ks) hit |= overlaps(kbox[t], karea[t], q, aq, mid, odd);
            }
          }
          // keeps past the shared copy, from the global scratch
          for (int t = kKeptInShared + tid / kTile; t < k && !hit;
               t += kSplit) {
            const float4 p = kextra[t - kKeptInShared];
            hit = overlaps(p, box_area(p), q, aq, mid, odd);
          }
          if (hit) removed[c] = 1;
        }
        __syncthreads();
      }
      mark(2);

      // (b) the round's triangle: row p's bits for the columns q > p, a
      // thread kChunk columns of one row (the same columns across a warp),
      // OR-ed into the row's word; rows (a) removed are never kept, and skip
      {
        constexpr int kChunk = kTile * kTile / kThreads;
        const int p = tid % kTile;
        const int q0 = tid / kTile * kChunk;
        if (q0 + kChunk - 1 > p && q0 < ncols && !removed[p]) {
          const float4 b = cbox[p];
          const float a = carea[p];
          u64 bits = 0;
  #pragma unroll 8
          for (int c = 0; c < kChunk; ++c) {
            const int q = q0 + c;
            if (overlaps(b, a, cbox[q], carea[q], mid, odd)) bits |= 1ull << q;
          }
          const u64 cols = ncols == kTile ? ~0ull : (1ull << ncols) - 1;
          bits &= cols & ~((2ull << p) - 1);
          if (bits) atomicOr(&blk[p], bits);
        }
      }
      __syncthreads();
      mark(3);

      // (c) the keeps, by warp 0. With O the round's open candidates and
      // row(q) the bits q removes (all after q), the greedy keep set is the
      // one fixed point of K = O \ OR of row(q), q in K: a candidate's
      // membership follows from its predecessors'. From K = O the iteration
      // reaches it in the depth of the round's removal chains plus one
      // steps, each an OR-reduction across the lanes (every lane holds the
      // rows of candidates lane and lane + 32). The first max_det - k of K
      // are kept, in order.
      if (warp == 0) {
        const u64 open =
            ~((static_cast<u64>(__ballot_sync(kFull, removed[32 + lane]))
               << 32) |
              __ballot_sync(kFull, removed[lane]));
        const u64 row_a = blk[lane], row_b = blk[lane + 32];
        u64 keep = open;
        for (int it = 0; it <= kTile; ++it) {
          const u64 v = (((keep >> lane) & 1) ? row_a : 0ull) |
                        (((keep >> (lane + 32)) & 1) ? row_b : 0ull);
          const u64 gone =
              (static_cast<u64>(__reduce_or_sync(
                   kFull, static_cast<unsigned>(v >> 32)))
               << 32) |
              __reduce_or_sync(kFull, static_cast<unsigned>(v));
          const u64 next = open & ~gone;
          if (next == keep) break;
          keep = next;
        }
        // the first max_det - k keeps, in order; each lane its two
        const int budget = max_det - k;
        const int rank_a = __popcll(keep & ((1ull << lane) - 1));
        const int rank_b = __popcll(keep & ((1ull << (lane + 32)) - 1));
        if (((keep >> lane) & 1) && rank_a < budget) kept[rank_a] = lane;
        if (((keep >> (lane + 32)) & 1) && rank_b < budget) {
          kept[rank_b] = lane + 32;
        }
        const int nkept = min(__popcll(keep), budget);
        __syncwarp();  // kept[] written
        mark(4);
        for (int t = lane; t < nkept; t += 32) {
          const int p = kept[t];
          out_idx[k + t] = cidx[p];
          out_scores[k + t] = cscore[p];
          if (k + t < kKeptInShared) {
            kbox[k + t] = cbox[p];
            karea[k + t] = carea[p];
          } else {
            kextra[k + t - kKeptInShared] = cbox[p];
          }
        }
        if (lane == 0) s_nkept = k + nkept;
      }
      __syncthreads();  // the keeps, and their boxes, seen by every thread
      k = s_nkept;
      mark(5);
      if (kProfile) ++cyc[7];
    }
    if constexpr (kLarge) {
      walked += batch;
      if (unsorted && k < max_det && walked < count) {
        lo = keys[batch - 1] + 1;  // above the batch's last key
        continue;
      }
    }
    break;
  }
  for (int i = k + tid; i < max_det; i += kThreads) {
    out_idx[i] = -1;
    out_scores[i] = 0.0f;
  }
#ifdef DETJAX_NMS_PROFILE
  if (tid == 0) {
    cyc[6] = clock64() - t_start;
    for (int i = 0; i < kPhases; ++i)
      g_phase_cycles[static_cast<size_t>(blockIdx.x) * kPhases + i] = cyc[i];
  }
#endif
}

// The midpoint between t and the next float above it, exactly, in fp64
// (t + 2^103 for the largest finite float, whose next is inf).
double upper_midpoint(float t) {
  const float next = nextafterf(t, INFINITY);
  if (std::isinf(next) && !std::isinf(t)) return t + std::ldexp(1.0, 103);
  return (static_cast<double>(t) + static_cast<double>(next)) * 0.5;
}

}  // namespace

// Bytes of scratch a call takes: the boxes of the keeps past the first
// kKeptInShared, [batch, max(max_det - kKeptInShared, 0)] float4.
extern "C" long long detjax_nms_scratch_bytes(int batch, int max_det) {
  return 16LL * batch * (max_det > kKeptInShared ? max_det - kKeptInShared
                                                 : 0);
}

namespace {

template <int kThreads, bool kLarge>
cudaError_t launch(const float* boxes, const float* scores, const int* labels,
                   int* keep_idx, float* keep_scores, void* scratch,
                   int batch, int n, int pow2, int max_det, double mid,
                   int odd, float class_offset, cudaStream_t stream) {
  auto kernel = nms_kernel<kThreads, kLarge>;
  const size_t smem =
      kLarge ? sizeof(u64) * kSelect + sizeof(int) * (kBins + 4)
             : sizeof(u64) * pow2;
  if (smem > 8 * 1024) {  // beside about 13 KB of static shared memory
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  kernel<<<batch, kThreads, smem, stream>>>(
      reinterpret_cast<const float4*>(boxes), scores, labels, keep_idx,
      keep_scores, static_cast<float4*>(scratch), n, pow2, max_det, mid, odd,
      class_offset);
  return cudaGetLastError();
}

}  // namespace

// Launches the kernel on `stream` of `device`, adding one to *launched when
// the runtime accepted the launch; returns the error (0 = ok). `scratch`
// (uninitialised, from the caller) holds detjax_nms_scratch_bytes bytes,
// 16-byte aligned. A block has 512 threads when there are few rows (each
// row's latency is the call's: more threads a round) and 256 from two rows
// an SM on (five blocks an SM, every row in one wave); rows of more than
// kSelect candidates take the large instance, 512 threads. The caller
// guarantees batch >= 1, 1 <= n < 2^31, max_det >= 1, contiguous buffers
// and 16-byte-aligned boxes.
extern "C" int detjax_nms_launch(const float* boxes, const float* scores,
                                 const int* labels, int* keep_idx,
                                 float* keep_scores, void* scratch,
                                 int batch, int n, int max_det,
                                 float iou_threshold, float class_offset,
                                 int device, void* stream, int* launched) {
  static int sm_count[64];  // per device, read once
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (device < 0 || device >= 64) {
    return static_cast<int>(cudaErrorInvalidDevice);
  }
  if (sm_count[device] == 0) {
    err = cudaDeviceGetAttribute(&sm_count[device],
                                 cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  int pow2 = 1;
  while (pow2 < n && pow2 < kSelect) pow2 <<= 1;
  unsigned bits;
  std::memcpy(&bits, &iou_threshold, sizeof bits);
  const double mid = upper_midpoint(iou_threshold);
  const int odd = static_cast<int>(bits & 1u);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n > kSelect) {
    err = launch<512, true>(boxes, scores, labels, keep_idx, keep_scores,
                            scratch, batch, n, pow2, max_det, mid, odd,
                            class_offset, s);
  } else {
    err = batch >= 2 * sm_count[device]
              ? launch<256, false>(boxes, scores, labels, keep_idx,
                                   keep_scores, scratch, batch, n, pow2,
                                   max_det, mid, odd, class_offset, s)
              : launch<512, false>(boxes, scores, labels, keep_idx,
                                   keep_scores, scratch, batch, n, pow2,
                                   max_det, mid, odd, class_offset, s);
  }
  if (err == cudaSuccess) ++*launched;
  return static_cast<int>(err);
}

#ifdef DETJAX_NMS_PROFILE
// The instrumented build's entry: as detjax_nms_launch, and each row's
// cycles by phase to `phase_cycles` ([batch, kPhases] int64).
extern "C" int detjax_nms_profile_launch(
    const float* boxes, const float* scores, const int* labels,
    int* keep_idx, float* keep_scores, void* scratch, int batch, int n,
    int max_det, float iou_threshold, float class_offset,
    long long* phase_cycles, int device, void* stream, int* launched) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaMemcpyToSymbolAsync(g_phase_cycles, &phase_cycles,
                                sizeof phase_cycles, 0,
                                cudaMemcpyHostToDevice,
                                static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return detjax_nms_launch(boxes, scores, labels, keep_idx, keep_scores,
                           scratch, batch, n, max_det, iou_threshold,
                           class_offset, device, stream, launched);
}
#endif
