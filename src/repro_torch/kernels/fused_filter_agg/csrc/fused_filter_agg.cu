// Fused filter + grouped aggregation for Hopper (sm_90a).
//
// Replaces repro/kernels/fused_filter_agg/kernel.py:fused_filter_agg_kernel,
// the Pallas TPU kernel.  For every row whose filter value passes
// `filt <op> threshold` (compared in float32) and whose key lies in
// [0, num_groups), adds the value (as float32) to its group's sum and one
// to its group's count.  Keys outside that range, -1 included, contribute
// nothing.  Outputs: sums f32[G] and counts f32[G], for any G >= 1.
//
// What bounds it: memory.  Each row is read once: a 4-byte key, a 4-byte
// value and a 4-byte filter value, 12 B a row.  At the query path's 2.8 M
// rows that is 33.6 MB, 0.0100 ms at the H100 SXM's 3.35 TB/s; the outputs
// are a few KB.  The arithmetic is a compare and an add a row.  What the
// design has to keep off the critical path is the per-row bookkeeping of
// the histogram, so that the loads stay in flight.
//
// Design: one launch of P blocks of 256 threads (8 warps); P and the rows
// of each block come from n alone (ops.py grid()), never from G or the SM
// count, so float sums are the same on every card.  Block b takes a fixed
// contiguous row range in tiles of 2048 rows; each thread loads two quads
// of 4 consecutive rows per tile, a 16-byte load from each column (int4),
// neighbouring threads on neighbouring addresses.  A column whose start is
// not 16-byte aligned takes four 4-byte loads of the same rows instead, and
// the ragged end of the rows (n % 4 != 0) is loaded row by row: the rows a
// thread owns do not depend on alignment, so neither do the sums.
//
// Per-warp histograms in shared memory, a float32 sum and an int32 count a
// group for each warp.  A warp takes its 32 lanes' rows one step at a time
// (quad by quad, row j of the quad); the predicate and the key range fold
// into the key (-1 for a row that fails either).  __match_any_sync groups
// the lanes that hold the same key; the lowest lane of each group adds the
// group's values in ascending lane order and updates its warp's own bins.
// No other warp touches those bins, and there are no atomics on them,
// float or integer.  At the end the block adds its warps' bins in warp
// order into its partial, part_sums[b][G] and part_counts[b][G].
//
// One launch: each block then fences its partial (__threadfence) and takes
// a ticket (atomicAdd on a counter).  The block that draws the last ticket
// adds the P partials in block order (a thread a group, or a few threads a
// group each over a fixed slice of blocks, then the slices in order),
// writes sums and counts, and puts the counter back to 0.  The wrapper
// keeps one counter per (device, stream), made zero once, so two calls on
// two streams never share one and no call spends a launch on a memset.
// Counts are summed as integers, so they are exact; float sums depend only
// on (n, G), so two launches on the same input are bitwise equal.
//
// Shared-memory budget: 8 warps x G x (4 + 4) B of bins, 8 x 32 x 4 B of
// lane values and 3 KB for the last block's slices: 8.2 KB at G = 64,
// 69.6 KB at G = 1024.  Above 48 KB a launch needs the dynamic
// shared-memory opt-in (cudaFuncSetAttribute), set once per instantiation
// for the largest window (below); the card allows a block 227 KB.
//
// More than 1,024 groups (kMaxGroups, the cap of engine/route.py's
// DEFAULT_MAX_GROUPS; a caller may raise it): group windows over the grid.
// The G groups are cut into W = ceil(G / kWindow) windows of at most
// kWindow = 3,072 groups (bins of 196 KB), as even as they go, and the
// launch has P x W blocks, window fastest, so the W blocks that read the
// same rows run side by side and all but the first read them from L2.
// Block (p, w) walks row block p exactly as above, keeps only the keys of
// window w in its warps' bins, and writes its groups' slice of partial p.
// A second launch (merge_partials, a thread a group) then adds the P
// partials in block order.  P shrinks with G (ops.py grid(): P x G at
// most 2^22 partial entries, 32 MB), so the partials stay within the
// rows' bytes at the query path's sizes.  The promises hold: counts are
// summed as integers, every float sum is taken in an order fixed by
// (n, G), there are no atomics on sums or counts, and there is no ticket.
// Two launches were chosen over one block-wide bin set with the warps in
// turn: that set holds at most 28 K groups in 227 KB, so large G needs
// windows anyway, and the turns would serialise the warps on every row.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kQuads = 2;                            // per thread and tile
constexpr int kTileRows = kThreads * 4 * kQuads;     // 2048
constexpr int kMaxGroups = 1024;                 // one launch, merged by ticket
constexpr int kWindow = 3072;                    // most groups a block bins

enum Op { kGe = 0, kGt = 1, kLe = 2, kLt = 3, kEq = 4, kNe = 5 };

__device__ __forceinline__ bool passes(float f, int op, float t) {
  switch (op) {
    case kGe: return f >= t;
    case kGt: return f > t;
    case kLe: return f <= t;
    case kLt: return f < t;
    case kEq: return f == t;
    default: return f != t;
  }
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(int x) { return __int2float_rn(x); }
__device__ __forceinline__ float from_bits(int x, float) { return __int_as_float(x); }
__device__ __forceinline__ int from_bits(int x, int) { return x; }

// Rows r0 .. r0 + 3 of a 4-byte column (r0 % 4 == 0): one 16-byte load when
// the column is 16-byte aligned and all four rows exist, else row by row;
// rows at or past `end` read as `fill`.
template <typename T>
__device__ __forceinline__ void load4(const T* __restrict__ p, long long r0,
                                      long long end, bool vec, T fill,
                                      T (&x)[4]) {
  if (vec && r0 + 4 <= end) {
    const int4 raw = __ldcs(reinterpret_cast<const int4*>(p + r0));
    x[0] = from_bits(raw.x, fill);
    x[1] = from_bits(raw.y, fill);
    x[2] = from_bits(raw.z, fill);
    x[3] = from_bits(raw.w, fill);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) x[j] = r0 + j < end ? __ldcs(p + r0 + j) : fill;
  }
}

size_t dynamic_smem(int num_groups) {
  return (size_t)kWarps * num_groups * 8 + (size_t)kWarps * 32 * 4;
}

template <typename V, typename F>
__global__ void __launch_bounds__(kThreads)
    fused_filter_agg_kernel(const int* __restrict__ keys,
                            const V* __restrict__ vals,
                            const F* __restrict__ filt, long long n,
                            long long rows_per_block, int op, float threshold,
                            int num_groups, int windows, int aligned,
                            float* __restrict__ part_sums,
                            int* __restrict__ part_counts,
                            unsigned int* __restrict__ ticket,
                            float* __restrict__ sums,
                            float* __restrict__ counts) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float slice_sum[kThreads];
  __shared__ long long slice_count[kThreads];
  __shared__ bool is_last;
  // this block's rows (row block pb) and groups (window win: [g0, g0 + G))
  const int pb = blockIdx.x / windows, win = blockIdx.x % windows;
  const int g0 = (int)((long long)num_groups * win / windows);
  const int G = (int)((long long)num_groups * (win + 1) / windows) - g0;
  float* bin_sum = reinterpret_cast<float*>(smem);  // [kWarps][G]
  int* bin_count = reinterpret_cast<int*>(bin_sum + kWarps * G);
  float* lane_val = reinterpret_cast<float*>(bin_count + kWarps * G);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  for (int i = threadIdx.x; i < kWarps * G; i += kThreads) {
    bin_sum[i] = 0.0f;
    bin_count[i] = 0;
  }
  __syncthreads();
  float* wsum = bin_sum + warp * G;
  int* wcount = bin_count + warp * G;
  float* wval = lane_val + warp * 32;

  const bool vk = aligned & 1, vv = aligned & 2, vf = aligned & 4;
  const long long begin = (long long)pb * rows_per_block;
  const long long end = min(n, begin + rows_per_block);
  for (long long base = begin; base < end; base += kTileRows) {
    int k[kQuads][4];
    V v[kQuads][4];
    F f[kQuads][4];
#pragma unroll
    for (int qd = 0; qd < kQuads; ++qd) {  // every load of the tile first
      const long long r0 = base + (long long)(qd * kThreads + threadIdx.x) * 4;
      load4(keys, r0, end, vk, -1, k[qd]);
      load4(vals, r0, end, vv, V(0), v[qd]);
      load4(filt, r0, end, vf, F(0), f[qd]);
    }
#pragma unroll
    for (int qd = 0; qd < kQuads; ++qd) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = k[qd][j] - g0;
        const bool keep =
            passes(to_f32(f[qd][j]), op, threshold) && kj >= 0 && kj < G;
        const int key = keep ? kj : -1;
        const unsigned peers = __match_any_sync(0xffffffffu, key);
        wval[lane] = to_f32(v[qd][j]);
        __syncwarp();
        if (key >= 0 && lane == __ffs(peers) - 1) {
          float s = 0.0f;
          for (unsigned m = peers; m != 0; m &= m - 1)  // ascending lanes
            s += wval[__ffs(m) - 1];
          wsum[key] += s;
          wcount[key] += __popc(peers);
        }
        __syncwarp();  // wval is free for the next step
      }
    }
  }
  __syncthreads();

  // this block's partial: its warps' bins in warp order
  for (int g = threadIdx.x; g < G; g += kThreads) {
    float s = 0.0f;
    int c = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      s += bin_sum[w * G + g];
      c += bin_count[w * G + g];
    }
    part_sums[(size_t)pb * num_groups + g0 + g] = s;
    part_counts[(size_t)pb * num_groups + g0 + g] = c;
  }
  if (num_groups > kMaxGroups) return;  // merge_partials adds the partials
  __threadfence();  // the partial is visible to every block before the ticket
  __syncthreads();
  if (threadIdx.x == 0) is_last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();

  // the last block: the P partials in block order, S slices a group
  const int P = gridDim.x;
  const int S = max(1, kThreads / G);
  for (int i = threadIdx.x; i < S * G; i += kThreads) {
    const int g = i % G, sl = i / G;
    const int p1 = (int)((long long)P * (sl + 1) / S);
    float s = 0.0f;
    long long c = 0;
#pragma unroll 8
    for (int p = (int)((long long)P * sl / S); p < p1; ++p) {
      s += __ldcg(part_sums + (size_t)p * G + g);
      c += __ldcg(part_counts + (size_t)p * G + g);
    }
    if (S == 1) {
      sums[g] = s;
      counts[g] = (float)c;
    } else {
      slice_sum[i] = s;
      slice_count[i] = c;
    }
  }
  if (S > 1) {
    __syncthreads();
    for (int g = threadIdx.x; g < G; g += kThreads) {
      float s = 0.0f;
      long long c = 0;
      for (int sl = 0; sl < S; ++sl) {
        s += slice_sum[sl * G + g];
        c += slice_count[sl * G + g];
      }
      sums[g] = s;
      counts[g] = (float)c;
    }
  }
  if (threadIdx.x == 0) *ticket = 0;  // ready for the next call on this stream
}

// More than kMaxGroups groups: sums[g] and counts[g] over the P partials
// in block order, a thread a group (neighbouring threads on neighbouring
// groups of a partial).
__global__ void __launch_bounds__(kThreads)
    merge_partials(const float* __restrict__ part_sums,
                   const int* __restrict__ part_counts, int num_blocks,
                   int num_groups, float* __restrict__ sums,
                   float* __restrict__ counts) {
  const int g = blockIdx.x * kThreads + threadIdx.x;
  if (g >= num_groups) return;
  float s = 0.0f;
  long long c = 0;
#pragma unroll 8
  for (int p = 0; p < num_blocks; ++p) {
    s += part_sums[(size_t)p * num_groups + g];
    c += part_counts[(size_t)p * num_groups + g];
  }
  sums[g] = s;
  counts[g] = (float)c;
}

// Windows of the groups: the fewest of at most kWindow groups each
// (ops.py windows()), so one up to kWindow groups.
int group_windows(int num_groups) { return (num_groups + kWindow - 1) / kWindow; }

template <typename V, typename F>
cudaError_t launch(const void* keys, const void* vals, const void* filt,
                   long long n, long long rows_per_block, int op,
                   float threshold, int num_groups, int num_blocks,
                   int aligned, float* part_sums, int* part_counts,
                   unsigned int* ticket, float* sums, float* counts,
                   cudaStream_t stream) {
  static bool configured = false;  // the attribute is per function
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        fused_filter_agg_kernel<V, F>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)dynamic_smem(kWindow));
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const int windows = group_windows(num_groups);
  const int widest = (num_groups + windows - 1) / windows;
  fused_filter_agg_kernel<V, F>
      <<<num_blocks * windows, kThreads, dynamic_smem(widest), stream>>>(
          static_cast<const int*>(keys), static_cast<const V*>(vals),
          static_cast<const F*>(filt), n, rows_per_block, op, threshold,
          num_groups, windows, aligned, part_sums, part_counts, ticket, sums,
          counts);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || num_groups <= kMaxGroups) return err;
  merge_partials<<<(num_groups + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      part_sums, part_counts, num_blocks, num_groups, sums, counts);
  return cudaGetLastError();
}

}  // namespace

// Rows per tile; the Python wrapper reads it to size the grid.
extern "C" int fused_filter_agg_tile_rows() { return kTileRows; }

// Launches the kernel on `stream` (and merge_partials above 1024 groups)
// and returns cudaGetLastError() (0 on success).  Does not synchronise.  `vals_is_int` / `filt_is_int` select
// int32 instead of float32 inputs; bit 0, 1, 2 of `aligned` say that keys,
// vals, filt start on a 16-byte boundary.  num_groups must be positive;
// rows_per_block a multiple of the tile rows.  part_sums / part_counts hold
// num_blocks * num_groups entries; `ticket` is one unsigned int that is 0
// before the call and is 0 again after it.
extern "C" int fused_filter_agg_launch(
    int device, const void* keys, const void* vals, int vals_is_int,
    const void* filt, int filt_is_int, long long n, int op, float threshold,
    int num_groups, int num_blocks, long long rows_per_block, int aligned,
    void* part_sums, void* part_counts, void* ticket, void* sums,
    void* counts, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaGetLastError();  // clear a stale error from an earlier call
  if (num_groups < 1 || num_blocks < 1 ||
      rows_per_block % kTileRows != 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* ps = static_cast<float*>(part_sums);
  int* pc = static_cast<int*>(part_counts);
  unsigned int* t = static_cast<unsigned int*>(ticket);
  float* os = static_cast<float*>(sums);
  float* oc = static_cast<float*>(counts);
  if (vals_is_int && filt_is_int)
    return (int)launch<int, int>(keys, vals, filt, n, rows_per_block, op,
                                 threshold, num_groups, num_blocks, aligned,
                                 ps, pc, t, os, oc, s);
  if (vals_is_int)
    return (int)launch<int, float>(keys, vals, filt, n, rows_per_block, op,
                                   threshold, num_groups, num_blocks, aligned,
                                   ps, pc, t, os, oc, s);
  if (filt_is_int)
    return (int)launch<float, int>(keys, vals, filt, n, rows_per_block, op,
                                   threshold, num_groups, num_blocks, aligned,
                                   ps, pc, t, os, oc, s);
  return (int)launch<float, float>(keys, vals, filt, n, rows_per_block, op,
                                   threshold, num_groups, num_blocks, aligned,
                                   ps, pc, t, os, oc, s);
}

extern "C" const char* fused_filter_agg_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
