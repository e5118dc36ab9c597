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
// for G = 1024; the card allows a block 227 KB.  G <= 1024 is the cap of
// engine/route.py's DEFAULT_MAX_GROUPS, and up to it a call is this one
// launch.
//
// More than 1,024 groups (a caller that raises the route's cap): partition
// the rows by group window, then bin each window.  Binning every row block
// once for every window would repeat the per-row work W times (22 times at
// 65,536 groups in windows of 3,072: 3.5x slower than torch.bincount on an
// H100).  Here every row's predicate, key and value are read from device
// memory once and binned once, whatever G is, in three launches:
//
// 1. partition_rows: block b takes rows [2048 b, 2048 b + 2048), one tile
//    of the loads above.  A row that passes and whose key is a group
//    goes to bucket key / width / per_bucket: the G groups are cut into
//    W = ceil(G / width) windows of width = ceil(G / ceil(G / 1,024))
//    groups, and a bucket is a window, or per_bucket neighbouring windows
//    where W > kMaxBuckets = 1,024 (above 1 M groups).  Each warp ranks its
//    lanes' rows step by step as the binning does (__match_any_sync on the
//    bucket, the rank among the lower lanes of the same bucket, a per-warp
//    count a bucket in shared memory), and stages the row's (key, float32
//    value) pair and its (bucket, rank) in shared memory.  Then the block
//    takes each bucket's count over its warps (warp prefixes) and an
//    exclusive scan over the buckets, finds each pair's place in the
//    block's region of the pair buffer (region b starts at pair 2,048 b;
//    the passing rows only, 8 B each, bucket by bucket, warp by warp, then
//    in step order), writes the region in order (coalesced), and writes
//    its bucket offsets (buckets + 1 ints).  The places are integer ranks,
//    so the layout is a function of the input alone.
// 2. bin_buckets: block (window w, chunk c) takes the row blocks of chunk
//    c (the P row blocks cut into C chunks) in order, 512 at a time, whose
//    segments of w's bucket make one sequence of pairs; its warps take
//    units of 32 consecutive pairs in turn (warp k: units k, k + 8, ...,
//    the next one's loads in flight while it bins this one), each unit one
//    __match_any_sync step of today's per-warp bins, and the block's
//    partial is its warps' bins in warp order, part[c][g].  A window of
//    1,024 groups takes 71 KB, so three blocks share an SM (a window of
//    3,072, 197 KB, leaves one block an SM and the bins' latency bare),
//    and units cut from the whole sequence keep every lane busy where a
//    segment holds few pairs.
// 3. merge_partials adds the C partials in a fixed order: 8 slices of
//    chunks in order, then the slices in order (32 groups a block).
//
// P = ceil(n / 2,048), W and C = min(P, ceil(396 / W)) come from (n, G)
// alone (ops.py many_plan; 396 is a constant, not the SM count), and every
// float sum is taken in an order they fix, so two launches are bitwise
// equal; counts are summed as integers; there are no atomics on sums or
// counts.  Traffic: 12 B a row read once, 8 B a passing row written and
// read again, and C x G x 8 B of partials written and read (3.7 MB at
// 65,536 groups: C = 7), against 33.6 MB of rows at Q2's 2.8 M.  Shared
// memory: partition_rows 32 KB of staging and 4 B x (8 + 1) a bucket (68
// KB at 1,024 buckets), bin_buckets 8 x width x 8 B + 5 KB (71 KB at
// 1,024).  A partition block of 2,048 rows (4,096 measured 4-6 % slower
// at 1,025 to 65,536 groups) leaves room for more blocks an SM; a bin
// block does not care how small the segments are, since it cuts its units
// from their sequence.  Thread-block clusters (one row tile fed by TMA multicast to a
// cluster of blocks, each binning a window) were the other Hopper option;
// they keep the per-row binning work W times over (every block of the
// cluster walks every row), which is what lost, so the rows are
// partitioned instead.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kQuads = 2;                            // per thread and tile
constexpr int kTileRows = kThreads * 4 * kQuads;     // 2048
constexpr int kMaxGroups = 1024;                 // one launch, merged by ticket
constexpr int kWindow = 1024;        // most groups a bin block holds (ops.py WINDOW)
constexpr int kPartRows = kTileRows;  // rows a partition block (ops.py PART_ROWS)
constexpr int kMaxBuckets = 1024;    // most buckets a partition block counts
constexpr int kSegBatch = 512;       // row blocks a bin block stages at a time

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
                            int num_groups, int aligned,
                            float* __restrict__ part_sums,
                            int* __restrict__ part_counts,
                            unsigned int* __restrict__ ticket,
                            float* __restrict__ sums,
                            float* __restrict__ counts) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float slice_sum[kThreads];
  __shared__ long long slice_count[kThreads];
  __shared__ bool is_last;
  const int G = num_groups;
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
  const long long begin = (long long)blockIdx.x * rows_per_block;
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
        const int kj = k[qd][j];
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
    part_sums[(size_t)blockIdx.x * G + g] = s;
    part_counts[(size_t)blockIdx.x * G + g] = c;
  }
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
        (int)dynamic_smem(kMaxGroups));
    if (err != cudaSuccess) return err;
    configured = true;
  }
  fused_filter_agg_kernel<V, F>
      <<<num_blocks, kThreads, dynamic_smem(num_groups), stream>>>(
          static_cast<const int*>(keys), static_cast<const V*>(vals),
          static_cast<const F*>(filt), n, rows_per_block, op, threshold,
          num_groups, aligned, part_sums, part_counts, ticket, sums, counts);
  return cudaGetLastError();
}


// ---------------------------------------------- more than kMaxGroups groups
// Shared memory of partition_rows: the staged pairs, (bucket, rank) and
// place of kPartRows rows, a count a bucket for each warp, and the bucket
// offsets.
size_t partition_smem(int buckets) {
  return (size_t)kPartRows * (8 + 4 + 4) + (size_t)kWarps * buckets * 4 +
         (size_t)(buckets + 1) * 4;
}

// a[0 .. len) becomes its exclusive prefix sums and a[len] the total; each
// thread takes a run of consecutive entries.  Every thread of the block
// calls it; `warp_total` holds kWarps ints.
__device__ void block_exclusive_scan(int* a, int len, int* warp_total) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int per = (len + kThreads - 1) / kThreads;
  const int i0 = min(len, (int)threadIdx.x * per), i1 = min(len, i0 + per);
  int local = 0;
  for (int i = i0; i < i1; ++i) local += a[i];
  int x = local;  // inclusive scan over the warp's lanes
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_total[warp] = x;
  __syncthreads();
  int run = x - local;
  for (int w = 0; w < warp; ++w) run += warp_total[w];
  for (int i = i0; i < i1; ++i) {
    const int c = a[i];
    a[i] = run;
    run += c;
  }
  if (threadIdx.x == 0) {
    int total = 0;
    for (int w = 0; w < kWarps; ++w) total += warp_total[w];
    a[len] = total;
  }
  __syncthreads();
}

// Step 1 (see the header): rows of row block blockIdx.x, read once, staged,
// and written as (key, float32 value) pairs to the block's region of
// `pairs`, bucket by bucket; `offsets` gets the region's bucket offsets
// (buckets + 1 ints a row block).
template <typename V, typename F>
__global__ void __launch_bounds__(kThreads)
    partition_rows(const int* __restrict__ keys, const V* __restrict__ vals,
                   const F* __restrict__ filt, long long n, int op,
                   float threshold, int num_groups, int width, int per_bucket,
                   int buckets, int aligned, int2* __restrict__ pairs,
                   int* __restrict__ offsets) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int warp_total[kWarps];
  int2* s_pair = reinterpret_cast<int2*>(smem);              // [kPartRows]
  int* s_info = reinterpret_cast<int*>(s_pair + kPartRows);  // [kPartRows]
  int* s_src = s_info + kPartRows;  // [kPartRows]: the staged entry of each place
  int* cnt = s_src + kPartRows;                              // [kWarps][buckets]
  int* off = cnt + kWarps * buckets;                         // [buckets + 1]
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const unsigned below = (1u << lane) - 1u;

  for (int i = threadIdx.x; i < kWarps * buckets; i += kThreads) cnt[i] = 0;
  __syncthreads();
  int* wcnt = cnt + warp * buckets;

  const bool vk = aligned & 1, vv = aligned & 2, vf = aligned & 4;
  const long long begin = (long long)blockIdx.x * kPartRows;
  const long long end = min(n, begin + kPartRows);
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
        const int kj = k[qd][j];
        const bool keep =
            passes(to_f32(f[qd][j]), op, threshold) && kj >= 0 && kj < num_groups;
        const int u = keep ? kj / width / per_bucket : -1;
        const unsigned peers = __match_any_sync(0xffffffffu, u);
        // staged step by step, a thread's entries kThreads apart (no bank
        // conflicts); the warp that ranked entry i is i % kThreads / 32
        const int slot = ((int)(base - begin) / kTileRows * kQuads * 4 + qd * 4 + j) *
                             kThreads + threadIdx.x;
        const int pos = u >= 0 ? wcnt[u] + __popc(peers & below) : 0;
        __syncwarp();  // every lane has read its bucket's count
        if (u >= 0 && lane == __ffs(peers) - 1) wcnt[u] += __popc(peers);
        s_pair[slot] = make_int2(kj, __float_as_int(to_f32(v[qd][j])));
        s_info[slot] = u >= 0 ? (u << 16) | pos : -1;
        __syncwarp();  // the counts are updated for the next step
      }
    }
  }
  __syncthreads();

  // each bucket's warp prefixes (in cnt) and total (in off), then the
  // buckets' offsets in the region
  for (int u = threadIdx.x; u < buckets; u += kThreads) {
    int run = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int c = cnt[w * buckets + u];
      cnt[w * buckets + u] = run;
      run += c;
    }
    off[u] = run;
  }
  __syncthreads();
  block_exclusive_scan(off, buckets, warp_total);
  int* out_off = offsets + (size_t)blockIdx.x * (buckets + 1);
  for (int u = threadIdx.x; u <= buckets; u += kThreads) out_off[u] = off[u];

  // each pair's place in the region (bucket, then warp, then the warp's
  // order), then the region written in order, neighbouring threads on
  // neighbouring pairs
  const int staged = (int)((end - begin + kTileRows - 1) / kTileRows) * kTileRows;
  for (int slot = threadIdx.x; slot < staged; slot += kThreads) {
    const int info = s_info[slot];
    if (info < 0) continue;
    const int u = info >> 16, pos = info & 0xffff;
    s_src[off[u] + cnt[warp * buckets + u] + pos] = slot;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < off[buckets]; i += kThreads)
    __stcg(pairs + begin + i, s_pair[s_src[i]]);
}

// Step 2: block (window blockIdx.x % windows, chunk blockIdx.x / windows)
// bins its window's pairs from the segments of the chunk's row blocks and
// writes its partial part[chunk][g] for the window's groups.  The row
// blocks are taken kSegBatch at a time: their segments' offsets go to
// shared memory (loaded side by side) with a prefix of their pair counts,
// so the batch's segments are one sequence of pairs; warp k takes its
// units of 32 consecutive pairs k, k + 8, ..., each lane finding its
// pair's segment by a binary search, and loads the next unit's pairs
// before it bins this one's.
__global__ void __launch_bounds__(kThreads)
    bin_buckets(const int2* __restrict__ pairs, const int* __restrict__ offsets,
                int row_blocks, int buckets, int per_bucket, int num_groups,
                int width, int windows, int chunks, float* __restrict__ part_sums,
                int* __restrict__ part_counts) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_lo[kSegBatch];         // a segment's first pair in its region
  __shared__ int s_first[kSegBatch + 1];  // and in the batch's sequence
  __shared__ int warp_total[kWarps];
  const int win = blockIdx.x % windows, chunk = blockIdx.x / windows;
  const int g0 = win * width, G = min(width, num_groups - g0);
  const int u = win / per_bucket;
  float* bin_sum = reinterpret_cast<float*>(smem);  // [kWarps][G]
  int* bin_count = reinterpret_cast<int*>(bin_sum + kWarps * G);
  float* lane_val = reinterpret_cast<float*>(bin_count + kWarps * G);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  for (int i = threadIdx.x; i < kWarps * G; i += kThreads) {
    bin_sum[i] = 0.0f;
    bin_count[i] = 0;
  }
  float* wsum = bin_sum + warp * G;
  int* wcount = bin_count + warp * G;
  float* wval = lane_val + warp * 32;

  const int b0 = (int)((long long)row_blocks * chunk / chunks);
  const int b1 = (int)((long long)row_blocks * (chunk + 1) / chunks);
  for (int bb = b0; bb < b1; bb += kSegBatch) {
    const int nb = min(kSegBatch, b1 - bb);
    __syncthreads();  // the last batch's offsets are used (and the bins zeroed)
    for (int i = threadIdx.x; i < nb; i += kThreads) {
      const int* ob = offsets + (size_t)(bb + i) * (buckets + 1) + u;
      s_lo[i] = ob[0];
      s_first[i] = ob[1] - ob[0];
    }
    __syncthreads();
    block_exclusive_scan(s_first, nb, warp_total);  // each segment's first pair
    const int total = s_first[nb];  // the batch's pairs, one sequence
    int seg = 0;  // the segment of this warp's last unit's first pair
    // pair `at` of the sequence ((-1, 0) past its end; keys in the pairs
    // are groups, so -1 is no key): its segment by a binary search from
    // the warp's last segment
    auto load_pair = [&](int at) {
      int lo = seg, hi = nb;  // s_first[lo] <= at < s_first[hi]
      while (hi - lo > 1) {
        const int mid = (lo + hi) / 2;
        if (s_first[mid] <= at) lo = mid;
        else hi = mid;
      }
      seg = __shfl_sync(0xffffffffu, lo, 0);
      return at < total
                 ? __ldcs(pairs + (size_t)(bb + lo) * kPartRows + s_lo[lo] + at - s_first[lo])
                 : make_int2(-1, 0);
    };
    // units of 32 consecutive pairs, warp k taking units k, k + kWarps, ...
    int2 next = 32 * warp < total ? load_pair(32 * warp + lane) : make_int2(-1, 0);
    for (int j = warp; 32 * j < total; j += kWarps) {
      const int2 p = next;
      if (32 * (j + kWarps) < total)
        next = load_pair(32 * (j + kWarps) + lane);  // in flight meanwhile
      int key = p.x - g0;
      if (key < 0 || key >= G) key = -1;  // none, or another window of the bucket
      const unsigned peers = __match_any_sync(0xffffffffu, key);
      wval[lane] = __int_as_float(p.y);
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
  __syncthreads();

  for (int g = threadIdx.x; g < G; g += kThreads) {
    float s = 0.0f;
    int c = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      s += bin_sum[w * G + g];
      c += bin_count[w * G + g];
    }
    part_sums[(size_t)chunk * num_groups + g0 + g] = s;
    part_counts[(size_t)chunk * num_groups + g0 + g] = c;
  }
}

// Step 3: sums[g] and counts[g] over the C partials: a block takes 32
// groups (a lane each, neighbouring lanes on neighbouring groups of a
// partial); warp s adds the partials [C s / 8, C (s + 1) / 8) in order,
// and the first warp adds the 8 slices in order.
__global__ void __launch_bounds__(kThreads)
    merge_partials(const float* __restrict__ part_sums,
                   const int* __restrict__ part_counts, int num_blocks,
                   int num_groups, float* __restrict__ sums,
                   float* __restrict__ counts) {
  __shared__ float slice_sum[kWarps][32];
  __shared__ long long slice_count[kWarps][32];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = blockIdx.x * 32 + lane;
  float s = 0.0f;
  long long c = 0;
  if (g < num_groups) {
    const int p1 = (int)((long long)num_blocks * (warp + 1) / kWarps);
#pragma unroll 8
    for (int p = (int)((long long)num_blocks * warp / kWarps); p < p1; ++p) {
      s += part_sums[(size_t)p * num_groups + g];
      c += part_counts[(size_t)p * num_groups + g];
    }
  }
  slice_sum[warp][lane] = s;
  slice_count[warp][lane] = c;
  __syncthreads();
  if (warp != 0 || g >= num_groups) return;
  s = 0.0f;
  c = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    s += slice_sum[w][lane];
    c += slice_count[w][lane];
  }
  sums[g] = s;
  counts[g] = (float)c;
}

template <typename V, typename F>
cudaError_t launch_many(const void* keys, const void* vals, const void* filt,
                        long long n, int op, float threshold, int num_groups,
                        int row_blocks, int windows, int width, int buckets,
                        int per_bucket, int chunks, int aligned, int2* pairs,
                        int* offsets, float* part_sums, int* part_counts,
                        float* sums, float* counts, cudaStream_t stream) {
  static bool configured = false;  // the attributes are per function
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        partition_rows<V, F>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)partition_smem(kMaxBuckets));
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(bin_buckets,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)dynamic_smem(kWindow));
    if (err != cudaSuccess) return err;
    configured = true;
  }
  partition_rows<V, F><<<row_blocks, kThreads, partition_smem(buckets), stream>>>(
      static_cast<const int*>(keys), static_cast<const V*>(vals),
      static_cast<const F*>(filt), n, op, threshold, num_groups, width,
      per_bucket, buckets, aligned, pairs, offsets);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  bin_buckets<<<windows * chunks, kThreads, dynamic_smem(width), stream>>>(
      pairs, offsets, row_blocks, buckets, per_bucket, num_groups, width,
      windows, chunks, part_sums, part_counts);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  merge_partials<<<(num_groups + 31) / 32, kThreads, 0, stream>>>(
      part_sums, part_counts, chunks, num_groups, sums, counts);
  return cudaGetLastError();
}

}  // namespace

// Rows per tile; the Python wrapper reads it to size the grid.
extern "C" int fused_filter_agg_tile_rows() { return kTileRows; }

// Launches the kernel on `stream` and returns cudaGetLastError() (0 on
// success).  Does not synchronise.  `vals_is_int` / `filt_is_int` select
// int32 instead of float32 inputs; bit 0, 1, 2 of `aligned` say that keys,
// vals, filt start on a 16-byte boundary.  num_groups must be in [1, 1024];
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
  if (num_groups < 1 || num_groups > kMaxGroups || num_blocks < 1 ||
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

// More than 1,024 groups: the three launches of the header on `stream`;
// returns cudaGetLastError() (0 on success) and does not synchronise.  The
// plan is ops.py many_plan(n, num_groups): row_blocks = max(1, ceil(n /
// 2048)); `windows` windows of `width` <= 1,024 groups covering
// num_groups; `buckets` <= 1,024 buckets of `per_bucket` windows each;
// 1 <= chunks <= row_blocks.  `pairs` holds n int2, `offsets` row_blocks *
// (buckets + 1) ints, part_sums / part_counts chunks * num_groups entries.
extern "C" int fused_filter_agg_many_launch(
    int device, const void* keys, const void* vals, int vals_is_int,
    const void* filt, int filt_is_int, long long n, int op, float threshold,
    int num_groups, int row_blocks, int windows, int width, int buckets,
    int per_bucket, int chunks, int aligned, void* pairs, void* offsets,
    void* part_sums, void* part_counts, void* sums, void* counts, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaGetLastError();  // clear a stale error from an earlier call
  const long long want_blocks = n > 0 ? (n + kPartRows - 1) / kPartRows : 1;
  if (num_groups <= kMaxGroups || row_blocks != want_blocks || width < 1 ||
      width > kWindow || (long long)(windows - 1) * width >= num_groups ||
      (long long)windows * width < num_groups || buckets < 1 ||
      buckets > kMaxBuckets || per_bucket < 1 ||
      (long long)(buckets - 1) * per_bucket >= windows ||
      (long long)buckets * per_bucket < windows || chunks < 1 ||
      chunks > row_blocks || (long long)windows * chunks > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int2* pr = static_cast<int2*>(pairs);
  int* of = static_cast<int*>(offsets);
  float* ps = static_cast<float*>(part_sums);
  int* pc = static_cast<int*>(part_counts);
  float* os = static_cast<float*>(sums);
  float* oc = static_cast<float*>(counts);
  auto go = vals_is_int && filt_is_int ? launch_many<int, int>
            : vals_is_int              ? launch_many<int, float>
            : filt_is_int              ? launch_many<float, int>
                                       : launch_many<float, float>;
  return (int)go(keys, vals, filt, n, op, threshold, num_groups, row_blocks,
                 windows, width, buckets, per_bucket, chunks, aligned, pr, of,
                 ps, pc, os, oc, s);
}

extern "C" const char* fused_filter_agg_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
