// Fused filter + grouped aggregation for Hopper (sm_90a).
//
// Replaces repro/kernels/fused_filter_agg/kernel.py:fused_filter_agg_kernel,
// the Pallas TPU kernel.  For every row whose filter value passes
// `filt <op> threshold` (compared in float32) and whose key lies in
// [0, num_groups), adds the value (as float32) to its group's sum and one
// to its group's count.  Keys outside that range, -1 included, contribute
// nothing.  Outputs: sums f32[G] and counts f32[G].
//
// What bounds it: memory.  Each row is read once: a 4-byte key, a 4-byte
// value and a 4-byte filter value, 12 B a row.  At n = 2^23 rows that is
// 96 MiB, about 30 us at the H100 SXM's 3.35 TB/s; the outputs are a few
// KB.  The arithmetic is a compare and an add a row, far below the card's
// rate.
//
// Design.  The TPU kernel carries its sums across a sequential grid in a
// revisited output block.  CUDA blocks run in parallel and in no fixed
// order, and float addition does not associate, so the sums must not
// depend on scheduling.  There are no float atomics here, in global or in
// shared memory; the result depends only on (n, P):
//
//   pass 1: each of P blocks takes a fixed contiguous row range.  It
//     stages the range a tile at a time in shared memory, with the
//     predicate and the key-range test folded into the key (a row that
//     fails either carries key -1).  Thread t owns group t: it scans the
//     tile in row order and keeps its group's partial sum and count in
//     registers.  At the end it writes them to the scratch rows
//     part_sums[P][G] and part_counts[P][G].
//   pass 2: one thread per group adds the P partials in block order.
//
// Counts are summed as integers, so they are exact.  Every row is read
// from device memory once, with neighbouring threads on neighbouring
// addresses, so the memory traffic is the bound's 12 B a row.  The cost
// is the scan: each of the block's ceil(G/32)*32 threads looks at every
// staged row, O(n*G) compares in all, like the TPU kernel's one-hot.
// Cutting that (warp-level histograms, 16-byte loads, one pass) is later
// work.

#include <cuda_runtime.h>

namespace {

// rows staged in shared memory per step: 2048 * (4 + 4) B = 16 KB
constexpr int kTileRows = 2048;

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

template <typename V, typename F>
__global__ void partial_kernel(const int* __restrict__ keys,
                               const V* __restrict__ vals,
                               const F* __restrict__ filt,
                               long long n, long long rows_per_block, int op,
                               float threshold, int num_groups,
                               float* __restrict__ part_sums,
                               int* __restrict__ part_counts) {
  __shared__ int s_key[kTileRows];
  __shared__ float s_val[kTileRows];
  const int t = threadIdx.x;
  const long long begin = (long long)blockIdx.x * rows_per_block;
  const long long end = min(n, begin + rows_per_block);
  float sum = 0.0f;
  int count = 0;
  for (long long base = begin; base < end; base += kTileRows) {
    const int rows = (int)min((long long)kTileRows, end - base);
    __syncthreads();  // every thread has finished scanning the last tile
    for (int r = t; r < rows; r += blockDim.x) {
      const long long i = base + r;
      const int k = keys[i];
      const bool keep =
          passes(to_f32(filt[i]), op, threshold) && k >= 0 && k < num_groups;
      s_key[r] = keep ? k : -1;
      s_val[r] = keep ? to_f32(vals[i]) : 0.0f;
    }
    __syncthreads();
#pragma unroll 8
    for (int r = 0; r < rows; ++r) {
      if (s_key[r] == t) {  // row order within the block: deterministic
        sum += s_val[r];
        ++count;
      }
    }
  }
  if (t < num_groups) {
    const long long slot = (long long)blockIdx.x * num_groups + t;
    part_sums[slot] = sum;
    part_counts[slot] = count;
  }
}

__global__ void combine_kernel(const float* __restrict__ part_sums,
                               const int* __restrict__ part_counts,
                               int num_blocks, int num_groups,
                               float* __restrict__ sums,
                               float* __restrict__ counts) {
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= num_groups) return;
  float s = 0.0f;
  long long c = 0;
  for (int p = 0; p < num_blocks; ++p) {  // block order: deterministic
    const long long slot = (long long)p * num_groups + g;
    s += part_sums[slot];
    c += part_counts[slot];
  }
  sums[g] = s;
  counts[g] = (float)c;
}

template <typename V, typename F>
void launch_partial(const void* keys, const void* vals, const void* filt,
                    long long n, long long rows_per_block, int op,
                    float threshold, int num_groups, int num_blocks,
                    int threads, float* part_sums, int* part_counts,
                    cudaStream_t stream) {
  partial_kernel<V, F><<<num_blocks, threads, 0, stream>>>(
      static_cast<const int*>(keys), static_cast<const V*>(vals),
      static_cast<const F*>(filt), n, rows_per_block, op, threshold,
      num_groups, part_sums, part_counts);
}

}  // namespace

// Rows per shared-memory tile; the Python wrapper reads it to size the grid.
extern "C" int fused_filter_agg_tile_rows() { return kTileRows; }

// Launches both passes on `stream` and returns cudaGetLastError() (0 on
// success).  Does not synchronise.  `vals_is_int` / `filt_is_int` select
// int32 instead of float32 inputs.  num_groups must be in [1, 1024]: one
// thread owns each group.  part_sums / part_counts hold num_blocks *
// num_groups entries.
extern "C" int fused_filter_agg_launch(
    int device, const void* keys, const void* vals, int vals_is_int,
    const void* filt, int filt_is_int, long long n, int op, float threshold,
    int num_groups, int num_blocks, long long rows_per_block,
    void* part_sums, void* part_counts, void* sums, void* counts,
    void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaGetLastError();  // clear a stale error from an earlier call
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int threads = (num_groups + 31) / 32 * 32;
  float* ps = static_cast<float*>(part_sums);
  int* pc = static_cast<int*>(part_counts);
  if (vals_is_int && filt_is_int)
    launch_partial<int, int>(keys, vals, filt, n, rows_per_block, op,
                             threshold, num_groups, num_blocks, threads, ps,
                             pc, s);
  else if (vals_is_int)
    launch_partial<int, float>(keys, vals, filt, n, rows_per_block, op,
                               threshold, num_groups, num_blocks, threads, ps,
                               pc, s);
  else if (filt_is_int)
    launch_partial<float, int>(keys, vals, filt, n, rows_per_block, op,
                               threshold, num_groups, num_blocks, threads, ps,
                               pc, s);
  else
    launch_partial<float, float>(keys, vals, filt, n, rows_per_block, op,
                                 threshold, num_groups, num_blocks, threads,
                                 ps, pc, s);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  combine_kernel<<<(num_groups + 255) / 256, 256, 0, s>>>(
      ps, pc, num_blocks, num_groups, static_cast<float*>(sums),
      static_cast<float*>(counts));
  return (int)cudaGetLastError();
}

extern "C" const char* fused_filter_agg_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
