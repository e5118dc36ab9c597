// Decode attention for Hopper (sm_90a): one new query token per sequence
// against a KV cache, with GQA and ragged lengths.
//
// Replaces repro/kernels/decode_attention/kernel.py:decode_attention_kernel,
// the Pallas TPU kernel.  q is (B*H, D), the caches are (B*Hkv, S, D), all
// float32 or all bfloat16; lengths is (B*H,) int32, one per q head as the
// Pallas wrapper broadcasts it from one per sequence.  For q head i:
// scores = (q * scale) . k_t in float32 for every cache row t, rows at or
// past lengths[i] set to -1e30, a float32 online softmax, and out =
// acc / max(l, 1e-30) written as float32 (the wrapper casts to q's dtype).
//
// What bounds it: memory.  Every valid cache row is read once, D elements
// of k and D of v: at B=4, Hkv=4, S=4096, D=128 in bf16 that is 16.8 MB a
// cache, 33.6 MB in all, 0.0100 ms at the H100 SXM's 3.35 TB/s.  The
// arithmetic is 4 flops per cache element a q head, 0.27 GFLOP there, far
// below the card's rate.
//
// Design.  The TPU kernel carries (m, l, acc) across a sequential grid axis
// over S in revisited output blocks (kernel.py:44-82).  CUDA blocks run in
// no order, so the carry becomes a loop over S inside one block: one block
// of 256 threads per (sequence, kv head) serves the `group` q heads that
// share that kv head, so each k/v row is read from device memory once per
// group and not once per q head (the GQA point of kernel.py:109-110).  Each
// 64-row tile of k and v is staged in shared memory as float32 with 16-byte
// loads; then a thread per (q head, row) takes the score, a warp per q head
// does the softmax update, and a thread per (q head, column) updates the
// accumulator, in float32.  The group's q heads belong to one sequence, so
// they share its length, read from the group's first head.  The loop stops
// at that length: a masked row adds exp(-1e30 - m) = 0 once a valid row has
// set m, and row 0 is valid.  Length 0 is the exception the port keeps:
// every score is then -1e30, every p is 1, and the TPU kernel returns the
// mean of all S cache rows, so the loop runs over all S.  With B * Hkv blocks (16 at B=4, Hkv=4) most of
// the card's 132 SMs sit idle; splitting S across blocks with a second
// combine pass is the later work that closes the gap to the bound.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kTS = 64;        // cache rows per shared-memory tile
constexpr int kThreads = 256;  // 8 warps
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
struct Vec16 {  // elements of T in one 16-byte load
  static constexpr int N = 16 / sizeof(T);
};

// Copy `rows` x D elements of a row-major (., D) array into shared memory
// as float32 times `mul`, with a row stride of `stride` floats; rows at or
// past `avail` are zero.  16-byte loads, neighbouring threads on
// neighbouring addresses.
template <typename T, int D>
__device__ __forceinline__ void stage(const T* __restrict__ src, int rows,
                                      int avail, float mul, float* dst,
                                      int stride) {
  constexpr int N = Vec16<T>::N;
  constexpr int kPerRow = D / N;
  for (int i = threadIdx.x; i < rows * kPerRow; i += blockDim.x) {
    const int r = i / kPerRow;
    const int c = (i % kPerRow) * N;
    float* out = dst + r * stride + c;
    if (r < avail) {
      const uint4 raw = *reinterpret_cast<const uint4*>(src + (size_t)r * D + c);
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int u = 0; u < N; ++u) out[u] = to_f32(e[u]) * mul;
    } else {
#pragma unroll
      for (int u = 0; u < N; ++u) out[u] = 0.0f;
    }
  }
}

template <int D>
size_t smem_bytes(int group) {
  return sizeof(float) *
         ((size_t)kTS * (D + 1) + (size_t)kTS * D + (size_t)group * D * 2 +
          (size_t)group * kTS + 3 * (size_t)group);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    decode_fwd(const T* __restrict__ q, const T* __restrict__ k_cache,
               const T* __restrict__ v_cache, const int* __restrict__ lengths,
               float* __restrict__ out, int n_kv_heads, int group,
               int seq_len, float scale) {
  constexpr int KS = D + 1;  // padded row stride of the k tile
  extern __shared__ float smem[];
  float* sK = smem;                // kTS x KS
  float* sV = sK + kTS * KS;       // kTS x D
  float* sQ = sV + kTS * D;        // group x D, q * scale
  float* sAcc = sQ + group * D;    // group x D
  float* sP = sAcc + group * D;    // group x kTS: scores, then p
  float* sM = sP + group * kTS;    // group: running max
  float* sL = sM + group;          // group: running denominator
  float* sC = sL + group;          // group: this tile's correction

  const int bk = blockIdx.x;  // b * n_kv_heads + kv head
  const int len = lengths[bk * group];  // the sequence's, for every q head
  const int n = len > 0 ? min(len, seq_len) : seq_len;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const T* kp = k_cache + (size_t)bk * seq_len * D;
  const T* vp = v_cache + (size_t)bk * seq_len * D;

  // the group's q heads are rows bk*group .. bk*group + group-1 of q
  stage<T, D>(q + (size_t)bk * group * D, group, group, scale, sQ, D);
  for (int i = threadIdx.x; i < group * D; i += blockDim.x) sAcc[i] = 0.0f;
  for (int h = threadIdx.x; h < group; h += blockDim.x) {
    sM[h] = kNegInf;
    sL[h] = 0.0f;
  }

  for (int t0 = 0; t0 < n; t0 += kTS) {
    const int rows = min(kTS, n - t0);
    __syncthreads();  // the last tile's sK, sV and sP are no longer read
    stage<T, D>(kp + (size_t)t0 * D, kTS, rows, 1.0f, sK, KS);
    stage<T, D>(vp + (size_t)t0 * D, kTS, rows, 1.0f, sV, D);
    __syncthreads();

    // scores: rows past the loop bound are -inf and add nothing; rows past
    // the length (only when it is 0) are -1e30, as the TPU kernel masks
    for (int i = threadIdx.x; i < group * kTS; i += blockDim.x) {
      const int h = i / kTS, t = i % kTS;
      float s = -INFINITY;
      if (t < rows) {
        const float* qr = sQ + h * D;
        const float* kr = sK + t * KS;
        s = 0.0f;
#pragma unroll 8
        for (int d = 0; d < D; ++d) s = fmaf(qr[d], kr[d], s);
        if (t0 + t >= len) s = kNegInf;
      }
      sP[i] = s;
    }
    __syncthreads();

    // softmax update, a warp per q head (kTS = 64: two scores a lane)
    for (int h = warp; h < group; h += kThreads / 32) {
      float* ph = sP + h * kTS;
      const float a = ph[lane], b = ph[lane + 32];
      float mt = fmaxf(a, b);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, o));
      const float m_old = sM[h];
      const float m_new = fmaxf(m_old, mt);
      const float pa = expf(a - m_new), pb = expf(b - m_new);
      float sum = pa + pb;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      ph[lane] = pa;
      ph[lane + 32] = pb;
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        sL[h] = sL[h] * corr + sum;
        sM[h] = m_new;
        sC[h] = corr;
      }
    }
    __syncthreads();

    // acc = acc * corr + p . v, a thread per (q head, column)
    for (int i = threadIdx.x; i < group * D; i += blockDim.x) {
      const int h = i / D, d = i % D;
      const float* ph = sP + h * kTS;
      float a = sAcc[i] * sC[h];
      for (int t = 0; t < rows; ++t) a = fmaf(ph[t], sV[t * D + d], a);
      sAcc[i] = a;
    }
  }
  __syncthreads();
  float* op = out + (size_t)bk * group * D;
  for (int i = threadIdx.x; i < group * D; i += blockDim.x)
    op[i] = sAcc[i] / fmaxf(sL[i / D], 1e-30f);
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* lengths, float* out, int n_seqs,
                   int n_kv_heads, int group, int seq_len, float scale,
                   cudaStream_t stream) {
  const size_t bytes = smem_bytes<D>(group);
  static size_t allowed = 48 * 1024;  // the attribute is per function
  if (bytes > allowed) {
    cudaError_t err = cudaFuncSetAttribute(
        decode_fwd<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (err != cudaSuccess) return err;
    allowed = bytes;
  }
  decode_fwd<T, D><<<n_seqs * n_kv_heads, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), lengths, out, n_kv_heads, group, seq_len,
      scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(int head_dim, const void* q, const void* k,
                     const void* v, const int* lengths, float* out,
                     int n_seqs, int n_kv_heads, int group, int seq_len,
                     float scale, cudaStream_t stream) {
  switch (head_dim) {
    case 32:
      return launch<T, 32>(q, k, v, lengths, out, n_seqs, n_kv_heads, group,
                           seq_len, scale, stream);
    case 64:
      return launch<T, 64>(q, k, v, lengths, out, n_seqs, n_kv_heads, group,
                           seq_len, scale, stream);
    case 128:
      return launch<T, 128>(q, k, v, lengths, out, n_seqs, n_kv_heads, group,
                            seq_len, scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// Largest `group` (q heads per kv head) the kernel's shared memory takes at
// head_dim, or 0 for a head_dim it is not built for.
extern "C" int decode_attention_max_group(int head_dim) {
  constexpr size_t kLimit = 227 * 1024;
  int g = 0;
  while (g < 1024) {
    size_t bytes = head_dim == 32    ? smem_bytes<32>(g + 1)
                   : head_dim == 64  ? smem_bytes<64>(g + 1)
                   : head_dim == 128 ? smem_bytes<128>(g + 1)
                                     : kLimit + 1;
    if (bytes > kLimit) break;
    ++g;
  }
  return g;
}

// Launches the kernel on `stream` and returns cudaGetLastError() (0 on
// success).  Does not synchronise.  dtype: 0 float32, 1 bfloat16.
// head_dim: 32, 64 or 128.  q holds n_seqs * n_kv_heads * group rows of
// head_dim and lengths one int32 per q row, the caches n_seqs * n_kv_heads
// * seq_len rows; out is float32 shaped like q.
extern "C" int decode_attention_launch(int device, int dtype, int head_dim,
                                       const void* q, const void* k_cache,
                                       const void* v_cache,
                                       const void* lengths, void* out,
                                       int n_seqs, int n_kv_heads, int group,
                                       int seq_len, float scale,
                                       void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaGetLastError();  // clear a stale error from an earlier call
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* len = static_cast<const int*>(lengths);
  float* o = static_cast<float*>(out);
  if (dtype == 0)
    err = launch_d<float>(head_dim, q, k_cache, v_cache, len, o, n_seqs,
                          n_kv_heads, group, seq_len, scale, s);
  else
    err = launch_d<__nv_bfloat16>(head_dim, q, k_cache, v_cache, len, o,
                                  n_seqs, n_kv_heads, group, seq_len, scale,
                                  s);
  return (int)err;
}

extern "C" const char* decode_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
