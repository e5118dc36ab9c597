// Flash attention forward for Hopper (sm_90a).
//
// Replaces repro/kernels/flash_attention/kernel.py:flash_attention_kernel,
// the Pallas TPU kernel.  q is (B*H, S, D), k and v are (B*Hkv, S, D), all
// float32 or all bfloat16; q head i reads kv head i / group.  For each
// query row: scores = (q * scale) . k in float32, keys outside the causal
// and window masks set to -1e30, an online softmax with a float32 running
// max, denominator and accumulator, and out = acc / max(l, 1e-30) written
// in q's dtype.  Whole key tiles outside a q tile's [lo, hi) are skipped,
// as the TPU kernel skips chunks (kernel.py:54-62).
//
// What bounds it: operations.  A causal pass does 2 * 2 * S^2/2 * D flops a
// head (q.k and p.v); at B=1, H=32, S=2048, D=128 that is 34.4 GFLOP,
// 0.035 ms at the H100's 989 TFLOP/s bf16 tensor-core rate, against 37.7 MB
// of q, k, v and out (0.011 ms at 3.35 TB/s).  Each k/v tile is read once
// per q tile, so the traffic grows as S^2/64, well inside L2 at these sizes.
//
// Design.  Right and simple first: one block of 256 threads per
// (batch-head, 64-row q tile); key tiles of 32 rows are staged through
// shared memory as float32, and every product is a float32 FMA on the CUDA
// cores, as the TPU kernel multiplies in float32 (kernel.py:49, 66-67).  A
// thread owns a 4-row x 2-column micro-tile of the scores and a 4-row x
// D/16-column micro-tile of the output, so a row's max, sum and rescale
// stay within 16 lanes of one warp (shuffles, no shared-memory reduction).
// Rows of q and k in shared memory are padded to D+1 floats, so the column
// walks of the score loop hit 32 distinct banks.  The float32 FMA path
// runs at about 1/15 of the bf16 tensor-core rate; moving the two products
// to wgmma, with TMA loads of k/v tiles, is the later work that closes it.
//
// Masked keys contribute exactly 0 once a row has seen a valid key (exp of
// -1e30 minus a finite max), and causal and windowed rows always see one,
// so the result does not depend on the tile sizes; keys at or past S (the
// ragged last tile) are -inf and contribute nothing at all.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 64;        // q rows per block
constexpr int kBK = 32;        // key rows per shared-memory tile
constexpr int kThreads = 256;  // 16 x 16: ty owns 4 rows, tx columns
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);  // round to nearest even, as torch's .to()
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

__device__ __forceinline__ float max16(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float sum16(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <int D>
constexpr int smem_floats() {
  return kBQ * (D + 1) + kBK * (D + 1) + kBK * D + kBQ * (kBK + 1);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, T* __restrict__ out, int seq_len,
              int group, int causal, float scale, int window) {
  constexpr int QS = D + 1;   // padded row stride of q and k tiles
  constexpr int PS = kBK + 1; // padded row stride of the p tile
  constexpr int CD = D / 16;  // output columns a thread owns
  extern __shared__ float smem[];
  float* sQ = smem;             // kBQ x QS, q * scale
  float* sK = sQ + kBQ * QS;    // kBK x QS
  float* sV = sK + kBK * QS;    // kBK x D
  float* sP = sV + kBK * D;     // kBQ x PS

  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * kBQ;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const T* qp = q + (size_t)bh * seq_len * D;
  const T* kp = k + (size_t)(bh / group) * seq_len * D;
  const T* vp = v + (size_t)(bh / group) * seq_len * D;

  stage<T, D>(qp + (size_t)q0 * D, kBQ, seq_len - q0, scale, sQ, QS);

  // key tiles this q tile can see (kernel.py:54-62; C division truncates
  // like lax.div, and a negative lo is clamped to 0)
  const int n_tiles = (seq_len + kBK - 1) / kBK;
  const int hi = causal ? min((q0 + kBQ - 1) / kBK + 1, n_tiles) : n_tiles;
  const int lo = window > 0 ? max((q0 - window + 1) / kBK, 0) : 0;

  float m[4], l[4], acc[4][CD];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < CD; ++j) acc[i][j] = 0.0f;
  }

  for (int kt = lo; kt < hi; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // the last tile's sK, sV and sP are no longer read
    stage<T, D>(kp + (size_t)k0 * D, kBK, seq_len - k0, 1.0f, sK, QS);
    stage<T, D>(vp + (size_t)k0 * D, kBK, seq_len - k0, 1.0f, sV, D);
    __syncthreads();

    float s[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i) s[i][0] = s[i][1] = 0.0f;
    const float* qrow = sQ + (ty * 4) * QS;
    const float* krow = sK + tx * QS;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float k_a = krow[d], k_b = krow[16 * QS + d];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float qv = qrow[i * QS + d];
        s[i][0] = fmaf(qv, k_a, s[i][0]);
        s[i][1] = fmaf(qv, k_b, s[i][1]);
      }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int col = k0 + tx + 16 * j;
        bool keep = true;
        if (causal) keep &= col <= row;
        if (window > 0) keep &= col > row - window;
        s[i][j] = col >= seq_len ? -INFINITY : (keep ? s[i][j] : kNegInf);
      }
      const float m_new = fmaxf(m[i], max16(fmaxf(s[i][0], s[i][1])));
      const float p0 = expf(s[i][0] - m_new), p1 = expf(s[i][1] - m_new);
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + sum16(p0 + p1);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < CD; ++j) acc[i][j] *= corr;
      sP[(ty * 4 + i) * PS + tx] = p0;
      sP[(ty * 4 + i) * PS + tx + 16] = p1;
    }
    __syncthreads();

    const float* prow = sP + (ty * 4) * PS;
#pragma unroll 4
    for (int t = 0; t < kBK; ++t) {
      float vv[CD];
#pragma unroll
      for (int j = 0; j < CD; ++j) vv[j] = sV[t * D + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = prow[i * PS + t];
#pragma unroll
        for (int j = 0; j < CD; ++j) acc[i][j] = fmaf(p, vv[j], acc[i][j]);
      }
    }
  }

  T* op = out + (size_t)bh * seq_len * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= seq_len) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < CD; ++j)
      store(op + (size_t)row * D + tx + 16 * j, acc[i][j] / denom);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int bh, int seq_len, int group, int causal, float scale,
                   int window, cudaStream_t stream) {
  constexpr size_t bytes = smem_floats<D>() * sizeof(float);
  static bool configured = false;  // the attribute is per function
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const dim3 grid(bh, (seq_len + kBQ - 1) / kBQ);
  flash_fwd<T, D><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), seq_len, group, causal,
      scale, window);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(int head_dim, const void* q, const void* k,
                     const void* v, void* out, int bh, int seq_len, int group,
                     int causal, float scale, int window,
                     cudaStream_t stream) {
  switch (head_dim) {
    case 32:
      return launch<T, 32>(q, k, v, out, bh, seq_len, group, causal, scale,
                           window, stream);
    case 64:
      return launch<T, 64>(q, k, v, out, bh, seq_len, group, causal, scale,
                           window, stream);
    case 128:
      return launch<T, 128>(q, k, v, out, bh, seq_len, group, causal, scale,
                            window, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// Launches the kernel on `stream` and returns cudaGetLastError() (0 on
// success).  Does not synchronise.  dtype: 0 float32, 1 bfloat16.
// head_dim: 32, 64 or 128.  window <= 0 means no window.  q and out hold
// bh * seq_len * head_dim elements, k and v bh / group times that.
extern "C" int flash_attention_launch(int device, int dtype, int head_dim,
                                      const void* q, const void* k,
                                      const void* v, void* out, int bh,
                                      int seq_len, int group, int causal,
                                      float scale, int window, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaGetLastError();  // clear a stale error from an earlier call
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    err = launch_d<float>(head_dim, q, k, v, out, bh, seq_len, group, causal,
                          scale, window, s);
  else
    err = launch_d<__nv_bfloat16>(head_dim, q, k, v, out, bh, seq_len, group,
                                  causal, scale, window, s);
  return (int)err;
}

extern "C" const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
