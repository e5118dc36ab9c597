// Decode attention for Hopper (sm_90a): one new query token per sequence
// against a KV cache, with GQA and ragged lengths.
//
// Replaces repro/kernels/decode_attention/kernel.py:decode_attention_kernel,
// the Pallas TPU kernel.  q is (B*H, D), the caches are (B*Hkv, S, D), all
// float32 or all bfloat16; lengths is (B,) int32, one per sequence (the
// Pallas wrapper broadcasts it to one per q head, all equal).  For q head
// i: scores = q . k_t * scale in float32 for every cache row t, rows at or
// past the length set to -1e30, a float32 softmax, and out = acc /
// max(l, 1e-30) written in q's dtype.
//
// What bounds it: memory.  Every valid cache row is read once, D elements
// of k and D of v: at B=4, Hkv=4, S=4096, D=128 in bf16 that is 16.8 MB a
// cache, 33.6 MB in all, 0.0100 ms at the H100 SXM's 3.35 TB/s.  The
// arithmetic is 4 flops per cache element a q head, 0.27 GFLOP there, far
// below the card's rate.  At recurrentgemma-9b's B=1, Hkv=1, S=4096, D=256
// the caches are 4.19 MB, 0.00125 ms: there a launch's fixed cost is most
// of the time.
//
// Design: split-S.  The TPU kernel carries (m, l, acc) across a sequential
// grid axis over S (kernel.py:44-82).  Here the cache axis is cut into
// `n_splits` chunks of `chunk` rows, chosen on the host from S, B and Hkv
// only (reading the lengths would synchronise), so that about two blocks
// per SM stream the cache.  decode_split: one block of 256 threads per
// (sequence, kv head, chunk) serves the `group` q heads of its kv head, so
// each cache row is read from device memory once per group.  Its 8 warps
// take steps of 8 cache rows in turn, each warp on its own with its own
// online-softmax state (no block barrier inside the walk): a warp streams
// its steps' k and v rows as they are stored (bf16, no float32 staging)
// through its own two-stage cp.async buffer in shared memory.  Scores: 4
// lanes a row, each holding a quarter of the row's k in registers and
// multiplying it with the float32 q of up to 8 heads; the 4 sums meet by
// shuffles and the scale is applied to the float32 score.  p.v: a lane
// owns DP/32 columns of every head and does float32 FMAs, so the output
// keeps float32 accuracy.  At the chunk's end the warps' (m, l, acc) merge
// in shared memory.  Groups above 8 heads walk the chunk again for each 8
// (from L2).  A chunk that starts at or past the sequence's length writes
// an empty partial (m = -inf, l = 0) and exits.  Length 0 keeps the
// Pallas result, the mean of all S rows: every chunk then runs over its
// rows with scores -1e30.
//
// decode_combine merges the chunks' float32 (m, l, acc) and writes q's
// dtype; with a single chunk, decode_split writes the output itself and
// there is no second launch.
//
// Head dims that are not a multiple of 32 (80 for qwen3-32b, 120 for
// h2o-danube-3-4b) run on a padded width DP, D rounded up to 32 (96 and
// 128): a lane's p.v columns, the mma k-steps and the four lanes of a row
// all divide DP.  The chunks of a row past D are loaded by cp.async with
// src-size 0, so they land as zeros; q's columns past D are zero too, so
// q.k gains exactly 0 from them, and acc's columns past D are never
// written out.  A cache row in global memory stays D elements.  In shared
// memory a row takes SC chunks, DP's chunks rounded up to a multiple of 8
// (bf16 at D = 80: 12 -> 16, 256 B): the k swizzle XORs a chunk index
// inside its aligned group of 8, so it stays inside the row for any chunk
// count, and rows a multiple of 128 B apart keep the mma loads free of
// bank conflicts.
//
// Head dim 256 (recurrentgemma-9b, MQA group 16): a bf16 row is 512 B, so a
// warp's two stages take 16 KB and the block 200,960 B at kMaxGroup (one
// block an SM; the register limit is then that of one block, so the 64
// float32 accumulators and 16 q fragments a lane stay in registers).
// float32 rows are 1 KB, and two stages would be 262,144 B alone: float32
// at 256 streams through a single stage a warp (Geo::kStages = 1; each step
// waits for its own rows, loaded after the step before was read), 131,072
// B of stages, the same as bf16.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxGroup = 64;  // q heads per kv head (ops.py MAX_GROUP)
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);  // round to nearest even, as torch's .to()
}

template <typename T, int D>
struct Geo {
  static constexpr int kRows = 8;                  // cache rows a warp step
  static constexpr int DP = (D + 31) / 32 * 32;    // padded width
  static constexpr int CPR = DP * sizeof(T) / 16;  // 16-byte chunks a padded row
  static constexpr int CD = D * sizeof(T) / 16;    // of them, chunks with data
  static constexpr int SC = CPR < 8 ? CPR : (CPR + 7) / 8 * 8;  // in shared memory
  static constexpr int E = 16 / sizeof(T);         // elements a chunk
  static constexpr int NC = CPR / 4;               // k chunks a lane (FMA path)
  static constexpr int CW = DP / 32;               // p.v columns a lane
  static constexpr int KK = DP / 16;               // mma k-steps over DP
  static constexpr int kColBytes = CW * sizeof(T);  // a lane's p.v columns
  static constexpr int kColAlign = kColBytes & -kColBytes;
  static constexpr int kRowBytes = SC * 16;        // a row in shared memory
  static constexpr int kStepBytes = 2 * kRows * kRowBytes;  // k, then v
  // stages a warp: two, but one for float32 at D = 256 (see above)
  static constexpr int kStages = sizeof(T) == 4 && D > 128 ? 1 : 2;
  static constexpr int kWarpBytes = kStages * kStepBytes;
  // blocks an SM the registers are budgeted for: one at D = 256, where the
  // shared memory allows no second
  static constexpr int kMinBlocks = D > 128 ? 1 : 2;
  static constexpr bool kMma = sizeof(T) == 2;  // bf16: q.k on the tensor cores
  static_assert(D * sizeof(T) % 16 == 0, "a cache row is whole 16-byte chunks");
  static_assert(CPR % 4 == 0, "four lanes share a row");
};

// Byte offset of 16-byte chunk c of k row r (0..7) in a step.  bf16: chunks
// XOR the row, so the eight rows an mma fragment load touches sit in
// different banks; float32: odd rows swap the 64-byte halves of each 128
// bytes, for the FMA path's four lanes a row.  Either XOR stays inside the
// chunk's aligned group of 8 (of 4 at CPR = 4), and a row holds SC chunks,
// a multiple of that group, so the offset never leaves the row.
template <typename T, int CPR>
__device__ __forceinline__ int k_offset(int r, int c) {
  if (sizeof(T) == 2) return (c ^ (r & (CPR >= 8 ? 7 : CPR - 1))) * 16;
  return CPR >= 8 ? (c ^ ((r & 1) << 2)) * 16 : c * 16;
}

template <typename T, int D>
size_t smem_bytes(int group) {
  using G = Geo<T, D>;
  const size_t stage = (size_t)kWarps * G::kWarpBytes;      // k/v stages
  const size_t merge = (size_t)kWarps * 8 * (G::DP + 2) * 4;  // warps' states
  return (size_t)group * G::DP * 4                           // q, float32
         + (size_t)kWarps * (2 * G::kRows * 8 + 8) * 4    // s, p, corr
         + (stage > merge ? stage : merge);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);  // .x = lo: low half
  return *reinterpret_cast<uint32_t*>(&h);
}

// d = a . b + d, m16n8k16, bf16 operands, float32 accumulators.
__device__ __forceinline__ void mma_16816(float (&d)[4], uint32_t a0,
                                          uint32_t a2, uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(0u), "r"(a2), "r"(0u), "r"(b0), "r"(b1));
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, (Geo<T, D>::kMinBlocks))
    decode_split(const T* __restrict__ q, const T* __restrict__ k_cache,
                 const T* __restrict__ v_cache, const int* __restrict__ lengths,
                 T* __restrict__ out, float* __restrict__ part_acc,
                 float* __restrict__ part_ml, int n_kv_heads, int group,
                 int seq_len, int chunk, float scale) {
  using G = Geo<T, D>;
  constexpr int R = G::kRows;
  extern __shared__ __align__(16) uint8_t smem[];
  float* sQ = reinterpret_cast<float*>(smem);  // group x DP, zero past D
  float* sW = sQ + group * G::DP;  // per warp: s [R][8], p [R][8], corr [8]
  uint8_t* sBuf = reinterpret_cast<uint8_t*>(sW + kWarps * (2 * R * 8 + 8));
  float* sMerge = reinterpret_cast<float*>(sBuf);  // reuses the stages

  const int bk = blockIdx.x;  // b * n_kv_heads + kv head
  const int split = blockIdx.y, n_splits = gridDim.y;
  const int len = lengths[bk / n_kv_heads];
  const int n = len > 0 ? min(len, seq_len) : seq_len;  // rows to walk
  const int c0 = split * chunk;
  const int c1 = min(c0 + chunk, n);
  const int head0 = bk * group;  // first q head (row of q) of this block

  if (c0 >= n) {  // nothing of this sequence here: an empty partial
    for (int h = threadIdx.x; h < group; h += kThreads) {
      part_ml[((size_t)(head0 + h) * n_splits + split) * 2] = -INFINITY;
      part_ml[((size_t)(head0 + h) * n_splits + split) * 2 + 1] = 0.0f;
    }
    return;
  }

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  // after the scores a lane holds head g's scores of step rows 2t, 2t + 1
  const int g = lane / 4, t = lane % 4;
  const T* kp = k_cache + (size_t)bk * seq_len * D;
  const T* vp = v_cache + (size_t)bk * seq_len * D;
  uint8_t* wbuf = sBuf + warp * G::kWarpBytes;
  const uint32_t wbuf_s = static_cast<uint32_t>(__cvta_generic_to_shared(wbuf));
  float* wS = sW + warp * (2 * R * 8 + 8);  // [R rows][8 heads]
  float* wP = wS + R * 8;                   // [R rows][8 heads]
  float* wC = wP + R * 8;                   // [8 heads]
  const int n_steps = (c1 - c0 + R - 1) / R;

  // k and v rows of step `s` into stage `st`; rows at or past c1, and the
  // chunks of a row past D, are zero
  auto load_step = [&](int s, int st) {
    const uint32_t dk = wbuf_s + st * G::kStepBytes;
    const uint32_t dv = dk + R * G::kRowBytes;
    const int t0 = c0 + s * R;
#pragma unroll
    for (int i = lane; i < R * G::CPR; i += 32) {
      const int rr = i / G::CPR, c = i % G::CPR;
      const bool valid = t0 + rr < c1 && c < G::CD;
      const size_t src = valid ? (size_t)(t0 + rr) * D + c * G::E : (size_t)c0 * D;
      cp_async16(dk + rr * G::kRowBytes + k_offset<T, G::CPR>(rr, c), kp + src, valid);
      cp_async16(dv + rr * G::kRowBytes + c * 16, vp + src, valid);
    }
  };

  // heads in batches of 8; each batch walks the chunk once (from L2 after
  // the first)
  for (int hb = 0; hb < group; hb += 8) {
    const int hn = min(8, group - hb);
    if (hb > 0) __syncthreads();  // the merge area (over the stages) is free
    if (warp < n_steps) load_step(warp, 0);
    asm volatile("cp.async.commit_group;" ::: "memory");
    if (hb == 0)
      for (int i = threadIdx.x; i < group * G::DP; i += kThreads) {
        const int h = i / G::DP, d = i % G::DP;
        sQ[i] = d < D ? to_f32(q[(size_t)(head0 + h) * D + d]) : 0.0f;
      }
    __syncthreads();  // q is in

    // bf16: this batch's q as mma A fragments (rows = heads; 8..15 zero)
    uint32_t qa[G::kMma ? G::KK : 1][2];
    if (G::kMma) {
      const float* qg = sQ + (hb + g) * G::DP;
#pragma unroll
      for (int kk = 0; kk < (G::kMma ? G::KK : 1); ++kk) {
        const int d = 16 * kk + 2 * t;
        qa[kk][0] = g < hn ? pack_bf16(qg[d], qg[d + 1]) : 0u;
        qa[kk][1] = g < hn ? pack_bf16(qg[d + 8], qg[d + 9]) : 0u;
      }
    }

    float m = -INFINITY, l = 0.0f;  // head g's, over this warp's rows
    float acc[8][G::CW];            // heads x this lane's columns
#pragma unroll
    for (int h = 0; h < 8; ++h)
#pragma unroll
      for (int j = 0; j < G::CW; ++j) acc[h][j] = 0.0f;

    for (int s = warp, it = 0; s < n_steps; s += kWarps, ++it) {
      const int st = G::kStages == 2 ? it & 1 : 0;
      if (G::kStages == 2) {  // the next step's rows load while this one runs
        if (s + kWarps < n_steps) load_step(s + kWarps, st ^ 1);
        asm volatile("cp.async.commit_group;" ::: "memory");
        asm volatile("cp.async.wait_group 1;" ::: "memory");
      } else {
        asm volatile("cp.async.wait_group 0;" ::: "memory");
      }
      __syncwarp();
      const uint8_t* tK = wbuf + st * G::kStepBytes;
      const uint8_t* tV = tK + R * G::kRowBytes;

      // raw scores of head g at step rows 2t, 2t + 1
      float s2[2];
      if (G::kMma) {
        float d[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        const uint8_t* krow = tK + g * G::kRowBytes + 4 * t;  // row g of the step
#pragma unroll
        for (int kk = 0; kk < (G::kMma ? G::KK : 1); ++kk) {
          const uint32_t b0 = *reinterpret_cast<const uint32_t*>(
              krow + k_offset<T, G::CPR>(g, 2 * kk));
          const uint32_t b1 = *reinterpret_cast<const uint32_t*>(
              krow + k_offset<T, G::CPR>(g, 2 * kk + 1));
          mma_16816(d, qa[kk][0], qa[kk][1], b0, b1);
        }
        s2[0] = d[0];
        s2[1] = d[1];
      } else {
        // float32: 4 lanes a row (r, part), each a quarter of k times q
        const int r = lane / 4, part = lane % 4;
        float kf[G::NC * G::E];
#pragma unroll
        for (int u = 0; u < G::NC; ++u) {
          const uint4 raw = *reinterpret_cast<const uint4*>(
              tK + r * G::kRowBytes + k_offset<T, G::CPR>(r, 4 * u + part));
          const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
          for (int x = 0; x < G::E; ++x) kf[u * G::E + x] = to_f32(e[x]);
        }
#pragma unroll
        for (int h = 0; h < 8; ++h) {
          float dot = 0.0f;
          if (h < hn) {
            const float* qh = sQ + (hb + h) * G::DP;
#pragma unroll
            for (int u = 0; u < G::NC; ++u)
#pragma unroll
              for (int x = 0; x < G::E; ++x)
                dot = fmaf(qh[(4 * u + part) * G::E + x], kf[u * G::E + x], dot);
          }
          dot += __shfl_xor_sync(0xffffffffu, dot, 1);
          dot += __shfl_xor_sync(0xffffffffu, dot, 2);
          if (part == 0) wS[r * 8 + h] = dot;
        }
        __syncwarp();
        s2[0] = wS[(2 * t) * 8 + g];
        s2[1] = wS[(2 * t + 1) * 8 + g];
      }

      // online softmax of head g over the step's 8 rows (4 lanes a head)
      const int row = c0 + s * R + 2 * t;
      float mt = -INFINITY;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        s2[e] = row + e >= c1 ? -INFINITY
                : row + e >= len ? kNegInf  // only at length 0
                                 : s2[e] * scale;
        mt = fmaxf(mt, s2[e]);
      }
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
      float corr = 1.0f, p0 = 0.0f, p1 = 0.0f;
      if (g < hn) {  // the batch's last heads may be padding
        const float m_new = fmaxf(m, mt);
        corr = expf(m - m_new);
        p0 = expf(s2[0] - m_new);
        p1 = expf(s2[1] - m_new);
        m = m_new;
        l = l * corr + p0 + p1;  // this lane's share; summed at the end
      }
      wP[(2 * t) * 8 + g] = p0;
      wP[(2 * t + 1) * 8 + g] = p1;
      if (t == 0) wC[g] = corr;
      __syncwarp();

      // acc = acc * corr + p . v in float32: this lane's CW columns
      {
        const float4 ca = *reinterpret_cast<const float4*>(wC);
        const float4 cb = *reinterpret_cast<const float4*>(wC + 4);
        const float cr[8] = {ca.x, ca.y, ca.z, ca.w, cb.x, cb.y, cb.z, cb.w};
#pragma unroll
        for (int h = 0; h < 8; ++h)
#pragma unroll
          for (int j = 0; j < G::CW; ++j) acc[h][j] *= cr[h];
      }
      struct alignas(G::kColAlign) Cols { T v[G::CW]; };
#pragma unroll
      for (int rr = 0; rr < R; ++rr) {
        const Cols cv = *reinterpret_cast<const Cols*>(
            tV + rr * G::kRowBytes + lane * G::kColBytes);
        const float4 pa = *reinterpret_cast<const float4*>(wP + rr * 8);
        const float4 pb = *reinterpret_cast<const float4*>(wP + rr * 8 + 4);
        const float pr[8] = {pa.x, pa.y, pa.z, pa.w, pb.x, pb.y, pb.z, pb.w};
#pragma unroll
        for (int j = 0; j < G::CW; ++j) {
          const float vj = to_f32(cv.v[j]);
#pragma unroll
          for (int h = 0; h < 8; ++h) acc[h][j] = fmaf(pr[h], vj, acc[h][j]);
        }
      }
      __syncwarp();  // the stage, wS, wP and wC are free for the next step
      if (G::kStages == 1 && s + kWarps < n_steps) {
        load_step(s + kWarps, 0);
        asm volatile("cp.async.commit_group;" ::: "memory");
      }
    }
    asm volatile("cp.async.wait_group 0;" ::: "memory");
    __syncthreads();  // every warp is done with the stages

    // merge the warps' (m, l, acc): [warp][head] of (m, l) then acc
    float* mMl = sMerge;                    // kWarps x 8 x 2
    float* mAcc = sMerge + kWarps * 8 * 2;  // kWarps x 8 x DP
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    if (t == 0) {
      mMl[(warp * 8 + g) * 2] = m;
      mMl[(warp * 8 + g) * 2 + 1] = l;
    }
#pragma unroll
    for (int h = 0; h < 8; ++h)
#pragma unroll
      for (int j = 0; j < G::CW; ++j)
        mAcc[(warp * 8 + h) * G::DP + lane * G::CW + j] = acc[h][j];
    __syncthreads();
    for (int i = threadIdx.x; i < hn * D; i += kThreads) {
      const int h = i / D, d = i % D;
      float mx = -INFINITY;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, mMl[(w * 8 + h) * 2]);
      float num = 0.0f, den = 0.0f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const float mw = mMl[(w * 8 + h) * 2];
        if (mw == -INFINITY) continue;  // a warp with no rows
        const float wgt = expf(mw - mx);
        den = fmaf(wgt, mMl[(w * 8 + h) * 2 + 1], den);
        num = fmaf(wgt, mAcc[(w * 8 + h) * G::DP + d], num);
      }
      const size_t qh = (size_t)(head0 + hb + h);
      if (n_splits == 1) {
        store(out + qh * D + d, num / fmaxf(den, 1e-30f));
      } else {
        part_acc[(qh * n_splits + split) * D + d] = num;
        if (d == 0) {
          part_ml[(qh * n_splits + split) * 2] = mx;
          part_ml[(qh * n_splits + split) * 2 + 1] = den;
        }
      }
    }
  }
}

// Merge the chunks' (m, l, acc) of each q head: one block per q head, a
// thread per column.  Empty partials (m = -inf) are skipped.
template <typename T, int D>
__global__ void __launch_bounds__(D)
    decode_combine(const float* __restrict__ part_acc,
                   const float* __restrict__ part_ml, T* __restrict__ out,
                   int n_splits) {
  const size_t qh = blockIdx.x;
  const float* ml = part_ml + qh * n_splits * 2;
  float m = -INFINITY;
  for (int s = 0; s < n_splits; ++s) m = fmaxf(m, ml[2 * s]);
  float num = 0.0f, den = 0.0f;
  for (int s = 0; s < n_splits; ++s) {
    const float ms = ml[2 * s];
    if (ms == -INFINITY) continue;
    const float w = expf(ms - m);
    den = fmaf(w, ml[2 * s + 1], den);
    num = fmaf(w, part_acc[(qh * n_splits + s) * D + threadIdx.x], num);
  }
  store(out + qh * D + threadIdx.x, num / fmaxf(den, 1e-30f));
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* lengths, void* out, float* part_acc,
                   float* part_ml, int n_seqs, int n_kv_heads, int group,
                   int seq_len, int n_splits, int chunk, float scale,
                   cudaStream_t stream) {
  static bool configured = false;  // the attribute is per function
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        decode_split<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem_bytes<T, D>(kMaxGroup));
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const dim3 grid(n_seqs * n_kv_heads, n_splits);
  decode_split<T, D><<<grid, kThreads, smem_bytes<T, D>(group), stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), lengths, static_cast<T*>(out), part_acc,
      part_ml, n_kv_heads, group, seq_len, chunk, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_splits == 1) return err;
  decode_combine<T, D><<<n_seqs * n_kv_heads * group, D, 0, stream>>>(
      part_acc, part_ml, static_cast<T*>(out), n_splits);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(int head_dim, const void* q, const void* k,
                     const void* v, const int* lengths, void* out,
                     float* part_acc, float* part_ml, int n_seqs,
                     int n_kv_heads, int group, int seq_len, int n_splits,
                     int chunk, float scale, cudaStream_t stream) {
  switch (head_dim) {
    case 32:
      return launch<T, 32>(q, k, v, lengths, out, part_acc, part_ml, n_seqs,
                           n_kv_heads, group, seq_len, n_splits, chunk, scale,
                           stream);
    case 64:
      return launch<T, 64>(q, k, v, lengths, out, part_acc, part_ml, n_seqs,
                           n_kv_heads, group, seq_len, n_splits, chunk, scale,
                           stream);
    case 80:
      return launch<T, 80>(q, k, v, lengths, out, part_acc, part_ml, n_seqs,
                           n_kv_heads, group, seq_len, n_splits, chunk, scale,
                           stream);
    case 120:
      return launch<T, 120>(q, k, v, lengths, out, part_acc, part_ml, n_seqs,
                            n_kv_heads, group, seq_len, n_splits, chunk,
                            scale, stream);
    case 128:
      return launch<T, 128>(q, k, v, lengths, out, part_acc, part_ml, n_seqs,
                            n_kv_heads, group, seq_len, n_splits, chunk,
                            scale, stream);
    case 256:
      return launch<T, 256>(q, k, v, lengths, out, part_acc, part_ml, n_seqs,
                            n_kv_heads, group, seq_len, n_splits, chunk,
                            scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// Launches the kernels on `stream` (decode_split, then decode_combine when
// n_splits > 1) and returns cudaGetLastError() (0 on success).  Does not
// synchronise.  dtype: 0 float32, 1 bfloat16.  head_dim: 32, 64, 80, 120,
// 128 or 256.  q and out hold n_seqs * n_kv_heads * group rows of
// head_dim, lengths one int32 per sequence, the caches n_seqs * n_kv_heads
// * seq_len rows.
// part_acc holds q's rows * n_splits * head_dim floats and part_ml q's rows
// * n_splits * 2; chunk is a multiple of 64 with n_splits * chunk >= seq_len.
extern "C" int decode_attention_launch(int device, int dtype, int head_dim,
                                       const void* q, const void* k_cache,
                                       const void* v_cache,
                                       const void* lengths, void* out,
                                       void* part_acc, void* part_ml,
                                       int n_seqs, int n_kv_heads, int group,
                                       int seq_len, int n_splits, int chunk,
                                       float scale, void* stream) {
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaGetLastError();  // clear a stale error from an earlier call
  if (group < 1 || group > kMaxGroup || chunk % 64 != 0 ||
      (long long)n_splits * chunk < seq_len)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* len = static_cast<const int*>(lengths);
  float* pa = static_cast<float*>(part_acc);
  float* pm = static_cast<float*>(part_ml);
  if (dtype == 0)
    err = launch_d<float>(head_dim, q, k_cache, v_cache, len, out, pa, pm,
                          n_seqs, n_kv_heads, group, seq_len, n_splits, chunk,
                          scale, s);
  else
    err = launch_d<__nv_bfloat16>(head_dim, q, k_cache, v_cache, len, out, pa,
                                  pm, n_seqs, n_kv_heads, group, seq_len,
                                  n_splits, chunk, scale, s);
  return (int)err;
}

extern "C" const char* decode_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
