// Decode attention for Hopper (sm_90a): one new query token per sequence
// against a KV cache, with GQA and ragged lengths.
//
// Replaces repro/kernels/decode_attention/kernel.py:decode_attention_kernel,
// the Pallas TPU kernel.  q is (B*H, D), the caches are (B*Hkv, S, D), all
// float32, all bfloat16 or all float16, at any head dim D from 1 up
// (decode_wide above 256) and any group H / Hkv; lengths is (B,) int32,
// one per sequence (the Pallas wrapper broadcasts it to one per q head,
// all equal).  For q head
// i: scores = q . k_t * scale in float32 for every cache row t, rows at or
// past the length set to -1e30, a float32 softmax, and out = acc /
// max(l, 1e-30) written in q's dtype.
//
// What bounds it: memory.  Every valid cache row is read once, D elements
// of k and D of v: at B=4, Hkv=4, S=4096, D=128 in bf16 that is 16.8 MB a
// cache, 33.6 MB in all, 0.0100 ms at the H100 SXM's 3.35 TB/s.  The
// arithmetic is 4 flops per cache element a q head, 0.27 GFLOP there, far
// below the card's rate.  At granite-34b's B=4, MQA 48/1, D=128 the caches
// are 8.39 MB (0.0025 ms) and at recurrentgemma-9b's B=1, 16/1, D=256 4.19
// MB (0.00125 ms): there a launch's fixed cost, the partials and the
// merge are most of the time.
//
// Design: split-S.  The TPU kernel carries (m, l, acc) across a sequential
// grid axis over S (kernel.py:44-82).  Here the cache axis is cut into
// `n_splits` chunks of `chunk` rows, chosen on the host from shapes only
// (ops.split_plan; reading the lengths would synchronise); every chunk
// writes a float32 partial (m, l, acc) for each of its q heads and
// decode_combine merges them.  Three kernels walk a chunk:
//
// * decode_split, for float32 and for groups of at most 8 q heads a kv
//   head in bf16 or float16 (the plan: about two blocks an SM).  One block of 256 threads per
//   (sequence, kv head, chunk) serves the group, so each cache row is read
//   from device memory once per group.  Its 8 warps take steps of 8 cache
//   rows in turn, each warp on its own with its own online-softmax state
//   (no block barrier inside the walk): a warp streams its steps' k and v
//   rows as they are stored (bf16, no float32 staging) through its own
//   two-stage cp.async buffer in shared memory.  Scores: bf16 and float16
//   on the tensor cores (mma.m16n8k16 in the operands' own type, the heads
//   in rows 0-7 of A; every product is exact in float32), float32 on 4
//   lanes a row, each holding a quarter of the row's k in registers and
//   multiplying it with the float32 q of up to 8 heads; the scale is
//   applied to the float32 score.  p.v: a lane owns DP/32 columns of every
//   head and does float32 FMAs, so the output keeps float32 accuracy.  At
//   the chunk's end the warps' (m, l, acc) merge in shared memory.
//
// * decode_group, for bf16 and float16 groups above 8 (granite-34b's 48,
//   recurrentgemma-9b's 16; the plan: one block an SM at most, the float32 partials,
//   written and read, within the cache's bytes).  decode_split would walk
//   each chunk once for every 8 heads (6 times at 48) with a block merge
//   after each walk, and leave rows 8-15 of each product empty.  Here all
//   256 threads take each 64-row step together: every k row is read from
//   shared memory once per 16 heads, the group in the rows of
//   mma.m16n8k16 (1-4 m-tiles reusing each k fragment); a thread per
//   quarter of a head's rows keeps its online softmax.  p is float32 in
//   the reference, so p.v does not round it to one bf16: p goes to the
//   tensor cores as a bf16 pair hi + lo (two products into float32
//   accumulators, v exact in bf16), each warp owning output tiles of 16
//   heads x 8 columns, 24 accumulators a thread at 48 x 128.  In float16
//   p is scaled by 2^15 before the split (p <= 1, so p 2^15 < 65504), so
//   that neither half falls among float16's subnormals for p above 2^-22;
//   the accumulators are scaled back by 2^-15, which is exact.  A chunk has
//   several steps, and a ring of cp.async stages (three, two at D = 256)
//   keeps the next steps' rows in flight.
//
// * decode_wide, for head dims above 256 in every dtype (no shipped config
//   has one; B = 4, 32/4 x 512, S = 4096 in bf16 reads 134 MB, 0.0401 ms at
//   3.35 TB/s): a block a batch of 8 q heads and a chunk of at most 512
//   rows.  k, then v, stream through a ring of four cp.async stages of 16
//   KB tiles with one block barrier a tile: q.k summed over 64-column
//   pieces of a row tile (each k stage carries q's piece), the chunk's
//   scores and p in shared memory, p.v an output slice of 512 bytes a row
//   at a time.  So a block's shared memory (106,816 B in bf16 and f16,
//   90,176 B in float32) does not grow with D, and two blocks fit an SM.
//   bf16 and f16 run both products on the tensor cores (mma.m16n8k16, the
//   8 heads in N; p as a hi + lo pair, as decode_group's), float32
//   register-blocked FMAs.  Rows that are not whole 16-byte chunks run
//   decode_wide_narrow, the same block reading element by element.  The
//   chunks' merge, decode_combine_wide, takes a column a thread.  Its block
//   comment has the rest.
//
// A chunk that starts at or past the sequence's length writes an empty
// partial (m = -inf, l = 0) and exits.  Length 0 keeps the Pallas result,
// the mean of all S rows: every chunk then runs over its rows with scores
// -1e30.  With a single chunk the kernel writes the output itself and
// there is no second launch.  decode_combine reads each chunk's (m, l)
// once (one warp) and sums the acc over the chunks with independent loads.
//
// Registers (ptxas, sm_90a): decode_group 80-185 a thread, no spills
// (114 at 128 x 3 m-tiles, 96 at 256 x 1, 185 at 256 x 4); decode_split
// as before (8 B of spills at bf16 x 120); decode_wide 80 (bf16, f16) and
// 111 (float32), decode_wide_narrow 127-128 (at the bound of two blocks an
// SM), no spills.
//
// Head dims.  Each kernel is compiled at the widths 32, 64, 80, 120, 128
// and 256 (the ported configs' and 32) for rows of exactly D elements, the
// stride a constant.  Any other head dim d runs decode_split_any /
// decode_group_any, the same blocks with d a runtime argument, at the
// smallest of 32, 64, 128 and 256 above d (Phi-3-mini's 96 runs 128).  The
// runtime row costs registers (decode_split<bf16, 64> went from 80 to 105,
// so from three blocks an SM to two, and 28 % slower at MusicGen's decode
// on an NVIDIA H100 80GB HBM3 at 700 W), so the compiled widths keep their
// constant.  A width that is not a multiple
// of 32 (80 for qwen3-32b, 120 for h2o-danube-3-4b) runs on a padded width
// DP, D rounded up to 32 (96 and 128): a lane's p.v columns, the mma
// k-steps and the four lanes of a row all divide DP.  The chunks of a row
// past d are loaded by cp.async with src-size 0, so they land as zeros;
// q's columns past d are zero too, so q.k gains exactly 0 from them, and
// acc's columns past d are never written out.  A cache row in global
// memory stays d elements: the cache is never copied.  Rows whose bytes
// are a multiple of 16 take the 16-byte cp.async loads; other rows (an odd
// d in bf16 or float16, d not a multiple of 4 in float32) do not start on
// a 16-byte boundary, and take a narrower path inside the kernel: element
// by element through registers (2- or 4-byte loads), stored where the
// 16-byte path puts them, zeros past d.  That path does not overlap its
// loads with the step before (the loads complete before the step's
// stores), so it is slower, and no shipped config takes it.  In shared
// memory a row takes SC chunks, DP's chunks rounded up to a multiple of 8
// (bf16 at D = 80: 12 -> 16, 256 B): the k swizzle XORs a chunk index
// inside its aligned group of 8, so it stays inside the row for any chunk
// count, and rows a multiple of 128 B apart keep the mma loads free of
// bank conflicts.
//
// Head dim 256 in decode_split (float32; bf16 groups up to 8): a bf16 row
// is 512 B, so a warp's two stages take 16 KB and the block 200,960 B at
// kMaxGroup (one block an SM; the register limit is then that of one
// block, so the 64 float32 accumulators and 16 q fragments a lane stay in
// registers).  float32 rows are 1 KB, and two stages would be 262,144 B
// alone: float32 at 256 streams through a single stage a warp
// (Geo::kStages = 1; each step waits for its own rows, loaded after the
// step before was read), 131,072 B of stages, the same as bf16.
//
// Groups above kMaxGroup (64; Falcon-7B's 71/1, a 128/1 MQA): a block's
// shared memory holds at most 64 heads (decode_split's float32 q, and
// decode_group's 4 m-tiles), so the group is cut into n_slices = ceil(group
// / 64) slices of ceil(group / n_slices) heads (71: 36 + 35; 128: 64 + 64),
// and each (sequence, kv head, chunk) has one block a slice, the slices of
// one chunk neighbours in the grid.  Each slice's block re-reads the chunk,
// from L2 after the first, since they run side by side.  Slices over the
// grid were chosen over a loop inside the block because the blocks then
// keep their shared memory, registers and plan as they are, and the extra
// blocks add parallelism where MQA has few (sequence, kv head) pairs; the
// cost is a second read of each chunk, from L2.  decode_combine merges each
// head's chunks as before.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxGroup = 64;  // most q heads a block serves (ops.py MAX_GROUP)
constexpr float kNegInf = -1e30f;

template <typename T>
constexpr bool kIsHalf = false;
template <>
constexpr bool kIsHalf<__half> = true;

// the raw bits of an element, for the narrow load path
template <int N>
struct BitsOf;
template <>
struct BitsOf<2> {
  using type = unsigned short;
};
template <>
struct BitsOf<4> {
  using type = unsigned int;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);  // round to nearest even, as torch's .to()
}
__device__ __forceinline__ void store(__half* p, float x) {
  *p = __float2half_rn(x);  // round to nearest even, as torch's .to()
}
// x rounded to T (to nearest even)
template <typename T>
__device__ __forceinline__ T round_to(float x) {
  if constexpr (kIsHalf<T>)
    return __float2half_rn(x);
  else
    return __float2bfloat16(x);
}

template <typename T, int D>
struct Geo {
  static constexpr int kRows = 8;                  // cache rows a warp step
  static constexpr int DP = (D + 31) / 32 * 32;    // padded width
  static constexpr int CPR = DP * sizeof(T) / 16;  // 16-byte chunks a padded row
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
  // shared memory allows no second, and three at bf16 and float16 D = 64
  // (80 registers; at 89 one block fewer fits, and MusicGen's decode, 4 x 24
  // x 3 blocks, took two waves of the H100's 132 SMs where it had taken one)
  static constexpr int kMinBlocks = D > 128 ? 1 : sizeof(T) == 2 && D == 64 ? 3 : 2;
  static constexpr bool kMma = sizeof(T) == 2;  // bf16, f16: q.k on the tensor cores
  static_assert(D * sizeof(T) % 16 == 0, "a compiled row is whole 16-byte chunks");
  static_assert(CPR % 4 == 0, "four lanes share a row");
};

// Byte offset of 16-byte chunk c of k row r (0..7) in a step.  bf16, f16: chunks
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

// The narrow load path (rows that are not whole 16-byte chunks): k and v
// rows t0 .. t0 + rows - 1 of hd elements each (rows at or past c1, and
// columns past hd, zero), element by element through registers, each
// element where the 16-byte path puts it: k at k_offset, v at k_offset too
// where kVSwizzle (decode_group) or in plain chunk order (decode_split).
// Threads first, first + stride, ... share the work.  Not inlined, so the
// 16-byte path keeps the registers and schedule it had.
template <typename T, int CPR, int DP, bool kVSwizzle>
__device__ __noinline__ void load_rows_narrow(uint8_t* bk, uint8_t* bv, int row_bytes,
                                              const T* kp, const T* vp, int t0, int rows,
                                              int c1, int hd, int first, int stride) {
  using B = typename BitsOf<sizeof(T)>::type;
  constexpr int E = 16 / sizeof(T);
  const B* kb = reinterpret_cast<const B*>(kp);
  const B* vb = reinterpret_cast<const B*>(vp);
  for (int i = first; i < rows * DP; i += stride) {
    const int rr = i / DP, e = i % DP;
    const bool valid = t0 + rr < c1 && e < hd;
    const size_t src = (size_t)(t0 + rr) * hd + e;
    const B kx = valid ? kb[src] : B(0), vx = valid ? vb[src] : B(0);
    const int c = e / E, off = (e % E) * (int)sizeof(T);
    *reinterpret_cast<B*>(bk + rr * row_bytes + k_offset<T, CPR>(rr, c) + off) = kx;
    *reinterpret_cast<B*>(bv + rr * row_bytes + (kVSwizzle ? k_offset<T, CPR>(rr, c) : c * 16) +
                          off) = vx;
  }
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

// two values as a pair of T (.x = lo: the low half), rounded to nearest
template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  if constexpr (kIsHalf<T>) {
    __half2 h = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&h);
  } else {
    __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&h);
  }
}

// d = a . b + d, m16n8k16, T operands (bf16 or f16), float32
// accumulators, all 16 rows of A (a0/a1: rows g and g + 8 at columns 2t,
// 2t + 1; a2/a3: the same rows at columns 2t + 8, 2t + 9).
#define MMA_16816(TY)                                                     \
  asm volatile("mma.sync.aligned.m16n8k16.row.col.f32." TY "." TY         \
               ".f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "      \
               "{%0, %1, %2, %3};"                                        \
               : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])           \
               : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1))
template <typename T>
__device__ __forceinline__ void mma_16816(float (&d)[4], uint32_t a0,
                                          uint32_t a1, uint32_t a2, uint32_t a3,
                                          uint32_t b0, uint32_t b1) {
  if constexpr (kIsHalf<T>)
    MMA_16816("f16");
  else
    MMA_16816("bf16");
}
#undef MMA_16816

// The same with rows 8-15 of A zero (decode_split: at most 8 heads).
template <typename T>
__device__ __forceinline__ void mma_16816(float (&d)[4], uint32_t a0,
                                          uint32_t a2, uint32_t b0,
                                          uint32_t b1) {
  mma_16816<T>(d, a0, 0u, a2, 0u, b0, b1);
}

// The block of decode_split and decode_split_any.  kAny: cache rows of
// hd <= D elements (a runtime argument, any alignment); else rows of
// exactly D, the stride a constant and every row whole 16-byte chunks, as
// the kernels at the compiled widths always had.
template <typename T, int D, bool kAny>
__device__ __forceinline__ void decode_split_block(
    const T* __restrict__ q, const T* __restrict__ k_cache,
    const T* __restrict__ v_cache, const int* __restrict__ lengths,
    T* __restrict__ out, float* __restrict__ part_acc, float* __restrict__ part_ml,
    int n_kv_heads, int group, int slice, int seq_len, int chunk, float scale,
    int hd_arg) {
  const int hd = kAny ? hd_arg : D;
  using G = Geo<T, D>;
  constexpr int R = G::kRows;
  extern __shared__ __align__(16) uint8_t smem[];
  float* sQ = reinterpret_cast<float*>(smem);  // slice x DP, zero past hd
  float* sW = sQ + slice * G::DP;  // per warp: s [R][8], p [R][8], corr [8]
  uint8_t* sBuf = reinterpret_cast<uint8_t*>(sW + kWarps * (2 * R * 8 + 8));
  float* sMerge = reinterpret_cast<float*>(sBuf);  // reuses the stages

  // (b * n_kv_heads + kv head, slice z of the group): heads z * slice ..
  // float32 groups above kMaxGroup are sliced here; bf16 and float16 groups
  // above kNarrowGroup run decode_group, so theirs never are
  const int n_slices = sizeof(T) == 2 ? 1 : (group + slice - 1) / slice;
  const int bk = n_slices == 1 ? blockIdx.x : blockIdx.x / n_slices;
  const int z = n_slices == 1 ? 0 : blockIdx.x % n_slices;
  const int gs = sizeof(T) == 2 ? group : min(slice, group - z * slice);  // this block's heads
  const int split = blockIdx.y, n_splits = gridDim.y;
  const int len = lengths[bk / n_kv_heads];
  const int n = len > 0 ? min(len, seq_len) : seq_len;  // rows to walk
  const int c0 = split * chunk;
  const int c1 = min(c0 + chunk, n);
  const int head0 = bk * group + z * slice;  // first q head (row of q) here

  if (c0 >= n) {  // nothing of this sequence here: an empty partial
    for (int h = threadIdx.x; h < gs; h += kThreads) {
      part_ml[((size_t)(head0 + h) * n_splits + split) * 2] = -INFINITY;
      part_ml[((size_t)(head0 + h) * n_splits + split) * 2 + 1] = 0.0f;
    }
    return;
  }

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  // after the scores a lane holds head g's scores of step rows 2t, 2t + 1
  const int g = lane / 4, t = lane % 4;
  const T* kp = k_cache + (size_t)bk * seq_len * hd;
  const T* vp = v_cache + (size_t)bk * seq_len * hd;
  // rows of whole 16-byte chunks take cp.async; others the narrow path
  const bool vec = hd * (int)sizeof(T) % 16 == 0;
  const int cd = hd * (int)sizeof(T) / 16;  // chunks with data (vec)
  uint8_t* wbuf = sBuf + warp * G::kWarpBytes;
  const uint32_t wbuf_s = static_cast<uint32_t>(__cvta_generic_to_shared(wbuf));
  float* wS = sW + warp * (2 * R * 8 + 8);  // [R rows][8 heads]
  float* wP = wS + R * 8;                   // [R rows][8 heads]
  float* wC = wP + R * 8;                   // [8 heads]
  const int n_steps = (c1 - c0 + R - 1) / R;

  // k and v rows of step `s` into stage `st`; rows at or past c1, and the
  // columns of a row past hd, are zero
  auto load_step = [&](int s, int st) {
    const int t0 = c0 + s * R;
    if (vec) {
      const uint32_t dk = wbuf_s + st * G::kStepBytes;
      const uint32_t dv = dk + R * G::kRowBytes;
#pragma unroll
      for (int i = lane; i < R * G::CPR; i += 32) {
        const int rr = i / G::CPR, c = i % G::CPR;
        const bool valid = t0 + rr < c1 && c < cd;
        const size_t src = valid ? (size_t)(t0 + rr) * hd + c * G::E : (size_t)c0 * hd;
        cp_async16(dk + rr * G::kRowBytes + k_offset<T, G::CPR>(rr, c), kp + src, valid);
        cp_async16(dv + rr * G::kRowBytes + c * 16, vp + src, valid);
      }
    } else {
      uint8_t* bk_ = wbuf + st * G::kStepBytes;
      load_rows_narrow<T, G::CPR, G::DP, false>(bk_, bk_ + R * G::kRowBytes, G::kRowBytes, kp,
                                                vp, t0, R, c1, hd, lane, 32);
    }
  };

  // heads in batches of 8; each batch walks the chunk once (from L2 after
  // the first)
  for (int hb = 0; hb < gs; hb += 8) {
    const int hn = min(8, gs - hb);
    if (hb > 0) __syncthreads();  // the merge area (over the stages) is free
    if (warp < n_steps) load_step(warp, 0);
    asm volatile("cp.async.commit_group;" ::: "memory");
    if (hb == 0)
      for (int i = threadIdx.x; i < gs * G::DP; i += kThreads) {
        const int h = i / G::DP, d = i % G::DP;
        sQ[i] = d < hd ? to_f32(q[(size_t)(head0 + h) * hd + d]) : 0.0f;
      }
    __syncthreads();  // q is in

    // bf16, f16: this batch's q as mma A fragments (rows = heads; 8..15 zero)
    uint32_t qa[G::kMma ? G::KK : 1][2];
    if (G::kMma) {
      const float* qg = sQ + (hb + g) * G::DP;
#pragma unroll
      for (int kk = 0; kk < (G::kMma ? G::KK : 1); ++kk) {
        const int d = 16 * kk + 2 * t;
        qa[kk][0] = g < hn ? pack2<T>(qg[d], qg[d + 1]) : 0u;
        qa[kk][1] = g < hn ? pack2<T>(qg[d + 8], qg[d + 9]) : 0u;
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
          mma_16816<T>(d, qa[kk][0], qa[kk][1], b0, b1);
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
    for (int i = threadIdx.x; i < hn * hd; i += kThreads) {
      const int h = i / hd, d = i % hd;
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
        store(out + qh * hd + d, num / fmaxf(den, 1e-30f));
      } else {
        part_acc[(qh * n_splits + split) * hd + d] = num;
        if (d == 0) {
          part_ml[(qh * n_splits + split) * 2] = mx;
          part_ml[(qh * n_splits + split) * 2 + 1] = den;
        }
      }
    }
  }
}

// rows of exactly D elements: the compiled widths
template <typename T, int D>
__global__ void __launch_bounds__(kThreads, (Geo<T, D>::kMinBlocks))
    decode_split(const T* __restrict__ q, const T* __restrict__ k_cache,
                 const T* __restrict__ v_cache, const int* __restrict__ lengths,
                 T* __restrict__ out, float* __restrict__ part_acc,
                 float* __restrict__ part_ml, int n_kv_heads, int group,
                 int slice, int seq_len, int chunk, float scale, int hd) {
  decode_split_block<T, D, false>(q, k_cache, v_cache, lengths, out, part_acc, part_ml, n_kv_heads, group, slice,
                                   seq_len, chunk, scale, hd);
}

// rows of any hd <= D elements
template <typename T, int D>
__global__ void __launch_bounds__(kThreads, (Geo<T, D>::kMinBlocks))
    decode_split_any(const T* __restrict__ q, const T* __restrict__ k_cache,
                 const T* __restrict__ v_cache, const int* __restrict__ lengths,
                 T* __restrict__ out, float* __restrict__ part_acc,
                 float* __restrict__ part_ml, int n_kv_heads, int group,
                 int slice, int seq_len, int chunk, float scale, int hd) {
  decode_split_block<T, D, true>(q, k_cache, v_cache, lengths, out, part_acc, part_ml, n_kv_heads, group, slice,
                                   seq_len, chunk, scale, hd);
}

// -------------------------------- decode_group (bf16 and f16, group > 8)
constexpr int kNarrowGroup = 8;  // wider groups run decode_group (ops.py NARROW_GROUP)
constexpr int kGroupRows = 64;   // cache rows a step (ops.py GROUP_ROWS)

// decode_group<T, D, MT>'s geometry: the group padded to MT m-tiles of 16
// heads; k/v rows of SC chunks, both with the k swizzle; q in bf16 rows of
// DP + 8 elements and p's bf16 halves in rows of R + 8 (the pads keep a
// fragment load's 32 lanes on 32 banks); scores [head][row] in float32.
// p.v's output, GP heads x DP columns, is MT x NT tiles of m16n8, TPW a
// warp.
template <int D, int MT>
struct GGeo {
  static constexpr int R = kGroupRows;
  static constexpr int GP = 16 * MT;              // heads, padded
  static constexpr int DP = (D + 31) / 32 * 32;   // padded width
  static constexpr int KK = DP / 16;              // mma k-steps over DP
  static constexpr int CPR = DP * 2 / 16;         // 16-byte chunks a padded row
  static constexpr int SC = CPR < 8 ? CPR : (CPR + 7) / 8 * 8;  // in shared memory
  static constexpr int kRowBytes = SC * 16;
  static constexpr int kStepBytes = 2 * R * kRowBytes;  // k, then v
  static constexpr int kStages = D > 128 ? 2 : 3;       // the cp.async ring
  static constexpr int QS = DP * 2 + 16;  // bytes a q row
  static constexpr int SS = R + 4;        // floats a score row (a head)
  static constexpr int PS = R + 8;        // bf16 a p row (a head)
  static constexpr int NT = DP / 8;       // p.v: n-tiles of 8 columns
  static constexpr int TPW = (MT * NT + kWarps - 1) / kWarps;  // tiles a warp
  static constexpr int kBytes =
      kStages * kStepBytes + GP * QS + (GP * SS + GP) * 4 + 2 * GP * PS * 2;
  static_assert(CPR % 4 == 0 && R * CPR % kThreads == 0, "whole loads a thread");
  static_assert(4 * GP <= kThreads && R / 8 == kWarps, "a warp per 8 rows");
};

// One block of 256 threads per (sequence, kv head, chunk, slice of at most
// 64 heads), for bf16 or float16 and a group above 8: every step of
// kGroupRows cache rows is read once by the
// whole block for all the group's heads.  Scores: warp w takes rows 8w ..
// 8w + 7 of the step and every head, the heads in the rows of
// mma.m16n8k16 (MT m-tiles reuse each k fragment), q's fragments read from
// shared memory.  Softmax: four threads a head, each over a quarter of the
// step's rows, keep the head's running (m, l) in float32, and split each
// float32 p into T's hi + lo (hi = p rounded, lo = p - hi rounded: p to
// about 2^-17 of itself in bf16; in float16 p 2^15 is split, to about
// 2^-22).  p.v on the tensor cores: two mma.m16n8k16 a
// tile and k-step, hi.v and lo.v, into float32 accumulators (v is exact in
// T), v's fragments loaded transposed by ldmatrix; warp w owns output
// tiles w, w + 8, ... of the MT x NT (heads x 8 columns), TPW * 4
// accumulators a thread.  Three block barriers a step; the next steps'
// rows stream in through a ring of kStages cp.async stages behind them.
template <typename T, int D, int MT, bool kAny>
__device__ __forceinline__ void decode_group_block(
    const T* __restrict__ q, const T* __restrict__ k_cache,
    const T* __restrict__ v_cache, const int* __restrict__ lengths,
    T* __restrict__ out, float* __restrict__ part_acc, float* __restrict__ part_ml,
    int n_kv_heads, int group, int slice, int seq_len, int chunk, float scale,
    int hd_arg) {
  const int hd = kAny ? hd_arg : D;  // as decode_split_block's
  using G = GGeo<D, MT>;
  using B = unsigned short;  // an element's bits (narrow path, q)
  // float16: p is split at 2^15 times itself (kPScale), o scaled back
  constexpr float kPScale = kIsHalf<T> ? 32768.0f : 1.0f;
  constexpr int R = G::R;
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* sQ = smem + G::kStages * G::kStepBytes;  // GP rows of QS bytes
  float* sS = reinterpret_cast<float*>(sQ + G::GP * G::QS);  // [head][SS]
  float* sC = sS + G::GP * G::SS;                             // [head]: corr
  T* sPh = reinterpret_cast<T*>(sC + G::GP);                  // [head][PS]: hi
  T* sPl = sPh + G::GP * G::PS;                               // [head][PS]: lo

  // (b * n_kv_heads + kv head, slice z of the group): heads z * slice ..
  const int n_slices = slice >= group ? 1 : (group + slice - 1) / slice;
  const int bk = n_slices == 1 ? blockIdx.x : blockIdx.x / n_slices;
  const int z = n_slices == 1 ? 0 : blockIdx.x % n_slices;
  const int gs = min(slice, group - z * slice);  // this block's heads
  const int split = blockIdx.y, n_splits = gridDim.y;
  const int len = lengths[bk / n_kv_heads];
  const int n = len > 0 ? min(len, seq_len) : seq_len;  // rows to walk
  const int c0 = split * chunk;
  const int c1 = min(c0 + chunk, n);
  const int head0 = bk * group + z * slice;  // first q head (row of q) here

  if (c0 >= n) {  // nothing of this sequence here: an empty partial
    for (int h = threadIdx.x; h < gs; h += kThreads) {
      part_ml[((size_t)(head0 + h) * n_splits + split) * 2] = -INFINITY;
      part_ml[((size_t)(head0 + h) * n_splits + split) * 2 + 1] = 0.0f;
    }
    return;
  }

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;  // mma fragment coordinates
  const T* kp = k_cache + (size_t)bk * seq_len * hd;
  const T* vp = v_cache + (size_t)bk * seq_len * hd;
  const uint32_t buf_s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const int n_steps = (c1 - c0 + R - 1) / R;
  // rows of whole 16-byte chunks take cp.async; others the narrow path
  const bool vec = hd % 8 == 0;
  const int cd = hd / 8;  // chunks with data (vec)

  // k and v rows of step `s` into stage `st`; rows at or past c1, and the
  // columns of a row past hd, are zero
  auto load_step = [&](int s, int st) {
    const int t0 = c0 + s * R;
    if (vec) {
      const uint32_t dk = buf_s + st * G::kStepBytes;
      const uint32_t dv = dk + R * G::kRowBytes;
#pragma unroll
      for (int i = tid; i < R * G::CPR; i += kThreads) {
        const int rr = i / G::CPR, c = i % G::CPR;
        const bool valid = t0 + rr < c1 && c < cd;
        const size_t src = valid ? (size_t)(t0 + rr) * hd + c * 8 : (size_t)c0 * hd;
        cp_async16(dk + rr * G::kRowBytes + k_offset<T, G::CPR>(rr, c), kp + src, valid);
        cp_async16(dv + rr * G::kRowBytes + k_offset<T, G::CPR>(rr, c), vp + src, valid);
      }
    } else {
      uint8_t* bk_ = smem + st * G::kStepBytes;
      load_rows_narrow<T, G::CPR, G::DP, true>(bk_, bk_ + R * G::kRowBytes, G::kRowBytes, kp,
                                               vp, t0, R, c1, hd, tid, kThreads);
    }
  };
#pragma unroll
  for (int s = 0; s < G::kStages - 1; ++s) {
    if (s < n_steps) load_step(s, s);
    asm volatile("cp.async.commit_group;" ::: "memory");
  }
  // q in T as it is stored, in pairs (element by element at an odd hd);
  // heads past the slice and columns past hd zero
  if (hd % 2 == 0) {
    for (int i = tid; i < G::GP * G::DP / 2; i += kThreads) {
      const int h = i / (G::DP / 2), d = 2 * (i % (G::DP / 2));
      uint32_t x = 0u;
      if (h < gs && d < hd)
        x = *reinterpret_cast<const uint32_t*>(q + (size_t)(head0 + h) * hd + d);
      *reinterpret_cast<uint32_t*>(sQ + h * G::QS + 2 * d) = x;
    }
  } else {
    const B* qb = reinterpret_cast<const B*>(q);
    for (int i = tid; i < G::GP * G::DP; i += kThreads) {
      const int h = i / G::DP, d = i % G::DP;
      *reinterpret_cast<B*>(sQ + h * G::QS + 2 * d) =
          h < gs && d < hd ? qb[(size_t)(head0 + h) * hd + d] : B(0);
    }
  }

  const int sh = tid / 4, sj = tid % 4;  // softmax: head sh, rows 4i + sj
  const bool soft = tid < 4 * G::GP;      // whole warps: GP is a multiple of 16
  float m_run = -INFINITY, l_run = 0.0f;  // head sh's, over the rows so far
  float acc[G::TPW][4];  // p.v: tile warp + kWarps j, as m16n8's C fragment
#pragma unroll
  for (int j = 0; j < G::TPW; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.0f;

  for (int s = 0; s < n_steps; ++s) {
    // this thread's rows of step s are in; the barrier makes everyone's
    // visible and frees the stage step s - 1 used for step s + kStages - 1
    if (G::kStages == 3)
      asm volatile("cp.async.wait_group 1;" ::: "memory");
    else
      asm volatile("cp.async.wait_group 0;" ::: "memory");
    __syncthreads();
    if (s + G::kStages - 1 < n_steps)
      load_step(s + G::kStages - 1, (s + G::kStages - 1) % G::kStages);
    asm volatile("cp.async.commit_group;" ::: "memory");
    const uint8_t* tK = smem + (s % G::kStages) * G::kStepBytes;
    const uint8_t* tV = tK + R * G::kRowBytes;
    const int t0 = c0 + s * R;

    // scores of every head at rows 8 warp .. 8 warp + 7, scaled and masked
    {
      float d[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        d[mt][0] = d[mt][1] = d[mt][2] = d[mt][3] = 0.0f;
      const int kr = 8 * warp + g;  // this lane's k row of the step
      const uint8_t* krow = tK + kr * G::kRowBytes + 4 * t;
#pragma unroll
      for (int kk = 0; kk < G::KK; ++kk) {
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(
            krow + k_offset<T, G::CPR>(kr, 2 * kk));
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(
            krow + k_offset<T, G::CPR>(kr, 2 * kk + 1));
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          const uint8_t* qa = sQ + (16 * mt + g) * G::QS + 32 * kk + 4 * t;
          mma_16816<T>(d[mt], *reinterpret_cast<const uint32_t*>(qa),
                    *reinterpret_cast<const uint32_t*>(qa + 8 * G::QS),
                    *reinterpret_cast<const uint32_t*>(qa + 16),
                    *reinterpret_cast<const uint32_t*>(qa + 8 * G::QS + 16), b0, b1);
        }
      }
      const int row = t0 + 8 * warp + 2 * t;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          float2 x;
          x.x = row >= c1 ? -INFINITY : row >= len ? kNegInf  // only at length 0
                                                   : d[mt][2 * hh] * scale;
          x.y = row + 1 >= c1 ? -INFINITY : row + 1 >= len ? kNegInf
                                                           : d[mt][2 * hh + 1] * scale;
          *reinterpret_cast<float2*>(sS + (16 * mt + g + 8 * hh) * G::SS + 8 * warp + 2 * t) = x;
        }
    }
    __syncthreads();

    // online softmax of head sh over the step's rows sj, sj + 4, ...
    if (soft) {
      const float* srow = sS + sh * G::SS + sj;
      float x[R / 4];
      float mx = -INFINITY;
#pragma unroll
      for (int i = 0; i < R / 4; ++i) {
        x[i] = srow[4 * i];
        mx = fmaxf(mx, x[i]);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_run, mx);  // finite: a step has a row < c1
      const float corr = expf(m_run - m_new);
      float ls = 0.0f;
#pragma unroll
      for (int i = 0; i < R / 4; ++i) {
        const float p = expf(x[i] - m_new);
        const float ps = p * kPScale;  // exact: a power of two
        const T hi = round_to<T>(ps);
        sPh[sh * G::PS + 4 * i + sj] = hi;
        sPl[sh * G::PS + 4 * i + sj] = round_to<T>(ps - to_f32(hi));
        ls += p;
      }
      l_run = l_run * corr + ls;  // this thread's share; summed at the end
      m_run = m_new;
      if (sj == 0) sC[sh] = corr;
    }
    __syncthreads();

    // acc = acc * corr + (hi + lo) . v in float32; rows past c1 have p = 0
    // and v = 0, columns past D v = 0
    {
#pragma unroll
      for (int j = 0; j < G::TPW; ++j) {
        const int i = warp + kWarps * j;
        if (i < MT * G::NT) {
          const int h = 16 * (i / G::NT) + g;
          const float c0 = sC[h], c1 = sC[h + 8];
          acc[j][0] *= c0;
          acc[j][1] *= c0;
          acc[j][2] *= c1;
          acc[j][3] *= c1;
        }
      }
#pragma unroll
      for (int ks = 0; ks < R / 16; ++ks) {
        const int vr = 16 * ks + (lane & 15);  // the row this lane addresses
        const uint32_t vrow = static_cast<uint32_t>(__cvta_generic_to_shared(tV)) +
                              vr * G::kRowBytes;
#pragma unroll
        for (int j = 0; j < G::TPW; ++j) {
          const int i = warp + kWarps * j;
          if (i >= MT * G::NT) break;  // the same for the whole warp
          const int nt = i % G::NT;
          uint32_t b0, b1;
          asm volatile(
              "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];"
              : "=r"(b0), "=r"(b1)
              : "r"(vrow + k_offset<T, G::CPR>(vr, nt)));
          const int a = (16 * (i / G::NT) + g) * G::PS + 16 * ks + 2 * t;
          const uint32_t* ph = reinterpret_cast<const uint32_t*>(sPh + a);
          const uint32_t* pl = reinterpret_cast<const uint32_t*>(sPl + a);
          constexpr int r8 = 8 * G::PS / 2;  // 8 heads on, in 32-bit words
          mma_16816<T>(acc[j], ph[0], ph[r8], ph[4], ph[r8 + 4], b0, b1);
          mma_16816<T>(acc[j], pl[0], pl[r8], pl[4], pl[r8 + 4], b0, b1);
        }
      }
    }
  }
  asm volatile("cp.async.wait_group 0;" ::: "memory");
  if constexpr (kPScale != 1.0f) {  // back from p 2^15: exact
#pragma unroll
    for (int j = 0; j < G::TPW; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] *= 1.0f / kPScale;
  }

  // each head's (m, l) into the score area (no longer read), then out
  if (soft) {
    float l = l_run;
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    if (sj == 0) {
      sS[sh] = m_run;
      sS[G::GP + sh] = l;
    }
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < G::TPW; ++j) {
    const int i = warp + kWarps * j;
    if (i >= MT * G::NT) break;
    const int d = 8 * (i % G::NT) + 2 * t;  // columns d, d + 1 (d + 1 < hd: even hd)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int h = 16 * (i / G::NT) + g + 8 * hh;
      if (h >= gs || d >= hd) continue;
      const size_t qh = (size_t)(head0 + h);
      const bool pair = d + 1 < hd;
      if (n_splits == 1) {
        const float den = fmaxf(sS[G::GP + h], 1e-30f);
        store(out + qh * hd + d, acc[j][2 * hh] / den);
        if (pair) store(out + qh * hd + d + 1, acc[j][2 * hh + 1] / den);
      } else if (hd % 2 == 0) {
        *reinterpret_cast<float2*>(part_acc + (qh * n_splits + split) * hd + d) =
            make_float2(acc[j][2 * hh], acc[j][2 * hh + 1]);
      } else {
        part_acc[(qh * n_splits + split) * hd + d] = acc[j][2 * hh];
        if (pair) part_acc[(qh * n_splits + split) * hd + d + 1] = acc[j][2 * hh + 1];
      }
    }
  }
  if (n_splits > 1) {
    for (int h = tid; h < gs; h += kThreads) {
      part_ml[((size_t)(head0 + h) * n_splits + split) * 2] = sS[h];
      part_ml[((size_t)(head0 + h) * n_splits + split) * 2 + 1] = sS[G::GP + h];
    }
  }
}

template <typename T, int D, int MT>
__global__ void __launch_bounds__(kThreads, 1)
    decode_group(const T* __restrict__ q, const T* __restrict__ k_cache,
                 const T* __restrict__ v_cache, const int* __restrict__ lengths,
                 T* __restrict__ out, float* __restrict__ part_acc,
                 float* __restrict__ part_ml, int n_kv_heads, int group,
                 int slice, int seq_len, int chunk, float scale, int hd) {
  decode_group_block<T, D, MT, false>(q, k_cache, v_cache, lengths, out, part_acc, part_ml, n_kv_heads, group, slice,
                                   seq_len, chunk, scale, hd);
}

template <typename T, int D, int MT>
__global__ void __launch_bounds__(kThreads, 1)
    decode_group_any(const T* __restrict__ q, const T* __restrict__ k_cache,
                 const T* __restrict__ v_cache, const int* __restrict__ lengths,
                 T* __restrict__ out, float* __restrict__ part_acc,
                 float* __restrict__ part_ml, int n_kv_heads, int group,
                 int slice, int seq_len, int chunk, float scale, int hd) {
  decode_group_block<T, D, MT, true>(q, k_cache, v_cache, lengths, out, part_acc, part_ml, n_kv_heads, group, slice,
                                   seq_len, chunk, scale, hd);
}

// Merge the chunks' (m, l, acc) of each q head: one block per q head, a
// thread per column (D threads, hd <= D of them with a column).  Its first
// warp reads every chunk's (m, l) and puts
// each chunk's weight exp(m - max m) (0 for an empty partial, m = -inf)
// and l in shared memory; then each thread sums over the chunks in order,
// its loads of acc independent of one another (an empty partial's acc,
// never written, is loaded and not used).
template <typename T, int D, bool kAny>
__device__ __forceinline__ void decode_combine_block(const float* __restrict__ part_acc,
                                                     const float* __restrict__ part_ml,
                                                     T* __restrict__ out, int n_splits,
                                                     int hd_arg) {
  const int hd = kAny ? hd_arg : D;  // as decode_split_block's
  extern __shared__ float sW[];  // weights, then l: 2 * n_splits
  const size_t qh = blockIdx.x;
  const float* ml = part_ml + qh * n_splits * 2;
  if (threadIdx.x < 32) {  // a whole warp: D >= 32
    float m = -INFINITY;
#pragma unroll 4
    for (int s = threadIdx.x; s < n_splits; s += 32) m = fmaxf(m, ml[2 * s]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    for (int s = threadIdx.x; s < n_splits; s += 32) {
      const float ms = ml[2 * s];
      sW[s] = ms == -INFINITY ? 0.0f : expf(ms - m);
      sW[n_splits + s] = ml[2 * s + 1];
    }
  }
  __syncthreads();
  if (threadIdx.x >= hd) return;
  const float* acc = part_acc + qh * n_splits * hd + threadIdx.x;
  float num = 0.0f, den = 0.0f;
#pragma unroll 8
  for (int s = 0; s < n_splits; ++s) {
    const float w = sW[s], a = acc[(size_t)s * hd];
    if (w != 0.0f) {
      den = fmaf(w, sW[n_splits + s], den);
      num = fmaf(w, a, num);
    }
  }
  store(out + qh * hd + threadIdx.x, num / fmaxf(den, 1e-30f));
}

template <typename T, int D>
__global__ void __launch_bounds__(D)
    decode_combine(const float* __restrict__ part_acc, const float* __restrict__ part_ml,
                   T* __restrict__ out, int n_splits, int hd) {
  decode_combine_block<T, D, false>(part_acc, part_ml, out, n_splits, hd);
}

template <typename T, int D>
__global__ void __launch_bounds__(D)
    decode_combine_any(const float* __restrict__ part_acc,
                       const float* __restrict__ part_ml, T* __restrict__ out,
                       int n_splits, int hd) {
  decode_combine_block<T, D, true>(part_acc, part_ml, out, n_splits, hd);
}

template <typename T, int D, bool kAny>
cudaError_t combine(float* part_acc, float* part_ml, void* out, int n_heads,
                    int n_splits, int hd, cudaStream_t stream) {
  if constexpr (kAny)
    decode_combine_any<T, D><<<n_heads, D, 2 * n_splits * sizeof(float), stream>>>(
        part_acc, part_ml, static_cast<T*>(out), n_splits, hd);
  else
    decode_combine<T, D><<<n_heads, D, 2 * n_splits * sizeof(float), stream>>>(
        part_acc, part_ml, static_cast<T*>(out), n_splits, hd);
  return cudaGetLastError();
}

// The slices of a group (ops.py group_slices): n_slices = ceil(group /
// kMaxGroup) of ceil(group / n_slices) heads each, the last maybe fewer.
int slice_width(int group) {
  const int n_slices = (group + kMaxGroup - 1) / kMaxGroup;
  return (group + n_slices - 1) / n_slices;
}

// The kernel a launch runs: the _any one where kAny (only the one named
// is instantiated)
template <typename T, int D, bool kAny>
auto split_kernel() {
  if constexpr (kAny)
    return &decode_split_any<T, D>;
  else
    return &decode_split<T, D>;
}
template <typename T, int D, int MT, bool kAny>
auto group_kernel() {
  if constexpr (kAny)
    return &decode_group_any<T, D, MT>;
  else
    return &decode_group<T, D, MT>;
}

template <typename T, int D, int MT, bool kAny>
cudaError_t launch_group(const void* q, const void* k, const void* v,
                         const int* lengths, void* out, float* part_acc,
                         float* part_ml, int n_seqs, int n_kv_heads, int group,
                         int seq_len, int n_splits, int chunk, float scale,
                         int hd, cudaStream_t stream) {
  auto kernel = group_kernel<T, D, MT, kAny>();
  static bool configured = false;  // the attribute is per function
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, GGeo<D, MT>::kBytes);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const int slice = slice_width(group);
  const dim3 grid(n_seqs * n_kv_heads * ((group + slice - 1) / slice), n_splits);
  kernel<<<grid, kThreads, GGeo<D, MT>::kBytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), lengths, static_cast<T*>(out), part_acc,
      part_ml, n_kv_heads, group, slice, seq_len, chunk, scale, hd);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_splits == 1) return err;
  return combine<T, D, kAny>(part_acc, part_ml, out, n_seqs * n_kv_heads * group,
                       n_splits, hd, stream);
}

template <typename T, int D, bool kAny>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* lengths, void* out, float* part_acc,
                   float* part_ml, int n_seqs, int n_kv_heads, int group,
                   int seq_len, int n_splits, int chunk, float scale, int hd,
                   cudaStream_t stream) {
  const int slice = slice_width(group);
  if constexpr (sizeof(T) == 2) {  // bf16 and f16 groups above 8: decode_group
    if (group > kNarrowGroup) {
      const int mt = (slice + 15) / 16;
      auto go = mt == 1   ? launch_group<T, D, 1, kAny>
                : mt == 2 ? launch_group<T, D, 2, kAny>
                : mt == 3 ? launch_group<T, D, 3, kAny>
                          : launch_group<T, D, 4, kAny>;
      return go(q, k, v, lengths, out, part_acc, part_ml, n_seqs, n_kv_heads,
                group, seq_len, n_splits, chunk, scale, hd, stream);
    }
  }
  auto kernel = split_kernel<T, D, kAny>();
  static bool configured = false;  // the attribute is per function
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem_bytes<T, D>(kMaxGroup));
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const dim3 grid(n_seqs * n_kv_heads * ((group + slice - 1) / slice), n_splits);
  kernel<<<grid, kThreads, smem_bytes<T, D>(slice), stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), lengths, static_cast<T*>(out), part_acc,
      part_ml, n_kv_heads, group, slice, seq_len, chunk, scale, hd);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_splits == 1) return err;
  return combine<T, D, kAny>(part_acc, part_ml, out, n_seqs * n_kv_heads * group,
                       n_splits, hd, stream);
}

// ------------------------------ decode_wide (head dims above 256, any dtype)
constexpr int kWideHeads = 8;      // q heads a block: the n8 of every product
constexpr int kWidePiece = 64;     // columns of a k tile: q.k's piece
constexpr int kWideSliceBytes = 512;  // bytes of a v tile row: p.v's output slice
constexpr int kWideTile = 16384;   // bytes of a k or a v tile
constexpr int kWideQBytes = 2048;  // a k stage's q piece (8 heads x 64 columns)
constexpr int kWideStages = 4;     // the cp.async ring
constexpr int kWideChunk = 512;    // most cache rows a block (ops.py WIDE_CHUNK)
constexpr int kWideStage = kWideTile + kWideQBytes;

// decode_wide<T>'s geometry.  A k tile is KR rows x kWidePiece columns and
// a v tile VR rows x SL columns (kWideSliceBytes), 16 KB either way (bf16
// and f16: 128 x 64 and 32 x 256; float32: 64 x 64 and 32 x 128), each 1,024
// 16-byte chunks, four a thread.  Scores [row][head] in float32; in bf16
// and f16 p's halves [head][row] in T, rows padded by 8 elements so a
// fragment load's eight heads fall on eight bank groups.  A block's
// dynamic shared memory (ops.py wide_smem_bytes): 106,816 B in bf16 and
// f16 (the ring 73,728, scores 16,384, p 16,640, (m, l) 64), 90,176 B in
// float32 (p overwrites the scores), so two blocks fit an SM.
template <typename T>
struct WideGeo {
  static constexpr int E = 16 / sizeof(T);  // elements a chunk
  static constexpr int KR = kWideTile / (kWidePiece * (int)sizeof(T));
  static constexpr int KC = kWidePiece / E;  // chunks a k row
  static constexpr int SL = kWideSliceBytes / (int)sizeof(T);  // p.v's slice
  static constexpr int VR = kWideTile / kWideSliceBytes;
  static constexpr int VC = kWideSliceBytes / 16;  // chunks a v row
  static constexpr int PS = kWideChunk + 8;  // p elements a head (16-bit)
  static constexpr int kScoreBytes = kWideChunk * kWideHeads * 4;
  static constexpr int kPBytes = sizeof(T) == 2 ? 2 * kWideHeads * PS * 2 : 0;
  static constexpr int kBytes =
      kWideStages * kWideStage + kScoreBytes + kPBytes + 2 * kWideHeads * 4;
  static_assert(KR * KC == 4 * kThreads && VR * VC == 4 * kThreads, "four chunks a thread");
  static_assert(kWideHeads * kWidePiece * 4 <= kWideQBytes, "a q piece fits its stage");
  static_assert(kWideChunk % KR == 0 && kWideChunk % VR == 0, "whole tiles a chunk");
};

// Byte offsets in a stage of chunk c of k row r, of v row r and of q head
// h.  bf16, f16: the chunk XORs the row's (the head's) low three bits, so
// the eight rows an ldmatrix reads fall on eight bank groups.  float32: a
// quarter warp reads eight chunks of one k row, or four chunks of two v
// rows, whose second row's chunks the XOR moves to the other 64 bytes.
template <typename T>
__device__ __forceinline__ int wide_k_off(int r, int c) {
  if constexpr (sizeof(T) == 2) return r * 128 + (c ^ (r & 7)) * 16;
  return r * 256 + c * 16;
}
template <typename T>
__device__ __forceinline__ int wide_v_off(int r, int c) {
  if constexpr (sizeof(T) == 2) return r * 512 + (c ^ (r & 7)) * 16;
  return r * 512 + (c ^ ((r & 1) << 2)) * 16;
}
template <typename T>
__device__ __forceinline__ int wide_q_off(int h, int c) {
  if constexpr (sizeof(T) == 2) return h * 128 + (c ^ (h & 7)) * 16;
  return h * 256 + c * 16;
}

// four 8 x 8 matrices of 16-bit elements, lanes 8j .. 8j + 7 addressing
// matrix j's rows; .trans delivers them transposed
__device__ __forceinline__ void ldsm_x4(uint32_t& r0, uint32_t& r1, uint32_t& r2,
                                        uint32_t& r3, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t& r0, uint32_t& r1, uint32_t& r2,
                                              uint32_t& r3, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(addr));
}

// x[0 .. N) summed over the lanes that differ in the bits kMask, kMask / 2,
// .. kStop of the lane index: a reduce-scatter.  At each bit a lane keeps
// the half of its values that its bit names (the upper half where it is
// set) and adds its partner's copy of that half, so x[0 .. N >> levels)
// ends as the group's sums of values base .. base + (N >> levels) - 1,
// base = N / 2 bit_kMask + N / 4 bit_(kMask / 2) + ..., in a fixed order.
template <int M, int N, int kMask, int kStop>
__device__ __forceinline__ void reduce_scatter(float (&x)[M], int lane) {
  if constexpr (kMask >= kStop) {
    constexpr int H = N / 2;
    const bool up = lane & kMask;
#pragma unroll
    for (int j = 0; j < H; ++j) {
      const float send = up ? x[j] : x[j + H];
      const float keep = up ? x[j + H] : x[j];
      x[j] = keep + __shfl_xor_sync(0xffffffffu, send, kMask);
    }
    reduce_scatter<M, H, kMask / 2, kStop>(x, lane);
  }
}

// decode_wide's narrow path, for rows that are not whole 16-byte chunks: a
// tile of kRows rows x kCols columns, rows r0 .. and columns col0 .. of src
// (a row every hd elements; rows at or past r1, and columns past hd, zero),
// element by element through registers, each where the 16-byte path puts
// it (kWhat: 0 a k tile, 1 a v tile, 2 q's piece, the heads its rows).  A
// thread takes one column and every (256 / kCols)-th row, 16 loads in
// flight at a time (32 spilled in 16-bit), neighbouring threads on
// neighbouring columns, and none needs a division.
template <typename T, int kRows, int kCols, int kWhat>
__device__ __forceinline__ void wide_load_narrow(uint8_t* buf, const T* src, int r0, int col0,
                                                 int r1, int hd, int tid) {
  using B = typename BitsOf<sizeof(T)>::type;
  constexpr int E = 16 / sizeof(T), kStep = kThreads / kCols;
  constexpr int kN = kRows * kCols / kThreads;  // elements a thread
  constexpr int kBatch = kN < 16 ? kN : 16;     // loads in flight
  static_assert(kN * kThreads == kRows * kCols && kN % kBatch == 0, "whole rows a step");
  const int e = tid % kCols, rr0 = tid / kCols, col = col0 + e;
  const int c = e / E, sub = e % E * (int)sizeof(T);
  const B* p = reinterpret_cast<const B*>(src) + (size_t)(r0 + rr0) * hd + col;
#pragma unroll
  for (int j0 = 0; j0 < kN; j0 += kBatch) {
    B x[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j)
      x[j] = col < hd && r0 + rr0 + kStep * (j0 + j) < r1 ? p[(size_t)(kStep * (j0 + j)) * hd]
                                                          : B(0);
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int rr = rr0 + kStep * (j0 + j);
      const int off = kWhat == 0   ? wide_k_off<T>(rr, c)
                      : kWhat == 1 ? wide_v_off<T>(rr, c)
                                   : wide_q_off<T>(rr, c);
      *reinterpret_cast<B*>(buf + off + sub) = x[j];
    }
  }
}

// Head dims above 256, in float32, bfloat16 and float16, any group and
// ragged lengths.  Block (sequence and kv head, batch of up to 8 q heads
// of the group, chunk of at most 512 cache rows) streams its chunk's k,
// then its v, through a ring of kWideStages cp.async stages of 16 KB
// tiles, with one block barrier a tile; its shared memory does not depend
// on the head dim.  Tiles in order: k by row tile and, inside a row tile,
// by 64-column piece (each k stage carries the batch's q piece, from L2),
// so a row tile's scores are whole after its last piece; then v by output
// slice of 512 bytes a row (256 columns in bf16 and f16, 128 in float32)
// and, inside a slice, by row tile.  The first v tiles are in flight while
// the softmax runs.  bf16, f16: q.k is mma.m16n8k16 in the operands' own
// type with the tile's rows in M and the 8 heads in N (warp w: rows 16w ..
// 16w + 15 of a 128-row tile, k by ldmatrix, q's fragments by ldmatrix
// from the stage); p.v is mma.m16n8k16 with the slice's columns in M (warp
// w: 32 of them, two m-tiles, v by ldmatrix.trans) and the heads in N, p
// as the pair hi + lo in T (float16: p 2^15, scaled back after), two
// products into float32 accumulators.  With the heads in N, GQA's group of
// 8 fills each product, where 16 heads in M would have padded half of
// every product and doubled the scores and p in shared memory.  float32:
// FMAs, register-blocked.  q.k: a lane takes 4 rows x 4 columns of the
// tile, so each q load (one LDS.128: 4 columns of a head) serves 4 rows;
// 16 lanes share a row's piece, and their 32 partial scores (4 rows x 8
// heads) add up across the pieces of the row tile and then across the
// lanes (reduce_scatter).  p.v: a lane takes 4 rows x 4 columns, so one v
// load and two p loads (8 heads) serve 32 FMAs; 8 lanes share a column
// set, summed at the slice's end.  Between the passes a warp a head: the
// scale, -1e30 past the length (only at length 0, which walks every row),
// the chunk's maximum, p = exp(s - m) and l.  A single chunk writes the
// output; more write their partials and decode_combine_wide merges them.
// kVec: rows of whole 16-byte chunks, by cp.async; else wide_load_narrow.
template <typename T, bool kVec>
__device__ __forceinline__ void decode_wide_block(
    const T* __restrict__ q, const T* __restrict__ k_cache, const T* __restrict__ v_cache,
    const int* __restrict__ lengths, T* __restrict__ out, float* __restrict__ part_acc,
    float* __restrict__ part_ml, int n_kv_heads, int group, int seq_len, int chunk,
    float scale, int hd) {
  using G = WideGeo<T>;
  constexpr int H = kWideHeads, E = G::E;
  constexpr bool kMma = sizeof(T) == 2;
  // float16: p is split at 2^15 times itself, o scaled back (decode_group's)
  constexpr float kPScale = kIsHalf<T> ? 32768.0f : 1.0f;
  extern __shared__ __align__(16) uint8_t smem[];
  float* sS = reinterpret_cast<float*>(smem + kWideStages * kWideStage);  // [row][head]
  T* sPh = reinterpret_cast<T*>(reinterpret_cast<uint8_t*>(sS) + G::kScoreBytes);
  T* sPl = sPh + H * G::PS;
  float* sM = reinterpret_cast<float*>(reinterpret_cast<uint8_t*>(sPh) + G::kPBytes);
  float* sL = sM + H;

  const int batches = (group + H - 1) / H;
  const int bk = blockIdx.x / batches, hb = blockIdx.x % batches;
  const int hn = min(H, group - hb * H);  // this block's heads
  const int split = blockIdx.y, n_splits = gridDim.y;
  const int len = lengths[bk / n_kv_heads];
  const int n = len > 0 ? min(len, seq_len) : seq_len;  // rows to walk
  const int c0 = split * chunk, c1 = min(c0 + chunk, n);
  const int head0 = bk * group + hb * H;
  if (c0 >= n) {  // nothing of this sequence here: an empty partial
    for (int h = threadIdx.x; h < hn; h += kThreads) {
      part_ml[((size_t)(head0 + h) * n_splits + split) * 2] = -INFINITY;
      part_ml[((size_t)(head0 + h) * n_splits + split) * 2 + 1] = 0.0f;
    }
    return;
  }
  const int rows = c1 - c0;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;  // mma fragment coordinates
  const T* kp = k_cache + (size_t)bk * seq_len * hd;
  const T* vp = v_cache + (size_t)bk * seq_len * hd;
  const T* qp = q + (size_t)head0 * hd;
  const uint32_t smem_s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const int n_pieces = (hd + kWidePiece - 1) / kWidePiece;
  const int n_slices = (hd + G::SL - 1) / G::SL;
  const int k_tiles = (rows + G::KR - 1) / G::KR;
  const int v_tiles = (rows + G::VR - 1) / G::VR;
  const int tiles_k = k_tiles * n_pieces;  // the k pass; then the v pass
  const int tiles = tiles_k + n_slices * v_tiles;

  // tile i into stage st: rows at or past c1, and columns past hd, zero
  auto load_tile = [&](int i, int st) {
    const bool kpass = i < tiles_k;
    const int rt = kpass ? i / n_pieces : (i - tiles_k) % v_tiles;
    const int col0 = kpass ? (i % n_pieces) * kWidePiece : (i - tiles_k) / v_tiles * G::SL;
    const int r0 = c0 + rt * (kpass ? G::KR : G::VR);
    const T* src = kpass ? kp : vp;
    if constexpr (kVec) {
      const int cpr = kpass ? G::KC : G::VC;  // chunks a row
      const uint32_t buf_s = smem_s + st * kWideStage;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int x = tid + j * kThreads, rr = x / cpr, c = x % cpr;
        const int row = r0 + rr, col = col0 + c * E;
        const bool valid = row < c1 && col < hd;
        cp_async16(buf_s + (kpass ? wide_k_off<T>(rr, c) : wide_v_off<T>(rr, c)),
                   valid ? src + (size_t)row * hd + col : src, valid);
      }
      if (kpass && tid < H * G::KC) {
        const int h = tid / G::KC, c = tid % G::KC, col = col0 + c * E;
        const bool valid = h < hn && col < hd;
        cp_async16(buf_s + kWideTile + wide_q_off<T>(h, c),
                   valid ? qp + (size_t)h * hd + col : qp, valid);
      }
    } else {
      uint8_t* buf = smem + st * kWideStage;
      if (kpass) {
        wide_load_narrow<T, G::KR, kWidePiece, 0>(buf, src, r0, col0, c1, hd, tid);
        wide_load_narrow<T, H, kWidePiece, 2>(buf + kWideTile, qp, 0, col0, hn, hd, tid);
      } else {
        wide_load_narrow<T, G::VR, G::SL, 1>(buf, src, r0, col0, c1, hd, tid);
      }
    }
  };

  // wait for tile i, then issue tile i + kWideStages - 1 into the stage
  // tile i - 1 used (the barrier frees it); returns tile i's stage offset
  auto next = [&](int i) {
    asm volatile("cp.async.wait_group %0;" ::"n"(kWideStages - 2) : "memory");
    __syncthreads();
    if (i + kWideStages - 1 < tiles)
      load_tile(i + kWideStages - 1, (i + kWideStages - 1) % kWideStages);
    asm volatile("cp.async.commit_group;" ::: "memory");
    return (i % kWideStages) * kWideStage;
  };
#pragma unroll
  for (int s = 0; s < kWideStages - 1; ++s) {
    if (s < tiles) load_tile(s, s);
    asm volatile("cp.async.commit_group;" ::: "memory");
  }

  // ------------------------------------------------------------ q.k
  {
    // bf16, f16: this warp's m16n8 tile of scores; float32: 4 rows x 8
    // heads over this lane's columns
    float sc[kMma ? 4 : 32];
    for (int i = 0; i < tiles_k; ++i) {
      const int off = next(i);
      const int rt = i / n_pieces, piece = i % n_pieces;
      if (piece == 0) {
#pragma unroll
        for (int e = 0; e < (kMma ? 4 : 32); ++e) sc[e] = 0.0f;
      }
      if constexpr (kMma) {
        const uint32_t buf_s = smem_s + off;
        // q's B fragments for the piece's 4 k-steps: heads 0-7 x 8 columns
        uint32_t qf[8];
        {
          const int j = lane / 8, h = lane % 8;
          ldsm_x4(qf[0], qf[1], qf[2], qf[3], buf_s + kWideTile + wide_q_off<T>(h, j));
          ldsm_x4(qf[4], qf[5], qf[6], qf[7], buf_s + kWideTile + wide_q_off<T>(h, 4 + j));
        }
        const int kr = 16 * warp + (lane & 7) + 8 * ((lane >> 3) & 1);  // this lane's k row
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) {
          uint32_t a[4];
          ldsm_x4(a[0], a[1], a[2], a[3], buf_s + wide_k_off<T>(kr, 2 * ks + (lane >> 4)));
          mma_16816<T>(sc, a[0], a[1], a[2], a[3], qf[2 * ks], qf[2 * ks + 1]);
        }
        if (piece == n_pieces - 1) {  // the row tile's scores, scaled and masked
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int r = rt * G::KR + 16 * warp + g + 8 * hh;
            if (r < rows) {
              const bool pad = c0 + r >= len;  // only at length 0
              *reinterpret_cast<float2*>(sS + r * H + 2 * t) =
                  make_float2(pad ? kNegInf : sc[2 * hh] * scale,
                              pad ? kNegInf : sc[2 * hh + 1] * scale);
            }
          }
        }
      } else {
        // float32: rows 8w + 4 (lane / 16) + 0..3, columns 4 (lane % 16) + 0..3
        const uint8_t* buf = smem + off;
        const int cp = lane % 16, r0 = 8 * warp + 4 * (lane / 16);
        float4 kv[4];
#pragma unroll
        for (int x = 0; x < 4; ++x)
          kv[x] = *reinterpret_cast<const float4*>(buf + wide_k_off<T>(r0 + x, cp));
#pragma unroll
        for (int h = 0; h < H; ++h) {
          const float4 qv =
              *reinterpret_cast<const float4*>(buf + kWideTile + wide_q_off<T>(h, cp));
#pragma unroll
          for (int x = 0; x < 4; ++x) {
            float d = sc[x * H + h];
            d = fmaf(qv.x, kv[x].x, d);
            d = fmaf(qv.y, kv[x].y, d);
            d = fmaf(qv.z, kv[x].z, d);
            d = fmaf(qv.w, kv[x].w, d);
            sc[x * H + h] = d;
          }
        }
        if (piece == n_pieces - 1) {
          // summed over the row's 16 lanes: lane cp keeps row cp / 4 of its
          // four, heads 2 (cp % 4) and 2 (cp % 4) + 1
          reduce_scatter<32, 32, 8, 1>(sc, lane);
          const int r = rt * G::KR + r0 + cp / 4;
          if (r < rows) {
            const bool pad = c0 + r >= len;  // only at length 0
            *reinterpret_cast<float2*>(sS + r * H + 2 * (cp % 4)) =
                make_float2(pad ? kNegInf : sc[0] * scale, pad ? kNegInf : sc[1] * scale);
          }
        }
      }
    }
  }

  // ------------------------------------------------------------ p.v
  // bf16, f16: 32 columns x 8 heads of the slice (two m16n8 C tiles);
  // float32: 4 columns x 8 heads over this lane's rows
  float acc[kMma ? 8 : 32];
  for (int i = tiles_k; i < tiles; ++i) {
    const int off = next(i);
    if (i == tiles_k) {
      // the chunk's scores are in (and the first v tiles in flight): a
      // warp a head takes the softmax
      const int h = warp;
      float m = -INFINITY;
      for (int r = lane; r < rows; r += 32) m = fmaxf(m, sS[r * H + h]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
      float l = 0.0f;
      for (int r = lane; r < v_tiles * G::VR; r += 32) {
        const float p = r < rows ? expf(sS[r * H + h] - m) : 0.0f;  // 0 past the chunk
        l += p;
        if constexpr (kMma) {
          const float ps = p * kPScale;  // exact: a power of two
          const T hi = round_to<T>(ps);
          sPh[h * G::PS + r] = hi;
          sPl[h * G::PS + r] = round_to<T>(ps - to_f32(hi));
        } else {
          sS[r * H + h] = p;
        }
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) l += __shfl_xor_sync(0xffffffffu, l, o);
      if (lane == 0) {
        sM[h] = m;
        sL[h] = l;
      }
      __syncthreads();
    }
    const int slice = (i - tiles_k) / v_tiles, rt = (i - tiles_k) % v_tiles;
    const int col0 = slice * G::SL;
    if (rt == 0) {
#pragma unroll
      for (int e = 0; e < (kMma ? 8 : 32); ++e) acc[e] = 0.0f;
    }
    int col[4];  // this lane's output columns (float32: one)
    int hcol;    // and the first of its heads at each
    if constexpr (kMma) {
      const uint32_t buf_s = smem_s + off;
      const int j = lane / 8, x = lane % 8;
      const uint32_t ph = static_cast<uint32_t>(__cvta_generic_to_shared(sPh));
      const uint32_t pl = static_cast<uint32_t>(__cvta_generic_to_shared(sPl));
#pragma unroll
      for (int ks = 0; ks < G::VR / 16; ++ks) {
        // p (16 rows x 8 heads) as B, hi and lo
        uint32_t b[4];
        const int pr = rt * G::VR + 16 * ks + 8 * (j & 1);  // the matrix's first cache row
        ldsm_x4(b[0], b[1], b[2], b[3], ((j >> 1) ? pl : ph) + (x * G::PS + pr) * 2);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          // v^T (16 columns x 16 rows) as A: columns 32 w + 16 mt ..
          uint32_t a[4];
          ldsm_x4_trans(a[0], a[1], a[2], a[3],
                        buf_s + wide_v_off<T>(16 * ks + x + 8 * (j >> 1),
                                              4 * warp + 2 * mt + (j & 1)));
          float (&d)[4] = *reinterpret_cast<float(*)[4]>(acc + 4 * mt);
          mma_16816<T>(d, a[0], a[1], a[2], a[3], b[0], b[1]);  // hi . v
          mma_16816<T>(d, a[0], a[1], a[2], a[3], b[2], b[3]);  // lo . v
        }
      }
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) col[cc] = col0 + 32 * warp + 8 * cc + g;
      hcol = 2 * t;
    } else {
      // float32: rows rs + 8 x of the tile, columns 16 w + 4 cg + 0..3
      const uint8_t* buf = smem + off;
      const int cg = lane % 4, rs = lane / 4;
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const int rr = rs + 8 * x;
        const float4 vv =
            *reinterpret_cast<const float4*>(buf + wide_v_off<T>(rr, 4 * warp + cg));
        const float* prow = sS + (rt * G::VR + rr) * H;
        const float4 pa = *reinterpret_cast<const float4*>(prow);
        const float4 pb = *reinterpret_cast<const float4*>(prow + 4);
        const float pr[H] = {pa.x, pa.y, pa.z, pa.w, pb.x, pb.y, pb.z, pb.w};
        const float vc[4] = {vv.x, vv.y, vv.z, vv.w};
#pragma unroll
        for (int c = 0; c < 4; ++c)
#pragma unroll
          for (int h = 0; h < H; ++h) acc[c * H + h] = fmaf(pr[h], vc[c], acc[c * H + h]);
      }
      // after the sum over the column's 8 lanes: column 4 cg + rs / 2 of
      // the warp's 16, heads 4 (rs % 2) .. + 3
      col[0] = col[1] = col0 + 16 * warp + 4 * cg + rs / 2;
      hcol = 4 * (rs % 2);
    }
    if (rt == v_tiles - 1) {  // the slice's last row tile: write it out
      if constexpr (!kMma) reduce_scatter<32, 32, 16, 4>(acc, lane);
      constexpr int kPer = kMma ? 2 : 4;  // heads a column a lane
#pragma unroll
      for (int cc = 0; cc < (kMma ? 4 : 1); ++cc) {
        if (col[cc] >= hd) continue;
#pragma unroll
        for (int e = 0; e < kPer; ++e) {
          const int h = hcol + e;
          if (h >= hn) continue;
          const float a = acc[cc * kPer + e] * (1.0f / kPScale);  // exact
          const size_t qh = (size_t)(head0 + h);
          if (n_splits == 1)
            store(out + qh * hd + col[cc], a / fmaxf(sL[h], 1e-30f));
          else
            part_acc[(qh * n_splits + split) * hd + col[cc]] = a;
        }
      }
    }
  }
  asm volatile("cp.async.wait_group 0;" ::: "memory");
  if (n_splits > 1 && tid < hn) {
    const size_t qh = (size_t)(head0 + tid);
    part_ml[(qh * n_splits + split) * 2] = sM[tid];
    part_ml[(qh * n_splits + split) * 2 + 1] = sL[tid];
  }
}

// rows of whole 16-byte chunks (hd a multiple of 16 / sizeof(T)): cp.async
template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
    decode_wide(const T* __restrict__ q, const T* __restrict__ k_cache,
                const T* __restrict__ v_cache, const int* __restrict__ lengths,
                T* __restrict__ out, float* __restrict__ part_acc,
                float* __restrict__ part_ml, int n_kv_heads, int group,
                int seq_len, int chunk, float scale, int hd) {
  decode_wide_block<T, true>(q, k_cache, v_cache, lengths, out, part_acc, part_ml, n_kv_heads,
                             group, seq_len, chunk, scale, hd);
}

// other rows: the narrow path (a kernel of its own, so that its registers
// do not raise decode_wide's)
template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
    decode_wide_narrow(const T* __restrict__ q, const T* __restrict__ k_cache,
                       const T* __restrict__ v_cache, const int* __restrict__ lengths,
                       T* __restrict__ out, float* __restrict__ part_acc,
                       float* __restrict__ part_ml, int n_kv_heads, int group,
                       int seq_len, int chunk, float scale, int hd) {
  decode_wide_block<T, false>(q, k_cache, v_cache, lengths, out, part_acc, part_ml, n_kv_heads,
                              group, seq_len, chunk, scale, hd);
}

// decode_combine for head dims above 256: a block a q head and
// kCombineCols of its columns, so that every column's chunks are summed by
// a thread of its own with all of its loads in flight; its first warp
// reads every chunk's (m, l) as decode_combine's does, then each thread
// sums its column's chunks in order.
constexpr int kCombineCols = 128;
template <typename T>
__global__ void __launch_bounds__(kCombineCols)
    decode_combine_wide(const float* __restrict__ part_acc,
                        const float* __restrict__ part_ml, T* __restrict__ out,
                        int n_splits, int hd) {
  extern __shared__ float sW[];  // weights, then l: 2 * n_splits
  const size_t qh = blockIdx.x;
  const float* ml = part_ml + qh * n_splits * 2;
  if (threadIdx.x < 32) {
    float m = -INFINITY;
    for (int s = threadIdx.x; s < n_splits; s += 32) m = fmaxf(m, ml[2 * s]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    for (int s = threadIdx.x; s < n_splits; s += 32) {
      const float ms = ml[2 * s];
      sW[s] = ms == -INFINITY ? 0.0f : expf(ms - m);
      sW[n_splits + s] = ml[2 * s + 1];
    }
  }
  __syncthreads();
  const int c = blockIdx.y * kCombineCols + threadIdx.x;
  if (c >= hd) return;
  const float* acc = part_acc + qh * n_splits * hd + c;
  float num = 0.0f, den = 0.0f;
#pragma unroll 16
  for (int s = 0; s < n_splits; ++s) {
    const float w = sW[s], a = acc[(size_t)s * hd];
    if (w != 0.0f) {
      den = fmaf(w, sW[n_splits + s], den);
      num = fmaf(w, a, num);
    }
  }
  store(out + qh * hd + c, num / fmaxf(den, 1e-30f));
}

template <typename T>
cudaError_t launch_wide(const void* q, const void* k, const void* v,
                        const int* lengths, void* out, float* part_acc,
                        float* part_ml, int n_seqs, int n_kv_heads, int group,
                        int seq_len, int n_splits, int chunk, float scale, int hd,
                        cudaStream_t stream) {
  if (chunk > kWideChunk) return cudaErrorInvalidValue;
  static bool configured = false;  // the attribute is per function
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        decode_wide<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, WideGeo<T>::kBytes);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(decode_wide_narrow<T>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, WideGeo<T>::kBytes);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const dim3 grid(n_seqs * n_kv_heads * ((group + kWideHeads - 1) / kWideHeads), n_splits);
  auto kernel = hd % (16 / (int)sizeof(T)) == 0 ? decode_wide<T> : decode_wide_narrow<T>;
  kernel<<<grid, kThreads, WideGeo<T>::kBytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), lengths, static_cast<T*>(out), part_acc,
      part_ml, n_kv_heads, group, seq_len, chunk, scale, hd);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_splits == 1) return err;
  const dim3 merge(n_seqs * n_kv_heads * group, (hd + kCombineCols - 1) / kCombineCols);
  decode_combine_wide<T><<<merge, kCombineCols, 2 * n_splits * sizeof(float), stream>>>(
      part_acc, part_ml, static_cast<T*>(out), n_splits, hd);
  return cudaGetLastError();
}

// Head dim hd at a compiled width runs that width's kernels; any other the
// _any kernels at the smallest of 32, 64, 128, 256 above it (ops.py width).
template <typename T>
cudaError_t launch_d(int hd, const void* q, const void* k, const void* v,
                     const int* lengths, void* out, float* part_acc,
                     float* part_ml, int n_seqs, int n_kv_heads, int group,
                     int seq_len, int n_splits, int chunk, float scale,
                     cudaStream_t stream) {
  auto go = hd > 256    ? launch_wide<T>
            : hd == 32  ? launch<T, 32, false>
            : hd == 64  ? launch<T, 64, false>
            : hd == 80  ? launch<T, 80, false>
            : hd == 120 ? launch<T, 120, false>
            : hd == 128 ? launch<T, 128, false>
            : hd == 256 ? launch<T, 256, false>
            : hd < 32   ? launch<T, 32, true>
            : hd < 64   ? launch<T, 64, true>
            : hd < 128  ? launch<T, 128, true>
                        : launch<T, 256, true>;
  return go(q, k, v, lengths, out, part_acc, part_ml, n_seqs, n_kv_heads,
            group, seq_len, n_splits, chunk, scale, hd, stream);
}

}  // namespace

// Launches the kernels on `stream` (decode_split, or decode_group for bf16
// and float16 groups above 8, then decode_combine when n_splits > 1) and
// returns cudaGetLastError() (0 on success).  Does not synchronise.
// dtype: 0 float32, 1 bfloat16, 2 float16; any other code is refused.
// head_dim: any >= 1 (decode_wide or decode_wide_narrow above 256, then
// decode_combine_wide; chunk at most 512 rows);
// any group >= 1.  q and out hold n_seqs * n_kv_heads
// * group rows of head_dim, lengths one int32 per sequence, the caches
// n_seqs * n_kv_heads * seq_len rows.
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
  if (group < 1 || head_dim < 1 || dtype < 0 || dtype > 2 ||
      chunk % 64 != 0 || (long long)n_splits * chunk < seq_len)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* len = static_cast<const int*>(lengths);
  float* pa = static_cast<float*>(part_acc);
  float* pm = static_cast<float*>(part_ml);
  auto go = dtype == 0   ? launch_d<float>
            : dtype == 1 ? launch_d<__nv_bfloat16>
                         : launch_d<__half>;
  err = go(head_dim, q, k_cache, v_cache, len, out, pa, pm, n_seqs, n_kv_heads,
           group, seq_len, n_splits, chunk, scale, s);
  return (int)err;
}

extern "C" const char* decode_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
