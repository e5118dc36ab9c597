// Flash attention forward for Hopper (sm_90a).
//
// Replaces repro/kernels/flash_attention/kernel.py:flash_attention_kernel,
// the Pallas TPU kernel.  q is (B*H, S, D), k and v are (B*Hkv, S, D), all
// float32, all bfloat16 or all float16; q head i reads kv head i / group.
// Any head dim from 1 up.  Rows wider than 256 run flash_wgmma_wide (bf16,
// float16) or flash_tf32_wide (float32), below.  A row of d elements runs
// the kernel compiled for width d where d is one of 32, 64, 80, 120, 128
// and 256 (the stride a constant); any other row runs flash_wgmma_any /
// flash_tf32_any, the same blocks with d a runtime argument (the columns
// past d are zeros in shared memory, so they add exact zeros, and are not
// stored): flash_tf32_any (float32) at the smallest of 32, 64, 128 and 256
// above d, flash_wgmma_any (bf16 and float16 rows of 1 to 255) at d rounded
// up to a multiple of 32, so that it does the row's own width of work.  A
// float32 row, or a 16-bit row of at most 32 or above 256 elements, whose
// bytes are not a multiple of 16 is padded with zero columns by the
// wrapper (ops.py), as TMA and the 16-byte copies need; flash_wgmma_any
// takes such rows as they are (its narrow loader, below).  For each
// query row: scores = q . k * scale in float32, keys outside the causal
// and window masks set to -1e30, an online softmax with a float32 running
// max, denominator and accumulator, and out = acc / max(l, 1e-30) written
// in q's dtype.  Whole key tiles outside a q tile's [lo, hi) are skipped,
// as the TPU kernel skips chunks (kernel.py:54-62).
//
// What bounds it: operations.  A causal pass does 2 * 2 * S^2/2 * D flops a
// head (q.k and p.v); at B=1, H=32, S=2048, D=128 that is 34.4 GFLOP,
// 0.0347 ms at the H100's 989 TFLOP/s bf16 tensor-core rate, against 37.7 MB
// of q, k, v and out (0.011 ms at 3.35 TB/s); at musicgen-medium's 24 heads
// of 64, 12.9 GFLOP, 0.0130 ms, and S^2/2 * H = 50.3 M exponentials, about
// as long again on the SMs' 16 MUFU lanes each; at recurrentgemma-9b's 16
// heads of 256, S = 4096 with a window of 2048 (6,292,480 visible pairs a
// head), 103.1 GFLOP, 0.1042 ms.  Each k/v tile is read once
// per q tile, and the q heads of one kv head run side by side, so the
// repeated reads hit L2.  At D = 32 neither bound sets the pace but the
// instructions each score takes between the two products (consume32).
//
// Four kernels, chosen by dtype and head dim in flash_attention_launch:
//
// * flash_wgmma<T, D>: bfloat16 and float16 at D = 32, 64, 80, 120, 128 and
//   256 (musicgen-medium, qwen3-32b, h2o-danube-3-4b, Yi-6B and
//   recurrentgemma-9b compute in bf16; Llama-2's published checkpoints are
//   float16; no shipped config computes at 32).  The two types share every
//   instruction but the wgmma's operand type (.f32.f16.f16 or
//   .f32.bf16.bf16), the TMA map's element type and the rounding of p and
//   of the output.  One block of
//   384 threads per (batch-head, 128-row q tile): two consumer warpgroups
//   of 64 q rows each and a producer warpgroup, which hands its registers
//   to the consumers (setmaxnreg 24 / 240).  One producer thread loads the
//   q tile once by TMA and streams 128-key k and v tiles through a ring
//   (cp.async.bulk.tensor; mbarriers "k landed", "v landed" and "both read"
//   a stage, so q.k^T starts before v is in).  Tiles are 128 rows in the
//   128-byte swizzle that wgmma's descriptors expect, in 64-column spans
//   of 16 KB (WGeo): at D = 80, 120 and 128 two spans (128 columns) and a
//   ring of two stages; at D = 64 one span, a row of the tensor map exactly,
//   and a ring of four stages (q 16 KB + 4 x 32 KB of k and v).  At D = 256
//   a row is four spans, and 128-key tiles would not fit (q 64 KB + 2
//   stages x 2 x 64 KB = 320 KB): k and v tiles hold 64 keys (four spans of
//   64 rows, 32 KB; boxes 64 x 64), two stages, 197 KB in all; q.k^T is
//   m64n64k16 and p.v one m64n256k16 a k-step (o is 128 float registers a
//   thread), and the block has no producer (below).  The tensor
//   map's rows are D elements long (128, 160, 240, 256 or 512 bytes, each a
//   multiple of 16 as TMA requires) and its boxes 64 x 128, one box per
//   span, so at 80 and 120 columns D .. 127 of the second span land as
//   TMA's zero fill; the transaction count is the full box, as it is for
//   rows past S.  A consumer warpgroup computes q.k^T with ceil(D/16)
//   steps of wgmma m64n128k16 (4 at D = 64, 5 at 80, 8 at 120 and 128; the
//   zero columns add exact zeros), with A = q, B = k, both K-major in
//   shared memory, bf16 operands, float32 accumulators in registers; it
//   scales the float32 scores by scale * log2(e), masks them (only on
//   tiles that cross the causal diagonal, the window edge or the ragged
//   end), runs the online softmax with exp2, converts p to bf16 in
//   registers and feeds it as the A operand of a second wgmma (B = v,
//   MN-major): m64n64k16 at D = 64, m64n80k16 at D = 80, which reads the
//   first span and 16 columns of the second, and m64n128k16 over the
//   padded tile at 120 and 128 (output columns 120 .. 127 are zeros,
//   neither stored nor read).  q tiles are scheduled longest first (causal
//   work grows with the tile index), and the `group` q heads of one kv head
//   are neighbours in the grid, so their k/v tiles are read from device
//   memory about once.
//
//   Schedules (consume).  At D = 80, 120 and 128 each warpgroup runs q.k^T,
//   its softmax and p.v in turn.  At D = 64 a tile's 8,192 exponentials a
//   warpgroup take the SM's 16 MUFU lanes as long as its two products take
//   the tensor cores, so that schedule would leave the tensor cores idle
//   half the time: there the two warpgroups take turns issuing their
//   products (named barriers), one's softmax runs while the other's
//   products do, and q.k^T of tile j starts together with p.v of tile j - 1.
//   The D = 64 softmax also spends fewer instructions an element (one FMA
//   and one ex2.approx.ftz; online_softmax_fma).
//
//   D = 256 (consume_wide) takes the same turns and overlap, and what bounds
//   it there is registers.  ptxas budgets a kernel's registers by its launch
//   bound, for every warp alike: with 12 warps (or 9) three share an SM
//   sub-partition's 16 K registers, so 168 a thread, and setmaxnreg does not
//   raise what ptxas allocates (the SASS of the 384-thread kernel used no
//   register above R166 after its setmaxnreg 240).  o alone is 128 a thread,
//   the scores 32 and p 16: the 384-thread kernel spilled 376 B, and once
//   o's registers spill ptxas serialises every wgmma (a wait after each).
//   So a D = 256 block is the two consumer warpgroups alone, 8 warps, 255
//   registers (233 used, no spills), and the consumers load k and v
//   themselves: thread 0 loads q and the first two tiles; after each
//   iteration every consumer arrives on that iteration's "read" barrier and
//   thread 0 of each warpgroup counts at its slot's counter in shared
//   memory; the warpgroup that counts second has seen both release the
//   stages and loads k tile j + 2 and v tile j + 1 into them.  The softmax
//   is the D = 64 one (one FMA and one ex2.approx.ftz an element, maxima
//   over the unscaled scores, scale > 0) with a lazy maximum: a row's
//   running maximum moves only when the tile's exceeds it 2^8-fold, so o is
//   rescaled on few tiles.  Without the turns, with an eager maximum or the
//   serial softmax, with k refilled with v, with 32 or 48 keys a tile, or
//   with q in registers, it measured slower (PERF.md).
//
//   D = 32 (consume32) is D = 256's block (two consumer warpgroups, no
//   producer) on rows of 64 bytes: q, k and v come by TMA in the 64-byte
//   swizzle (no padding to 128-byte spans), 64-key tiles, two blocks an SM,
//   each warpgroup running q.k^T (m64n64k16), its softmax and p.v in turn;
//   p.v is m64n40k16 with p as a hi + lo pair against v and a tile of ones,
//   so the output keeps one 16-bit ulp of the plain version and the same
//   products give l.
//
// * flash_wgmma_any<T, D>: the same blocks for rows of ld <= D elements, at
//   D = 32, 64, 96, 128, 160, 192, 224 and 256 (ld rounded up to a multiple
//   of 32): q.k^T runs D / 16 k-steps and p.v D output columns (m64n96k16 at
//   96; m64n160k16 .. m64n224k16 at 160 .. 224), each a fixed instantiation
//   (a product whose issue hangs on a runtime count makes ptxas serialise
//   every wgmma).  64 is flash_wgmma<64>'s geometry and schedule, 128 the
//   128-column one (a producer warpgroup, 128-key tiles, the serial
//   consume), 160 .. 256 the 256-column one (64-key tiles, no producer,
//   consume_wide; three spans a tile at 160 and 192).  96 keeps 128-key
//   tiles but has no producer and runs consume_wide: its scores, p and o
//   take 144 registers a thread, and a 12-warp block gets 168 (on the
//   serial consume it ran no faster than at 128 columns, and on
//   consume_overlap it spilled and ptxas serialised every wgmma; PERF.md).
//   Rows of whole 16-byte pieces come by TMA as above.  Other rows of 33
//   to 192 (33, 100, 170 ... in a 16-bit type) have no tensor map (TMA
//   needs 16-byte row strides), and the wrapper makes no padded copy of
//   them: the narrow
//   loader copies a tile's rows, one contiguous run of bytes in the
//   caller's array, with a 1-D bulk copy (cp.async.bulk, a 16-byte-aligned
//   window around the run: a head starts at any even address) into a
//   staging buffer in shared memory, and threads rewrite it into the
//   128-byte swizzle the descriptors read (relayout: a thread a row, four
//   4-byte words and four byte permutes a chunk of 8 elements; columns from
//   ld and rows from S on as zeros), then fence.proxy.async and arrive on
//   the tile's barrier.  With a producer warpgroup (64, 128) its 128
//   threads do that, through up to four staging buffers a few tiles ahead
//   of the ring (produce_narrow); without one the consumers do at each
//   refill (refill_narrow), from two staging buffers filled a refill
//   earlier, one warpgroup the k tile and the other the v tile, after a
//   start-up that stages q and the first tiles through the empty ring
//   (start_narrow).  At 224 and 256 only one buffer fits beside the
//   layout, so a refill would wait for a copy: that was 13 % slower than
//   the padded copy (PERF.md), and the wrapper pads those rows (ops.py
//   row_elems); the narrow loader is not compiled there (WGeo<D>::narrow).
//   The output is written row by row at ld (pairs where ld is even,
//   elements where it is odd).
//
// * flash_tf32<T, D>: float32 at every head dim (no shipped config
//   computes in it; an LMConfig with compute_dtype=float32 sends both
//   kernels float32).  The TPU kernel
//   multiplies in float32 (kernel.py:49, 66-67), and a float32 output is
//   held to 1e-5 + 1e-5 |plain|.  One TF32 product rounds each operand to
//   10 mantissa bits and misses that by about 60x, so every float32 operand
//   x is split as hi = tf32(x) (cvt.rna) and lo = tf32(x - hi), and each
//   product is the three TF32 products lo.hi + hi.lo + hi.hi
//   (mma.sync.m16n8k8, float32 accumulators; lo.lo, about 2^-22 of the
//   product, is left out).  The split operands are q * scale (rounded to
//   float32 once, as the plain version does), k, p and v.  What bounds it:
//   operations, three TF32 products a pair at the H100's 494.7 TFLOP/s dense
//   TF32 rate, 2.5x the 67 TFLOP/s of any kernel on the CUDA cores (at Yi's
//   32/4 x 128, S = 2048, causal: 34.4 GFLOP, 0.209 ms; 0.513 ms on the
//   CUDA cores).  A block is 8 warps (4 at D = 256) and each warp owns 16 q
//   rows and their online-softmax state (the m of the mma), so a block
//   takes 128 q rows (64 at 256); k and v tiles of 64 keys (32 at 256) come
//   through a two-stage cp.async ring in shared memory, rows padded so that
//   a warp's fragment loads hit 32 distinct banks (TGeo).  q * scale stays
//   in shared memory as float32 and is split at each fragment load (at
//   D = 256 its split halves would not fit beside the ring).  The mma's k
//   index t stands for column 2t and t + 4 for column 2t + 1, in a and b
//   alike, so q and k come as 8-byte pairs, and p's accumulator layout is
//   p.v's a layout with no shuffle (keys 2t, 2t + 1; v's rows read in the
//   same order).  The split costs ALU work beside every product (two cvt and
//   a subtraction an operand); a wgmma design would need v transposed in
//   shared memory (TF32 wgmma takes K-major operands only).  A warp skips
//   the tiles of its block's range that are masked for all its rows, masks
//   only tiles that cross the diagonal, the window's edge or the ragged end,
//   and rescales o only when a row's maximum moved (a factor of exactly 1
//   changes nothing).
//
// * Above head dim 256 (no shipped config; the Pallas kernel takes any D)
//   the kernels above would need q and a k/v tile of whole rows in shared
//   memory (197 KB at 256), so the wide kernels take q.k as a sum over
//   64-column pieces staged through shared memory, and a block 64 q rows
//   and a group of 512 output columns in two halves of 256, each half
//   taking alternate pieces and the two partial score tiles summed through
//   shared memory, so a key tile's scores are computed once a group (see
//   the kernels' comments).  flash_wgmma_wide<T>: bfloat16 and float16, on
//   wgmma (two warpgroups, TMA, p.v with p as a hi + lo pair).
//   flash_tf32_wide<T>: float32, flash_tf32's split-TF32 mma.sync (two sets
//   of 4 warps, k and v split into hi and lo once a block).
//
// Masked keys contribute exactly 0 once a row has seen a valid key (exp of
// -1e30 minus a finite max), and causal and windowed rows always see one,
// so the result does not depend on the tile sizes; keys at or past S (the
// ragged last tile) are -inf and contribute nothing at all.  flash_wgmma<64>
// and flash_wgmma<256> mask with -inf throughout, which for such rows is the
// same function.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;

// ---------------------------------------------- flash_wgmma (tensor cores)
constexpr int kWBQ = 128;                // q rows per block
constexpr int kWBK = 128;                // keys per k/v tile
constexpr int kWCols = 128;              // columns of a tile in shared memory
constexpr int kHalf = 64;                // columns in one 128-byte swizzle span
constexpr int kHalfBytes = kWBK * kHalf * 2;  // 16 KB: 128 rows x 128 B
constexpr int kTileBytes = kWBK * kWCols * 2; // 32 KB: one q, k or v tile
constexpr int kStages = 2;
constexpr int kConsumers = 2;            // warpgroups of 64 q rows
constexpr int kWThreads = (kConsumers + 1) * 128;  // + a producer warpgroup
constexpr int kWSmem = 1024                      // slack to align to 1 KB
                       + kTileBytes              // q
                       + 2 * kStages * kTileBytes  // k and v rings
                       + 8 * (1 + 3 * kStages);  // mbarriers
// D = 64: a tile is one span (kHalfBytes), so the ring can be deeper
constexpr int kNarrowStages = 4;
constexpr int kNarrowSmem = 1024 + kHalfBytes + 2 * kNarrowStages * kHalfBytes +
                            8 * (1 + 3 * kNarrowStages);
// D = 256: four spans a row, and a 128-key tile would not fit (q 64 KB + 2
// stages x 2 x 64 KB = 320 KB), so k and v tiles hold 64 keys (32 KB; four
// spans of 64 rows x 128 B) in a ring of two stages, 197 KB in all.
constexpr int kWideCols = 256;
constexpr int kWideKeys = 64;
constexpr int kWideSpanBytes = kWideKeys * kHalf * 2;          // 8 KB
constexpr int kWideTileBytes = (kWideCols / kHalf) * kWideSpanBytes;  // 32 KB
constexpr int kWideQBytes = (kWideCols / kHalf) * kHalfBytes;  // 64 KB
constexpr int kWideStages = 2;
// q, the ring, mbarriers (q; k landed, v landed, read a stage) and a refill
// counter a stage
constexpr int kWideSmem = 1024 + kWideQBytes + 2 * kWideStages * kWideTileBytes +
                          8 * (1 + 3 * kWideStages) + 4 * kWideStages;
// D = 256: the two consumer warpgroups and no producer, 8 warps, so that
// ptxas budgets 255 registers a thread.  A block of 9 or 12 warps puts 3
// on one SM sub-partition and gets 168 (setmaxnreg does not raise what
// ptxas allocates), too few for o (128 floats a thread): it spills and
// serialises every wgmma.  The loads are issued by the consumers.
constexpr int kWideThreads = kConsumers * 128;
constexpr float kLog2e = 1.4426950408889634f;
// dynamic shared memory a block may use on the H100 (227 KB)
constexpr int kSmemLimit = 232448;
// D = 32 (bf16 and float16 rows of 1 to 32; consume32): a row is 64 bytes,
// one span of the 64-byte swizzle, so q is 8 KB and a k or v tile of
// k32Keys keys 4 KB, in a ring of k32Ring stages
constexpr int k32Cols = 32;
constexpr int k32RowBytes = k32Cols * 2;
constexpr int k32Keys = 64;
constexpr int k32Ring = 4;

// flash_wgmma<D>'s shared-memory geometry: 64-column TMA boxes a tile row,
// keys a k or v tile, bytes of a k/v tile's 64-column span and of the whole
// tile, bytes of the 128-row q tile, stages in the k/v ring, dynamic shared
// memory.  At D = 32 (r64) a span is the tile's 64-byte rows.
template <int D>
struct WGeo {
  static constexpr bool r64 = D == k32Cols;
  static constexpr int boxes = (D + kHalf - 1) / kHalf;
  static constexpr int keys = r64 ? k32Keys : D > kWCols ? kWideKeys : kWBK;
  static constexpr int span = keys * (r64 ? k32RowBytes : kHalf * 2);
  static constexpr int tile = boxes * span;
  static constexpr int qtile = r64 ? kWBQ * k32RowBytes : boxes * kHalfBytes;
  static constexpr int ring =
      r64 ? k32Ring : D <= kHalf ? kNarrowStages : D > kWCols ? kWideStages : kStages;
  // no producer warpgroup: the consumers load k and v themselves
  // (consume_wide) above D = 128 and in flash_wgmma_any<96>, whose 128-key
  // tiles' scores, p and o (144 floats a thread) want the 255 registers of
  // an 8-warp block (with a producer, 12 warps, ptxas gives 168), and at
  // D = 32 (consume32), whose blocks keep to 128 registers, two an SM
  static constexpr bool self_load = r64 || D > kWCols || D == 96;
  // threads a block: a producer warpgroup, or none
  static constexpr int threads = self_load ? kWideThreads : kWThreads;
  // blocks an SM: two at D = 32, whose 64-key tiles keep a thread within
  // 128 registers, else one
  static constexpr int blocks = r64 ? 2 : 1;
  static_assert(k32Keys == 64, "two blocks an SM need D = 32's 64-key tiles");
  // D = 32: a tile of ones after the v ring, which p.v's last 8 columns
  // read (so they sum p)
  static constexpr int ones = r64 ? tile : 0;
  // dynamic shared memory: 1 KB of slack, q, the ring, the ones, the
  // mbarriers and, without a producer, a refill counter a stage
  static constexpr int smem =
      1024 + qtile + 2 * ring * tile + ones + 8 * (1 + 3 * ring) + (self_load ? 4 * ring : 0);
  // flash_wgmma_any's narrow loader (rows whose bytes are not a multiple of
  // 16): staging buffers after the layout (stage_at bytes from its 1 KB
  // aligned base), each the raw rows of a k or v tile (keys rows of at most
  // D - 1 elements, the 16-byte window's slack and the second word its last
  // chunk reads), as many as fit in the SM's shared memory up to 4 with a
  // producer (4 at 64, 2 at 96 and 128) and 2 without (2 at 160 and 192),
  // then their mbarriers, two start-up mbarriers and two refill flags.  The
  // loader runs where at least two fit (narrow): at 224 and 256 one does,
  // and those rows are padded by the wrapper instead; rows of at most 32
  // are padded too (whole 16-byte pieces: TMA).
  static constexpr int stage_at = (smem - 1024 + 127) / 128 * 128;
  static constexpr int xbytes = (keys * (D - 1) * 2 + 48 + 127) / 128 * 128;
  static constexpr int fit = (kSmemLimit - 1024 - stage_at - 24) / (xbytes + 8);
  static constexpr int nx = fit > (self_load ? 2 : 4) ? (self_load ? 2 : 4) : fit;
  static constexpr bool narrow = !r64 && nx >= 2;
  static constexpr int narrow_smem = narrow ? 1024 + stage_at + nx * (xbytes + 8) + 24 : smem;
};
static_assert(WGeo<64>::smem == kNarrowSmem && WGeo<80>::smem == kWSmem &&
                  WGeo<120>::smem == kWSmem && WGeo<128>::smem == kWSmem &&
                  WGeo<256>::smem == kWideSmem,
              "the compiled widths' shared memory");

// Output columns p.v computes at head dim D: 64 at D = 64 (m64n64k16, one
// span), 80 up to D = 80 (m64n80k16: the first half and 16 columns of the
// second), 96 up to D = 96 (m64n96k16, flash_wgmma_any), the whole padded
// tile up to D = 128 (m64n128k16; at D = 120 its last 8 columns are zeros),
// and D above (m64n160k16 .. m64n256k16).
template <int D>
__host__ __device__ constexpr int pv_cols() {
  return D <= kHalf ? kHalf : D <= 80 ? 80 : D <= 96 ? 96 : D <= kWCols ? kWCols : D;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

// Wait for the completion of the barrier's phase of parity `parity`.  A
// wait that never ends (a load that never lands) traps, so it surfaces as
// a launch error instead of a hung card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  uint32_t tries = 0;
  do {
    if (++tries == (1u << 28)) __trap();
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// One TMA box of a 3-D tensor map into shared memory, completing on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void st_shared(uint32_t addr, uint32_t v) {
  asm volatile("st.shared::cta.u32 [%0], %1;" ::"r"(addr), "r"(v) : "memory");
}
__device__ __forceinline__ uint32_t atom_add_shared(uint32_t addr, uint32_t v) {
  uint32_t old;
  asm volatile("atom.shared::cta.add.u32 %0, [%1], %2;"
               : "=r"(old)
               : "r"(addr), "r"(v)
               : "memory");
  return old;
}

// wgmma shared-memory descriptor, 128-byte swizzle.  K-major operands
// (q, k): rows of 128 B, 8-row groups 1024 B apart (SBO); LBO unused.
// MN-major operand (v): 8-key groups 1024 B apart (SBO), the two 64-column
// halves kHalfBytes apart (LBO).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}
// The same in the 64-byte swizzle (layout type 2; D = 32): rows of 64 B,
// 8-row groups 512 B apart (SBO), K-major (q, k; LBO unused) or MN-major
// (v: 32-column atoms, the next one LBO away).
__device__ __forceinline__ uint64_t sw64_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (2ull << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}
// Wait until at most one committed group is still running.
__device__ __forceinline__ void wg_wait_one() {
  asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");
}
// Named barriers over the two consumer warpgroups (id 0 is __syncthreads).
__device__ __forceinline__ void bar_sync(int id) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(kConsumers * 128) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(kConsumers * 128) : "memory");
}
// Keep the compiler from reading accumulators before the wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define WG_D64                                   \
  "{%0, %1, %2, %3, %4, %5, %6, %7, "            \
  "%8, %9, %10, %11, %12, %13, %14, %15, "       \
  "%16, %17, %18, %19, %20, %21, %22, %23, "     \
  "%24, %25, %26, %27, %28, %29, %30, %31, "     \
  "%32, %33, %34, %35, %36, %37, %38, %39, "     \
  "%40, %41, %42, %43, %44, %45, %46, %47, "     \
  "%48, %49, %50, %51, %52, %53, %54, %55, "     \
  "%56, %57, %58, %59, %60, %61, %62, %63}"
#define R8(i)                                                          \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),          \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define R64 R8(0), R8(8), R8(16), R8(24), R8(32), R8(40), R8(48), R8(56)

// The wgmma forms below take bf16 or float16 operands (T), float32
// accumulators; WG_TY(T) spells the operand types of the instruction.
template <typename T>
constexpr bool kIsHalf = false;
template <>
constexpr bool kIsHalf<__half> = true;
#define WG_TY(TY) ".f32." TY "." TY " "

// d (+)= A . B^T, m64n128k16, A and B K-major T in shared memory.
template <typename T>
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da,
                                         uint64_t db, int accumulate) {
#define WG_SS(TY)                                                          \
  asm volatile(                                                            \
      "{\n"                                                                \
      ".reg .pred p;\n"                                                    \
      "setp.ne.b32 p, %66, 0;\n"                                           \
      "wgmma.mma_async.sync.aligned.m64n128k16" WG_TY(TY) WG_D64           \
      ", %64, %65, p, 1, 1, 0, 0;\n"                                       \
      "}\n"                                                                \
      : R64                                                                \
      : "l"(da), "l"(db), "r"(accumulate))
  if constexpr (kIsHalf<T>)
    WG_SS("f16");
  else
    WG_SS("bf16");
#undef WG_SS
}

#define WG_D32                                   \
  "{%0, %1, %2, %3, %4, %5, %6, %7, "            \
  "%8, %9, %10, %11, %12, %13, %14, %15, "       \
  "%16, %17, %18, %19, %20, %21, %22, %23, "     \
  "%24, %25, %26, %27, %28, %29, %30, %31}"
#define R32 R8(0), R8(8), R8(16), R8(24)

// d (+)= A . B^T, m64n64k16 (64-key tiles at D = 256).
template <typename T>
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int accumulate) {
#define WG_SS(TY)                                                          \
  asm volatile(                                                            \
      "{\n"                                                                \
      ".reg .pred p;\n"                                                    \
      "setp.ne.b32 p, %34, 0;\n"                                           \
      "wgmma.mma_async.sync.aligned.m64n64k16" WG_TY(TY) WG_D32            \
      ", %32, %33, p, 1, 1, 0, 0;\n"                                       \
      "}\n"                                                                \
      : R32                                                                \
      : "l"(da), "l"(db), "r"(accumulate))
  if constexpr (kIsHalf<T>)
    WG_SS("f16");
  else
    WG_SS("bf16");
#undef WG_SS
}

// d += A . B, m64n128k16, A in registers (T pairs), B MN-major T in
// shared memory.
template <typename T>
__device__ __forceinline__ void wgmma_rs(float (&d)[64], uint32_t a0,
                                         uint32_t a1, uint32_t a2, uint32_t a3,
                                         uint64_t db) {
#define WG_RS(TY)                                                          \
  asm volatile(                                                            \
      "{\n"                                                                \
      ".reg .pred p;\n"                                                    \
      "setp.ne.b32 p, %69, 0;\n"                                           \
      "wgmma.mma_async.sync.aligned.m64n128k16" WG_TY(TY) WG_D64           \
      ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n"                         \
      "}\n"                                                                \
      : R64                                                                \
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1))
  if constexpr (kIsHalf<T>)
    WG_RS("f16");
  else
    WG_RS("bf16");
#undef WG_RS
}

#define WG_D40                                   \
  "{%0, %1, %2, %3, %4, %5, %6, %7, "            \
  "%8, %9, %10, %11, %12, %13, %14, %15, "       \
  "%16, %17, %18, %19, %20, %21, %22, %23, "     \
  "%24, %25, %26, %27, %28, %29, %30, %31, "     \
  "%32, %33, %34, %35, %36, %37, %38, %39}"
#define R40 R8(0), R8(8), R8(16), R8(24), R8(32)

// d += A . B, m64n80k16: the same over B's first 80 columns, 64 in the
// first half and 16 in the second (LBO apart).
template <typename T>
__device__ __forceinline__ void wgmma_rs(float (&d)[40], uint32_t a0,
                                         uint32_t a1, uint32_t a2, uint32_t a3,
                                         uint64_t db) {
#define WG_RS(TY)                                                          \
  asm volatile(                                                            \
      "{\n"                                                                \
      ".reg .pred p;\n"                                                    \
      "setp.ne.b32 p, %45, 0;\n"                                           \
      "wgmma.mma_async.sync.aligned.m64n80k16" WG_TY(TY) WG_D40            \
      ", {%40, %41, %42, %43}, %44, p, 1, 1, 1;\n"                         \
      "}\n"                                                                \
      : R40                                                                \
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1))
  if constexpr (kIsHalf<T>)
    WG_RS("f16");
  else
    WG_RS("bf16");
#undef WG_RS
}

// d += A . B at flash_wgmma_any's p.v widths, m64nNk16 with N = 2 NO (96,
// 160, 192, 224): B's spans LBO apart, the last one read in part.
#define WG_RS_ANY(NO, SHAPE, DL, RL, OPS, PRED)                                 \
  template <typename T>                                                         \
  __device__ __forceinline__ void wgmma_rs(float(&d)[NO], uint32_t a0,          \
                                           uint32_t a1, uint32_t a2,            \
                                           uint32_t a3, uint64_t db) {          \
    if constexpr (kIsHalf<T>)                                                   \
      asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, " PRED ", 0;\n"           \
                   "wgmma.mma_async.sync.aligned." SHAPE WG_TY("f16") DL        \
                   ", " OPS ", p, 1, 1, 1;\n}\n"                                \
                   : RL                                                         \
                   : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));     \
    else                                                                        \
      asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, " PRED ", 0;\n"           \
                   "wgmma.mma_async.sync.aligned." SHAPE WG_TY("bf16") DL       \
                   ", " OPS ", p, 1, 1, 1;\n}\n"                                \
                   : RL                                                         \
                   : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));     \
  }
#define WG_D48                                   \
  "{%0, %1, %2, %3, %4, %5, %6, %7, "            \
  "%8, %9, %10, %11, %12, %13, %14, %15, "       \
  "%16, %17, %18, %19, %20, %21, %22, %23, "     \
  "%24, %25, %26, %27, %28, %29, %30, %31, "     \
  "%32, %33, %34, %35, %36, %37, %38, %39, "     \
  "%40, %41, %42, %43, %44, %45, %46, %47}"
#define R48 R8(0), R8(8), R8(16), R8(24), R8(32), R8(40)
#define WG_D80                                   \
  "{%0, %1, %2, %3, %4, %5, %6, %7, "            \
  "%8, %9, %10, %11, %12, %13, %14, %15, "       \
  "%16, %17, %18, %19, %20, %21, %22, %23, "     \
  "%24, %25, %26, %27, %28, %29, %30, %31, "     \
  "%32, %33, %34, %35, %36, %37, %38, %39, "     \
  "%40, %41, %42, %43, %44, %45, %46, %47, "     \
  "%48, %49, %50, %51, %52, %53, %54, %55, "     \
  "%56, %57, %58, %59, %60, %61, %62, %63, "     \
  "%64, %65, %66, %67, %68, %69, %70, %71, "     \
  "%72, %73, %74, %75, %76, %77, %78, %79}"
#define R80 R48, R8(48), R8(56), R8(64), R8(72)
#define WG_D96                                   \
  "{%0, %1, %2, %3, %4, %5, %6, %7, "            \
  "%8, %9, %10, %11, %12, %13, %14, %15, "       \
  "%16, %17, %18, %19, %20, %21, %22, %23, "     \
  "%24, %25, %26, %27, %28, %29, %30, %31, "     \
  "%32, %33, %34, %35, %36, %37, %38, %39, "     \
  "%40, %41, %42, %43, %44, %45, %46, %47, "     \
  "%48, %49, %50, %51, %52, %53, %54, %55, "     \
  "%56, %57, %58, %59, %60, %61, %62, %63, "     \
  "%64, %65, %66, %67, %68, %69, %70, %71, "     \
  "%72, %73, %74, %75, %76, %77, %78, %79, "     \
  "%80, %81, %82, %83, %84, %85, %86, %87, "     \
  "%88, %89, %90, %91, %92, %93, %94, %95}"
#define R96 R80, R8(80), R8(88)
#define WG_D112                                  \
  "{%0, %1, %2, %3, %4, %5, %6, %7, "            \
  "%8, %9, %10, %11, %12, %13, %14, %15, "       \
  "%16, %17, %18, %19, %20, %21, %22, %23, "     \
  "%24, %25, %26, %27, %28, %29, %30, %31, "     \
  "%32, %33, %34, %35, %36, %37, %38, %39, "     \
  "%40, %41, %42, %43, %44, %45, %46, %47, "     \
  "%48, %49, %50, %51, %52, %53, %54, %55, "     \
  "%56, %57, %58, %59, %60, %61, %62, %63, "     \
  "%64, %65, %66, %67, %68, %69, %70, %71, "     \
  "%72, %73, %74, %75, %76, %77, %78, %79, "     \
  "%80, %81, %82, %83, %84, %85, %86, %87, "     \
  "%88, %89, %90, %91, %92, %93, %94, %95, "     \
  "%96, %97, %98, %99, %100, %101, %102, %103, " \
  "%104, %105, %106, %107, %108, %109, %110, %111}"
#define R112 R96, R8(96), R8(104)
WG_RS_ANY(48, "m64n96k16", WG_D48, R48, "{%48, %49, %50, %51}, %52", "%53")
WG_RS_ANY(80, "m64n160k16", WG_D80, R80, "{%80, %81, %82, %83}, %84", "%85")
WG_RS_ANY(96, "m64n192k16", WG_D96, R96, "{%96, %97, %98, %99}, %100", "%101")
WG_RS_ANY(112, "m64n224k16", WG_D112, R112, "{%112, %113, %114, %115}, %116", "%117")
#undef WG_RS_ANY

// d += A . B, m64n64k16: B is one 64-column span (LBO unused).
template <typename T>
__device__ __forceinline__ void wgmma_rs(float (&d)[32], uint32_t a0,
                                         uint32_t a1, uint32_t a2, uint32_t a3,
                                         uint64_t db) {
#define WG_RS(TY)                                                          \
  asm volatile(                                                            \
      "{\n"                                                                \
      ".reg .pred p;\n"                                                    \
      "setp.ne.b32 p, %37, 0;\n"                                           \
      "wgmma.mma_async.sync.aligned.m64n64k16" WG_TY(TY) WG_D32            \
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"                         \
      "}\n"                                                                \
      : R32                                                                \
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1))
  if constexpr (kIsHalf<T>)
    WG_RS("f16");
  else
    WG_RS("bf16");
#undef WG_RS
}

#define WG_D20                                   \
  "{%0, %1, %2, %3, %4, %5, %6, %7, "            \
  "%8, %9, %10, %11, %12, %13, %14, %15, "       \
  "%16, %17, %18, %19}"
#define R20 R8(0), R8(8), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19])

// d += A . B, m64n40k16: B is a 32-column atom of the 64-byte swizzle and
// 8 columns of a second one LBO apart (D = 32: v, then the ones that sum p)
template <typename T>
__device__ __forceinline__ void wgmma_rs(float (&d)[20], uint32_t a0,
                                         uint32_t a1, uint32_t a2, uint32_t a3,
                                         uint64_t db) {
#define WG_RS(TY)                                                          \
  asm volatile(                                                            \
      "{\n"                                                                \
      ".reg .pred p;\n"                                                    \
      "setp.ne.b32 p, %25, 0;\n"                                           \
      "wgmma.mma_async.sync.aligned.m64n40k16" WG_TY(TY) WG_D20            \
      ", {%20, %21, %22, %23}, %24, p, 1, 1, 1;\n"                         \
      "}\n"                                                                \
      : R20                                                                \
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1))
  if constexpr (kIsHalf<T>)
    WG_RS("f16");
  else
    WG_RS("bf16");
#undef WG_RS
}

#define WG_D128 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, " \
  "%8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, " \
  "%24, %25, %26, %27, %28, %29, %30, %31, " \
  "%32, %33, %34, %35, %36, %37, %38, %39, " \
  "%40, %41, %42, %43, %44, %45, %46, %47, " \
  "%48, %49, %50, %51, %52, %53, %54, %55, " \
  "%56, %57, %58, %59, %60, %61, %62, %63, " \
  "%64, %65, %66, %67, %68, %69, %70, %71, " \
  "%72, %73, %74, %75, %76, %77, %78, %79, " \
  "%80, %81, %82, %83, %84, %85, %86, %87, " \
  "%88, %89, %90, %91, %92, %93, %94, %95, " \
  "%96, %97, %98, %99, %100, %101, %102, %103, " \
  "%104, %105, %106, %107, %108, %109, %110, %111, " \
  "%112, %113, %114, %115, %116, %117, %118, %119, " \
  "%120, %121, %122, %123, %124, %125, %126, %127}"
#define R128                                                            \
  R8(0), R8(8), R8(16), R8(24), R8(32), R8(40), R8(48), R8(56), R8(64), \
      R8(72), R8(80), R8(88), R8(96), R8(104), R8(112), R8(120)

// d += A . B, m64n256k16: B's four 64-column spans, LBO apart (D = 256).
template <typename T>
__device__ __forceinline__ void wgmma_rs(float (&d)[128], uint32_t a0,
                                         uint32_t a1, uint32_t a2, uint32_t a3,
                                         uint64_t db) {
#define WG_RS(TY)                                                          \
  asm volatile(                                                            \
      "{\n"                                                                \
      ".reg .pred p;\n"                                                    \
      "setp.ne.b32 p, %133, 0;\n"                                          \
      "wgmma.mma_async.sync.aligned.m64n256k16" WG_TY(TY) WG_D128          \
      ", {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n"                    \
      "}\n"                                                                \
      : R128                                                               \
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1))
  if constexpr (kIsHalf<T>)
    WG_RS("f16");
  else
    WG_RS("bf16");
#undef WG_RS
}

// two values as a pair of T (.x = lo: the low half), rounded to nearest
template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  if constexpr (kIsHalf<T>) {
    __half2 h = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&h);
  } else {
    __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);  // .x = lo: low half
    return *reinterpret_cast<uint32_t*>(&h);
  }
}

// two T as floats (the inverse of pack2)
template <typename T>
__device__ __forceinline__ float2 unpack2(uint32_t u) {
  if constexpr (kIsHalf<T>)
    return __half22float2(*reinterpret_cast<__half2*>(&u));
  else
    return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&u));
}

// out columns col and col + 1 (col even, below ld) of the row at p: one
// 4-byte store where ld is even; where it is odd the pair is not 4-byte
// aligned and its second column may lie past the row, so element by element
template <typename Elt>
__device__ __forceinline__ void store_pair(Elt* p, int col, int ld, float a, float b) {
  const uint32_t u = pack2<Elt>(a, b);
  if (ld & 1) {
    reinterpret_cast<uint16_t*>(p)[col] = (uint16_t)(u & 0xFFFFu);
    if (col + 1 < ld) reinterpret_cast<uint16_t*>(p)[col + 1] = (uint16_t)(u >> 16);
  } else {
    *reinterpret_cast<uint32_t*>(p + col) = u;
  }
}

// One consumer warpgroup on the serial schedule (D = 80, 120 and 128):
// q rows q0 + 64 wg .. + 63 against key tiles lo .. lo + n_iter - 1
// of KB keys (128, or 64 at D = 256), per tile q.k^T, wait, softmax, p.v,
// wait; writes those rows of `op` (rows of ld <= D elements).  Only the warp
// schedulers' interleaving of the two consumer warpgroups overlaps one's
// softmax with the other's products.
template <typename Elt, int D>
__device__ __forceinline__ void consume(
    uint32_t sQ, uint32_t sK, uint32_t sV, uint32_t bar_q, uint32_t bar_k,
    uint32_t bar_v, uint32_t bar_empty, int wg, int q0, int lo, int n_iter,
    Elt* __restrict__ op, int ld, int seq_len, int causal, float scale_log2,
    int window) {
  constexpr int R = WGeo<D>::ring, T = WGeo<D>::tile, KB = WGeo<D>::keys;
  // consumer warpgroup wg: q rows q0 + 64 wg .. + 63.  Accumulator layout
  // of m64nN: d[4j + e] is (row r, column 8j + 2c + e), d[4j + 2 + e] is
  // (row r + 8, the same column), r = 16 warp + lane / 4, c = lane % 4.
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32;
  const int c2 = 2 * (lane % 4);
  const int wrow = q0 + 64 * wg;  // first q row of this warpgroup
  const int row0 = wrow + 16 * warp + lane / 4, row1 = row0 + 8;

  constexpr int NV = pv_cols<D>();  // output columns p.v computes
  float o[NV / 2];
#pragma unroll
  for (int i = 0; i < NV / 2; ++i) o[i] = 0.0f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.0f, l1 = 0.0f;

  mbar_wait(bar_q, 0);
  for (int it = 0; it < n_iter; ++it) {
    const int s = it % R;
    const uint32_t phase = (it / R) & 1;
    mbar_wait(bar_k + 8 * s, phase);
    const uint32_t tK = sK + s * T, tV = sV + s * T;

    // scores = q . k^T over D: ceil(D/16) steps of 16, four per 64-column
    // span (columns past D are zeros in both tiles); a q span is 128 rows,
    // a k span KB rows
    float sc[KB / 2];
#pragma unroll
    for (int i = 0; i < KB / 2; ++i) sc[i] = 0.0f;
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < (D + 15) / 16; ++kk) {
      const uint32_t off = (kk % 4) * 32;
      wgmma_ss<Elt>(sc, sw128_desc(sQ + (kk / 4) * kHalfBytes + off + wg * 64 * 128, 16, 1024),
               sw128_desc(tK + (kk / 4) * WGeo<D>::span + off, 16, 1024), kk > 0);
    }
    wg_commit();
    wg_wait_all();
    fence_regs(sc);

    const int k0 = (lo + it) * KB;
    const bool edge = k0 + KB > seq_len ||
                      (causal && k0 + KB - 1 > wrow) ||
                      (window > 0 && k0 <= wrow + 63 - window);
    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int j = 0; j < KB / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float a = sc[4 * j + e] * scale_log2, b = sc[4 * j + 2 + e] * scale_log2;
        if (edge) {
          const int col = k0 + 8 * j + c2 + e;
          bool keep0 = true, keep1 = true;
          if (causal) {
            keep0 &= col <= row0;
            keep1 &= col <= row1;
          }
          if (window > 0) {
            keep0 &= col > row0 - window;
            keep1 &= col > row1 - window;
          }
          a = col >= seq_len ? -INFINITY : (keep0 ? a : kNegInf);
          b = col >= seq_len ? -INFINITY : (keep1 ? b : kNegInf);
        }
        sc[4 * j + e] = a;
        sc[4 * j + 2 + e] = b;
        mx0 = fmaxf(mx0, a);
        mx1 = fmaxf(mx1, b);
      }
    }
    // the four lanes of a row hold its KB scores
#pragma unroll
    for (int o_ = 1; o_ < 4; o_ <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, o_));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, o_));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float corr0 = exp2f(m0 - mn0), corr1 = exp2f(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float ls0 = 0.0f, ls1 = 0.0f;
#pragma unroll
    for (int j = 0; j < KB / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float p0 = exp2f(sc[4 * j + e] - mn0);
        const float p1 = exp2f(sc[4 * j + 2 + e] - mn1);
        sc[4 * j + e] = p0;
        sc[4 * j + 2 + e] = p1;
        ls0 += p0;
        ls1 += p1;
      }
    }
#pragma unroll
    for (int j = 0; j < NV / 8; ++j) {
      o[4 * j] *= corr0;
      o[4 * j + 1] *= corr0;
      o[4 * j + 2] *= corr1;
      o[4 * j + 3] *= corr1;
    }
    l0 = l0 * corr0 + ls0;  // this thread's share; the quad sums at the end
    l1 = l1 * corr1 + ls1;

    // o += p . v: p (bf16) is the A operand straight from the accumulator
    // layout, 16 keys a step; all NV columns of the v tile (past D zeros),
    // its spans WGeo<D>::span apart
    uint32_t pa[KB / 4];
#pragma unroll
    for (int i = 0; i < KB / 4; ++i) {
      pa[i] = pack2<Elt>(sc[2 * i], sc[2 * i + 1]);
      asm volatile("" : "+r"(pa[i])::"memory");
    }
    mbar_wait(bar_v + 8 * s, phase);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < KB / 16; ++kk)
      wgmma_rs<Elt>(o, pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2], pa[4 * kk + 3],
               sw128_desc(tV + kk * 16 * 128, WGeo<D>::span, 1024));
    wg_commit();
    wg_wait_all();
    fence_regs(o);
    mbar_arrive(bar_empty + 8 * s);
  }

#pragma unroll
  for (int o_ = 1; o_ < 4; o_ <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, o_);
    l1 += __shfl_xor_sync(0xffffffffu, l1, o_);
  }
  const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
  // col is even: a pair straddles column ld only where ld is odd (store_pair)
#pragma unroll
  for (int j = 0; j < NV / 8; ++j) {
    const int col = 8 * j + c2;
    if (col >= ld) continue;
    if (row0 < seq_len)
      store_pair(op + (size_t)row0 * ld, col, ld, o[4 * j] / d0, o[4 * j + 1] / d0);
    if (row1 < seq_len)
      store_pair(op + (size_t)row1 * ld, col, ld, o[4 * j + 2] / d1, o[4 * j + 3] / d1);
  }
}

__device__ __forceinline__ float ex2(float x) {  // 2^x, subnormals flushed
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The overlapped schedules' online softmax over one warpgroup's 64 x KB
// score tile, in place (the accumulator layout of m64nKB: sc[4j + e] is
// (row0, column k0 + 8j + c2 + e), sc[4j + 2 + e] is (row1, the same
// column)).  It updates the running maxima m0, m1 and this thread's share
// of the denominators l0, l1, and returns in corr0, corr1 the factors that
// bring o over the earlier tiles to the new maxima.  The exponentials are
// on the critical path here, so it spends fewer instructions an element
// than the serial schedule's softmax (consume): masked keys are -inf (a row
// always sees a valid key, and the keys before it contribute exactly 0
// either way, so this is the same function as -1e30), the maxima are over
// the unscaled scores (scale > 0), each exponent is one FMA, s * scale_log2
// - m * scale_log2, into ex2.approx.ftz, and the maxima and sums are trees
// of four chains.  kLazy (consume_wide, D = 256): a row's running maximum
// moves only when the tile's exceeds it by more than 8 in log2 units of the
// scaled scores (p then stays below 2^8, exact in float32 and as relatively
// precise in bf16), so corr is exactly 1 on most tiles and the caller skips
// o's rescale; o / l is the same function.  kShift (consume32 in
// float16): every p, and so l, is scaled by 2^kShift, the shift added to
// the exponent in its FMA (o / l is the same function; the maximum's p is
// exactly 2^kShift).  kSums = false (consume32, whose l comes from its p.v
// products): l0 and l1 are left as they are and no sums are taken.  kExact
// (float16): each exponent
// is (s - m) * scale_log2 instead, an FADD and an FMUL.  The FMA's
// -m * scale_log2 is rounded, so its p carry a common factor 2^delta
// (|delta| up to half a float32 ulp of m * scale_log2) that o / l cancels,
// except where rounding p to the operand type drops it: p = 1 at the
// maximum rounds to 1 in float16 (2^-10 apart above 1), while l keeps the
// factor.  That costs a few 1e-6 of the output, invisible under bf16's
// rounding, but as large as the float16 chunked route's own error where the
// scale is a power of two (D = 64 and 256).  With s - m the maximum's p is
// exactly 1.
template <int KB, bool kLazy, bool kExact, int kShift = 0, bool kSums = true>
__device__ __forceinline__ void online_softmax_fma(
    float (&sc)[KB / 2], int k0, int wrow, int row0, int row1, int c2, int seq_len,
    int causal, int window, float scale_log2, float& m0, float& m1, float& l0,
    float& l1, float& corr0, float& corr1) {
  const bool edge = k0 + KB > seq_len ||
                    (causal && k0 + KB - 1 > wrow) ||
                    (window > 0 && k0 <= wrow + 63 - window);
  if (edge) {
#pragma unroll
    for (int j = 0; j < KB / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = k0 + 8 * j + c2 + e;
        bool keep0 = col < seq_len, keep1 = col < seq_len;
        if (causal) {
          keep0 &= col <= row0;
          keep1 &= col <= row1;
        }
        if (window > 0) {
          keep0 &= col > row0 - window;
          keep1 &= col > row1 - window;
        }
        if (!keep0) sc[4 * j + e] = -INFINITY;
        if (!keep1) sc[4 * j + 2 + e] = -INFINITY;
      }
    }
  }
  float x0[4], x1[4];
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    x0[t] = sc[t % 2 + 4 * (t / 2)];
    x1[t] = sc[2 + t % 2 + 4 * (t / 2)];
  }
#pragma unroll
  for (int j = 2; j < KB / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int t = 2 * (j % 2) + e;
      x0[t] = fmaxf(x0[t], sc[4 * j + e]);
      x1[t] = fmaxf(x1[t], sc[4 * j + 2 + e]);
    }
  }
  float mx0 = fmaxf(fmaxf(x0[0], x0[1]), fmaxf(x0[2], x0[3]));
  float mx1 = fmaxf(fmaxf(x1[0], x1[1]), fmaxf(x1[2], x1[3]));
#pragma unroll
  for (int o_ = 1; o_ < 4; o_ <<= 1) {
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, o_));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, o_));
  }
  float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
  if constexpr (kLazy) {  // keep the old maximum unless it grew 2^8-fold
    if ((mn0 - m0) * scale_log2 <= 8.0f) mn0 = m0;
    if ((mn1 - m1) * scale_log2 <= 8.0f) mn1 = m1;
  }
  corr0 = ex2((m0 - mn0) * scale_log2);
  corr1 = ex2((m1 - mn1) * scale_log2);
  m0 = mn0;
  m1 = mn1;
  constexpr float kS = kShift;
  const float b0 = kShift ? fmaf(-mn0, scale_log2, kS) : -mn0 * scale_log2;
  const float b1 = kShift ? fmaf(-mn1, scale_log2, kS) : -mn1 * scale_log2;
  float s0[4] = {0.0f, 0.0f, 0.0f, 0.0f}, s1[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int j = 0; j < KB / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int t = 2 * (j % 2) + e;
      const float d0 = sc[4 * j + e] - mn0, d1 = sc[4 * j + 2 + e] - mn1;
      const float x0 = kExact ? (kShift ? fmaf(d0, scale_log2, kS) : d0 * scale_log2)
                              : fmaf(sc[4 * j + e], scale_log2, b0);
      const float x1 = kExact ? (kShift ? fmaf(d1, scale_log2, kS) : d1 * scale_log2)
                              : fmaf(sc[4 * j + 2 + e], scale_log2, b1);
      const float p0 = ex2(x0);
      const float p1 = ex2(x1);
      sc[4 * j + e] = p0;
      sc[4 * j + 2 + e] = p1;
      if constexpr (kSums) {
        s0[t] += p0;
        s1[t] += p1;
      }
    }
  }
  if constexpr (kSums) {
    l0 = l0 * corr0 + ((s0[0] + s0[1]) + (s0[2] + s0[3]));
    l1 = l1 * corr1 + ((s1[0] + s1[1]) + (s1[2] + s1[3]));
  }
}

// o *= corr by row (accumulator layout of m64nN, N = 8 * (NO / 4)).
template <int NO>
__device__ __forceinline__ void rescale(float (&o)[NO], float corr0, float corr1) {
#pragma unroll
  for (int j = 0; j < NO / 4; ++j) {
    o[4 * j] *= corr0;
    o[4 * j + 1] *= corr0;
    o[4 * j + 2] *= corr1;
    o[4 * j + 3] *= corr1;
  }
}

// p (float, the accumulator layout) as bf16 pairs in the A-operand layout
// of the p.v wgmma: registers 4kk .. 4kk + 3 hold keys 16kk .. 16kk + 15.
template <typename Elt>
__device__ __forceinline__ void pack_p(uint32_t (&pa)[32], const float (&sc)[64]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    pa[i] = pack2<Elt>(sc[2 * i], sc[2 * i + 1]);
    asm volatile("" : "+r"(pa[i])::"memory");
  }
}

// q.k^T of this warpgroup's 64 rows against k tile tK: ceil(D/16) steps of
// 16, four per 64-column span (columns past D are zeros in both tiles).
template <typename Elt, int D>
__device__ __forceinline__ void mma_qk(float (&sc)[64], uint32_t sQ,
                                         uint32_t tK, int wg) {
#pragma unroll
  for (int kk = 0; kk < (D + 15) / 16; ++kk) {
    const uint32_t off = (kk / 4) * kHalfBytes + (kk % 4) * 32;
    wgmma_ss<Elt>(sc, sw128_desc(sQ + off + wg * 64 * 128, 16, 1024),
             sw128_desc(tK + off, 16, 1024), kk > 0);
  }
}

// o += p . v: p (bf16) is the A operand from registers, 16 keys a step; v
// MN-major, the spans kHalfBytes apart.
template <typename Elt, int NO>
__device__ __forceinline__ void mma_pv(float (&o)[NO], const uint32_t (&pa)[32],
                                         uint32_t tV) {
#pragma unroll
  for (int kk = 0; kk < kWBK / 16; ++kk)
    wgmma_rs<Elt>(o, pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2], pa[4 * kk + 3],
             sw128_desc(tV + kk * 16 * 128, kHalfBytes, 1024));
}

// out = o / l for rows row0 and row1 of this thread, rows of ld elements,
// l summed over the four threads of a row unless each holds it whole
// (kQuadSum); col is even, so a pair straddles column ld only where ld is
// odd (store_pair).
template <typename Elt, int NO, bool kQuadSum = true>
__device__ __forceinline__ void store_rows(const float (&o)[NO], float l0, float l1,
                                           int row0, int row1, int c2,
                                           Elt* __restrict__ op, int ld,
                                           int seq_len) {
  if constexpr (kQuadSum) {  // else each thread holds its rows' whole l
#pragma unroll
    for (int o_ = 1; o_ < 4; o_ <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, o_);
      l1 += __shfl_xor_sync(0xffffffffu, l1, o_);
    }
  }
  const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
#pragma unroll
  for (int j = 0; j < NO / 4; ++j) {
    const int col = 8 * j + c2;
    if (col >= ld) continue;
    if (row0 < seq_len)
      store_pair(op + (size_t)row0 * ld, col, ld, o[4 * j] / d0, o[4 * j + 1] / d0);
    if (row1 < seq_len)
      store_pair(op + (size_t)row1 * ld, col, ld, o[4 * j + 2] / d1, o[4 * j + 3] / d1);
  }
}

// One consumer warpgroup on the overlapped schedule (D = 64, where a tile's
// exponentials take as long as its products): the two warpgroups take turns
// at the tensor cores (named barriers 1 and 2: a warpgroup starts its
// products only after the other has started its own, so one's softmax runs
// while the other's products do), and within a warpgroup q.k^T of tile j
// starts together with p.v of tile j - 1, so the softmax of tile j runs while
// p.v of tile j - 1 is on the tensor cores (wait_group 1, then 0).  o is
// therefore rescaled after p.v of tile j - 1 lands instead of before it:
// o = (o + p v) * corr where the serial schedule computes o * corr + p v.
template <typename Elt, int D>
__device__ __forceinline__ void consume_overlap(
    uint32_t sQ, uint32_t sK, uint32_t sV, uint32_t bar_q, uint32_t bar_k,
    uint32_t bar_v, uint32_t bar_empty, int wg, int q0, int lo, int n_iter,
    Elt* __restrict__ op, int ld, int seq_len, int causal, float scale_log2,
    int window) {
  constexpr int R = WGeo<D>::ring, T = WGeo<D>::tile;
  // accumulator rows: r = 16 warp + lane / 4 and r + 8; columns 8j + c2 + e
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32;
  const int c2 = 2 * (lane % 4);
  const int wrow = q0 + 64 * wg;  // first q row of this warpgroup
  const int row0 = wrow + 16 * warp + lane / 4, row1 = row0 + 8;

  float o[pv_cols<D>() / 2];
#pragma unroll
  for (int i = 0; i < pv_cols<D>() / 2; ++i) o[i] = 0.0f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.0f, l1 = 0.0f, corr0, corr1;
  float sc[64];
  uint32_t pa[32];

  static_assert(WGeo<D>::boxes == 1, "the overlapped schedule takes one span");
  static_assert(R >= 3, "a turn polls the next tile before releasing the last");
  mbar_wait(bar_q, 0);
  const int mine = 1 + wg, other = 2 - wg;  // named barriers: whose turn
  if (wg == 1) bar_arrive(other);           // warpgroup 0 goes first
  // tile 0: q.k^T and its softmax
  mbar_wait(bar_k, 0);
  bar_sync(mine);
  wg_fence();
  mma_qk<Elt, D>(sc, sQ, sK, wg);
  wg_commit();
  bar_arrive(other);
  // the next turn's operands are polled while q.k^T runs (the ring is deep
  // enough: tile it + 1 only needs tile it + 1 - R released)
  if (n_iter > 1) mbar_wait(bar_k + 8 * (1 % R), (1 / R) & 1);
  mbar_wait(bar_v, 0);
  wg_wait_all();
  fence_regs(sc);
  online_softmax_fma<kWBK, false, kIsHalf<Elt>>(sc, lo * kWBK, wrow, row0, row1, c2, seq_len,
                                  causal, window, scale_log2, m0, m1, l0, l1, corr0,
                                  corr1);
  pack_p<Elt>(pa, sc);  // o is 0: nothing to rescale
  for (int it = 1; it < n_iter; ++it) {
    const int s = it % R, sp = (it - 1) % R;
    bar_sync(mine);
    wg_fence();
    mma_qk<Elt, D>(sc, sQ, sK + s * T, wg);
    wg_commit();
    mma_pv<Elt>(o, pa, sV + sp * T);
    wg_commit();
    bar_arrive(other);
    if (it + 1 < n_iter) mbar_wait(bar_k + 8 * ((it + 1) % R), ((it + 1) / R) & 1);
    mbar_wait(bar_v + 8 * s, (it / R) & 1);
    wg_wait_one();  // q.k^T of tile it
    fence_regs(sc);
    online_softmax_fma<kWBK, false, kIsHalf<Elt>>(sc, (lo + it) * kWBK, wrow, row0, row1, c2,
                                    seq_len, causal, window, scale_log2, m0, m1, l0,
                                    l1, corr0, corr1);
    wg_wait_all();  // p.v of tile it - 1
    fence_regs(o);
    mbar_arrive(bar_empty + 8 * sp);
    rescale(o, corr0, corr1);
    pack_p<Elt>(pa, sc);
  }
  // p.v of the last tile.  Each warpgroup takes n_iter + 1 turns, so
  // warpgroup 1's last arrive would be one more than warpgroup 0 waits for.
  const int s = (n_iter - 1) % R;
  bar_sync(mine);
  wg_fence();
  mma_pv<Elt>(o, pa, sV + s * T);
  wg_commit();
  if (wg == 0) bar_arrive(other);
  wg_wait_all();
  fence_regs(o);
  mbar_arrive(bar_empty + 8 * s);
  store_rows(o, l0, l1, row0, row1, c2, op, ld, seq_len);
}

// k or v tile `it` (keys from lo + it) into its stage of ring `ring`, B
// boxes of 64 columns each, completing on the stage's barrier in `full`.
template <int D>
__device__ __forceinline__ void load_tile(uint32_t ring, uint32_t full,
                                          const CUtensorMap* map, int it, int lo,
                                          int kvh) {
  constexpr int B = WGeo<D>::boxes, T = WGeo<D>::tile, R = WGeo<D>::ring;
  constexpr int KB = WGeo<D>::keys, SP = WGeo<D>::span;
  const int s = it % R;
  mbar_expect_tx(full + 8 * s, T);
  for (int h = 0; h < B; ++h)
    tma_load(ring + s * T + h * SP, map, full + 8 * s, h * kHalf, (lo + it) * KB, kvh);
}

// --------------------------------- flash_wgmma_any's narrow loader
__device__ __forceinline__ void fence_proxy_async() {  // generic writes -> wgmma
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}
// bar.sync over the 128 threads of one warpgroup (ids 3 and 4; 1 and 2
// are the consumers' turns)
__device__ __forceinline__ void wg_bar(int id) {
  asm volatile("bar.sync %0, 128;" ::"r"(id) : "memory");
}
__device__ __forceinline__ uint32_t ld_shared(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared::cta.u32 %0, [%1];" : "=r"(v) : "r"(addr) : "memory");
  return v;
}

// Byte of the staging buffer at which rows copied from p start (load_raw).
template <typename Elt>
__device__ __forceinline__ uint32_t raw_skew(const Elt* p) {
  return (uint32_t)(reinterpret_cast<uint64_t>(p) & 15u);
}

// `rows` (>= 1) rows of ld elements from p, any even address, into the
// staging buffer x by one 1-D bulk copy completing on bar: the 16-byte
// aligned window around their bytes (each 16-byte piece of it holds one of
// their bytes, so it lies in their pages).
template <typename Elt>
__device__ __forceinline__ void load_raw(uint32_t x, uint32_t bar, const Elt* p, int rows,
                                         int ld) {
  const uint64_t s = reinterpret_cast<uint64_t>(p);
  const uint64_t a0 = s & ~15ull;
  const uint32_t bytes =
      (uint32_t)(((s + (uint64_t)rows * ld * sizeof(Elt) + 15) & ~15ull) - a0);
  mbar_expect_tx(bar, bytes);
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
      "[%3];" ::"r"(x),
      "l"(a0), "r"(bytes), "r"(bar)
      : "memory");
}

// The staging buffer x (rows of ld 16-bit elements from byte `skew` on) as
// a tile of KR rows in the 128-byte swizzle at dst, NC chunks of 8 elements
// a row: chunk j of row r at dst + (j / 8) span + 128 r + 16 ((j % 8) ^ (r %
// 8)), columns from ld and rows from `rows` on zeros.  NT threads: thread t
// takes row t % KR and its NT / KR-th part of the chunks, in order, so a
// chunk is four 4-byte words read at the row's offset (a multiple of 2)
// from the 4-byte word before it, the last kept for the next chunk, and
// byte-permuted where the row starts half a word in; a warp reads 32 rows
// and writes 32 chunks in distinct 16-byte positions of their lines.
template <int NC, int KR, int NT>
__device__ __forceinline__ void relayout(uint32_t dst, uint32_t span, uint32_t x,
                                         uint32_t skew, int rows, int ld, int t) {
  static_assert(NT % KR == 0, "whole rows a thread group");
  constexpr int P = NT / KR, PER = (NC + P - 1) / P;
  const int r = t % KR, j0 = (t / KR) * PER;
  const int elems = r < rows ? ld : 0;
  const uint32_t off = skew + 2u * (uint32_t)(r * ld) + 16u * j0;
  const uint32_t sel = (off & 2u) ? 0x5432u : 0x3210u;
  uint32_t a = x + (off & ~3u), w0 = 0u;
  if (elems > 8 * j0) asm volatile("ld.shared.b32 %0, [%1];" : "=r"(w0) : "r"(a));
#pragma unroll 4
  for (int j = j0; j < j0 + PER && j < NC; ++j, a += 16) {
    const int cnt = elems - 8 * j;  // the row's elements from this chunk on
    uint32_t w[4] = {0u, 0u, 0u, 0u};
    if (cnt > 0) {
      uint32_t n[4];
      asm volatile("ld.shared.b32 %0, [%1];" : "=r"(n[0]) : "r"(a + 4));
      asm volatile("ld.shared.b32 %0, [%1];" : "=r"(n[1]) : "r"(a + 8));
      asm volatile("ld.shared.b32 %0, [%1];" : "=r"(n[2]) : "r"(a + 12));
      asm volatile("ld.shared.b32 %0, [%1];" : "=r"(n[3]) : "r"(a + 16));
      w[0] = __byte_perm(w0, n[0], sel);
#pragma unroll
      for (int m = 1; m < 4; ++m) w[m] = __byte_perm(n[m - 1], n[m], sel);
      w0 = n[3];
      if (cnt < 8) {
#pragma unroll
        for (int m = 0; m < 4; ++m)
          w[m] = 2 * m >= cnt ? 0u : 2 * m + 1 >= cnt ? (w[m] & 0xFFFFu) : w[m];
      }
    }
    asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};" ::"r"(
                     dst + (j >> 3) * span + r * 128 + ((uint32_t)((j & 7) ^ (r & 7)) << 4)),
                 "r"(w[0]), "r"(w[1]), "r"(w[2]), "r"(w[3])
                 : "memory");
  }
}

// The producer warpgroup of flash_wgmma_any at D <= 128 for narrow rows:
// items q, k tile 0, v tile 0, k tile 1, ... each through staging buffer
// i % NX (its copy issued NX items ahead, once the buffer's last reader is
// done), rewritten into its place (a k tile's once the ring stage is
// released) by the warpgroup's 128 threads, each arriving on the place's
// barrier after fence.proxy.async.
template <typename Elt, int D>
__device__ __forceinline__ void produce_narrow(
    const Elt* qh, const Elt* kh, const Elt* vh, uint32_t sQ, uint32_t sK, uint32_t sV,
    uint32_t bar_q, uint32_t bar_k, uint32_t bar_v, uint32_t bar_empty, uint32_t xs,
    uint32_t bar_x, int q0, int lo, int n_iter, int ld, int seq_len) {
  constexpr int R = WGeo<D>::ring, T = WGeo<D>::tile, KB = WGeo<D>::keys;
  constexpr int X = WGeo<D>::xbytes, NX = WGeo<D>::nx;
  static_assert(KB == kWBQ && WGeo<D>::span == kHalfBytes, "q and a k/v tile alike");
  static_assert(NX >= 2, "a copy in flight while a buffer is rewritten");
  const int t = threadIdx.x % 128, n = 1 + 2 * n_iter;
  // item i's first row (the q tile's, or k or v tile (i - 1) / 2's) and its
  // rows below seq_len
  auto rows_of = [&](int i, const Elt*& p) {
    const int r0 = i == 0 ? q0 : (lo + (i - 1) / 2) * KB;
    p = (i == 0 ? qh : (i & 1) ? kh : vh) + (size_t)r0 * ld;
    return min(KB, seq_len - r0);
  };
  auto issue = [&](int i) {
    if (t == 0 && i < n) {
      const Elt* p;
      const int rows = rows_of(i, p);
      fence_proxy_async();
      load_raw(xs + (i % NX) * X, bar_x + 8 * (i % NX), p, rows, ld);
    }
  };
  for (int i = 0; i < NX; ++i) issue(i);
  for (int i = 0; i < n; ++i) {
    const int tile = (i - 1) / 2, s = tile % R;
    uint32_t dst = sQ, bar = bar_q;
    if (i > 0 && (i & 1)) {  // k tile `tile`, once its stage is released
      mbar_wait(bar_empty + 8 * s, ((tile / R) & 1) ^ 1);
      dst = sK + s * T;
      bar = bar_k + 8 * s;
    } else if (i > 0) {
      dst = sV + s * T;
      bar = bar_v + 8 * s;
    }
    const Elt* p;
    const int rows = rows_of(i, p);
    mbar_wait(bar_x + 8 * (i % NX), (i / NX) & 1);
    relayout<D / 8, KB, 128>(dst, kHalfBytes, xs + (i % NX) * X, raw_skew(p), rows, ld, t);
    fence_proxy_async();
    mbar_arrive(bar);
    wg_bar(3);  // buffer i % NX read by every thread
    issue(i + NX);
  }
}

// Once consume_wide has read k tile kt and v tile vt (-1: none) in its
// j-th release (j = kt): every consumer thread arrives on release j's
// `read` barrier (slot j % R), and thread 0 of each warpgroup counts at
// the slot's counter; the one that counts second waits for the barrier and
// loads k tile kt + R and v tile vt + R into the freed stages.
template <int D>
__device__ __forceinline__ void refill(uint32_t read, uint32_t cnt, uint32_t sK,
                                       uint32_t sV, uint32_t bar_k, uint32_t bar_v,
                                       const CUtensorMap* tm_k, const CUtensorMap* tm_v,
                                       int j, int kt, int vt, int n_iter, int lo,
                                       int kvh) {
  constexpr int R = WGeo<D>::ring;
  const int s = j % R;
  const bool k_next = kt >= 0 && kt + R < n_iter, v_next = vt >= 0 && vt + R < n_iter;
  mbar_arrive(read + 8 * s);
  if (threadIdx.x % 128 == 0 && (k_next || v_next) &&
      (atom_add_shared(cnt + 4 * s, 1u) & 1u)) {
    mbar_wait(read + 8 * s, (j / R) & 1);
    if (k_next) load_tile<D>(sK, bar_k, tm_k, kt + R, lo, kvh);
    if (v_next) load_tile<D>(sV, bar_v, tm_v, vt + R, lo, kvh);
  }
}

// Where consume_wide's row is narrow, the block's staging: buffers xs (nx
// of them), their barriers bar_x, the start-up barriers bar_s, a refill flag
// a warpgroup, and the k and v heads' first rows.
template <typename Elt>
struct Narrow {
  uint32_t xs, bar_x, bar_s, flag;
  const Elt* kh;
  const Elt* vh;
};

// refill for narrow rows, with two staging buffers (96, 160, 192).  Thread
// 0 of each warpgroup counts at release j's counter and passes its place to
// the warpgroup (a flag and named barrier 3 + wg).  Both warpgroups wait
// for release j, then the one that counted second rewrites k tile kt + R
// from buffer 0 into its freed stage and the first v tile vt + R from
// buffer 1 (128 arrivals a barrier), so each rewrites one tile; each then
// copies its stream's next tile into its buffer (k tile m is buffer 0's
// m-th copy, the start-up's included; v tile m from 2 on buffer 1's (m -
// 2)-th), a refill ahead.
template <typename Elt, int D>
__device__ __forceinline__ void refill_narrow(uint32_t read, uint32_t cnt, uint32_t sK,
                                              uint32_t sV, uint32_t bar_k, uint32_t bar_v,
                                              const Narrow<Elt>& nw, int wg, int j, int kt,
                                              int vt, int n_iter, int lo, int ld,
                                              int seq_len) {
  constexpr int R = WGeo<D>::ring, T = WGeo<D>::tile, KB = WGeo<D>::keys;
  constexpr int X = WGeo<D>::xbytes;
  static_assert(WGeo<D>::nx == 2, "a staging buffer for each stream");
  const int s = j % R, t = threadIdx.x % 128;
  const bool k_next = kt >= 0 && kt + R < n_iter, v_next = vt >= 0 && vt + R < n_iter;
  mbar_arrive(read + 8 * s);
  // 0: no tile to load; 1: counted first; 2: counted second
  if (t == 0)
    st_shared(nw.flag + 4 * wg,
              (k_next || v_next) ? 1u + (atom_add_shared(cnt + 4 * s, 1u) & 1u) : 0u);
  wg_bar(3 + wg);
  const uint32_t place = ld_shared(nw.flag + 4 * wg);
  if (place == 0) return;
  mbar_wait(read + 8 * s, (j / R) & 1);
  auto rows_of = [&](const Elt* h, int tile, const Elt*& p) {
    const int r0 = (lo + tile) * KB;
    p = h + (size_t)r0 * ld;
    return min(KB, seq_len - r0);
  };
  auto put = [&](const Elt* h, int tile, uint32_t ring, uint32_t bar, uint32_t x) {
    const Elt* p;
    const int rows = rows_of(h, tile, p);
    relayout<D / 8, KB, 128>(ring + (tile % R) * T, WGeo<D>::span, x, raw_skew(p), rows, ld,
                             t);
    fence_proxy_async();
    mbar_arrive(bar + 8 * (tile % R));
  };
  auto fetch = [&](const Elt* h, int tile, uint32_t x, uint32_t bx) {
    if (t == 0 && tile < n_iter) {
      const Elt* p;
      const int rows = rows_of(h, tile, p);
      fence_proxy_async();
      load_raw(x, bx, p, rows, ld);
    }
  };
  if (place == 2) {
    if (k_next) {
      mbar_wait(nw.bar_x, (kt + R) & 1);
      put(nw.kh, kt + R, sK, bar_k, nw.xs);
    }
    wg_bar(3 + wg);  // buffer 0 read
    fetch(nw.kh, kt + R + 1, nw.xs, nw.bar_x);
  } else {
    if (v_next) {
      mbar_wait(nw.bar_x + 8, (vt + R) & 1);
      put(nw.vh, vt + R, sV, bar_v, nw.xs + X);
    }
    wg_bar(3 + wg);  // buffer 1 read
    fetch(nw.vh, vt + R + 1, nw.xs + X, nw.bar_x + 8);
  }
}

// consume_wide's start for narrow rows, all 256 threads: q's two 64-row
// halves by way of the v stages and k tile 0 by way of buffer 0, then v
// tile 0 by way of v stage 1, v tile 1 by way of k stage 1 and k tile 1 by
// way of buffer 0 (each staging place rewritten before it is a tile's), the
// copies of a round in flight together; warpgroup 0 then arrives on the
// barriers of what was loaded, and thread 0 issues k tile 2's copy.
template <typename Elt, int D>
__device__ __forceinline__ void start_narrow(const Elt* qh, uint32_t sQ, uint32_t sK,
                                             uint32_t sV, uint32_t bar_q, uint32_t bar_k,
                                             uint32_t bar_v, const Narrow<Elt>& nw, int q0,
                                             int lo, int n_iter, int ld, int seq_len) {
  constexpr int T = WGeo<D>::tile, KB = WGeo<D>::keys, SP = WGeo<D>::span, NC = D / 8;
  static_assert(WGeo<D>::xbytes <= T, "a stage holds a tile's raw rows");
  const int t = threadIdx.x;
  const int qrows = seq_len - q0;  // >= 1; rows from 64 on may be none
  const Elt* q1 = qh + (qrows > 64 ? 64 * ld : 0);
  auto rows_of = [&](const Elt* h, int tile, const Elt*& p) {
    const int r0 = (lo + tile) * KB;
    p = h + (size_t)r0 * ld;
    return min(KB, seq_len - r0);
  };
  const Elt *k0, *k1, *v0, *v1;
  const int nk0 = rows_of(nw.kh, 0, k0), nv0 = rows_of(nw.vh, 0, v0);
  const int nk1 = n_iter > 1 ? rows_of(nw.kh, 1, k1) : 0;
  const int nv1 = n_iter > 1 ? rows_of(nw.vh, 1, v1) : 0;
  if (t == 0) {
    load_raw(sV, nw.bar_s, qh, min(64, qrows), ld);
    load_raw(sV + T, nw.bar_s + 8, q1, qrows > 64 ? min(64, qrows - 64) : 1, ld);
    load_raw(nw.xs, nw.bar_x, k0, nk0, ld);
  }
  mbar_wait(nw.bar_s, 0);
  mbar_wait(nw.bar_s + 8, 0);
  mbar_wait(nw.bar_x, 0);
  relayout<NC, 64, 256>(sQ, kHalfBytes, sV, raw_skew(qh), min(64, qrows), ld, t);
  relayout<NC, 64, 256>(sQ + 64 * 128, kHalfBytes, sV + T, raw_skew(q1), qrows - 64, ld, t);
  relayout<NC, KB, 256>(sK, SP, nw.xs, raw_skew(k0), nk0, ld, t);
  fence_proxy_async();
  __syncthreads();
  if (t == 0) {
    load_raw(sV + T, nw.bar_s + 8, v0, nv0, ld);
    if (n_iter > 1) {
      load_raw(sK + T, nw.bar_s, v1, nv1, ld);
      load_raw(nw.xs, nw.bar_x, k1, nk1, ld);
    }
  }
  mbar_wait(nw.bar_s + 8, 1);
  relayout<NC, KB, 256>(sV, SP, sV + T, raw_skew(v0), nv0, ld, t);
  fence_proxy_async();
  __syncthreads();
  if (n_iter > 1) {
    mbar_wait(nw.bar_s, 1);
    relayout<NC, KB, 256>(sV + T, SP, sK + T, raw_skew(v1), nv1, ld, t);
    fence_proxy_async();
    __syncthreads();
    mbar_wait(nw.bar_x, 1);
    relayout<NC, KB, 256>(sK + T, SP, nw.xs, raw_skew(k1), nk1, ld, t);
    fence_proxy_async();
    __syncthreads();
  }
  if (t < 128) {
    mbar_arrive(bar_q);
    for (int s = 0; s < 2 && s < n_iter; ++s) {
      mbar_arrive(bar_k + 8 * s);
      mbar_arrive(bar_v + 8 * s);
    }
  }
  if (t == 0 && n_iter > 2) {
    const Elt* k2;
    const int nk2 = rows_of(nw.kh, 2, k2);
    load_raw(nw.xs, nw.bar_x, k2, nk2, ld);
  }
}

// One consumer warpgroup at D = 256 (and flash_wgmma_any at 96 and 160 ..
// 224, o at D / 2 floats; at 96 the tiles are 128 keys), overlapped within
// the warpgroup: q.k^T
// of tile j is issued together with p.v of tile j - 1, the softmax of tile
// j runs while p.v of tile j - 1 is on the tensor cores (wait_group 1, then
// 0), and the bf16 p of tile j - 1 stays in registers until that product
// retires.  o is rescaled after p.v of tile j - 1 lands: o = (o + p v) *
// corr, and only when a row's lazy maximum moved (online_softmax_fma).
// Live across the softmax: o (128 floats), the scores (KB / 2) and the last
// tile's p (KB / 4).  The two warpgroups take turns issuing their products
// (named barriers 1 and 2, as consume_overlap), so one's softmax runs while
// the other's products do.  There is no producer: after each iteration's
// products the consumers release k tile j (q.k^T has retired) and v tile
// j - 1, and the warpgroup that releases them second refills their stages
// with tiles j + R and j - 1 + R (refill; for narrow rows refill_narrow),
// k a tile ahead of v.
template <typename Elt, int D, bool kAny>
__device__ __forceinline__ void consume_wide(
    uint32_t sQ, uint32_t sK, uint32_t sV, uint32_t bar_q, uint32_t bar_k,
    uint32_t bar_v, uint32_t bar_read, uint32_t cnt, int wg, int q0, int lo,
    int n_iter, Elt* __restrict__ op, int ld, int seq_len, int causal,
    float scale_log2, int window, const CUtensorMap* tm_k, const CUtensorMap* tm_v,
    int kvh, bool narrow, const Narrow<Elt>& nw) {
  constexpr int R = WGeo<D>::ring, T = WGeo<D>::tile, KB = WGeo<D>::keys;
  constexpr int SP = WGeo<D>::span;
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32;
  const int c2 = 2 * (lane % 4);
  const int wrow = q0 + 64 * wg;  // first q row of this warpgroup
  const int row0 = wrow + 16 * warp + lane / 4, row1 = row0 + 8;

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.0f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.0f, l1 = 0.0f, corr0, corr1;
  float sc[KB / 2];
  uint32_t pa[KB / 4];

  // q.k^T of tile `it` into sc: D / 16 steps, four per 64-column span
  auto qk = [&](int it) {
    const uint32_t tK = sK + (it % R) * T;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off = (kk % 4) * 32;
      wgmma_ss<Elt>(sc, sw128_desc(sQ + (kk / 4) * kHalfBytes + off + wg * 64 * 128, 16, 1024),
               sw128_desc(tK + (kk / 4) * SP + off, 16, 1024), kk > 0);
    }
  };
  // o += p . v of tile `it`: KB / 16 steps of m64n256k16, v's spans SP apart
  auto pv = [&](int it) {
    const uint32_t tV = sV + (it % R) * T;
#pragma unroll
    for (int kk = 0; kk < KB / 16; ++kk)
      wgmma_rs<Elt>(o, pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2], pa[4 * kk + 3],
               sw128_desc(tV + kk * 16 * 128, SP, 1024));
  };
  auto softmax = [&](int k0) {
    online_softmax_fma<KB, true, kIsHalf<Elt>>(sc, k0, wrow, row0, row1, c2, seq_len, causal,
                                                window,
                                 scale_log2, m0, m1, l0, l1, corr0, corr1);
  };
  auto pack = [&]() {
#pragma unroll
    for (int i = 0; i < KB / 4; ++i) {
      pa[i] = pack2<Elt>(sc[2 * i], sc[2 * i + 1]);
      asm volatile("" : "+r"(pa[i])::"memory");
    }
  };
  // release k tile kt and v tile vt (-1: none) and refill their stages
  auto release = [&](int j, int kt, int vt) {
    if constexpr (kAny && WGeo<D>::narrow) {
      if (narrow) {
        refill_narrow<Elt, D>(bar_read, cnt, sK, sV, bar_k, bar_v, nw, wg, j, kt, vt, n_iter,
                              lo, ld, seq_len);
        return;
      }
    }
    refill<D>(bar_read, cnt, sK, sV, bar_k, bar_v, tm_k, tm_v, j, kt, vt, n_iter, lo, kvh);
  };

  const int mine = 1 + wg, other = 2 - wg;  // named barriers: whose turn
  mbar_wait(bar_q, 0);
  mbar_wait(bar_k, 0);
  if (wg == 1) bar_arrive(other);  // warpgroup 0 goes first
  bar_sync(mine);
  wg_fence();
  qk(0);
  wg_commit();
  bar_arrive(other);
  wg_wait_all();
  fence_regs(sc);
  release(0, 0, -1);
  softmax(lo * KB);
  pack();  // o is 0: nothing to rescale
  for (int it = 1; it < n_iter; ++it) {
    mbar_wait(bar_k + 8 * (it % R), (it / R) & 1);
    mbar_wait(bar_v + 8 * ((it - 1) % R), ((it - 1) / R) & 1);
    bar_sync(mine);
    wg_fence();
    qk(it);
    wg_commit();
    pv(it - 1);
    wg_commit();
    bar_arrive(other);
    wg_wait_one();  // q.k^T of tile it
    fence_regs(sc);
    softmax((lo + it) * KB);
    wg_wait_all();  // p.v of tile it - 1
    fence_regs(o);
    // refilled with no product in flight (a refill's atomics and copies
    // between a wgmma and its wait make ptxas serialise every wgmma)
    release(it, it, it - 1);
    if (corr0 != 1.0f || corr1 != 1.0f) rescale(o, corr0, corr1);
    pack();
  }
  // p.v of the last tile.  Each warpgroup takes n_iter + 1 turns, so
  // warpgroup 1's last arrive would be one more than warpgroup 0 waits for.
  mbar_wait(bar_v + 8 * ((n_iter - 1) % R), ((n_iter - 1) / R) & 1);
  bar_sync(mine);
  wg_fence();
  pv(n_iter - 1);
  wg_commit();
  if (wg == 0) bar_arrive(other);
  wg_wait_all();
  fence_regs(o);
  store_rows(o, l0, l1, row0, row1, c2, op, ld, seq_len);
}

// One consumer warpgroup at D = 32 (flash_wgmma<T, 32> and
// flash_wgmma_any<T, 32>, rows of 1 to 32 elements).  At 32/4 x 32, S =
// 2048, causal, the products are 8.6 GFLOP (0.0087 ms at 989 TFLOP/s) and
// the 67 M exponentials about 0.017 ms on the SMs' MUFU lanes, but what
// sets the pace is the instructions a score takes on the way from q.k to
// p.v (a maximum, an FMA, ex2, p's split) and the latency between the
// tile's steps, which more warps hide.  So: (1) rows of 64 bytes in the
// 64-byte swizzle (TMA and the sw64_desc descriptors, no padding to
// 128-byte spans), q 8 KB, k and v tiles of k32Keys keys (4 KB) in a ring
// of k32Ring stages, no producer (the consumers refill, as consume_wide
// does), so that a block keeps to 128 registers a thread and two blocks,
// 16 warps, share an SM (WGeo<32>::blocks; 64-key tiles); (2) each
// warpgroup runs q.k^T (two k-steps of m64n64k16 on q and k as they are:
// exact products, float32 sums, the scale applied after), its softmax and
// p.v in turn, and the warps of the four warpgroups on an SM overlap one
// another (taking turns at the tensor cores, overlapping q.k^T of tile j
// with p.v of tile j - 1, 128- or 256-key tiles, or some exponentials on
// the FMA pipes each measured slower: PERF.md); (3) the softmax is
// online_softmax_fma's (maxima over the unscaled scores, scale > 0, the
// lazy maximum; in float16 (s - m) * scale_log2 + 7, so p and l carry 2^7
// and p's pair clears float16's subnormals: the lazy maximum keeps p below
// 2^15); (4) the output keeps one 16-bit ulp of the plain version: p.v
// takes p as a pair, hi (bf16: p truncated, the top half of its bits;
// float16: p rounded) and lo = p - hi rounded, m64n40k16 for each, and the
// 8 columns past v's 32 read a tile of ones, so the same products give l
// = sum of hi + lo in float32 (each thread holds its rows' whole l; the
// softmax takes no sums of its own: kSums = false).  p rounded once misses that rule
// (tests/test_torch_head_dim32.py).  A warpgroup skips the block's last
// tile where the causal mask hides it from all its rows.
template <typename Elt>
__device__ __forceinline__ void consume32(
    uint32_t sQ, uint32_t sK, uint32_t sV, uint32_t bar_q, uint32_t bar_k,
    uint32_t bar_v, uint32_t bar_read, uint32_t cnt, int wg, int q0, int lo,
    int n_iter, Elt* __restrict__ op, int ld, int seq_len, int causal,
    float scale_log2, int window, const CUtensorMap* tm_k, const CUtensorMap* tm_v,
    int kvh) {
  using G = WGeo<k32Cols>;
  constexpr int R = G::ring, T = G::tile, KB = G::keys;
  constexpr int kShift = kIsHalf<Elt> ? 7 : 0;  // float16: p and l carry 2^7
  const uint32_t sOnes = sV + R * T;            // the ones tile after the v ring
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32;
  const int c2 = 2 * (lane % 4);
  const int wrow = q0 + 64 * wg;  // first q row of this warpgroup
  const int row0 = wrow + 16 * warp + lane / 4, row1 = row0 + 8;

  // o: v's 32 columns, then 8 of l (o[16] row0's, o[18] row1's)
  float o[k32Cols / 2 + 4];
#pragma unroll
  for (int i = 0; i < k32Cols / 2 + 4; ++i) o[i] = 0.0f;
  // no_l0, no_l1: online_softmax_fma's sums, which it leaves as they are
  // (kSums = false: l is o[16] and o[18], from p.v)
  float m0 = kNegInf, m1 = kNegInf, no_l0 = 0.0f, no_l1 = 0.0f, corr0, corr1;
  float sc[KB / 2];
  uint32_t ph[KB / 4], pl[KB / 4];

  // q.k^T of tile `it` into sc: two k-steps of 16 columns, 32 bytes apart
  // in the 64-byte rows
  auto qk = [&](int it) {
    const uint32_t tK = sK + (it % R) * T;
#pragma unroll
    for (int kk = 0; kk < k32Cols / 16; ++kk)
      wgmma_ss<Elt>(sc, sw64_desc(sQ + wg * 64 * k32RowBytes + kk * 32, 16, 512),
                    sw64_desc(tK + kk * 32, 16, 512), kk > 0);
  };
  // [o | l] += p . [v | ones] of tile `it`: KB / 16 k-steps of 16 keys,
  // hi and lo each; the ones' rows for the step lie LBO past v's
  auto pv = [&](int it) {
    const uint32_t tV = sV + (it % R) * T;
#pragma unroll
    for (int kk = 0; kk < KB / 16; ++kk) {
      const uint64_t dv = sw64_desc(tV + kk * 16 * k32RowBytes, sOnes - tV, 512);
      wgmma_rs<Elt>(o, ph[4 * kk], ph[4 * kk + 1], ph[4 * kk + 2], ph[4 * kk + 3], dv);
      wgmma_rs<Elt>(o, pl[4 * kk], pl[4 * kk + 1], pl[4 * kk + 2], pl[4 * kk + 3], dv);
    }
  };
  auto softmax = [&](int k0) {
    online_softmax_fma<KB, true, kIsHalf<Elt>, kShift, false>(
        sc, k0, wrow, row0, row1, c2, seq_len, causal, window, scale_log2, m0, m1, no_l0, no_l1,
        corr0, corr1);
  };
  // p as the pair hi + lo, the A operand of p.v.  bf16: hi is p truncated
  // (its bits' top half: one LOP3 and half a PRMT an element, no unpack),
  // lo = p - hi exact in float32, rounded once; float16: hi = round(p)
  auto split = [&]() {
#pragma unroll
    for (int i = 0; i < KB / 4; ++i) {
      const float a = sc[2 * i], b = sc[2 * i + 1];
      if constexpr (kIsHalf<Elt>) {
        ph[i] = pack2<Elt>(a, b);
        const float2 h = unpack2<Elt>(ph[i]);
        pl[i] = pack2<Elt>(a - h.x, b - h.y);
      } else {
        const uint32_t ha = __float_as_uint(a) & 0xFFFF0000u;
        const uint32_t hb = __float_as_uint(b) & 0xFFFF0000u;
        ph[i] = __byte_perm(ha, hb, 0x7632);
        pl[i] = pack2<Elt>(a - __uint_as_float(ha), b - __uint_as_float(hb));
      }
      asm volatile("" : "+r"(ph[i]), "+r"(pl[i])::"memory");
    }
  };
  // release k tile kt and v tile vt and refill their stages
  auto release = [&](int j, int kt, int vt) {
    refill<k32Cols>(bar_read, cnt, sK, sV, bar_k, bar_v, tm_k, tm_v, j, kt, vt, n_iter, lo,
                    kvh);
  };

  mbar_wait(bar_q, 0);
  // the block's last tile, where it lies wholly past this warpgroup's
  // causal diagonal (warpgroup 0's at 64-key tiles), is skipped: its p
  // would all be 0, and its release would refill nothing (tile n_iter - 1
  // + R is past the range)
  const int n_mine = causal && (lo + n_iter - 1) * KB > wrow + 63 ? n_iter - 1 : n_iter;
  for (int it = 0; it < n_mine; ++it) {
    mbar_wait(bar_k + 8 * (it % R), (it / R) & 1);
    wg_fence();
    qk(it);
    wg_commit();
    wg_wait_all();
    fence_regs(sc);
    softmax((lo + it) * KB);
    if (corr0 != 1.0f || corr1 != 1.0f) rescale(o, corr0, corr1);
    split();
    mbar_wait(bar_v + 8 * (it % R), (it / R) & 1);
    fence_regs(o);
    wg_fence();
    pv(it);
    wg_commit();
    wg_wait_all();
    fence_regs(o);
    release(it, it, it);
  }
  store_rows<Elt, k32Cols / 2 + 4, false>(o, o[16], o[18], row0, row1, c2, op, ld, seq_len);
}

// The block of flash_wgmma and flash_wgmma_any.  kAny: rows of ld <= D
// elements (a runtime argument), by TMA where their bytes are whole 16-byte
// pieces and else by the narrow loader from qp, kp and vp; else rows of
// exactly D, the stride a constant, as the kernels at the compiled widths
// always had.
template <typename Elt, int D, bool kAny>
__device__ __forceinline__ void flash_wgmma_block(
    const CUtensorMap* tm_q, const CUtensorMap* tm_k, const CUtensorMap* tm_v,
    const Elt* qp, const Elt* kp, const Elt* vp, Elt* __restrict__ out, int ld_arg,
    int seq_len, int group, int causal, float scale_log2, int window) {
  const int ld = kAny ? ld_arg : D;
  const bool narrow = kAny && WGeo<D>::narrow && ld % 8 != 0;
  constexpr int B = WGeo<D>::boxes, T = WGeo<D>::tile, R = WGeo<D>::ring;
  constexpr int QT = WGeo<D>::qtile, KB = WGeo<D>::keys;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t sQ = base;
  const uint32_t sK = sQ + QT;
  const uint32_t sV = sK + R * T;
  const uint32_t bar_q = sV + R * T + WGeo<D>::ones;
  const uint32_t bar_k = bar_q + 8;          // k landed, a stage each
  const uint32_t bar_v = bar_k + 8 * R;      // v landed
  const uint32_t bar_empty = bar_v + 8 * R;  // both read
  // the narrow loader's (flash_wgmma_any): staging buffers, their barriers,
  // the start-up barriers, the refill flags
  const uint32_t xs = base + WGeo<D>::stage_at;
  const uint32_t bar_x = xs + WGeo<D>::nx * WGeo<D>::xbytes;

  const int bh = blockIdx.x;
  const int qt = gridDim.y - 1 - blockIdx.y;  // longest causal tiles first
  const int q0 = qt * kWBQ;
  // key tiles of KB keys this q tile can see (kernel.py:54-62); a negative
  // lo is clamped to 0
  const int n_kt = (seq_len + KB - 1) / KB;
  const int hi = causal ? min((q0 + kWBQ - 1) / KB + 1, n_kt) : n_kt;
  const int lo = window > 0 ? max((q0 - window + 1) / KB, 0) : 0;
  const int n_iter = hi - lo;

  if (threadIdx.x == 0) {
    // a tile the narrow loader rewrites lands when its 128 writers arrive
    const int landed = narrow ? 128 : 1;
    mbar_init(bar_q, landed);
    for (int s = 0; s < R; ++s) {
      mbar_init(bar_k + 8 * s, landed);
      mbar_init(bar_v + 8 * s, landed);
      mbar_init(bar_empty + 8 * s, kConsumers * 128);
      if constexpr (WGeo<D>::self_load) st_shared(bar_empty + 8 * R + 4 * s, 0u);  // counters
    }
    if (narrow)
      for (int b = 0; b < WGeo<D>::nx + 2; ++b) mbar_init(bar_x + 8 * b, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  if constexpr (WGeo<D>::r64) {  // the ones tile (consume32's row sums)
    const uint32_t one = kIsHalf<Elt> ? 0x3C003C00u : 0x3F803F80u;
    for (int i = threadIdx.x; i < WGeo<D>::ones / 16; i += blockDim.x)
      asm volatile("st.shared.v4.b32 [%0], {%1, %1, %1, %1};" ::"r"(sV + R * T + 16 * i),
                   "r"(one)
                   : "memory");
    fence_proxy_async();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  const int kvh = bh / group;
  if constexpr (WGeo<D>::self_load) {
    // no producer: thread 0 loads q and the first R tiles, the consumers
    // the rest (consume_wide, refill); the refill counters follow the
    // barriers
    const Narrow<Elt> nw = {xs, bar_x, bar_x + 8 * WGeo<D>::nx,
                            bar_x + 8 * WGeo<D>::nx + 16,
                            kp + (size_t)kvh * seq_len * ld, vp + (size_t)kvh * seq_len * ld};
    if (kAny && narrow) {
      start_narrow<Elt, D>(qp + ((size_t)bh * seq_len + q0) * ld, sQ, sK, sV, bar_q, bar_k,
                           bar_v, nw, q0, lo, n_iter, ld, seq_len);
    } else if (threadIdx.x == 0) {
      mbar_expect_tx(bar_q, QT);
      for (int h = 0; h < B; ++h)
        tma_load(sQ + h * kHalfBytes, tm_q, bar_q, h * kHalf, q0, bh);
      for (int it = 0; it < R && it < n_iter; ++it) {
        load_tile<D>(sK, bar_k, tm_k, it, lo, kvh);
        load_tile<D>(sV, bar_v, tm_v, it, lo, kvh);
      }
    }
    if constexpr (WGeo<D>::r64)
      consume32<Elt>(sQ, sK, sV, bar_q, bar_k, bar_v, bar_empty, bar_empty + 8 * R, wg, q0, lo,
                     n_iter, out + (size_t)bh * seq_len * ld, ld, seq_len, causal, scale_log2,
                     window, tm_k, tm_v, kvh);
    else
      consume_wide<Elt, D, kAny>(sQ, sK, sV, bar_q, bar_k, bar_v, bar_empty,
                                 bar_empty + 8 * R, wg, q0, lo, n_iter,
                                 out + (size_t)bh * seq_len * ld, ld, seq_len, causal,
                                 scale_log2, window, tm_k, tm_v, kvh, narrow, nw);
  } else if (wg == kConsumers) {
    // producer warpgroup: gives its registers to the consumers; one thread
    // starts every load, B boxes of 64 columns a tile (the _any kernels keep
    // 56, for the narrow loader's 128 threads)
    if constexpr (kAny)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 56;");
    else
      asm volatile("setmaxnreg.dec.sync.aligned.u32 24;");
    if (kAny && narrow) {
      produce_narrow<Elt, D>(qp + (size_t)bh * seq_len * ld, kp + (size_t)kvh * seq_len * ld,
                             vp + (size_t)kvh * seq_len * ld, sQ, sK, sV, bar_q, bar_k, bar_v,
                             bar_empty, xs, bar_x, q0, lo, n_iter, ld, seq_len);
    } else if (threadIdx.x == kConsumers * 128) {
      mbar_expect_tx(bar_q, QT);
      for (int h = 0; h < B; ++h)
        tma_load(sQ + h * kHalfBytes, tm_q, bar_q, h * kHalf, q0, bh);
      for (int it = 0; it < n_iter; ++it) {
        mbar_wait(bar_empty + 8 * (it % R), ((it / R) & 1) ^ 1);
        load_tile<D>(sK, bar_k, tm_k, it, lo, kvh);
        load_tile<D>(sV, bar_v, tm_v, it, lo, kvh);
      }
    }
  } else {
    if constexpr (kAny)  // ptxas gives every thread 168 in any case
      asm volatile("setmaxnreg.inc.sync.aligned.u32 224;");
    else
      asm volatile("setmaxnreg.inc.sync.aligned.u32 240;");
    Elt* op = out + (size_t)bh * seq_len * ld;
    if constexpr (D == kHalf)
      consume_overlap<Elt, D>(sQ, sK, sV, bar_q, bar_k, bar_v, bar_empty, wg, q0, lo,
                              n_iter, op, ld, seq_len, causal, scale_log2, window);
    else
      consume<Elt, D>(sQ, sK, sV, bar_q, bar_k, bar_v, bar_empty, wg, q0, lo, n_iter,
                      op, ld, seq_len, causal, scale_log2, window);
  }
}

// bf16 or float16 (Elt) rows of exactly D elements: the compiled widths
template <typename Elt, int D>
__global__ void __launch_bounds__(WGeo<D>::threads, WGeo<D>::blocks)
    flash_wgmma(const __grid_constant__ CUtensorMap tm_q,
                const __grid_constant__ CUtensorMap tm_k,
                const __grid_constant__ CUtensorMap tm_v,
                Elt* __restrict__ out, int ld, int seq_len, int group,
                int causal, float scale_log2, int window) {
  flash_wgmma_block<Elt, D, false>(&tm_q, &tm_k, &tm_v, nullptr, nullptr, nullptr, out, ld,
                                   seq_len, group, causal, scale_log2, window);
}

// rows of any ld <= D elements: a multiple of 8 by TMA (which fills the
// columns past ld with zeros), any other from q, k and v (the narrow
// loader; the tensor maps unused)
template <typename Elt, int D>
__global__ void __launch_bounds__(WGeo<D>::threads, WGeo<D>::blocks)
    flash_wgmma_any(const __grid_constant__ CUtensorMap tm_q,
                    const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v, const Elt* q, const Elt* k,
                    const Elt* v, Elt* __restrict__ out, int ld, int seq_len, int group,
                    int causal, float scale_log2, int window) {
  flash_wgmma_block<Elt, D, true>(&tm_q, &tm_k, &tm_v, q, k, v, out, ld, seq_len, group,
                                  causal, scale_log2, window);
}

// A (rows, S, d) bf16 or float16 array (`type`) as a 3-D tensor map with
// boxes of box_cols columns x box_rows in `swizzle` (64 columns in the
// 128-byte swizzle; 32 in the 64-byte one at D = 32); rows past S and
// columns past d read as zeros.  The row stride, d * 2 bytes, must be a
// multiple of 16 (d a multiple of 8; the wrapper pads other rows).
CUresult make_map(CUtensorMap* map, const void* ptr, int rows, int seq_len, int d,
                  int box_rows, CUtensorMapDataType type, int box_cols = kHalf,
                  CUtensorMapSwizzle swizzle = CU_TENSOR_MAP_SWIZZLE_128B) {
  const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)seq_len,
                              (cuuint64_t)rows};
  const cuuint64_t strides[2] = {(cuuint64_t)d * 2,
                                 (cuuint64_t)seq_len * d * 2};
  const cuuint32_t box[3] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  // libcuda's encoder, looked up at run time: nothing links against libcuda
  typedef CUresult (*Encode)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                             void*, const cuuint64_t*, const cuuint64_t*,
                             const cuuint32_t*, const cuuint32_t*,
                             CUtensorMapInterleave, CUtensorMapSwizzle,
                             CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
  static Encode encode = nullptr;
  if (encode == nullptr) {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW);
    if (lib != nullptr)
      encode = reinterpret_cast<Encode>(dlsym(lib, "cuTensorMapEncodeTiled"));
    if (encode == nullptr) return CUDA_ERROR_NOT_FOUND;
  }
  return encode(
      map, type, 3, const_cast<void*>(ptr), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

// ------------------ flash_wgmma_wide (bf16 and float16 above head dim 256)
constexpr int kGCols = 512;    // output columns a block (a column group)
constexpr int kGWgCols = 256;  // of them, a warpgroup's (o: m64n256)
constexpr int kGRows = 64;     // q rows a block, shared by both warpgroups
constexpr int kGKeys = 64;     // keys a k/v tile
constexpr int kGPiece = 64;    // columns of a q.k piece: one 128-byte span
constexpr int kGRing = 4;      // stages of each warpgroup's piece ring
constexpr int kGSpanBytes = kGKeys * kHalf * 2;           // 8 KB: 64 rows x 128 B
constexpr int kGStageBytes = 2 * kGSpanBytes;             // a q piece, a k piece
constexpr int kGVBytes = (kGCols / kHalf) * kGSpanBytes;  // 64 KB: v's 512 columns
constexpr int kGXBytes = kGRows * kGKeys * 4;             // 16 KB: a partial score tile
// two piece rings, v's tile, the score exchange, and a warpgroup's
// mbarriers (a ring stage landed, its v spans landed): 214,096 B
constexpr int kGSmem = 1024 + kConsumers * kGRing * kGStageBytes + kGVBytes + kGXBytes +
                       8 * kConsumers * (kGRing + 1);

__device__ __forceinline__ void bar_sync_n(int id, int n) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(n) : "memory");
}

// Head dims above 256 in bfloat16 and float16 (rows of ld > 256 elements,
// a multiple of 8).  Block (bh, 64-row q tile, column group z) computes
// out[:, 512 z .. 512 z + 511] for its 64 q rows: warpgroup 0 columns
// 0 .. 255 of the group, warpgroup 1 256 .. 511, each holding o as the
// 128 float registers of m64n256 as flash_wgmma<256> does, so at D <= 512
// a key tile's scores are computed once, and above 512 once a group
// (ceil(ld / 512) groups).  Two consumer warpgroups and no producer (8 warps,
// so ptxas budgets 255 registers; see kWideThreads).
//
// q.k^T over 64-column pieces: q and k arrive piece by piece (TMA boxes of
// 64 x 64 in the 128-byte swizzle, q's 64 rows and the tile's 64 keys) into
// a ring of kGRing stages that each warpgroup owns and refills itself;
// warpgroup w takes pieces w, w + 2, ..., m64n64k16 steps into a fresh
// accumulator a tile, one chain over its half of the row (the tensor cores
// truncate as they accumulate: in float32 one chain over a 1,024-wide row
// drifted past the float32 rule; here the products are exact and the rule
// one 16-bit ulp).  Both warpgroups take as many pieces, half the row's
// rounded up to whole chunks of kGRing (a piece past the row is TMA's zero
// fill), so neither's products depend on which warpgroup it is, and a tile
// with more pieces than the ring takes them a chunk at a time.  Thread t of
// both warpgroups holds the same (row, key) elements, so the
// halves are summed through 16 KB of shared memory: warpgroup 0 writes its
// half and arrives on named barrier 1, warpgroup 1 waits, adds it, writes
// its own and arrives on 2, warpgroup 0 waits and adds (a + b = b + a: both
// hold the same sums to the bit).  Both run the same online softmax on the
// same scores (flash_wgmma<256>'s: maxima over the unscaled scores, scale
// > 0, a lazy maximum), so both keep the same m and l.  p.v keeps the
// plain version's accuracy: p is split into a T pair, hi = round(p) and lo =
// round(p - hi), and both go to m64n256k16 against the warpgroup's 256
// columns of v (MN-major, four spans), two products a k-step, as
// decode_group's p.v (float16: p 2^7 is split, since the lazy maximum
// leaves p <= 2^8, so hi <= 2^15 and lo clear of float16's subnormals; o is
// scaled back in the finish).  v's tile holds the group's 512 columns (64
// KB; a warpgroup loads and waits for its own four spans, only those below
// ld).
//
// Schedule of a warpgroup, tile j: q.k^T of tile j has retired (with p.v
// of tile j - 1), so the leader loads the freed ring stages and v spans;
// the exchange, the softmax, o rescaled where a row's lazy maximum moved, p
// split; then p.v of tile j and q.k^T of tile j + 1 issued together and
// retired, while the other warpgroup's exchange or softmax may run.  What
// bounds it: operations.  At 16 q heads of 512 over one kv head, S = 2048,
// causal, q.k and p.v are 68.7 GFLOP, 0.0695 ms at 989 TFLOP/s, and p's lo
// half adds p.v once more (0.104 ms); q and k pieces are read again
// for every key tile and group, from L2 (the q heads of a kv head are
// neighbours in the grid).
// Shared memory does not grow with D (214,096 B); the masks (-1e30, -inf
// past S: the same function, as flash_wgmma<256>), the [lo, hi) tile
// skipping, the longest q tiles first, the q heads of one kv head side by
// side in the grid, and acc / max(l, 1e-30) are flash_wgmma's.
template <typename Elt>
__global__ void __launch_bounds__(kConsumers * 128, 1)
    flash_wgmma_wide(const __grid_constant__ CUtensorMap tm_q,
                     const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v,
                     Elt* __restrict__ out, int ld, int seq_len, int group,
                     int causal, float scale_log2, int window) {
  constexpr int R = kGRing, KB = kGKeys;
  constexpr float kPScale = kIsHalf<Elt> ? 128.0f : 1.0f;  // p's split, a power of 2
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32, c2 = 2 * (lane % 4);
  const bool leader = tid == 0;
  const uint32_t sRing = base + wg * R * kGStageBytes;  // this warpgroup's ring
  const uint32_t sV = base + kConsumers * R * kGStageBytes;
  const uint32_t sX = sV + kGVBytes;
  const uint32_t bar_full = sX + kGXBytes + 8 * (R + 1) * wg;  // a ring stage landed
  const uint32_t bar_v = bar_full + 8 * R;                    // this warpgroup's v spans
  float4* xch = reinterpret_cast<float4*>(smem_raw + (sX - raw)) + tid;

  const int bh = blockIdx.x, kvh = bh / group;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kGRows;  // longest causal tiles first
  const int c0 = blockIdx.z * kGCols + wg * kGWgCols;    // this warpgroup's columns
  const bool has_cols = c0 < ld;
  const int n_spans = has_cols ? min(kGWgCols, ld - c0 + kHalf - 1) / kHalf : 0;
  // pieces a warpgroup takes a tile (its own: wg, wg + 2, ...): half the
  // row's rounded up to whole chunks of R, the same count in both
  // warpgroups, so that every product is issued in control flow that does
  // not depend on the warpgroup (ptxas serialises every wgmma otherwise);
  // a piece past the row is TMA's zero fill and adds exact zeros
  const int n_pieces = (ld + kGPiece - 1) / kGPiece;
  const int per = ((n_pieces + 1) / 2 + R - 1) / R * R;
  // key tiles this q tile can see (kernel.py:54-62); a negative lo is 0
  const int n_kt = (seq_len + KB - 1) / KB;
  const int hi = causal ? min((q0 + kGRows - 1) / KB + 1, n_kt) : n_kt;
  const int lo = window > 0 ? max((q0 - window + 1) / KB, 0) : 0;
  const int n_iter = hi - lo;
  const int total = n_iter * per;  // this warpgroup's pieces, in order

  if (leader) {
    for (int s = 0; s < R; ++s) mbar_init(bar_full + 8 * s, 1);
    mbar_init(bar_v, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // piece i of this warpgroup: tile i / per, q and k columns 64 p
  auto load_piece = [&](int i) {
    const int p = 2 * (i % per) + wg, s = i % R;
    const uint32_t st = sRing + s * kGStageBytes, bar = bar_full + 8 * s;
    mbar_expect_tx(bar, kGStageBytes);
    tma_load(st, &tm_q, bar, p * kGPiece, q0, bh);
    tma_load(st + kGSpanBytes, &tm_k, bar, p * kGPiece, (lo + i / per) * KB, kvh);
  };
  // v tile j: this warpgroup's spans below ld
  auto load_v = [&](int j) {
    mbar_expect_tx(bar_v, n_spans * kGSpanBytes);
    for (int h = 0; h < n_spans; ++h)
      tma_load(sV + (wg * (kGWgCols / kHalf) + h) * kGSpanBytes, &tm_v, bar_v,
               c0 + h * kHalf, (lo + j) * KB, kvh);
  };
  int loaded = min(R, total);
  if (leader) {
    for (int i = 0; i < loaded; ++i) load_piece(i);
    if (has_cols) load_v(0);
  }
  // every product reading the ring has retired and pieces < done are
  // consumed: once the warpgroup's warps are all here, the leader loads
  // the pieces up to done + R into the freed stages
  auto refill = [&](int done) {
    bar_sync_n(3 + wg, 128);
    const int upto = min(done + R, total);
    if (leader)
      for (int i = loaded; i < upto; ++i) load_piece(i);
    loaded = upto;
  };

  const int row0 = q0 + 16 * warp + lane / 4, row1 = row0 + 8;
  float o[kGWgCols / 2];
#pragma unroll
  for (int i = 0; i < kGWgCols / 2; ++i) o[i] = 0.0f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.0f, l1 = 0.0f, corr0, corr1;
  float sc[KB / 2];
  uint32_t ph[KB / 4], pl[KB / 4];

  // this warpgroup's half of q.k^T of tile j into sc, R pieces at a time
  // (one chunk at D <= 512), piece c + u of the tile in stage u.  Nothing
  // waits or copies while a product is in flight, and every product
  // retires in the pass of the loop that issued it (a product in flight
  // across a loop's back edge makes ptxas serialise every wgmma): a chunk's
  // pieces are waited for before its products are issued (the first
  // chunk's by the caller, ready), and a tile with more pieces than the
  // ring retires each chunk but the last and refills the ring before the
  // next; the caller commits and retires the last.
  auto ready = [&](int j, int c) {
    const uint32_t parity = ((j * per + c) / R) & 1;
    for (int u = 0; u < R; ++u) mbar_wait(bar_full + 8 * u, parity);
  };
  auto qk = [&](int j) {
    for (int c = 0; c < per; c += R) {
      if (c > 0) {
        refill(j * per + c);
        ready(j, c);
        wg_fence();
      }
#pragma unroll
      for (int u = 0; u < R; ++u) {
        const uint32_t st = sRing + u * kGStageBytes;
#pragma unroll
        for (int kk = 0; kk < kGPiece / 16; ++kk)
          wgmma_ss<Elt>(sc, sw128_desc(st + kk * 32, 16, 1024),
                        sw128_desc(st + kGSpanBytes + kk * 32, 16, 1024),
                        c > 0 || u > 0 || kk > 0);
      }
      if (c + R < per) {
        wg_commit();
        wg_wait_all();
        fence_regs(sc);
      }
    }
  };

  ready(0, 0);
  wg_fence();
  qk(0);
  wg_commit();
  wg_wait_all();
  fence_regs(sc);
  for (int j = 0; j < n_iter; ++j) {
    // p.v of tile j - 1 and q.k^T of tile j have retired: their v spans
    // and ring stages are free for tile j's v and the next pieces
    refill((j + 1) * per);
    if (leader && has_cols && j > 0) load_v(j);
    // the two halves summed (both warpgroups end with the same tile)
    if (wg == 0) {
#pragma unroll
      for (int v = 0; v < KB / 8; ++v)
        xch[128 * v] = make_float4(sc[4 * v], sc[4 * v + 1], sc[4 * v + 2], sc[4 * v + 3]);
      bar_arrive(1);
      bar_sync(2);
#pragma unroll
      for (int v = 0; v < KB / 8; ++v) {
        const float4 y = xch[128 * v];
        sc[4 * v] += y.x;
        sc[4 * v + 1] += y.y;
        sc[4 * v + 2] += y.z;
        sc[4 * v + 3] += y.w;
      }
    } else {
      bar_sync(1);
#pragma unroll
      for (int v = 0; v < KB / 8; ++v) {
        const float4 y = xch[128 * v];
        xch[128 * v] = make_float4(sc[4 * v], sc[4 * v + 1], sc[4 * v + 2], sc[4 * v + 3]);
        sc[4 * v] += y.x;
        sc[4 * v + 1] += y.y;
        sc[4 * v + 2] += y.z;
        sc[4 * v + 3] += y.w;
      }
      bar_arrive(2);
    }
    online_softmax_fma<KB, true, kIsHalf<Elt>>(sc, (lo + j) * KB, q0, row0, row1, c2,
                                                 seq_len, causal, window, scale_log2, m0,
                                                 m1, l0, l1, corr0, corr1);
    if (corr0 != 1.0f || corr1 != 1.0f) rescale(o, corr0, corr1);
    // p as a pair hi + lo (p * kPScale: exact), the A operand of p.v
#pragma unroll
    for (int i = 0; i < KB / 4; ++i) {
      const float a = sc[2 * i] * kPScale, b = sc[2 * i + 1] * kPScale;
      ph[i] = pack2<Elt>(a, b);
      const float2 h = unpack2<Elt>(ph[i]);
      pl[i] = pack2<Elt>(a - h.x, b - h.y);
      asm volatile("" : "+r"(ph[i]), "+r"(pl[i])::"memory");
    }
    if (has_cols) mbar_wait(bar_v, j & 1);
    if (j + 1 < n_iter) ready(j + 1, 0);
    // o's rescale and the scores are done before the fence; a warpgroup
    // past the row runs p.v too, on spans it never loaded, so that no
    // product depends on the warpgroup (its o is not stored)
    fence_regs(o);
    fence_regs(sc);
    wg_fence();
    const uint32_t tV = sV + wg * (kGWgCols / kHalf) * kGSpanBytes;
#pragma unroll
    for (int kk = 0; kk < KB / 16; ++kk) {
      const uint64_t dv = sw128_desc(tV + kk * 16 * 128, kGSpanBytes, 1024);
      wgmma_rs<Elt>(o, ph[4 * kk], ph[4 * kk + 1], ph[4 * kk + 2], ph[4 * kk + 3], dv);
      wgmma_rs<Elt>(o, pl[4 * kk], pl[4 * kk + 1], pl[4 * kk + 2], pl[4 * kk + 3], dv);
    }
    if (j + 1 < n_iter) qk(j + 1);
    wg_commit();
    wg_wait_all();  // p.v of tile j and q.k^T of tile j + 1
    fence_regs(o);
    fence_regs(sc);
  }
  if (!has_cols) return;

  // out = o / (l kPScale) for this warpgroup's columns below ld (ld is a
  // multiple of 8 and col even: a pair never straddles it)
#pragma unroll
  for (int o_ = 1; o_ < 4; o_ <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, o_);
    l1 += __shfl_xor_sync(0xffffffffu, l1, o_);
  }
  const float d0 = fmaxf(l0, 1e-30f) * kPScale, d1 = fmaxf(l1, 1e-30f) * kPScale;
  Elt* op = out + (size_t)bh * seq_len * ld + c0;
#pragma unroll
  for (int j = 0; j < kGWgCols / 8; ++j) {
    const int col = 8 * j + c2;
    if (c0 + col >= ld) continue;
    if (row0 < seq_len)
      *reinterpret_cast<uint32_t*>(op + (size_t)row0 * ld + col) =
          pack2<Elt>(o[4 * j] / d0, o[4 * j + 1] / d0);
    if (row1 < seq_len)
      *reinterpret_cast<uint32_t*>(op + (size_t)row1 * ld + col) =
          pack2<Elt>(o[4 * j + 2] / d1, o[4 * j + 3] / d1);
  }
}

// ------------------------------------- flash_tf32 (TF32 tensor cores, split)
constexpr int kTRows = 16;      // q rows a warp owns: the m of mma.m16n8k8
constexpr int kTWarps = 8;      // warps a block, D <= 128
constexpr int kTWideWarps = 4;  // warps a block at D = 256
constexpr int kTKeys = 64;      // keys a k/v tile, D <= 128
constexpr int kTWideKeys = 32;  // keys a k/v tile at D = 256
constexpr int kTStages = 2;     // the cp.async ring of k/v tiles

// flash_tf32<T, D>'s geometry (T is float: bf16 and float16 run
// flash_wgmma at every width): warps, threads and q rows a block, keys a
// k/v tile, the row strides of q, k and v in shared memory, in elements,
// and the block's dynamic shared memory.  The strides are padded so that
// the fragment loads of a warp hit 32 distinct banks: q and k are read as
// 8-byte pairs at row g, word 2t (a stride of 8 mod 16 words); v as words
// at row 2t, column g (a stride of 4 mod 16).  Every row is a multiple of
// 16 bytes for cp.async.
template <typename T, int D>
struct TGeo {
  static_assert(sizeof(T) == 4, "float32 only");
  static constexpr bool wide = D > 128;
  static constexpr int warps = wide ? kTWideWarps : kTWarps;
  static constexpr int threads = 32 * warps;
  static constexpr int rows = kTRows * warps;
  static constexpr int keys = wide ? kTWideKeys : kTKeys;
  static constexpr int qs = (D + 15) / 16 * 16 + 8;
  static constexpr int ks = qs;
  static constexpr int vs = D + 4;
  static constexpr int smem = rows * qs * 4 + kTStages * keys * (ks + vs) * 4;
  // two blocks an SM up to D = 64 (at most 128 registers a thread)
  static constexpr int min_blocks = D <= 64 ? 2 : 1;
};

// two neighbouring elements of a row
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
// two neighbouring outputs
__device__ __forceinline__ void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// x rounded to TF32 (10 mantissa bits; to nearest, ties away from zero)
__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}
// x = hi + lo to about 2^-22 of x: hi = tf32(x), lo = tf32(x - hi)
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}

// c += a . b, one m16n8k8 product of TF32 operands into float32
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a . b to float32 accuracy, a given as its hi and lo halves: the
// products lo . hi, hi . lo and hi . hi (lo . lo, about 2^-22 of a product,
// is left out).
__device__ __forceinline__ void mma3(float (&c)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], float b0,
                                     float b1) {
  uint32_t h0, l0, h1, l1;
  split(b0, h0, l0);
  split(b1, h1, l1);
  mma_tf32(c, al, h0, h1);
  mma_tf32(c, ah, l0, l1);
  mma_tf32(c, ah, h0, h1);
}

// The block of flash_tf32 and flash_tf32_any; kAny as flash_wgmma_block's.
template <typename T, int D, bool kAny>
__device__ __forceinline__ void flash_tf32_block(const T* __restrict__ q,
                                                 const T* __restrict__ k,
                                                 const T* __restrict__ v,
                                                 T* __restrict__ out, int ld_arg,
                                                 int seq_len, int group, int causal,
                                                 float scale, int window) {
  const int ld = kAny ? ld_arg : D;
  using G = TGeo<T, D>;
  constexpr int BQ = G::rows, BK = G::keys;
  constexpr int NK = BK / 8;  // 8-key n-tiles of q.k^T, k-steps of p.v
  constexpr int ND = D / 8;   // 8-column k-steps of q.k^T, n-tiles of p.v
  constexpr int C = 16 / (int)sizeof(T);  // elements a 16-byte copy
  static_assert(D % C == 0, "rows are copied in 16-byte pieces");
  extern __shared__ __align__(16) unsigned char smem[];
  float* sQ = reinterpret_cast<float*>(smem);     // BQ x qs: q * scale
  T* sK = reinterpret_cast<T*>(sQ + BQ * G::qs);  // kTStages x BK x ks
  T* sV = sK + kTStages * BK * G::ks;             // kTStages x BK x vs

  const int bh = blockIdx.x;
  // causal work grows with the q tile: the longest tiles start first
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  // rows are ld <= D elements (whole 16-byte pieces); columns past ld are
  // zeros in shared memory, so they add exact zeros and are not stored
  const T* qp = q + (size_t)bh * seq_len * ld;
  const T* kp = k + (size_t)(bh / group) * seq_len * ld;
  const T* vp = v + (size_t)(bh / group) * seq_len * ld;

  // key tiles the block can see (kernel.py:54-62; C division truncates like
  // lax.div, and a negative lo is clamped to 0)
  const int n_tiles = (seq_len + BK - 1) / BK;
  const int hi = causal ? min((q0 + BQ - 1) / BK + 1, n_tiles) : n_tiles;
  const int lo = window > 0 ? max((q0 - window + 1) / BK, 0) : 0;

  // k and v tile j into ring stage j % kTStages; rows past S and columns
  // past ld are zeros
  auto load_kv = [&](int j) {
    constexpr int CPR = D / C;
    const int k0 = j * BK;
    const uint32_t dk = smem_addr(sK + (j % kTStages) * BK * G::ks);
    const uint32_t dv = smem_addr(sV + (j % kTStages) * BK * G::vs);
    for (int i = threadIdx.x; i < BK * CPR; i += G::threads) {
      const int r = i / CPR, c = (i % CPR) * C;
      const bool valid = k0 + r < seq_len && c < ld;
      const size_t src = valid ? (size_t)(k0 + r) * ld + c : 0;
      cp_async16(dk + (r * G::ks + c) * (int)sizeof(T), kp + src, valid);
      cp_async16(dv + (r * G::vs + c) * (int)sizeof(T), vp + src, valid);
    }
    asm volatile("cp.async.commit_group;" ::: "memory");
  };
  load_kv(lo);

  // q * scale (rounded once, as the plain version), rows past S and
  // columns past ld zero; the first barrier of the loop publishes it
  for (int i = threadIdx.x; i < BQ * (D / C); i += G::threads) {
    const int r = i / (D / C), c = (i % (D / C)) * C;
    float* dst = sQ + r * G::qs + c;
    if (q0 + r < seq_len && c < ld) {
      const uint4 raw =
          *reinterpret_cast<const uint4*>(qp + (size_t)(q0 + r) * ld + c);
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int u = 0; u < C; ++u) dst[u] = e[u] * scale;
    } else {
#pragma unroll
      for (int u = 0; u < C; ++u) dst[u] = 0.0f;
    }
  }

  // the warp's 16 rows: this thread holds rows g and g + 8 of them
  const int r0 = q0 + warp * kTRows;
  const int row0 = r0 + g, row1 = row0 + 8;
  const bool live = r0 < seq_len;
  // the tiles of [lo, hi) that this warp's rows see; a tile wholly masked
  // for every row of the warp adds exactly 0 (every row has a valid key in
  // its range), so the warp skips it
  const int whi = causal ? min((r0 + kTRows - 1) / BK + 1, hi) : hi;
  const int wlo = window > 0 ? max((r0 - window + 1) / BK, lo) : lo;
  const float* qr0 = sQ + (warp * kTRows + g) * G::qs + 2 * t;
  const float* qr1 = qr0 + 8 * G::qs;

  float o[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.0f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.0f, l1 = 0.0f;

  for (int j = lo; j < hi; ++j) {
    if (j + 1 < hi) {
      load_kv(j + 1);  // into the stage tile j - 1 used
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile j (and q) is in shared memory for every warp
    if (live && j >= wlo && j < whi) {
      const T* tk = sK + (j % kTStages) * BK * G::ks;
      const T* tv = sV + (j % kTStages) * BK * G::vs;
      const int k0 = j * BK;

      // s = (q * scale) . k^T.  The mma's k index t holds column 2t of an
      // 8-column step and t + 4 holds column 2t + 1, in a and in b alike (a
      // sum does not care about the order), so each operand pair is one
      // 8-byte load.
      float s[NK][4];
#pragma unroll
      for (int n = 0; n < NK; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < ND; ++kk) {
        const float2 x0 = *reinterpret_cast<const float2*>(qr0 + 8 * kk);
        const float2 x1 = *reinterpret_cast<const float2*>(qr1 + 8 * kk);
        uint32_t ah[4], al[4];
        split(x0.x, ah[0], al[0]);  // (g, 2t)
        split(x1.x, ah[1], al[1]);  // (g + 8, 2t)
        split(x0.y, ah[2], al[2]);  // (g, 2t + 1)
        split(x1.y, ah[3], al[3]);  // (g + 8, 2t + 1)
#pragma unroll
        for (int n = 0; n < NK; ++n) {
          const float2 y = load2(tk + (8 * n + g) * G::ks + 8 * kk + 2 * t);
          mma3(s[n], ah, al, y.x, y.y);
        }
      }

      // masks, only on tiles that cross the causal diagonal, the window's
      // edge or the ragged end for some row of the warp: -1e30 outside the
      // masks, -inf past S.  s[n][e] is row (e < 2 ? g : g + 8), key
      // 8n + 2t + (e & 1).
      if (k0 + BK > seq_len || (causal && k0 + BK - 1 > r0) ||
          (window > 0 && k0 <= r0 + kTRows - 1 - window)) {
#pragma unroll
        for (int n = 0; n < NK; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int row = e < 2 ? row0 : row1;
            const int col = k0 + 8 * n + 2 * t + (e & 1);
            bool keep = true;
            if (causal) keep &= col <= row;
            if (window > 0) keep &= col > row - window;
            s[n][e] = col >= seq_len ? -INFINITY : (keep ? s[n][e] : kNegInf);
          }
      }

      // the online softmax in float32; the four threads of a row share its
      // maximum, and each keeps its own share of the denominator (every
      // share is rescaled by the same factor; summed at the end)
      float mx0 = m0, mx1 = m1;
#pragma unroll
      for (int n = 0; n < NK; ++n) {
        mx0 = fmaxf(mx0, fmaxf(s[n][0], s[n][1]));
        mx1 = fmaxf(mx1, fmaxf(s[n][2], s[n][3]));
      }
#pragma unroll
      for (int x = 1; x <= 2; x <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, x));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, x));
      }
      const float c0 = expf(m0 - mx0), c1 = expf(m1 - mx1);
      m0 = mx0;
      m1 = mx1;
      float ps0 = 0.0f, ps1 = 0.0f;
#pragma unroll
      for (int n = 0; n < NK; ++n) {
        s[n][0] = expf(s[n][0] - mx0);
        s[n][1] = expf(s[n][1] - mx0);
        s[n][2] = expf(s[n][2] - mx1);
        s[n][3] = expf(s[n][3] - mx1);
        ps0 += s[n][0] + s[n][1];
        ps1 += s[n][2] + s[n][3];
      }
      l0 = l0 * c0 + ps0;
      l1 = l1 * c1 + ps1;
      // a factor of exactly 1 changes nothing, so o is rescaled only when
      // some row's maximum moved
      if (__any_sync(0xffffffffu, c0 != 1.0f || c1 != 1.0f)) {
#pragma unroll
        for (int jd = 0; jd < ND; ++jd) {
          o[jd][0] *= c0;
          o[jd][1] *= c0;
          o[jd][2] *= c1;
          o[jd][3] *= c1;
        }
      }

      // o += p . v.  p's accumulator layout (rows g, g + 8; keys 2t, 2t + 1)
      // is the a layout once the mma's k index t stands for key 2t and t + 4
      // for key 2t + 1; v's rows are read in the same order.  p is split
      // into hi + lo here.
#pragma unroll
      for (int n = 0; n < NK; ++n) {
        uint32_t ah[4], al[4];
        split(s[n][0], ah[0], al[0]);  // (g, key 2t)
        split(s[n][2], ah[1], al[1]);  // (g + 8, key 2t)
        split(s[n][1], ah[2], al[2]);  // (g, key 2t + 1)
        split(s[n][3], ah[3], al[3]);  // (g + 8, key 2t + 1)
        const T* vr = tv + (8 * n + 2 * t) * G::vs + g;
#pragma unroll
        for (int jd = 0; jd < ND; ++jd)
          mma3(o[jd], ah, al, vr[8 * jd], vr[G::vs + 8 * jd]);
      }
    }
    __syncthreads();  // every warp is done with this stage before its refill
  }

#pragma unroll
  for (int x = 1; x <= 2; x <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, x);
    l1 += __shfl_xor_sync(0xffffffffu, l1, x);
  }
  if (!live) return;
  const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
  // ld is a multiple of 4: a pair never straddles column ld
  T* op = out + (size_t)bh * seq_len * ld + 2 * t;
#pragma unroll
  for (int jd = 0; jd < ND; ++jd) {
    if (8 * jd + 2 * t >= ld) continue;
    if (row0 < seq_len)
      store2(op + (size_t)row0 * ld + 8 * jd, o[jd][0] / d0, o[jd][1] / d0);
    if (row1 < seq_len)
      store2(op + (size_t)row1 * ld + 8 * jd, o[jd][2] / d1, o[jd][3] / d1);
  }
}

// float32 (T) rows of exactly D elements
template <typename T, int D>
__global__ void __launch_bounds__(TGeo<T, D>::threads, TGeo<T, D>::min_blocks)
    flash_tf32(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, T* __restrict__ out, int ld, int seq_len,
               int group, int causal, float scale, int window) {
  flash_tf32_block<T, D, false>(q, k, v, out, ld, seq_len, group, causal, scale, window);
}

// rows of any ld <= D elements, whole 16-byte pieces
template <typename T, int D>
__global__ void __launch_bounds__(TGeo<T, D>::threads, TGeo<T, D>::min_blocks)
    flash_tf32_any(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, T* __restrict__ out, int ld, int seq_len,
                   int group, int causal, float scale, int window) {
  flash_tf32_block<T, D, true>(q, k, v, out, ld, seq_len, group, causal, scale, window);
}

// The kernel a launch runs: the _any one where kAny (only the one named
// is instantiated)
template <typename T, int D, bool kAny>
auto tf32_kernel() {
  if constexpr (kAny)
    return &flash_tf32_any<T, D>;
  else
    return &flash_tf32<T, D>;
}
template <typename T, int D, bool kAny>
auto wgmma_kernel() {
  if constexpr (kAny)
    return &flash_wgmma_any<T, D>;
  else
    return &flash_wgmma<T, D>;
}

template <typename T, int D, bool kAny>
cudaError_t launch_tf32(const void* q, const void* k, const void* v, void* out,
                        int ld, int bh, int seq_len, int group, int causal,
                        float scale, int window, cudaStream_t stream) {
  using G = TGeo<T, D>;
  auto kernel = tf32_kernel<T, D, kAny>();
  static bool configured = false;  // the attribute is per function
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, G::smem);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const dim3 grid(bh, (seq_len + G::rows - 1) / G::rows);
  kernel<<<grid, G::threads, G::smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), ld, seq_len, group,
      causal, scale, window);
  return cudaGetLastError();
}

// ------------------------------ flash_tf32_wide (float32 above head dim 256)
constexpr int kXRows = 64;     // q rows a block, shared by both sets of warps
constexpr int kXKeys = 32;     // keys a k/v tile
constexpr int kXPiece = 64;    // columns of a q.k piece
constexpr int kXCols = 512;    // output columns a block (a column group)
constexpr int kXSetCols = 256; // of them, a set's: o is 32 n-tiles of 8
constexpr int kXWarps = 8;     // two sets of 4 warps, 16 q rows a warp

// flash_tf32_wide<T>'s geometry, in floats: the row strides of a q or k
// piece and of v's tile in shared memory (padded as TGeo's, so that a
// warp's fragment loads hit 32 distinct banks), a stage (both sets' q and k
// pieces, or v's tile of the group's 512 columns: the larger), the lo
// halves of a stage's k pieces or v, the partial-score exchange (a set's
// 128 threads x 16 floats, each set its own), and the block's dynamic
// shared memory: two stages, lo and the exchange, 214,528 B at every head dim.
template <typename T>
struct XGeo {
  static_assert(sizeof(T) == 4, "float32 only: bf16 and float16 run flash_wgmma_wide");
  static constexpr int threads = 32 * kXWarps;
  static constexpr int ps = kXPiece + 8;
  static constexpr int vs = kXCols + 4;
  static constexpr int set_piece = (kXRows + kXKeys) * ps;  // a set's q piece, then k piece
  static constexpr int stage = 2 * set_piece > kXKeys * vs ? 2 * set_piece : kXKeys * vs;
  static constexpr int lo = kXKeys * vs;
  static constexpr int xch = 2 * 128 * 16;
  static constexpr int smem = (2 * stage + lo + xch) * 4;
};

// c += a . b to float32 accuracy from both operands' halves (bh, bl: b's
// hi and lo, split once a block): lo . hi, hi . lo, hi . hi, as mma3
__device__ __forceinline__ void mma3s(float (&c)[4], const uint32_t (&ah)[4],
                                      const uint32_t (&al)[4], float bh0, float bh1,
                                      float bl0, float bl1) {
  const uint32_t h0 = __float_as_uint(bh0), h1 = __float_as_uint(bh1);
  mma_tf32(c, al, h0, h1);
  mma_tf32(c, ah, __float_as_uint(bl0), __float_as_uint(bl1));
  mma_tf32(c, ah, h0, h1);
}

// Head dims above 256 in float32 (rows of ld > 256 elements, a multiple of
// 4).  Block (bh, 64-row q tile, column group z) computes out[:, 512 z ..
// 512 z + 511]: 8 warps in two sets of 4 that share the tile's 64 rows
// (warp w: rows 16 (w % 4) ..), set s holding columns 256 s .. of the group
// as flash_tf32 holds o (128 registers a thread), so a key tile's scores
// are computed once a group.  flash_tf32's split-TF32 products throughout
// (every float32 operand x as hi = tf32(x) and lo = tf32(x - hi), three
// products a pair: one TF32 product misses the float32 rule 60x).  A block
// runs its steps in order, tile by tile, every step's copies (cp.async)
// issued while the step before computes, the steps alternating between two
// stages: ceil(pieces / 2) piece steps, in which set s takes the 64-column
// piece 2 m + s of q and of k, then the tile's v step.  When a step's copies
// land, each set splits its k piece, or its 256 columns of v, into hi (in
// place) and lo once for its 4 warps, where flash_tf32 splits at every
// fragment load in every warp.  A set sums its pieces' products, each piece
// in accumulators of its own (the tensor cores truncate as they accumulate:
// one chain over a 1,024-wide row drifted past the float32 rule), and
// the two sets' partial scores meet through shared memory at the v step
// (a + b = b + a: both hold the same scores to the bit, so the same m and l).
// Then flash_tf32's masks (-1e30, -inf past S), online softmax and p.v (p
// split) over the set's columns; a warp skips the tiles masked for all its
// rows, and its partner in the other set (the same rows) does too.  What
// bounds it: operations, three TF32 products a pair at 494.7 TFLOP/s (at
// 16 q heads of 512 over one kv head, S = 2048, causal: 0.417 ms); the
// splits and fragment loads beside every mma.sync take issue slots, so the
// block splits k and v once for its warps.
template <typename T>
__global__ void __launch_bounds__(XGeo<T>::threads, 1)
    flash_tf32_wide(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, T* __restrict__ out, int ld,
                    int seq_len, int group, int causal, float scale, int window) {
  using G = XGeo<T>;
  constexpr int BQ = kXRows, BK = kXKeys;
  constexpr int NK = BK / 8;           // 8-key n-tiles of q.k^T, k-steps of p.v
  constexpr int NP = kXPiece / 8;      // 8-column k-steps of a piece
  constexpr int ND = kXSetCols / 8;    // 8-column n-tiles of p.v
  constexpr int C = 4;                 // floats a 16-byte copy
  extern __shared__ __align__(16) unsigned char smem[];
  float* sS = reinterpret_cast<float*>(smem);  // 2 stages
  float* sL = sS + 2 * G::stage;               // lo halves
  float4* sX = reinterpret_cast<float4*>(sL + G::lo);

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // longest tiles first
  const int cg = blockIdx.z * kXCols;                // the group's first column
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int set = warp / 4, st = threadIdx.x % 128;  // a set's thread
  const int g = lane / 4, t = lane % 4;
  const int c0 = cg + set * kXSetCols;               // this set's columns
  const int cols = min(kXSetCols, ld - c0);          // <= 0: none
  const int n_pieces = (ld + kXPiece - 1) / kXPiece;
  const int per_tile = (n_pieces + 1) / 2 + 1;       // piece steps, then v's
  const float* qp = q + (size_t)bh * seq_len * ld;
  const float* kp = k + (size_t)(bh / group) * seq_len * ld;
  const float* vp = v + (size_t)(bh / group) * seq_len * ld;

  const int n_tiles = (seq_len + BK - 1) / BK;
  const int hi = causal ? min((q0 + BQ - 1) / BK + 1, n_tiles) : n_tiles;
  const int lo = window > 0 ? max((q0 - window + 1) / BK, 0) : 0;
  const int n_steps = max(hi - lo, 0) * per_tile;

  // step i: tile lo + i / per_tile; part i % per_tile: piece step m (set
  // s takes piece 2 m + s) or, last, v's tile of the group's columns
  auto load_step = [&](int i) {
    const int k0 = (lo + i / per_tile) * BK, m = i % per_tile;
    float* dst = sS + (i & 1) * G::stage;
    if (m < per_tile - 1) {
      constexpr int CPR = kXPiece / C;
      for (int e = threadIdx.x; e < 2 * (BQ + BK) * CPR; e += G::threads) {
        const int s2 = e / ((BQ + BK) * CPR), r = e / CPR % (BQ + BK), c = (e % CPR) * C;
        const int col = (2 * m + s2) * kXPiece + c;
        const int row = r < BQ ? q0 + r : k0 + r - BQ;
        const bool valid = row < seq_len && col < ld;
        const float* src = (r < BQ ? qp : kp) + (valid ? (size_t)row * ld + col : 0);
        cp_async16(smem_addr(dst + s2 * G::set_piece + r * G::ps + c), src, valid);
      }
    } else {
      constexpr int CPR = kXCols / C;
      for (int e = threadIdx.x; e < BK * CPR; e += G::threads) {
        const int r = e / CPR, c = (e % CPR) * C;
        const bool valid = k0 + r < seq_len && cg + c < ld;
        const float* src = vp + (valid ? (size_t)(k0 + r) * ld + cg + c : 0);
        cp_async16(smem_addr(dst + r * G::vs + c), src, valid);
      }
    }
    asm volatile("cp.async.commit_group;" ::: "memory");
  };
  if (n_steps > 0) load_step(0);

  const int r0 = q0 + (warp % 4) * kTRows;
  const int row0 = r0 + g, row1 = row0 + 8;
  const bool live = r0 < seq_len;
  const int whi = causal ? min((r0 + kTRows - 1) / BK + 1, hi) : hi;
  const int wlo = window > 0 ? max((r0 - window + 1) / BK, lo) : lo;

  float o[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.0f;
  float s[NK][4];
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.0f, l1 = 0.0f;

  for (int i = 0; i < n_steps; ++i) {
    cp_async_wait<0>();
    __syncthreads();  // step i is in shared memory; every warp is done with step i - 1
    if (i + 1 < n_steps) load_step(i + 1);  // into the other stage
    const int j = lo + i / per_tile, m = i % per_tile;
    const bool vstep = m == per_tile - 1;
    const int pc = 2 * m + set;  // this set's piece (piece steps)
    float* tile = sS + (i & 1) * G::stage;
    // split once for the set: its k piece, or its columns of v; hi in
    // place, lo beside
    if (vstep) {
      for (int e = st; e < BK * kXSetCols; e += 128) {
        const int off = (e / kXSetCols) * G::vs + set * kXSetCols + e % kXSetCols;
        const float x = tile[off];
        const uint32_t h = tf32(x);
        tile[off] = __uint_as_float(h);
        sL[off] = __uint_as_float(tf32(x - __uint_as_float(h)));
      }
    } else if (pc < n_pieces) {
      float* tk = tile + set * G::set_piece + BQ * G::ps;
      float* tl = sL + set * BK * G::ps;
      for (int e = st; e < BK * kXPiece; e += 128) {
        const int off = (e / kXPiece) * G::ps + e % kXPiece;
        const float x = tk[off];
        const uint32_t h = tf32(x);
        tk[off] = __uint_as_float(h);
        tl[off] = __uint_as_float(tf32(x - __uint_as_float(h)));
      }
    }
    bar_sync_n(1 + set, 128);  // the set's split is done
    if (!live || j < wlo || j >= whi) continue;
    const int k0 = j * BK;

    if (!vstep) {
      if (pc >= n_pieces) continue;  // an odd count: set 1 has one piece fewer
      // this piece's (q * scale) . k^T, in accumulators of its own
      const float* tq = tile + set * G::set_piece;
      const float* tk = tq + BQ * G::ps;
      const float* tl = sL + set * BK * G::ps;
      const float* qr0 = tq + ((warp % 4) * kTRows + g) * G::ps + 2 * t;
      const float* qr1 = qr0 + 8 * G::ps;
      float sp[NK][4];
#pragma unroll
      for (int n = 0; n < NK; ++n) sp[n][0] = sp[n][1] = sp[n][2] = sp[n][3] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < NP; ++kk) {
        const float2 x0 = load2(qr0 + 8 * kk), x1 = load2(qr1 + 8 * kk);
        uint32_t ah[4], al[4];
        split(x0.x * scale, ah[0], al[0]);  // (g, 2t)
        split(x1.x * scale, ah[1], al[1]);  // (g + 8, 2t)
        split(x0.y * scale, ah[2], al[2]);  // (g, 2t + 1)
        split(x1.y * scale, ah[3], al[3]);  // (g + 8, 2t + 1)
#pragma unroll
        for (int n = 0; n < NK; ++n) {
          const int off = (8 * n + g) * G::ps + 8 * kk + 2 * t;
          const float2 yh = load2(tk + off), yl = load2(tl + off);
          mma3s(sp[n], ah, al, yh.x, yh.y, yl.x, yl.y);
        }
      }
#pragma unroll
      for (int n = 0; n < NK; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = m == 0 ? sp[n][e] : s[n][e] + sp[n][e];
      if (2 * (m + 1) + set >= n_pieces) {  // the set's last piece: its partial out
#pragma unroll
        for (int n = 0; n < NK; ++n)
          sX[(set * NK + n) * 128 + st] = make_float4(s[n][0], s[n][1], s[n][2], s[n][3]);
      }
      continue;
    }

    // the v step: the other set's partial added (the same sum in both)
#pragma unroll
    for (int n = 0; n < NK; ++n) {
      const float4 y = sX[((1 - set) * NK + n) * 128 + st];
      s[n][0] += y.x;
      s[n][1] += y.y;
      s[n][2] += y.z;
      s[n][3] += y.w;
    }
    // masks, only on tiles that cross the causal diagonal, the window's edge
    // or the ragged end for some row of the warp
    if (k0 + BK > seq_len || (causal && k0 + BK - 1 > r0) ||
        (window > 0 && k0 <= r0 + kTRows - 1 - window)) {
#pragma unroll
      for (int n = 0; n < NK; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = e < 2 ? row0 : row1;
          const int col = k0 + 8 * n + 2 * t + (e & 1);
          bool keep = true;
          if (causal) keep &= col <= row;
          if (window > 0) keep &= col > row - window;
          s[n][e] = col >= seq_len ? -INFINITY : (keep ? s[n][e] : kNegInf);
        }
    }
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int n = 0; n < NK; ++n) {
      mx0 = fmaxf(mx0, fmaxf(s[n][0], s[n][1]));
      mx1 = fmaxf(mx1, fmaxf(s[n][2], s[n][3]));
    }
#pragma unroll
    for (int x = 1; x <= 2; x <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, x));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, x));
    }
    const float cr0 = expf(m0 - mx0), cr1 = expf(m1 - mx1);
    m0 = mx0;
    m1 = mx1;
    float ps0 = 0.0f, ps1 = 0.0f;
#pragma unroll
    for (int n = 0; n < NK; ++n) {
      s[n][0] = expf(s[n][0] - mx0);
      s[n][1] = expf(s[n][1] - mx0);
      s[n][2] = expf(s[n][2] - mx1);
      s[n][3] = expf(s[n][3] - mx1);
      ps0 += s[n][0] + s[n][1];
      ps1 += s[n][2] + s[n][3];
    }
    l0 = l0 * cr0 + ps0;
    l1 = l1 * cr1 + ps1;
    if (cols <= 0) continue;
    if (__any_sync(0xffffffffu, cr0 != 1.0f || cr1 != 1.0f)) {
#pragma unroll
      for (int jd = 0; jd < ND; ++jd) {
        o[jd][0] *= cr0;
        o[jd][1] *= cr0;
        o[jd][2] *= cr1;
        o[jd][3] *= cr1;
      }
    }
    // o += p . v over the set's columns (n-tiles past them skipped); p's
    // accumulator layout is the a layout (keys 2t, 2t + 1 as flash_tf32)
#pragma unroll
    for (int n = 0; n < NK; ++n) {
      uint32_t ah[4], al[4];
      split(s[n][0], ah[0], al[0]);
      split(s[n][2], ah[1], al[1]);
      split(s[n][1], ah[2], al[2]);
      split(s[n][3], ah[3], al[3]);
      const int off = (8 * n + 2 * t) * G::vs + set * kXSetCols + g;
      const float* vh = tile + off;
      const float* vl = sL + off;
#pragma unroll
      for (int jd = 0; jd < ND; ++jd)
        if (8 * jd < cols)
          mma3s(o[jd], ah, al, vh[8 * jd], vh[G::vs + 8 * jd], vl[8 * jd], vl[G::vs + 8 * jd]);
    }
  }

#pragma unroll
  for (int x = 1; x <= 2; x <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, x);
    l1 += __shfl_xor_sync(0xffffffffu, l1, x);
  }
  if (!live || cols <= 0) return;
  const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
  float* op = out + (size_t)bh * seq_len * ld + c0 + 2 * t;
#pragma unroll
  for (int jd = 0; jd < ND; ++jd) {
    if (8 * jd + 2 * t >= cols) continue;
    if (row0 < seq_len)
      store2(op + (size_t)row0 * ld + 8 * jd, o[jd][0] / d0, o[jd][1] / d0);
    if (row1 < seq_len)
      store2(op + (size_t)row1 * ld + 8 * jd, o[jd][2] / d1, o[jd][3] / d1);
  }
}

template <typename T>
cudaError_t launch_wide(const void* q, const void* k, const void* v, void* out,
                        int ld, int bh, int seq_len, int group, int causal,
                        float scale, int window, cudaStream_t stream) {
  using G = XGeo<T>;
  static bool configured = false;  // the attribute is per function
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_tf32_wide<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, G::smem);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  if (ld % 4 != 0 || ld <= kWideCols) return cudaErrorInvalidValue;
  const dim3 grid(bh, (seq_len + kXRows - 1) / kXRows, (ld + kXCols - 1) / kXCols);
  flash_tf32_wide<T><<<grid, G::threads, G::smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), ld, seq_len, group,
      causal, scale, window);
  return cudaGetLastError();
}

// float32 at every head dim: flash_tf32 at a compiled width, else
// flash_tf32_any at the smallest of 32, 64, 128, 256 above ld (ops.py
// width)
cudaError_t launch_f32(int ld, const void* q, const void* k, const void* v,
                       void* out, int bh, int seq_len, int group, int causal,
                       float scale, int window, cudaStream_t stream) {
  using T = float;
  auto go = ld > 256    ? launch_wide<T>
            : ld == 32  ? launch_tf32<T, 32, false>
            : ld == 64  ? launch_tf32<T, 64, false>
            : ld == 80  ? launch_tf32<T, 80, false>
            : ld == 120 ? launch_tf32<T, 120, false>
            : ld == 128 ? launch_tf32<T, 128, false>
            : ld == 256 ? launch_tf32<T, 256, false>
            : ld < 32   ? launch_tf32<T, 32, true>
            : ld < 64   ? launch_tf32<T, 64, true>
            : ld < 128  ? launch_tf32<T, 128, true>
                        : launch_tf32<T, 256, true>;
  return go(q, k, v, out, ld, bh, seq_len, group, causal, scale, window, stream);
}

// flash_wgmma<T, D>: the overlapped schedule at D = 64, the one within a
// warpgroup above 128 and at 96 (consume_wide) and at 32 (consume32, rows
// of 64 bytes in the 64-byte swizzle), the serial one at 80, 120 and 128
// (see consume).  The D = 32, 64, 96 and D > 128 softmaxes take their
// maxima over the unscaled scores, so there only scale > 0 is computed and
// any other scale is refused here (NaN included).  The wrapper
// handles the sign (flash_attention/ops.py, positive_scale): it launches
// a negative scale as -q with |scale|, and scale 0 as a zero q with scale
// 1, which give the same scaled scores.  Rows are ld <= D elements, exactly
// D unless kAny.  A multiple of 8 comes by TMA, which fills the columns past
// ld with zeros; any other (kAny only) by the narrow loader, with the
// narrow loader's shared memory and no tensor map.
template <typename T, int D, bool kAny>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v, void* out,
                         int ld, int bh, int seq_len, int group, int causal,
                         float scale, int window, cudaStream_t stream) {
  static_assert(D % 32 == 0 || (!kAny && D % 8 == 0), "rows of 16-byte multiples");
  static_assert((D >= kHalf || D == k32Cols) && D <= kWideCols &&
                    (kAny || D <= kWCols || D == kWideCols),
                "widths that fill at least one span");
  static_assert(WGeo<D>::narrow_smem <= kSmemLimit, "the narrow loader's buffers fit");
  if constexpr (D == kHalf || WGeo<D>::self_load)
    if (!(scale > 0.0f)) return cudaErrorInvalidValue;
  auto kernel = wgmma_kernel<T, D, kAny>();
  constexpr int most = kAny ? WGeo<D>::narrow_smem : WGeo<D>::smem;
  static bool configured = false;  // the attribute is per function
  if (!configured) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, most);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const bool narrow = kAny && WGeo<D>::narrow && ld % 8 != 0;
  const CUtensorMapDataType type =
      kIsHalf<T> ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  // boxes of a span's columns: 32 in the 64-byte swizzle at D = 32
  constexpr int box = WGeo<D>::r64 ? k32Cols : kHalf;
  const CUtensorMapSwizzle sw =
      WGeo<D>::r64 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_128B;
  constexpr int keys = WGeo<D>::keys;
  CUtensorMap tq = {}, tk = {}, tv = {};
  if (ld < 1 || ld > D || (!kAny && ld != D) || (ld % 8 != 0 && !narrow) ||
      (!narrow &&
       (make_map(&tq, q, bh, seq_len, ld, kWBQ, type, box, sw) != CUDA_SUCCESS ||
        make_map(&tk, k, bh / group, seq_len, ld, keys, type, box, sw) != CUDA_SUCCESS ||
        make_map(&tv, v, bh / group, seq_len, ld, keys, type, box, sw) != CUDA_SUCCESS)))
    return cudaErrorInvalidValue;
  const dim3 grid(bh, (seq_len + kWBQ - 1) / kWBQ);
  if constexpr (kAny)
    kernel<<<grid, WGeo<D>::threads, narrow ? WGeo<D>::narrow_smem : WGeo<D>::smem,
             stream>>>(tq, tk, tv, static_cast<const T*>(q), static_cast<const T*>(k),
                       static_cast<const T*>(v), static_cast<T*>(out), ld, seq_len, group,
                       causal, scale * kLog2e, window);
  else
    kernel<<<grid, WGeo<D>::threads, WGeo<D>::smem, stream>>>(
        tq, tk, tv, static_cast<T*>(out), ld, seq_len, group, causal,
        scale * kLog2e, window);
  return cudaGetLastError();
}

// flash_wgmma_wide<T>: rows of ld > 256 elements, a multiple of 8; scale >
// 0 only, as flash_wgmma at 256 (its softmax)
template <typename T>
cudaError_t launch_wgmma_wide(const void* q, const void* k, const void* v, void* out,
                              int ld, int bh, int seq_len, int group, int causal,
                              float scale, int window, cudaStream_t stream) {
  if (!(scale > 0.0f)) return cudaErrorInvalidValue;
  static bool configured = false;  // the attribute is per function
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_wgmma_wide<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, kGSmem);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const CUtensorMapDataType type =
      kIsHalf<T> ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  CUtensorMap tq, tk, tv;
  if (ld % 8 != 0 || ld <= kWideCols ||
      make_map(&tq, q, bh, seq_len, ld, kGRows, type) != CUDA_SUCCESS ||
      make_map(&tk, k, bh / group, seq_len, ld, kGKeys, type) != CUDA_SUCCESS ||
      make_map(&tv, v, bh / group, seq_len, ld, kGKeys, type) != CUDA_SUCCESS)
    return cudaErrorInvalidValue;
  const dim3 grid(bh, (seq_len + kGRows - 1) / kGRows, (ld + kGCols - 1) / kGCols);
  flash_wgmma_wide<T><<<grid, kConsumers * 128, kGSmem, stream>>>(
      tq, tk, tv, static_cast<T*>(out), ld, seq_len, group, causal, scale * kLog2e,
      window);
  return cudaGetLastError();
}

// bfloat16 and float16: flash_wgmma at a compiled width, else
// flash_wgmma_any at ld rounded up to a multiple of 32 (ops.py width); above
// 256 flash_wgmma_wide
template <typename T>
cudaError_t launch_16bit(int ld, const void* q, const void* k, const void* v,
                         void* out, int bh, int seq_len, int group, int causal,
                         float scale, int window, cudaStream_t stream) {
  auto go = ld > 256    ? launch_wgmma_wide<T>
            : ld == 32  ? launch_wgmma<T, 32, false>
            : ld == 64  ? launch_wgmma<T, 64, false>
            : ld == 80  ? launch_wgmma<T, 80, false>
            : ld == 120 ? launch_wgmma<T, 120, false>
            : ld == 128 ? launch_wgmma<T, 128, false>
            : ld == 256 ? launch_wgmma<T, 256, false>
            : ld < 32   ? launch_wgmma<T, 32, true>
            : ld < 64   ? launch_wgmma<T, 64, true>
            : ld <= 96  ? launch_wgmma<T, 96, true>
            : ld < 128  ? launch_wgmma<T, 128, true>
            : ld <= 160 ? launch_wgmma<T, 160, true>
            : ld <= 192 ? launch_wgmma<T, 192, true>
            : ld <= 224 ? launch_wgmma<T, 224, true>
                        : launch_wgmma<T, 256, true>;
  return go(q, k, v, out, ld, bh, seq_len, group, causal, scale, window, stream);
}

}  // namespace

// Launches the kernel on `stream` and returns cudaGetLastError() (0 on
// success).  Does not synchronise.  dtype: 0 float32, 1 bfloat16, 2
// float16; any other code is refused.  head_dim: the row length ld, any
// ld >= 1 with ld * element bytes a multiple of 16, and in bfloat16 and
// float16 any ld from 33 to 192 (the narrow loader; the wrapper pads other
// rows with zero columns); above 256, flash_wgmma_wide in bfloat16 and
// float16 (scale > 0 only) and flash_tf32_wide in float32.  window <= 0
// means no window.  q and out hold
// bh * seq_len * ld elements, k and v bh / group times that.  float32 runs
// flash_tf32 at the smallest compiled width D >= ld (32, 64, 80, 120, 128,
// 256); bfloat16 and float16 flash_wgmma at 32, 64, 80, 120, 128 and 256
// and flash_wgmma_any at ld rounded up to a multiple of 32 for other rows
// (rows of at most 32 at 32).  flash_wgmma at 32, 64 and above 128 takes
// only scale > 0 (cudaErrorInvalidValue otherwise; the wrapper rewrites the
// others).
extern "C" int flash_attention_launch(int device, int dtype, int head_dim,
                                      const void* q, const void* k,
                                      const void* v, void* out, int bh,
                                      int seq_len, int group, int causal,
                                      float scale, int window, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaGetLastError();  // clear a stale error from an earlier call
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int elem = dtype == 0 ? 4 : 2;
  const bool narrow = dtype != 0 && head_dim > 32 && head_dim <= 192;
  if (dtype < 0 || dtype > 2 || head_dim < 1 || (head_dim * elem % 16 != 0 && !narrow))
    return (int)cudaErrorInvalidValue;
  auto go = dtype == 0   ? launch_f32
            : dtype == 1 ? launch_16bit<__nv_bfloat16>
                         : launch_16bit<__half>;
  err = go(head_dim, q, k, v, out, bh, seq_len, group, causal, scale, window, s);
  return (int)err;
}

extern "C" const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
