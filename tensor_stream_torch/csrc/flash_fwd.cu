// Flash-attention forward on Hopper (sm_90a): softmax(Q K^T * scale) V
// without the [Sq, Sk] logits ever reaching device memory.
//
// Replaces the JAX package's two Pallas TPU kernels
//   ops/flash_attention.py::_kernel       (via _flash_fwd_pallas), and
//   ops/flash_attention.py::_band_kernel  (via _flash_fwd_band_pallas).
// It computes what _kernel computes; it is not carried over grid step by
// grid step:
//   * One block handles one (q tile, head, batch). A loop inside the block
//     over kv tiles takes the place of the TPU's sequential ("arbitrary")
//     kv grid dimension, with the running row max m, row sum l and the
//     unnormalized accumulator kept in registers.
//   * The loop's bounds do the work of the TPU's tile skips: causal stops
//     at the diagonal, `window` starts at the band's first tile (_band_lo)
//     and, when symmetric, stops at its last, and every loop stops at Sk.
//     That band-restricted loop is what _band_kernel buys on the TPU (no
//     per-step cost for dead tiles), so its function is served here by
//     the band mode of this one kernel.
//   * Masked logits get -0.7 * FLT_MAX, never -inf; only tiles that hold
//     padding or an edge of the causal or band mask are masked. GQA maps
//     q head h to kv head h / (H / Hk). Cross-attention (Sq != Sk) works
//     when not causal.
//   * Inputs are [B, H, S, d] with any 16-byte aligned B/H/S strides and a
//     contiguous last dimension, so the model's [B, S, H, d] projections
//     go in without a transpose copy. The output takes its own strides.
//
// Numerics, as the JAX _reference states them: logits accumulate in f32;
// m and l are kept online in f32; P is cast to the input dtype before
// P@V, which accumulates in f32; the output is acc * (l == 0 ? 1 : 1/l),
// cast to q's dtype; l is the f32 sum of p (the TPU's ones-augmented V
// column is a TPU workaround and is not here).
//
// bf16: bound at the headline shape [2, 12, 1568, 64], non-causal, by
// operations: 4*B*H*Sq*Sk*d = 15.1 GFLOP -> 15.3 us at 989 TFLOP/s, against
// 19.3 MB of q, k, v and o -> 5.8 us at 3.35 TB/s. So the tensor cores
// must be kept busy, and at d = 64 the exponentials cost as much as the
// products (one MUFU.EX2 a logit at 16 a clock an SM against 4*64 FLOP at
// about 4096 a clock), so the two have to overlap. The design is Hopper's:
//   * TMA. q, k and v are 4-D tensor maps over (d, S, H, B) with the
//     caller's strides, encoded on the host for each launch. One thread
//     loads a whole tile into shared memory with the 128-byte swizzle
//     that wgmma reads (64-byte for d = 32; d = 128 is two 64-column
//     boxes). TMA zero-fills rows >= Sq and >= Sk inside the head.
//   * A ring of kStages K/V stages with full/empty mbarrier pairs. K and V
//     of a stage have their own full barrier, so Q K^T starts while V is
//     still in flight.
//   * Warp specialisation: warpgroup 0 is the producer (one thread issues
//     every TMA load and runs up to kStages tiles ahead; setmaxnreg gives
//     its registers away), the others are consumers of 64 q rows each:
//     three (a 192-row q tile at 160 registers a thread) for d <= 64, two
//     (128 rows at 240) for d = 128, whose O takes twice the registers.
//   * Both products on wgmma with f32 accumulation. S = Q K^T is
//     m64n128k16 with Q and K read from shared memory through descriptors.
//     O += P V takes P from registers: the S accumulator fragment, packed
//     to bf16 pairs, is wgmma's register A fragment, so P never goes to
//     shared memory; V is read as stored, through the B descriptor's
//     transpose bit (no transpose of V by hand).
//   * Overlap. Inside a warpgroup, tile i's Q K^T is issued together with
//     tile i-1's P V, and tile i's softmax runs while both are in flight.
//     Across warpgroups, a ring of named barriers makes each issue its
//     products right after the one before it (FA3's ping-pong), so one's
//     softmax runs under the others' products.
//   * Softmax in base 2: p = exp2(s * scale*log2e - m * scale*log2e), one
//     FMA and one ex2.approx.ftz a logit; m is kept on the raw dot
//     products and scaled once at the end, so the residual m is the max of
//     the scaled logits and l = sum exp(s*scale - m), as the plain version
//     defines them. Each thread keeps partial row sums; the quad adds them
//     once.
// At the headline shape this is 216 blocks of 120 KB of shared memory,
// one 512-thread block an SM, so 1.64 waves on 132 SMs (the second wave
// is 64% full) and the last q tile holds 32 of its 192 rows. Left for
// later: a persistent grid or split kv to fill the second wave, K/V
// multicast across a cluster of two blocks (each K/V tile is read from L2
// by 9 blocks), and a TMA store of O.
//
// bf16 at short sequences (Sq <= 64 and Sk <= 64, every mode): FlashFwdShort,
// the design of _band_kernel (a q tile's whole live band fetched as one kv
// block, one plain softmax pass, no online m and l), cut to Hopper's
// sizes. It replaces _band_kernel and _kernel where a head holds at most
// 64 rows: the factorized VideoViT's temporal attention, whose sequence is
// the clip's tubelet steps ([392, 6, 16, 64] with W = 8 in the windowed
// causal twin of the streaming model). There the work is some 77 MFLOP
// against 19.3 MB of q, k, v and o, so it is bound by bytes (5.75 us at
// 3.35 TB/s), and the tiled kernel above, which fills 16 of a block's
// 192 q rows and runs one 512-thread block an SM, pays its fixed cost in
// 18 waves of blocks. The design:
//   * A warp computes 16 q rows of one head on mma.sync m16n8k16 (bf16
//     in, f32 accumulate): S = Q K^T over the columns KvRange gives those
//     rows (all of them but the band's), masked by Live; the row max and
//     exp2 in f32 as above, l the f32 sum of p, P cast to bf16 from the S
//     fragments straight into P V's A fragments. A wgmma tile would be 64
//     rows, 75% empty at S = 16; the tensor cores' rate does not matter
//     here, bytes do.
//   * A block of 4 warps takes the q heads of one kv head (GQA's group), or
//     of as many kv heads as give its warps a 16-row tile each (4 heads
//     under MHA at S <= 16), and loads their K and V once into shared
//     memory with 16-byte cp.async copies (zeros past Sk), the caller's
//     [B, S, H, d] strides read in place. Each warp stages its Q rows and
//     its O rows through 16 padded rows of its own, so the loads and
//     stores are 16 bytes a lane too.
//   * A 1-D grid over the kv heads: no 65535 limit on y or z; at
//     [392, 6, 16, 64] 588 blocks of 27 KB, one wave.
// MHA self-attention at S <= 8 (the factorized ViT-B's temporal attention,
// [1568, 12, 4, 64] in training) takes FlashFwdPacked inside the same
// design: at S = 4 a 16-row tile of one head would be three quarters
// padding in every copy, ldmatrix, product and store, and a block would
// load, then compute, then store. There the work is 0.15 GFLOP against
// 38.5 MB of q, k, v, o (and 0.6 MB of l, m): bound by bytes (11.5 us).
//   * A tile packs 16 / S heads, each in its diagonal block (P = 0 off
//     it); S, P and O are one 16 x 16 column pair's registers.
//   * A warp needs only its tile's own 16 rows of Q, K and V, so warps
//     work alone: a persistent grid of PackBlocksPerSm blocks an SM, each
//     warp through a ring of kPackStages slots of its own, the next tile's
//     cp.async copies in flight while it computes the current one.
//   * A warp's copies sweep each tile's rows in the order that lies
//     closest in memory (a run of pack heads a row in the model's views).
//
// bf16 at mid-length sequences (64 < max(Sq, Sk) <= 256, d <= 64, every
// mode): FlashFwdMid. It serves the factorized VideoViT's spatial
// attention ([32, 12, 196, 64] in ViT-B training, [32, 6, 196, 64] in the
// streaming twin), where the tiled kernel's 192-row q tile holds 192 rows
// in its first tile and 4 in its second and each of those blocks reads the
// kv head again. The work there is 3.8 GFLOP against 38.5 MB (11.5 us at
// 3.35 TB/s): bound by bytes. An earlier design of this range put a warp
// on each 16-row q tile on mma.sync, so every warp read the whole kv head
// from shared memory through ldmatrix (13 times a head at S = 196) and its
// products bound it. This one is Hopper's:
//   * One block stages one kv head's K and V once by TMA in 64-row boxes
//     (the tiled kernel's tensor maps over (d, S, H, B) with the caller's
//     strides, 128-byte swizzle, 64-byte at d = 32; zeros past Sk: 256
//     rows at S = 196), an mbarrier a box.
//   * Each of its two warpgroups takes one 64-row q tile of the kv head's
//     q heads (a task); both Q tiles are loaded at the start, beside K and
//     V.
//   * S = Q K^T is an SS wgmma over 64-column chunks of the staged kv rows
//     (m64n64k16), the last chunk cut to 16 columns (m64n16k16) where no
//     more of it is live (4 of 64 at S = 196); m and l are kept online as
//     the tiled kernel keeps them (its Softmax). P goes from the
//     accumulator, packed to bf16, as the register A operand of O += P V,
//     V read MN-major through the descriptor's transpose bit. A chunk's
//     Q K^T runs beside the previous chunk's P V; the other warpgroup's,
//     and the other block's, softmax runs under them.
//   * Four 64-row tiles read the kv head 4 times a head at S = 196 (the
//     mma.sync design read it 13 times), straight from the swizzled stage.
//   * Two blocks an SM (128 registers a thread, 83 KB at S = 196): one
//     block's loads land while the other computes. A kv head's tasks are
//     split over blocks of two, each reading K and V (the second time
//     from L2). tools/flash_variants.py times the cuts of the design
//     (loads only, products only, no exponentials, the launch floor);
//     PERF.md has those readings and the alternatives' (two q tiles a
//     warpgroup, four warpgroups a block, a persistent grid of one wave:
//     none faster on an H100).
//
// f32: plain f32 FMAs, no TF32 (wgmma has no f32 without TF32). 128
// threads, 32 q rows (4 threads a row), kv tiles of 32.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>


#include "mma_sync.cuh"
#include "sm90.cuh"

namespace {

constexpr float kMask = -0.7f * FLT_MAX;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* l;  // [B, H, Sq] contiguous, or null
  float* m;  // [B, H, Sq] contiguous, or null
  int B, H, Hk, Sq, Sk;
  long long qsb, qsh, qss, ksb, ksh, kss, vsb, vsh, vss, osb, osh, oss;
  float scale;
  int causal;
  int window;  // 0: no window
};

// Half-open range of kv columns that q rows [q0, q0 + bq) may see.
__device__ __forceinline__ void KvRange(const Params& p, int q0, int bq,
                                        int* lo, int* hi) {
  int l = 0, h = p.Sk;
  if (p.causal) h = min(h, q0 + bq);
  if (p.window > 0) {
    l = max(q0 - (p.window - 1), 0);
    if (!p.causal) h = min(h, q0 + bq + p.window - 1);
  }
  *lo = l;
  *hi = h;
}

// Whether the kv tile [k0, k0 + bk) needs the elementwise mask for q rows
// [q0, q0 + bq): it holds padding, or an edge of the causal or band mask
// crosses it.
__device__ __forceinline__ bool TileNeedsMask(const Params& p, int q0, int bq,
                                              int k0, int bk) {
  bool need = k0 + bk > p.Sk;
  if (p.causal) need |= k0 + bk - 1 > q0;
  if (p.window > 0) {
    need |= k0 <= q0 + bq - 1 - p.window;
    if (!p.causal) need |= k0 + bk - 1 >= q0 + p.window;
  }
  return need;
}

__device__ __forceinline__ bool Live(const Params& p, int row, int col) {
  bool live = col < p.Sk;
  if (p.causal) live &= col <= row;
  if (p.window > 0) {
    if (p.causal) {
      live &= col > row - p.window;
    } else {
      live &= abs(col - row) < p.window;
    }
  }
  return live;
}

// --------------------------------------------------------------- bf16

using mma_sync::PackBf16;

constexpr int kWgRows = 64;  // q rows a consumer warpgroup
constexpr int kBk = 128;     // kv columns a tile: the N of S = Q K^T
constexpr int kStages = 3;   // K/V tiles in the ring
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct TileCfg {
  // Consumer warpgroups: three (a 192-row q tile, 160 registers a thread)
  // where Q and three stages fit in shared memory, else two (128 rows,
  // 240 registers a thread).
  static constexpr int kConsumers = D <= 64 ? 3 : 2;
  static constexpr int kBq = kConsumers * kWgRows;  // q rows a block
  static constexpr int kThreads = 128 * (kConsumers + 1);
  static constexpr int kProducerRegs = kConsumers == 3 ? 32 : 24;
  static constexpr int kConsumerRegs = kConsumers == 3 ? 160 : 240;
  static constexpr int kCols = D < 64 ? D : 64;  // columns of a swizzle row
  static constexpr int kChunks = D / kCols;      // TMA boxes across d
  static constexpr int kRowBytes = kCols * 2;    // 64 or 128
  static constexpr int kQBytes = kBq * D * 2;
  static_assert(128 * kProducerRegs + 128 * kConsumers * kConsumerRegs <=
                    65536, "register file");
  static constexpr int kKvBytes = kBk * D * 2;
  static constexpr int kBarOff = kQBytes + 2 * kStages * kKvBytes;
  // 1024 bytes of slack to align the swizzled tiles to 1024.
  static constexpr int kSmem = 1024 + kBarOff + 8 * (1 + 3 * kStages);
};

// The mbarriers, after the tiles: Q full, then K full, V full and empty
// for each stage.
__device__ __forceinline__ uint32_t KFull(uint32_t bar, int s) {
  return bar + 8 * (1 + s);
}
__device__ __forceinline__ uint32_t VFull(uint32_t bar, int s) {
  return bar + 8 * (1 + kStages + s);
}
__device__ __forceinline__ uint32_t Empty(uint32_t bar, int s) {
  return bar + 8 * (1 + 2 * kStages + s);
}

struct Tiles {
  uint32_t q, k, v, bar;  // shared addresses: Q, K stage 0, V stage 0
  int q0, h, b, first, count;
};

// One thread: Q once, then K and V of every kv tile into the ring.
template <int D>
__device__ __forceinline__ void Produce(const CUtensorMap* tq,
                                        const CUtensorMap* tk,
                                        const CUtensorMap* tv,
                                        const Params& p, const Tiles& t) {
  using C = TileCfg<D>;
  const int hk = t.h / (p.H / p.Hk);
  sm90::MbarExpectTx(t.bar, C::kQBytes);
#pragma unroll
  for (int c = 0; c < C::kChunks; ++c)
    sm90::TmaLoad4d(t.q + c * C::kBq * C::kRowBytes, tq, t.bar, c * C::kCols,
                    t.q0, t.h, t.b);
  for (int i = 0; i < t.count; ++i) {
    const int s = i % kStages;
    if (i >= kStages)
      sm90::MbarWait(Empty(t.bar, s), (i / kStages - 1) & 1);
    const int k0 = (t.first + i) * kBk;
    const uint32_t ks = t.k + s * C::kKvBytes, vs = t.v + s * C::kKvBytes;
    sm90::MbarExpectTx(KFull(t.bar, s), C::kKvBytes);
#pragma unroll
    for (int c = 0; c < C::kChunks; ++c)
      sm90::TmaLoad4d(ks + c * kBk * C::kRowBytes, tk, KFull(t.bar, s),
                      c * C::kCols, k0, hk, t.b);
    sm90::MbarExpectTx(VFull(t.bar, s), C::kKvBytes);
#pragma unroll
    for (int c = 0; c < C::kChunks; ++c)
      sm90::TmaLoad4d(vs + c * kBk * C::kRowBytes, tv, VFull(t.bar, s),
                      c * C::kCols, k0, hk, t.b);
  }
}

// Q K^T of one kv tile into the S accumulator, issued, not waited for.
template <int D>
__device__ __forceinline__ void IssueQK(float* s, uint32_t q_rows,
                                        uint32_t ks) {
  using C = TileCfg<D>;
  sm90::WgmmaFence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int chunk = kk * 16 / C::kCols;
    const int off = (kk * 16 % C::kCols) * 2;
    sm90::WgmmaSS128(
        s, sm90::Desc(q_rows + chunk * C::kBq * C::kRowBytes + off,
                      C::kRowBytes),
        sm90::Desc(ks + chunk * kBk * C::kRowBytes + off, C::kRowBytes),
        kk > 0);
  }
  sm90::WgmmaCommit();
}

// O += P V of one kv tile, P from registers, issued, not waited for.
template <int D>
__device__ __forceinline__ void IssuePV(float* o, uint32_t (*pa)[4],
                                        uint32_t vs) {
  using C = TileCfg<D>;
  sm90::WgmmaFence();
#pragma unroll
  for (int kk = 0; kk < kBk / 16; ++kk) {
#pragma unroll
    for (int ch = 0; ch < C::kChunks; ++ch) {
      const uint64_t dv = sm90::Desc(
          vs + ch * kBk * C::kRowBytes + kk * 16 * C::kRowBytes, C::kRowBytes);
      if constexpr (C::kCols == 64) {
        sm90::WgmmaRS64(o + ch * 32, pa[kk], dv);
      } else {
        sm90::WgmmaRS32(o, pa[kk], dv);
      }
    }
  }
  sm90::WgmmaCommit();
}

// The online softmax of one S tile of 8 NJ columns, in place: masks it
// where the tile needs it, updates the raw row max m and this thread's
// share of l, turns s into p and sets alpha to the factor the accumulator
// is rescaled by.
template <int NJ>
__device__ __forceinline__ void Softmax(const Params& p, float* s, int row0,
                                        int q0w, int k0, int c, float c2,
                                        float* m_run, float* l_run,
                                        float* alpha) {
  if (TileNeedsMask(p, q0w, kWgRows, k0, 8 * NJ)) {
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (!Live(p, row0 + 8 * (e >> 1), k0 + 8 * j + 2 * c + (e & 1)))
          s[4 * j + e] = kMask;
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mx = kMask;
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      mx = fmaxf(mx, fmaxf(s[4 * j + 2 * r], s[4 * j + 2 * r + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m_run[r], mx);
    alpha[r] = sm90::Exp2((m_run[r] - m_new) * c2);
    m_run[r] = m_new;
    // A row that has seen only masked logits so far gets p = 0 for them
    // (s * c2 - m * c2 with both near -FLT_MAX would leave the FMA's
    // rounding residue in the exponent).
    const float mc = m_new > kMask ? m_new * c2 : 0.f;
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float x = sm90::Exp2(fmaf(s[4 * j + 2 * r + e], c2, -mc));
        s[4 * j + 2 * r + e] = x;
        sum += x;
      }
    }
    l_run[r] = l_run[r] * alpha[r] + sum;
  }
}

// p, rounded to bf16 pairs: the S accumulator fragment of n-tiles 2kk and
// 2kk + 1 is the A fragment of P for k-step kk of P V (KS k-steps).
template <int KS>
__device__ __forceinline__ void PackP(const float* s, uint32_t (*pa)[4]) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
    for (int x = 0; x < 4; ++x)
      pa[kk][x] = PackBf16(s[8 * kk + 2 * x], s[8 * kk + 2 * x + 1]);
  }
}

// Ping-pong of the consumer warpgroups: each issues its products only
// after the one before it (in a ring) has issued its own, so one's
// softmax runs under the others' products. Warpgroup w waits on named
// barrier 1 + w; the last warpgroup opens the ring.
__device__ __forceinline__ void TurnWait(int wg) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(1 + wg) : "memory");
}
template <int NC>
__device__ __forceinline__ void TurnPass(int wg) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(1 + (wg + 1) % NC) : "memory");
}

// A consumer warpgroup's output rows row0 and row0 + 8 of this thread
// (the accumulator fragment) over the quad's sum l (1 where l is 0), in
// bf16, rows below Sq of q head (b, h); l and m (the raw max times the
// scale) beside them where the caller asked for them.
template <int D>
__device__ __forceinline__ void StoreO(const Params& p, const float* o,
                                       const float* l_run,
                                       const float* m_run, int b, int h,
                                       int row0, int c) {
  float l_row[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_run[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    l_row[r] = l;
  }
  __nv_bfloat16* og = static_cast<__nv_bfloat16*>(p.o) + b * p.osb + h * p.osh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= p.Sq) continue;
    const float inv = l_row[r] == 0.f ? 1.f : 1.f / l_row[r];
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<uint32_t*>(og + row * p.oss + 8 * j + 2 * c) =
          PackBf16(o[4 * j + 2 * r] * inv, o[4 * j + 2 * r + 1] * inv);
    }
    if (c == 0 && p.l != nullptr) {
      const long long at = (static_cast<long long>(b) * p.H + h) * p.Sq + row;
      p.l[at] = l_row[r];
      p.m[at] = m_run[r] * p.scale;
    }
  }
}

// One consumer warpgroup: 64 q rows against every kv tile of the block.
// Thread fragment (sm90.cuh): warp w, g = lane / 4, c = lane % 4 own rows
// row0 = q0w + 16w + g and row0 + 8; s[4j + e] and o[4j + e] are column
// 8j + 2c + (e % 2) of row row0 + 8 (e / 2).
// Tile i's Q K^T is issued before tile i-1's P V, so both products run
// while the warpgroup computes tile i's softmax; the accumulator is
// rescaled once tile i-1's P V is done.
template <int D>
__device__ __forceinline__ void Consume(const Params& p, const Tiles& t,
                                        int wg, int tw) {
  using C = TileCfg<D>;
  constexpr int SN = kBk / 2;  // S accumulator floats a thread
  constexpr int ON = D / 2;    // O accumulator floats a thread
  const int warp = tw / 32, lane = tw % 32, g = lane >> 2, c = lane & 3;
  const int q0w = t.q0 + wg * kWgRows;
  const int row0 = q0w + warp * 16 + g;
  const float c2 = p.scale * kLog2e;
  const uint32_t q_rows = t.q + wg * kWgRows * C::kRowBytes;

  float s[SN], o[ON];
  uint32_t pa[kBk / 16][4];
#pragma unroll
  for (int i = 0; i < SN; ++i) s[i] = 0.f;
#pragma unroll
  for (int i = 0; i < ON; ++i) o[i] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};  // max of the raw dot products
  float l_run[2] = {0.f, 0.f};              // this thread's share of l
  float alpha[2];

  sm90::MbarWait(t.bar, 0);
  sm90::MbarWait(KFull(t.bar, 0), 0);
  constexpr int NC = C::kConsumers;
  if (wg == NC - 1) TurnPass<NC>(wg);
  TurnWait(wg);
  IssueQK<D>(s, q_rows, t.k);
  TurnPass<NC>(wg);
  sm90::WgmmaWait<0>();
  sm90::FenceRegs<SN>(s);
  Softmax<kBk / 8>(p, s, row0, q0w, t.first * kBk, c, c2, m_run, l_run,
                   alpha);
  PackP<kBk / 16>(s, pa);
  for (int i = 1; i < t.count; ++i) {
    const int st = i % kStages, prev = (i - 1) % kStages;
    sm90::MbarWait(KFull(t.bar, st), (i / kStages) & 1);
    sm90::MbarWait(VFull(t.bar, prev), ((i - 1) / kStages) & 1);
    TurnWait(wg);
    IssueQK<D>(s, q_rows, t.k + st * C::kKvBytes);
    IssuePV<D>(o, pa, t.v + prev * C::kKvBytes);
    TurnPass<NC>(wg);
    sm90::WgmmaWait<1>();  // Q K^T of tile i
    sm90::FenceRegs<SN>(s);
    Softmax<kBk / 8>(p, s, row0, q0w, (t.first + i) * kBk, c, c2, m_run,
                     l_run, alpha);
    sm90::WgmmaWait<0>();  // P V of tile i - 1
    sm90::FenceRegs<ON>(o);
    sm90::FenceRegs<4 * kBk / 16>(&pa[0][0]);
    sm90::MbarArrive(Empty(t.bar, prev));
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      o[4 * j] *= alpha[0];
      o[4 * j + 1] *= alpha[0];
      o[4 * j + 2] *= alpha[1];
      o[4 * j + 3] *= alpha[1];
    }
    PackP<kBk / 16>(s, pa);
  }
  const int last = (t.count - 1) % kStages;
  sm90::MbarWait(VFull(t.bar, last), ((t.count - 1) / kStages) & 1);
  TurnWait(wg);
  IssuePV<D>(o, pa, t.v + last * C::kKvBytes);
  if (wg != NC - 1) TurnPass<NC>(wg);
  sm90::WgmmaWait<0>();
  sm90::FenceRegs<ON>(o);
  sm90::MbarArrive(Empty(t.bar, last));

  StoreO<D>(p, o, l_run, m_run, t.b, t.h, row0, c);
}

template <int D>
__global__ void __launch_bounds__(TileCfg<D>::kThreads, 1)
    FlashFwdBf16(const __grid_constant__ CUtensorMap tq,
                 const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv, const Params p) {
  using C = TileCfg<D>;
  extern __shared__ __align__(16) unsigned char smem[];
  Tiles t;
  t.q = (sm90::SmemAddr(smem) + 1023) & ~1023u;
  t.k = t.q + C::kQBytes;
  t.v = t.k + kStages * C::kKvBytes;
  t.bar = t.q + C::kBarOff;
  t.q0 = blockIdx.x * C::kBq;
  t.h = blockIdx.y;
  t.b = blockIdx.z;
  int lo, hi;
  KvRange(p, t.q0, C::kBq, &lo, &hi);
  t.first = lo / kBk;
  t.count = (hi + kBk - 1) / kBk - t.first;

  if (threadIdx.x == 0) {
    sm90::MbarInit(t.bar, 1);
    for (int s = 0; s < kStages; ++s) {
      sm90::MbarInit(KFull(t.bar, s), 1);
      sm90::MbarInit(VFull(t.bar, s), 1);
      sm90::MbarInit(Empty(t.bar, s), 128 * C::kConsumers);
    }
    sm90::FenceBarrierInit();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    sm90::SetMaxRegsDec<C::kProducerRegs>();
    if (threadIdx.x == 0) Produce<D>(&tq, &tk, &tv, p, t);
  } else {
    sm90::SetMaxRegsInc<C::kConsumerRegs>();
    Consume<D>(p, t, threadIdx.x / 128 - 1, threadIdx.x % 128);
  }
}

template <int D>
cudaError_t LaunchBf16(const Params& p, cudaStream_t stream) {
  using C = TileCfg<D>;
  CUtensorMap tq, tk, tv;
  if (!sm90::EncodeMap(&tq, p.q, D, p.Sq, p.H, p.B, p.qsb, p.qsh, p.qss,
                       C::kBq, C::kCols) ||
      !sm90::EncodeMap(&tk, p.k, D, p.Sk, p.Hk, p.B, p.ksb, p.ksh, p.kss,
                       kBk, C::kCols) ||
      !sm90::EncodeMap(&tv, p.v, D, p.Sk, p.Hk, p.B, p.vsb, p.vsh, p.vss,
                       kBk, C::kCols))
    return cudaErrorInvalidValue;
  const cudaError_t err = cudaFuncSetAttribute(
      FlashFwdBf16<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Sq + C::kBq - 1) / C::kBq, p.H, p.B);
  FlashFwdBf16<D><<<grid, C::kThreads, C::kSmem, stream>>>(tq, tk, tv, p);
  return cudaGetLastError();
}

// ------------------------------------------------- bf16, short sequences

constexpr int kShortMax = 64;   // Sq and Sk up to which FlashFwdShort runs
constexpr int kShortWarps = 4;  // warps a block
constexpr int kShortPad = 8;    // bf16 of row padding: conflict-free ldmatrix

// Blocks an SM must hold at once: 6 at d <= 64 (80 registers a thread), so
// that [392, 6, 16, 64]'s 588 blocks and its GQA twin's 784 run in one
// wave; 4 at d = 128, whose O takes twice the registers.
template <int D>
constexpr int ShortBlocksPerSm() {
  return D <= 64 ? 6 : 4;
}

// Shared memory of a block that takes `heads` kv heads: K and V of each,
// Sk rounded up to 16 rows, and a 16-row Q/O stage a warp.
template <int D>
int SmemShort(int heads, int sk) {
  return (2 * heads * ((sk + 15) / 16 * 16) + kShortWarps * 16) *
         (D + kShortPad) * 2;
}

// Which rows a warp task covers: task t of a block whose first kv head is
// `first` (kv heads b * Hk + hk in order) is kv head first + t / per_kv,
// q head hk * group + (t % per_kv) / tiles of it, rows 16 * (t % tiles).
struct ShortTask {
  int j, b, h, r0;
};

__device__ __forceinline__ ShortTask TaskOf(const Params& p, long long first,
                                            int group, int tiles, int t) {
  const int per_kv = group * tiles;
  ShortTask k;
  k.j = t / per_kv;
  const long long kv = first + k.j;
  k.b = static_cast<int>(kv / p.Hk);
  k.h = static_cast<int>(kv % p.Hk) * group + (t % per_kv) / tiles;
  k.r0 = 16 * (t % tiles);
  return k;
}

// The task's 16 q rows into the warp's stage, zeros past Sq.
template <int D>
__device__ __forceinline__ void StageQ(const Params& p, const ShortTask& k,
                                       __nv_bfloat16* stage, int lane) {
  constexpr int LD = D + kShortPad;
  const __nv_bfloat16* q =
      static_cast<const __nv_bfloat16*>(p.q) + k.b * p.qsb + k.h * p.qsh;
  for (int i = lane; i < 16 * D / 8; i += 32) {
    const int r = i / (D / 8), col = (i % (D / 8)) * 8;
    const bool in = k.r0 + r < p.Sq;
    mma_sync::CpAsync16(stage + r * LD + col,
                        in ? q + (k.r0 + r) * p.qss + col : q, in);
  }
}

template <int D>
__global__ void __launch_bounds__(kShortWarps * 32, ShortBlocksPerSm<D>())
    FlashFwdShort(const Params p, int heads) {
  constexpr int LD = D + kShortPad;
  constexpr int NP = kShortMax / 16;  // 16-column pairs of n-tiles
  using mma_sync::LoadA;
  using mma_sync::LoadB;
  using mma_sync::LoadBt;
  using mma_sync::Mma;
  extern __shared__ __align__(16) unsigned char smem[];
  const int skp = (p.Sk + 15) / 16 * 16;
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* vs = ks + heads * skp * LD;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  __nv_bfloat16* stage = vs + heads * skp * LD + warp * 16 * LD;
  const int group = p.H / p.Hk;
  const int tiles = (p.Sq + 15) / 16;
  const long long first = static_cast<long long>(blockIdx.x) * heads;
  const int live =
      static_cast<int>(min(static_cast<long long>(heads),
                           static_cast<long long>(p.B) * p.Hk - first));
  const int tasks = live * group * tiles;

  // K and V of the block's kv heads, and the first task's Q rows.
  for (int i = threadIdx.x; i < live * skp * (D / 8); i += blockDim.x) {
    const int j = i / (skp * (D / 8)), r = (i / (D / 8)) % skp;
    const int col = (i % (D / 8)) * 8;
    const long long kv = first + j;
    const int b = static_cast<int>(kv / p.Hk);
    const int hk = static_cast<int>(kv % p.Hk);
    const bool in = r < p.Sk;
    const __nv_bfloat16* kg = static_cast<const __nv_bfloat16*>(p.k) +
                              b * p.ksb + hk * p.ksh + (in ? r * p.kss : 0);
    const __nv_bfloat16* vg = static_cast<const __nv_bfloat16*>(p.v) +
                              b * p.vsb + hk * p.vsh + (in ? r * p.vss : 0);
    mma_sync::CpAsync16(ks + (j * skp + r) * LD + col, kg + col, in);
    mma_sync::CpAsync16(vs + (j * skp + r) * LD + col, vg + col, in);
  }
  if (warp < tasks) StageQ<D>(p, TaskOf(p, first, group, tiles, warp), stage,
                              lane);
  mma_sync::CpAsyncCommit();
  mma_sync::CpAsyncWait<0>();
  __syncthreads();

  const int g = lane >> 2, c = lane & 3;
  const float c2 = p.scale * kLog2e;
  for (int t = warp; t < tasks; t += kShortWarps) {
    const ShortTask k = TaskOf(p, first, group, tiles, t);
    if (t != warp) {
      StageQ<D>(p, k, stage, lane);
      mma_sync::CpAsyncCommit();
      mma_sync::CpAsyncWait<0>();
      __syncwarp();
    }
    uint32_t qa[D / 16][4];
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      LoadA(qa[kk], stage, LD, 0, 16 * kk, lane);
    const __nv_bfloat16* kt = ks + k.j * skp * LD;
    const __nv_bfloat16* vt = vs + k.j * skp * LD;
    int lo, hi;
    KvRange(p, k.r0, 16, &lo, &hi);
    const int plo = lo / 16, phi = (hi + 15) / 16;  // the warp's column pairs

    // S = Q K^T over the live column pairs (raw dot products).
    float s[2 * NP][4];
#pragma unroll
    for (int j = 0; j < 2 * NP; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int np = 0; np < NP; ++np) {
      if (np < plo || np >= phi) continue;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t bk[4];
        LoadBt(bk, kt, LD, 16 * np, 16 * kk, lane);
        Mma(s[2 * np], qa[kk], bk[0], bk[1]);
        Mma(s[2 * np + 1], qa[kk], bk[2], bk[3]);
      }
    }

    // One softmax pass over the whole row: s[j][e] is row r0 + g + 8 (e/2),
    // column 8j + 2c + (e%2).
    float l_row[2], m_row[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = k.r0 + g + 8 * r;
      float mx = kMask;
#pragma unroll
      for (int j = 0; j < 2 * NP; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = 8 * j + 2 * c + e;
          if (j < 2 * plo || j >= 2 * phi || !Live(p, row, col))
            s[j][2 * r + e] = kMask;
          mx = fmaxf(mx, s[j][2 * r + e]);
        }
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float mc = mx > kMask ? mx * c2 : 0.f;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 2 * NP; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float x = sm90::Exp2(fmaf(s[j][2 * r + e], c2, -mc));
          s[j][2 * r + e] = x;
          sum += x;
        }
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      l_row[r] = sum;
      m_row[r] = mx;
    }

    // O = P V, P rounded to bf16 pairs in registers (s is dead after).
    uint32_t pa[NP][4];
    mma_sync::PackA<2 * NP>(pa, s);
    float o[D / 8][4];
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
#pragma unroll
    for (int np = 0; np < NP; ++np) {
      if (np < plo || np >= phi) continue;
#pragma unroll
      for (int n0 = 0; n0 < D; n0 += 16) {
        uint32_t bv[4];
        LoadB(bv, vt, LD, 16 * np, n0, lane);
        Mma(o[n0 / 8], pa[np], bv[0], bv[1]);
        Mma(o[n0 / 8 + 1], pa[np], bv[2], bv[3]);
      }
    }

    // O through the stage to 16-byte stores; l and m beside it.
    __syncwarp();
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float inv = l_row[r] == 0.f ? 1.f : 1.f / l_row[r];
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<uint32_t*>(stage + (g + 8 * r) * LD + 8 * j +
                                     2 * c) =
            PackBf16(o[j][2 * r] * inv, o[j][2 * r + 1] * inv);
      const int row = k.r0 + g + 8 * r;
      if (c == 0 && p.l != nullptr && row < p.Sq) {
        const long long at =
            (static_cast<long long>(k.b) * p.H + k.h) * p.Sq + row;
        p.l[at] = l_row[r];
        p.m[at] = m_row[r] * p.scale;
      }
    }
    __syncwarp();
    __nv_bfloat16* og =
        static_cast<__nv_bfloat16*>(p.o) + k.b * p.osb + k.h * p.osh;
    for (int i = lane; i < 16 * D / 8; i += 32) {
      const int r = i / (D / 8), col = (i % (D / 8)) * 8;
      if (k.r0 + r < p.Sq)
        *reinterpret_cast<uint4*>(og + (k.r0 + r) * p.oss + col) =
            *reinterpret_cast<const uint4*>(stage + r * LD + col);
    }
    __syncwarp();
  }
}

// ------------------------ bf16, MHA self-attention at S <= 8: packed heads

// Heads of S <= kPackMax rows (MHA self-attention) packed 16 / S to a
// 16-row tile: FlashFwdPacked, the twin of flash_bwd.cu's FlashBwdPacked,
// which reads the l and m it writes.
constexpr int kPackMax = 8;
constexpr int kPackWarps = 4;        // warps a block, each on tiles of its own
constexpr int kPackStages = 2;       // a warp's ring: tiles staged or landing
constexpr int kPackBlocksPerSm = 3;  // the persistent grid's blocks an SM

// Blocks an SM of the persistent grid: kPackBlocksPerSm at d <= 64 (55 KB
// of rings a block at d = 64); 2 at d = 128, whose rings take 104 KB. At
// [1568, 12, 4, 64] 3 blocks read 25.33 us held against 25.81 at 2 (the
// last of a warp's turns 97% full, not 45%), 25.42 at 4, 35.90 at 1; at
// 2 blocks, one slot a warp read 32.58 and three 27.33 (an H100 80GB HBM3
// at 700 W, tools/flash_variants.py short_fwd).
template <int D>
constexpr int PackBlocksPerSm() {
  return D <= 64 ? kPackBlocksPerSm : 2;
}

// A warp's ring: kPackStages slots of Q, K and V, 16 padded rows each.
template <int D>
constexpr int SmemPacked() {
  return kPackWarps * kPackStages * 3 * 16 * (D + kShortPad) * 2;
}

using sm90::SmCount;

// Whether rows rq and rk of a tile of packed heads of s rows each are a
// live pair: the same head, one of the tile's `pack`, and Live there.
__device__ __forceinline__ bool LivePacked(const Params& p, int pack, int s,
                                           int rq, int rk) {
  const int hq = rq / s;
  return hq == rk / s && hq < pack && Live(p, rq - hq * s, rk - hq * s);
}

// Copy k of a tile's 16 rows: head *ih of the tile (pack or more: a spare
// row), row *lr of it, at tile row *r = *ih * s + *lr. The pack * s live
// rows go row-major over (lr, ih) where the heads lie closer together in
// memory than the rows (the model's [B, S, H, d] views: a warp's copies
// then sweep runs of pack heads), else over (ih, lr); spare rows last.
__device__ __forceinline__ void PackedRow(int k, int pack, int s, bool smajor,
                                          int* r, int* ih, int* lr) {
  if (k >= pack * s) {
    *r = k;
    *ih = pack;
    *lr = 0;
    return;
  }
  *ih = smajor ? k % pack : k / s;
  *lr = smajor ? k / pack : k % s;
  *r = *ih * s + *lr;
}

// FlashFwdShort for MHA self-attention at S <= kPackMax (H == Hk, Sq ==
// Sk), where a 16-row tile of one head is at least half padding (three
// quarters at the factorized ViT-B's S = 4). Tile t holds the `pack` = 16
// / S heads [t pack, (t + 1) pack) in the flat order b * H + h, head i of
// it at rows [i S, (i + 1) S), the rows past pack * S spare. A logit is
// live only within its head's diagonal block (LivePacked), so the heads
// of a tile do not see each other: P = 0 exactly off it, and no spare row
// writes o, l or m. The tile's Q, K and V are its own 16 rows, so a warp
// needs nothing of the other warps: a persistent grid, each warp on the
// tiles warp, warp + W, ... (W warps in all), through a ring of
// kPackStages slots of its own, tile u + kPackStages - 1 copied in by
// cp.async while tile u is computed. The products are one 16 x 16 column
// pair (S = Q K^T: d / 16 steps; O = P V: one step), so S, P and O take
// the registers of the live tile alone. Numerics are FlashFwdShort's: the
// raw dot products, the row max and exp2 in f32, l the f32 sum of p (each
// lane's four columns, then across its quad), P rounded to bf16 before P
// V, o = acc * (l == 0 ? 1 : 1/l), m the row max times the scale. O goes
// through the slot's Q rows to 16-byte stores; each output is written
// once, so two launches give the same bytes.
template <int D>
__global__ void __launch_bounds__(kPackWarps * 32, PackBlocksPerSm<D>())
    FlashFwdPacked(const Params p, int pack, int smajor) {
  constexpr int LD = D + kShortPad;
  constexpr int CPR = D / 8;       // 16-byte pieces a row
  constexpr int kTile = 16 * LD;   // a staged 16-row tile
  using mma_sync::CpAsync16;
  using mma_sync::LoadA;
  using mma_sync::LoadB;
  using mma_sync::LoadBt;
  using mma_sync::Mma;
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem) +
                        warp * kPackStages * 3 * kTile;
  const int s = p.Sq;
  const long long heads = static_cast<long long>(p.B) * p.H;
  const long long tiles = (heads + pack - 1) / pack;
  const long long step = static_cast<long long>(gridDim.x) * kPackWarps;
  const long long w0 = static_cast<long long>(blockIdx.x) * kPackWarps + warp;
  const __nv_bfloat16* qg = static_cast<const __nv_bfloat16*>(p.q);
  const __nv_bfloat16* kg = static_cast<const __nv_bfloat16*>(p.k);
  const __nv_bfloat16* vg = static_cast<const __nv_bfloat16*>(p.v);

  // The batch b0 and head h0 of tile t's first head.
  auto first_of = [&](long long t, int* b0, int* h0) {
    const long long head = t * pack;
    *b0 = static_cast<int>(head / p.H);
    *h0 = static_cast<int>(head - static_cast<long long>(*b0) * p.H);
  };
  // The batch and head of head ih of tile t, whose first is (b0, h0);
  // false for a spare row or past the last head.
  auto locate = [&](long long t, int b0, int h0, int ih, int* b, int* h) {
    if (ih >= pack || t * pack + ih >= heads) return false;
    *b = b0;
    *h = h0 + ih;
    if (*h >= p.H) {
      const int wrap = *h / p.H;
      *b += wrap;
      *h -= wrap * p.H;
    }
    return true;
  };
  // Q, K and V of tile t into a slot, zeros in spare rows.
  auto stage = [&](long long t, __nv_bfloat16* slot) {
    int b0, h0;
    first_of(t, &b0, &h0);
#pragma unroll
    for (int i = lane; i < 16 * CPR; i += 32) {
      const int k = i / CPR, col = (i % CPR) * 8;
      int r, ih, lr, b = 0, h = 0;
      PackedRow(k, pack, s, smajor, &r, &ih, &lr);
      const bool in = locate(t, b0, h0, ih, &b, &h);
      const long long qo = in ? b * p.qsb + h * p.qsh + lr * p.qss : 0;
      const long long ko = in ? b * p.ksb + h * p.ksh + lr * p.kss : 0;
      const long long vo = in ? b * p.vsb + h * p.vsh + lr * p.vss : 0;
      CpAsync16(slot + r * LD + col, qg + qo + col, in);
      CpAsync16(slot + kTile + r * LD + col, kg + ko + col, in);
      CpAsync16(slot + 2 * kTile + r * LD + col, vg + vo + col, in);
    }
  };

#pragma unroll
  for (int u = 0; u < kPackStages - 1; ++u) {
    const long long t = w0 + u * step;
    if (t < tiles) stage(t, ring + u * 3 * kTile);
    mma_sync::CpAsyncCommit();
  }
  const int g = lane >> 2, c = lane & 3;
  const float c2 = p.scale * kLog2e;
  long long t = w0;
  for (int u = 0; t < tiles; ++u, t += step) {
    // The slot of tile u + kPackStages - 1 held tile u - 1, whose O the
    // lanes have read out by now.
    __syncwarp();
    const long long ahead = t + (kPackStages - 1) * step;
    if (ahead < tiles)
      stage(ahead, ring + (u + kPackStages - 1) % kPackStages * 3 * kTile);
    mma_sync::CpAsyncCommit();
    mma_sync::CpAsyncWait<kPackStages - 1>();
    __syncwarp();
    __nv_bfloat16* qs = ring + u % kPackStages * 3 * kTile;
    const __nv_bfloat16* ks = qs + kTile;
    const __nv_bfloat16* vs = qs + 2 * kTile;

    // S = Q K^T over the tile (raw dot products).
    float sc[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t qa[4], bk[4];
      LoadA(qa, qs, LD, 0, 16 * kk, lane);
      LoadBt(bk, ks, LD, 0, 16 * kk, lane);
      Mma(sc[0], qa, bk[0], bk[1]);
      Mma(sc[1], qa, bk[2], bk[3]);
    }

    // One softmax pass a row over its head's diagonal block: sc[j][e] is
    // row g + 8 (e/2), column 8j + 2c + (e%2).
    float l_row[2], m_row[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = g + 8 * r;
      float mx = kMask;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          if (!LivePacked(p, pack, s, row, 8 * j + 2 * c + e))
            sc[j][2 * r + e] = kMask;
          mx = fmaxf(mx, sc[j][2 * r + e]);
        }
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float mc = mx > kMask ? mx * c2 : 0.f;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float x = sm90::Exp2(fmaf(sc[j][2 * r + e], c2, -mc));
          sc[j][2 * r + e] = x;
          sum += x;
        }
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      l_row[r] = sum;
      m_row[r] = mx;
    }

    // O = P V, P rounded to bf16 pairs in registers.
    uint32_t pa[1][4];
    mma_sync::PackA<2>(pa, sc);
    float o[D / 8][4];
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
#pragma unroll
    for (int n0 = 0; n0 < D; n0 += 16) {
      uint32_t bv[4];
      LoadB(bv, vs, LD, 0, n0, lane);
      Mma(o[n0 / 8], pa[0], bv[0], bv[1]);
      Mma(o[n0 / 8 + 1], pa[0], bv[2], bv[3]);
    }

    // O through the slot's Q rows to 16-byte stores; l and m beside it
    // (a tile's live rows are l's and m's rows [t pack s, (t + 1) pack s)).
    __syncwarp();
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = g + 8 * r;
      const float inv = l_row[r] == 0.f ? 1.f : 1.f / l_row[r];
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<uint32_t*>(qs + row * LD + 8 * j + 2 * c) =
            PackBf16(o[j][2 * r] * inv, o[j][2 * r + 1] * inv);
      const long long at = t * pack * s + row;
      if (c == 0 && p.l != nullptr && row < pack * s && at < heads * s) {
        p.l[at] = l_row[r];
        p.m[at] = m_row[r] * p.scale;
      }
    }
    __syncwarp();
    __nv_bfloat16* og = static_cast<__nv_bfloat16*>(p.o);
    int b0, h0;
    first_of(t, &b0, &h0);
#pragma unroll
    for (int i = lane; i < 16 * CPR; i += 32) {
      const int k = i / CPR, col = (i % CPR) * 8;
      int r, ih, lr, b, h;
      PackedRow(k, pack, s, smajor, &r, &ih, &lr);
      if (locate(t, b0, h0, ih, &b, &h))
        *reinterpret_cast<uint4*>(og + b * p.osb + h * p.osh + lr * p.oss +
                                  col) =
            *reinterpret_cast<const uint4*>(qs + r * LD + col);
    }
  }
  mma_sync::CpAsyncWait<0>();
}

// The launch plan of the short design at a shape. FlashFwdPacked serves
// MHA self-attention at S <= kPackMax: a persistent grid of at most
// PackBlocksPerSm blocks an SM, a warp a tile of 16 / S heads at a time.
// FlashFwdShort serves the rest: as many kv heads a block as give its
// warps a 16-row q tile each, all of a block's tiles loaded before the
// first product.
struct ShortFwdPlan {
  int pack;    // heads a 16-row tile: above 1 for FlashFwdPacked
  int heads;   // heads a block takes at a time (kv heads for FlashFwdShort)
  int blocks;
  int smem;    // dynamic shared memory a block
  int stages;  // tiles a warp has staged or landing
  int smajor;  // FlashFwdPacked: copies over (row, head), else (head, row)
};

inline bool Packed(const Params& p) {
  return p.H == p.Hk && p.Sq == p.Sk && p.Sq <= kPackMax;
}

// Fills `plan` and opts the kernel it names in to its shared memory.
template <int D>
cudaError_t PlanShort(const Params& p, ShortFwdPlan* plan) {
  ShortFwdPlan& x = *plan;
  long long blocks;
  if (Packed(p)) {
    x.pack = 16 / p.Sq;
    x.heads = kPackWarps * x.pack;
    const long long tiles =
        (static_cast<long long>(p.B) * p.H + x.pack - 1) / x.pack;
    blocks = (tiles + kPackWarps - 1) / kPackWarps;
    const long long grid = static_cast<long long>(SmCount()) *
                           PackBlocksPerSm<D>();
    if (blocks > grid) blocks = grid;
    x.smem = SmemPacked<D>();
    x.stages = kPackStages;
    x.smajor = p.qsh < p.qss;
  } else {
    const int tasks = p.H / p.Hk * ((p.Sq + 15) / 16);
    x.pack = 1;
    x.heads = tasks >= kShortWarps ? 1 : kShortWarps / tasks;
    blocks = (static_cast<long long>(p.B) * p.Hk + x.heads - 1) / x.heads;
    x.smem = SmemShort<D>(x.heads, p.Sk);
    x.stages = 1;
    x.smajor = 0;
  }
  x.blocks = static_cast<int>(blocks);
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  if (x.smem <= 48 * 1024) return cudaSuccess;
  return x.pack > 1 ? cudaFuncSetAttribute(
                          FlashFwdPacked<D>,
                          cudaFuncAttributeMaxDynamicSharedMemorySize, x.smem)
                    : cudaFuncSetAttribute(
                          FlashFwdShort<D>,
                          cudaFuncAttributeMaxDynamicSharedMemorySize, x.smem);
}

template <int D>
cudaError_t LaunchShort(const Params& p, cudaStream_t stream) {
  ShortFwdPlan x;
  const cudaError_t err = PlanShort<D>(p, &x);
  if (err != cudaSuccess) return err;
  if (x.pack > 1)
    FlashFwdPacked<D><<<x.blocks, kPackWarps * 32, x.smem, stream>>>(
        p, x.pack, x.smajor);
  else
    FlashFwdShort<D><<<x.blocks, kShortWarps * 32, x.smem, stream>>>(
        p, x.heads);
  return cudaGetLastError();
}

// ------------------------------------------------ bf16, mid-length sequences

constexpr int kMidMax = 256;   // max(Sq, Sk) up to which FlashFwdMid runs
constexpr int kMidRows = 64;   // q rows a task, kv rows a staged box
constexpr int kMidConsumers = 2;  // warpgroups a block, a task each
constexpr int kMidTail = 16;      // N of a last kv chunk with <= 16 live
// Blocks an SM must hold at once: 2 (128 registers a thread, 97 KB of
// shared memory at d = 64), so that one block's K/V and Q loads land
// while the other's warpgroups compute.
constexpr int kMidBlocksPerSm = 2;

template <int D>
struct MidCfg {
  static constexpr int kRowBytes = 2 * D;  // one 64- or 128-byte swizzle row
  static constexpr int kBoxBytes = kMidRows * kRowBytes;
  static constexpr int kThreads = 128 * kMidConsumers;
};

// Shared memory of a FlashFwdMid block: from a 1024-aligned base, K and V
// of one kv head in 64-row boxes (Sk rounded up to 64, zeros past Sk),
// a Q tile a warpgroup, then an mbarrier a K/V box and one a Q tile.
template <int D>
int SmemMid(int sk) {
  using C = MidCfg<D>;
  const int boxes = (sk + kMidRows - 1) / kMidRows;
  return 1024 + (2 * boxes + kMidConsumers) * C::kBoxBytes +
         8 * (boxes + kMidConsumers);
}

// S = Q K^T of one kv chunk of N = 8 NJ columns (64 for a full chunk, 16
// for the tail) into s, Q and K read from their swizzled tiles; issued and
// committed, not waited for. (Q from registers, loaded once a task by
// ldmatrix, read within 1% of this on an H100: tools/flash_variants.py's
// sweep at the time.)
template <int D, int NJ>
__device__ __forceinline__ void MidQK(float* s, uint32_t q_tile,
                                      uint32_t k_rows) {
  constexpr int RB = MidCfg<D>::kRowBytes;
  sm90::WgmmaFence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint64_t da = sm90::Desc(q_tile + kk * 32, RB);
    const uint64_t db = sm90::Desc(k_rows + kk * 32, RB);
    if constexpr (NJ == 8) {
      if (kk == 0) {
        sm90::WgmmaSS64Init(s, da, db);
      } else {
        sm90::WgmmaSS64(s, da, db);
      }
    } else {
      if (kk == 0) {
        sm90::WgmmaSS16Init(s, da, db);
      } else {
        sm90::WgmmaSS16(s, da, db);
      }
    }
  }
  sm90::WgmmaCommit();
}

// O += P V over KS k-steps of 16 kv rows from `v_rows`, P from registers,
// V read MN-major; issued and committed, not waited for.
template <int D, int KS>
__device__ __forceinline__ void MidPV(float* o, uint32_t (*pa)[4],
                                      uint32_t v_rows) {
  constexpr int RB = MidCfg<D>::kRowBytes;
  sm90::WgmmaFence();
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    const uint64_t dv = sm90::Desc(v_rows + kk * 16 * RB, RB);
    if constexpr (D == 64) {
      sm90::WgmmaRS64(o, pa[kk], dv);
    } else {
      sm90::WgmmaRS32(o, pa[kk], dv);
    }
  }
  sm90::WgmmaCommit();
}

// One kv chunk of a task, in the tiled kernel's order: S = Q K^T of the
// chunk (N = 8 NJ) issued together with O += P V of the full chunk before
// it (kPrev; its P in `pa`), the chunk's online softmax run while that
// P V runs, then the accumulator rescaled once it is done and the chunk's
// P packed into `pa`.
template <int D, int NJ, bool kPrev>
__device__ __forceinline__ void MidChunk(const Params& p, float* s, float* o,
                                         uint32_t (*pa)[4], uint32_t q_tile,
                                         uint32_t ks, uint32_t vs, int k0,
                                         int row0, int q0, int c, float c2,
                                         float* m_run, float* l_run) {
  constexpr int RB = MidCfg<D>::kRowBytes;
  MidQK<D, NJ>(s, q_tile, ks + k0 * RB);
  if constexpr (kPrev) MidPV<D, 4>(o, pa, vs + (k0 - kMidRows) * RB);
  sm90::WgmmaWait<kPrev ? 1 : 0>();
  sm90::FenceRegs<4 * NJ>(s);
  float alpha[2];
  Softmax<NJ>(p, s, row0, q0, k0, c, c2, m_run, l_run, alpha);
  if constexpr (kPrev) {
    sm90::WgmmaWait<0>();
    sm90::FenceRegs<D / 2>(o);
    sm90::FenceRegs<16>(&pa[0][0]);
  }
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    o[4 * j] *= alpha[0];
    o[4 * j + 1] *= alpha[0];
    o[4 * j + 2] *= alpha[1];
    o[4 * j + 3] *= alpha[1];
  }
  PackP<NJ / 2>(s, pa);
}

// One task: 64 q rows [q0, q0 + 64) of q head h against the staged kv
// head, in 64-column chunks from the one KvRange's first column falls in
// to the one its last falls in, that last one cut to kMidTail columns
// where no more of it is live. Thread fragment as the tiled kernel's
// Consume: row0 = q0 + 16 warp + g and row0 + 8.
template <int D>
__device__ __forceinline__ void MidTask(const Params& p, uint32_t q_tile,
                                        uint32_t qbar, uint32_t ks,
                                        uint32_t vs, uint32_t kvbar, int b,
                                        int h, int q0, int tw) {
  constexpr int ON = D / 2;
  const int warp = tw / 32, lane = tw % 32, g = lane >> 2, c = lane & 3;
  const int row0 = q0 + warp * 16 + g;
  const float c2 = p.scale * kLog2e;
  int lo, hi;
  KvRange(p, q0, kWgRows, &lo, &hi);
  const int first = lo / kMidRows, last = (hi - 1) / kMidRows;
  const bool tail = hi - last * kMidRows <= kMidTail;
  const int full_end = tail ? last : last + 1;

  float s[32], o[ON];
  uint32_t pa[4][4];
#pragma unroll
  for (int i = 0; i < ON; ++i) o[i] = 0.f;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int x = 0; x < 4; ++x) pa[kk][x] = 0u;
  float m_run[2] = {-INFINITY, -INFINITY};  // max of the raw dot products
  float l_run[2] = {0.f, 0.f};              // this thread's share of l

  constexpr int RB = MidCfg<D>::kRowBytes;
  const uint32_t v_last = vs + last * kMidRows * RB;
  sm90::MbarWait(qbar, 0);
  sm90::MbarWait(kvbar + 8 * first, 0);
  if (first < full_end) {
    MidChunk<D, 8, false>(p, s, o, pa, q_tile, ks, vs,
                          first * kMidRows, row0, q0, c, c2, m_run, l_run);
    for (int ch = first + 1; ch < full_end; ++ch) {
      sm90::MbarWait(kvbar + 8 * ch, 0);
      MidChunk<D, 8, true>(p, s, o, pa, q_tile, ks, vs, ch * kMidRows,
                           row0, q0, c, c2, m_run, l_run);
    }
    if (tail) {
      sm90::MbarWait(kvbar + 8 * last, 0);
      MidChunk<D, 2, true>(p, s, o, pa, q_tile, ks, vs,
                           last * kMidRows, row0, q0, c, c2, m_run, l_run);
      MidPV<D, 1>(o, pa, v_last);
    } else {
      MidPV<D, 4>(o, pa, v_last);
    }
  } else {  // the tail is the task's one chunk
    MidChunk<D, 2, false>(p, s, o, pa, q_tile, ks, vs, last * kMidRows,
                          row0, q0, c, c2, m_run, l_run);
    MidPV<D, 1>(o, pa, v_last);
  }
  sm90::WgmmaWait<0>();
  sm90::FenceRegs<ON>(o);
  sm90::FenceRegs<16>(&pa[0][0]);
  StoreO<D>(p, o, l_run, m_run, b, h, row0, c);
}

// One kv head's K and V staged once by TMA, the q heads of its group cut
// into 64-row tasks (q head hk * group + t / tiles, rows 64 (t % tiles)),
// a warpgroup a task: S = Q K^T on wgmma from the swizzled tiles, m and
// l online over 64-column chunks (base 2, m on the raw dot products,
// scaled once), P packed to bf16 in registers as the A operand of O +=
// P V. Block `blockIdx.x` is part `blockIdx.x % parts` of kv head
// `blockIdx.x / parts` and takes tasks 2 part and 2 part + 1; one thread
// issues every load at the start, Q before all but the first K/V box.
template <int D>
__global__ void __launch_bounds__(MidCfg<D>::kThreads, kMidBlocksPerSm)
    FlashFwdMid(const __grid_constant__ CUtensorMap tq,
                const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv, const Params p,
                int parts) {
  using C = MidCfg<D>;
  extern __shared__ __align__(16) unsigned char smem[];
  const uint32_t base = (sm90::SmemAddr(smem) + 1023) & ~1023u;
  const int boxes = (p.Sk + kMidRows - 1) / kMidRows;
  const uint32_t ks = base, vs = ks + boxes * C::kBoxBytes;
  const uint32_t qs = vs + boxes * C::kBoxBytes;
  const uint32_t kvbar = qs + kMidConsumers * C::kBoxBytes;
  const uint32_t qbar = kvbar + 8 * boxes;
  const int group = p.H / p.Hk;
  const int tiles = (p.Sq + kMidRows - 1) / kMidRows;
  const int tasks = group * tiles;
  const long long kv = blockIdx.x / parts;
  const int t_lo = kMidConsumers * (blockIdx.x % parts);
  const int b = static_cast<int>(kv / p.Hk);
  const int hk = static_cast<int>(kv % p.Hk);
  // The warpgroup, broadcast from lane 0 so that the compiler sees it
  // uniform (wgmma under a divergent branch is serialized).
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);

  if (threadIdx.x == 0) {
    for (int i = 0; i < boxes + kMidConsumers; ++i)
      sm90::MbarInit(kvbar + 8 * i, 1);
    sm90::FenceBarrierInit();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int x = 0; x < boxes; ++x) {
      sm90::MbarExpectTx(kvbar + 8 * x, 2 * C::kBoxBytes);
      sm90::TmaLoad4d(ks + x * C::kBoxBytes, &tk, kvbar + 8 * x, 0,
                      x * kMidRows, hk, b);
      sm90::TmaLoad4d(vs + x * C::kBoxBytes, &tv, kvbar + 8 * x, 0,
                      x * kMidRows, hk, b);
      if (x > 0) continue;
      // Task t_lo + w into warpgroup w's Q tile.
      for (int w = 0; w < kMidConsumers && t_lo + w < tasks; ++w) {
        const int t = t_lo + w;
        sm90::MbarExpectTx(qbar + 8 * w, C::kBoxBytes);
        sm90::TmaLoad4d(qs + w * C::kBoxBytes, &tq, qbar + 8 * w, 0,
                        kMidRows * (t % tiles), hk * group + t / tiles, b);
      }
    }
  }
  const int t = t_lo + wg;
  if (t < tasks)
    MidTask<D>(p, qs + wg * C::kBoxBytes, qbar + 8 * wg, ks, vs, kvbar, b,
               hk * group + t / tiles, kMidRows * (t % tiles),
               threadIdx.x % 128);
}

// Blocks a kv head: two tasks a block.
inline int MidParts(const Params& p) {
  const int tasks = p.H / p.Hk * ((p.Sq + kMidRows - 1) / kMidRows);
  return (tasks + kMidConsumers - 1) / kMidConsumers;
}

template <int D>
cudaError_t LaunchMid(const Params& p, cudaStream_t stream) {
  const int parts = MidParts(p);
  const long long blocks = static_cast<long long>(p.B) * p.Hk * parts;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  // The opt-in at kMidMax's size, the same for every launch.
  const cudaError_t err = cudaFuncSetAttribute(
      FlashFwdMid<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SmemMid<D>(kMidMax));
  if (err != cudaSuccess) return err;
  CUtensorMap tq, tk, tv;
  if (!sm90::EncodeMap(&tq, p.q, D, p.Sq, p.H, p.B, p.qsb, p.qsh, p.qss,
                       kMidRows, D) ||
      !sm90::EncodeMap(&tk, p.k, D, p.Sk, p.Hk, p.B, p.ksb, p.ksh, p.kss,
                       kMidRows, D) ||
      !sm90::EncodeMap(&tv, p.v, D, p.Sk, p.Hk, p.B, p.vsb, p.vsh, p.vss,
                       kMidRows, D))
    return cudaErrorInvalidValue;
  FlashFwdMid<D><<<static_cast<int>(blocks), MidCfg<D>::kThreads,
                   SmemMid<D>(p.Sk), stream>>>(tq, tk, tv, p, parts);
  return cudaGetLastError();
}

// ---------------------------------------------------------------- f32

constexpr int kBqF = 32;  // q rows a block (4 threads a row)
constexpr int kBkF = 32;  // kv columns a tile

template <int D>
constexpr int SmemF32() {
  return (kBqF * (D + 1) + kBkF * (D + 1) + kBkF * D + kBqF * (kBkF + 1)) * 4;
}

template <int D>
__global__ void __launch_bounds__(128) FlashFwdF32(Params p) {
  constexpr int LD = D + 1;          // odd row pitch: no bank conflicts
  constexpr int PLD = kBkF + 1;
  constexpr int DC = D / 4;          // output columns a thread
  constexpr int JC = kBkF / 4;       // logits a thread per tile
  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);  // [BQ][D+1]
  float* ks = qs + kBqF * LD;                  // [BK][D+1]
  float* vs = ks + kBkF * LD;                  // [BK][D]
  float* ps = vs + kBkF * D;                   // [BQ][BK+1]

  const int tid = threadIdx.x, r = tid >> 2, sub = tid & 3;
  const int q0 = blockIdx.x * kBqF, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (p.H / p.Hk);
  const float* qg = static_cast<const float*>(p.q) + b * p.qsb + h * p.qsh;
  const float* kg = static_cast<const float*>(p.k) + b * p.ksb + hk * p.ksh;
  const float* vg = static_cast<const float*>(p.v) + b * p.vsb + hk * p.vsh;

  for (int i = tid; i < kBqF * D / 4; i += 128) {
    const int rr = i / (D / 4), col = (i % (D / 4)) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q0 + rr < p.Sq)
      val = *reinterpret_cast<const float4*>(qg + (q0 + rr) * p.qss + col);
    float* dst = qs + rr * LD + col;
    dst[0] = val.x; dst[1] = val.y; dst[2] = val.z; dst[3] = val.w;
  }

  float acc[DC];
#pragma unroll
  for (int t = 0; t < DC; ++t) acc[t] = 0.f;
  float m_run = -INFINITY, l_run = 0.f;
  const int row = q0 + r;

  int lo, hi;
  KvRange(p, q0, kBqF, &lo, &hi);
  for (int k0 = (lo / kBkF) * kBkF; k0 < hi; k0 += kBkF) {
    __syncthreads();
    for (int i = tid; i < kBkF * D / 4; i += 128) {
      const int j = i / (D / 4), col = (i % (D / 4)) * 4;
      float4 kv = make_float4(0.f, 0.f, 0.f, 0.f), vv = kv;
      if (k0 + j < p.Sk) {
        kv = *reinterpret_cast<const float4*>(kg + (k0 + j) * p.kss + col);
        vv = *reinterpret_cast<const float4*>(vg + (k0 + j) * p.vss + col);
      }
      float* kd = ks + j * LD + col;
      kd[0] = kv.x; kd[1] = kv.y; kd[2] = kv.z; kd[3] = kv.w;
      *reinterpret_cast<float4*>(vs + j * D + col) = vv;
    }
    __syncthreads();

    const bool masked = TileNeedsMask(p, q0, kBqF, k0, kBkF);
    float s[JC];
    float mx = kMask;
#pragma unroll
    for (int jj = 0; jj < JC; ++jj) {
      const int j = sub + 4 * jj;
      float dot = 0.f;
#pragma unroll 16
      for (int x = 0; x < D; ++x) dot = fmaf(qs[r * LD + x], ks[j * LD + x], dot);
      dot *= p.scale;
      if (masked && !Live(p, row, k0 + j)) dot = kMask;
      s[jj] = dot;
      mx = fmaxf(mx, dot);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m_run, mx);
    const float alpha = expf(m_run - m_new);
    m_run = m_new;
    float sum = 0.f;
#pragma unroll
    for (int jj = 0; jj < JC; ++jj) {
      const float e = expf(s[jj] - m_new);
      ps[r * PLD + sub + 4 * jj] = e;
      sum += e;
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    l_run = l_run * alpha + sum;
    __syncwarp();  // a row's 4 threads share one warp
#pragma unroll
    for (int t = 0; t < DC; ++t) acc[t] *= alpha;
    for (int j = 0; j < kBkF; ++j) {
      const float pj = ps[r * PLD + j];
#pragma unroll
      for (int t = 0; t < DC; ++t) acc[t] = fmaf(pj, vs[j * D + sub + 4 * t], acc[t]);
    }
    __syncwarp();
  }

  if (row < p.Sq) {
    float* og = static_cast<float*>(p.o) + b * p.osb + h * p.osh + row * p.oss;
    const float inv = l_run == 0.f ? 1.f : 1.f / l_run;
#pragma unroll
    for (int t = 0; t < DC; ++t) og[sub + 4 * t] = acc[t] * inv;
    if (sub == 0 && p.l != nullptr) {
      const long long at = (static_cast<long long>(b) * p.H + h) * p.Sq + row;
      p.l[at] = l_run;
      p.m[at] = m_run;
    }
  }
}

template <typename Kernel>
cudaError_t Launch(Kernel kernel, int smem, dim3 grid, const Params& p,
                   cudaStream_t stream) {
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<grid, 128, smem, stream>>>(p);
  return cudaGetLastError();
}

// The design ts_flash_fwd launches: 0 "tiled" (TMA and wgmma), 1 "short"
// (mma.sync, Sq and Sk <= kShortMax: FlashFwdPacked or FlashFwdShort, as
// PlanShort picks), 2 "f32", 3 "mid" (TMA and wgmma, Sq
// and Sk <= kMidMax, one of them past kShortMax, d <= 64). The shape alone
// chooses.
int Design(int dtype, int d, int sq, int sk) {
  if (dtype == 1) return 2;
  if (sq <= kShortMax && sk <= kShortMax) return 1;
  return d <= 64 && sq <= kMidMax && sk <= kMidMax ? 3 : 0;
}

}  // namespace

// dtype: 0 bf16, 1 f32. d: 32, 64 or 128. Strides in elements; the last
// dimension of every tensor is contiguous. l and m may both be null.
// *design is set to the design launched (Design() above).
// Returns a cudaError_t (0 on success, cudaErrorInvalidValue for a head
// dim or dtype the kernel does not take, or for bf16 strides that TMA
// cannot describe).
extern "C" int ts_flash_fwd(
    const void* q, const void* k, const void* v, void* o, float* l, float* m,
    int dtype, int B, int H, int Hk, int Sq, int Sk, int d,
    long long qsb, long long qsh, long long qss,
    long long ksb, long long ksh, long long kss,
    long long vsb, long long vsh, long long vss,
    long long osb, long long osh, long long oss,
    float scale, int causal, int window, void* stream, int* design) {
  Params p{q, k, v, o, l, m, B, H, Hk, Sq, Sk,
           qsb, qsh, qss, ksb, ksh, kss, vsb, vsh, vss, osb, osh, oss,
           scale, causal, window};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype != 0 && dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  *design = Design(dtype, d, Sq, Sk);
  switch (*design) {
    case 0:
      switch (d) {
        case 32: return LaunchBf16<32>(p, s);
        case 64: return LaunchBf16<64>(p, s);
        case 128: return LaunchBf16<128>(p, s);
      }
      break;
    case 1:
      switch (d) {
        case 32: return LaunchShort<32>(p, s);
        case 64: return LaunchShort<64>(p, s);
        case 128: return LaunchShort<128>(p, s);
      }
      break;
    case 3:
      switch (d) {
        case 32: return LaunchMid<32>(p, s);
        case 64: return LaunchMid<64>(p, s);
      }
      break;
    case 2: {
      const dim3 grid((Sq + kBqF - 1) / kBqF, H, B);
      switch (d) {
        case 32: return Launch(FlashFwdF32<32>, SmemF32<32>(), grid, p, s);
        case 64: return Launch(FlashFwdF32<64>, SmemF32<64>(), grid, p, s);
        case 128: return Launch(FlashFwdF32<128>, SmemF32<128>(), grid, p, s);
      }
      break;
    }
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// The blocks an SM holds (out[0]) and the shared memory a block (out[4])
// of FlashFwdMid<D> at Sk, as LaunchMid sets it up.
template <int D>
int MidOccupancy(int sk, int* out) {
  out[4] = SmemMid<D>(sk);
  const cudaError_t err = cudaFuncSetAttribute(
      FlashFwdMid<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SmemMid<D>(kMidMax));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &out[0], FlashFwdMid<D>, MidCfg<D>::kThreads, out[4]));
}

// The launch plan of the "short" design (Design() == 1) at a shape, for a
// caller that reports it: out[0] the heads a 16-row tile (FlashFwdPacked
// where above 1, else FlashFwdShort), out[1] the heads a block takes at a
// time, out[2] the blocks, out[3] the shared memory a block, out[4] the
// tiles a warp has staged or landing, out[5] the blocks an SM holds,
// out[6] the warps a block. Returns a cudaError_t.
template <int D>
int ReportShort(const Params& p, int* out) {
  ShortFwdPlan x;
  const cudaError_t err = PlanShort<D>(p, &x);
  const int plan[] = {x.pack, x.heads, x.blocks, x.smem, x.stages, 0,
                      x.pack > 1 ? kPackWarps : kShortWarps};
  for (int i = 0; i < 7; ++i) out[i] = plan[i];
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(
      x.pack > 1 ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                       &out[5], FlashFwdPacked<D>, kPackWarps * 32, x.smem)
                 : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                       &out[5], FlashFwdShort<D>, kShortWarps * 32, x.smem));
}

extern "C" int ts_flash_fwd_short_plan(int d, int B, int H, int Hk, int Sq,
                                       int Sk, int* out) {
  Params p{};
  p.B = B; p.H = H; p.Hk = Hk; p.Sq = Sq; p.Sk = Sk;
  // The model's [B, S, H, d] views (the copy order only).
  p.qsh = d; p.qss = static_cast<long long>(H) * d;
  switch (d) {
    case 32: return ReportShort<32>(p, out);
    case 64: return ReportShort<64>(p, out);
    case 128: return ReportShort<128>(p, out);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// The launch plan of the "mid" design (Design() == 3) at a shape, for a
// caller that reports it: out[0] the blocks an SM holds, out[1] the blocks
// a kv head, out[2] the blocks, out[3] the warps a block, out[4] the
// shared memory a block. Returns a cudaError_t.
extern "C" int ts_flash_fwd_mid_plan(int d, int B, int H, int Hk, int Sq,
                                     int Sk, int* out) {
  Params p{};
  p.B = B; p.H = H; p.Hk = Hk; p.Sq = Sq; p.Sk = Sk;
  out[1] = MidParts(p);
  out[2] = B * Hk * out[1];
  out[3] = 4 * kMidConsumers;
  switch (d) {
    case 32: return MidOccupancy<32>(Sk, out);
    case 64: return MidOccupancy<64>(Sk, out);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
