// Flash-attention backward on Hopper (sm_90a): dQ, dK and dV of
// o = softmax(Q K^T * scale) V from the forward's residuals (o and its f32
// row sum l and row max m), without the [Sq, Sk] logits in device memory.
//
// Replaces the JAX package's ops/flash_attention.py::_flash_bwd (the VJP
// bound to _flash by defvjp). That routine is a lax.scan over kv tiles,
// not a Pallas kernel, but it is the device code of the JAX training path.
// It computes what _flash_bwd computes, not step by step:
//   delta = rowsum(f32(dO) * f32(o)), o as the forward returned it;
//   l_inv = l == 0 ? 1 : 1 / l;
//   S = Q K^T * scale (f32), masked with -0.7 * FLT_MAX (col >= Sk; under
//     causal col > row; under a window col <= row - W when causal and
//     |col - row| >= W when symmetric);
//   P = exp(S - m) * l_inv (f32);
//   dV = bf16(P)^T dO            (P cast to the input dtype: "pc");
//   dP = dO V^T (f32);
//   dS = cast((P * (dP - delta)) * scale), with the f32 P;
//   dQ = dS K, dK = dS^T Q.
// Matmul operands are in the input dtype, every sum is f32 and each output
// is cast once at the end. A masked logit gives P = 0 exactly, as
// exp(-0.7 * FLT_MAX - m) does in the reference.
//
// Three kernels, one launch each, on the caller's stream:
//   * Delta: each row's statistics, delta and l_inv (DeltaTiles: b and
//     delta * scale, in the wgmma design).
//   * Dkv: one block per (kv tile, batch * kv head). It loops over the g =
//     H / Hk q heads of its group and over the q tiles of its kv tile's
//     live row band (causal starts at the tile's first column; a window
//     ends W - 1 rows past its last column and, symmetric, starts W - 1
//     before its first), so a window costs O(S * W) like _flash_bwd's
//     banded_bwd. dK and dV of the group sum in registers.
//   * Dq: one block per (q tile, batch * head), looping over the live kv
//     tiles as the forward does; dQ sums in f32 registers across them (the
//     scan's carry).
// No block writes what another writes and nothing uses atomics: two
// launches on the same inputs give the same bytes. The price is that S
// and dP are computed in both Dkv and Dq: seven products a tile pair
// where one pass with atomic dQ sums would need five.
//
// Bound: at the training shape [4, 12, 1568, 64] bf16 the five products
// are 10 * B*H*Sq*Sk*d = 75.5 GFLOP, 76.3 us at 989 TFLOP/s (the seven
// run here are 105.7 GFLOP, 107 us), against ~77 MB of q, k, v, o, dO, l,
// m and the three outputs (23 us at 3.35 TB/s): the tensor cores bound it.
//
// Five designs, chosen by dtype, head dim, length and, for "mid" under
// GQA, the (batch, kv head) pairs (Design(), which the wrapper reads to
// count launches by design):
//   * "short", bf16 at Sq and Sk <= 64 (any d): FlashBwdShort, one launch
//     for the three kernels below. It serves the factorized VideoViT's
//     temporal attention ([1568, 12, 4, 64] in ViT-B training, [392, 6,
//     16, 64] W = 8 in the streaming twin), where the wgmma design's
//     128-row tiles hold 4 or 16 live rows, each of its 18,816 Dkv and Dq
//     blocks (64,512 registers) runs one an SM, some 143 waves a kernel,
//     against about 78 MB of bytes (23 us at 3.35 TB/s) and few products:
//     bound by bytes. A block of 4 warps stages the K and V of its kv heads
//     and the Q, dO and o of their q heads once (cp.async), computes delta
//     and each row's exp2 bias itself, and runs the dK/dV pass (a warp a
//     16-row kv slice) and the dQ pass (a warp a 16-row q tile) on
//     mma.sync from shared memory; see FlashBwdShort.
//   * "mid", bf16 at d = 64 and 64 < max(Sq, Sk) <= 256, without GQA or
//     at B * Hk >= kMidMinKvHeads: FlashBwdMid, one launch. It serves the factorized VideoViT's spatial attention
//     ([32, 12, 196, 64] in ViT-B training), where the "wgmma" design's
//     128-row tiles hold 128 and 68 rows, its Dkv and Dq compute S and dP
//     twice (seven products where five do) and DeltaTiles makes a third
//     launch; there the work is 9.4 GFLOP against 77 MB (23.2 us at 3.35
//     TB/s): bound by bytes. At S <= 256 one kv head fits on one SM (K
//     and V 64 KB at most), so a block takes one (batch, kv head):
//     - TMA stages K and V once in 64-row slices, and streams each q
//       tile's Q and dO (64 rows, every q head of the group in order)
//       through a ring, as the "wgmma" design's Dkv streams them; delta
//       and each row's exp2 bias are computed in the block from o and dO,
//       as FlashBwdShort does (no DeltaTiles, no scratch), a tile ahead:
//       the loads for tile u + 1 are issued during tile u.
//     - Each of two consumer warpgroups owns kv slices wg and wg + 2 and
//       keeps their dK and dV in registers (setmaxnreg: 240 a thread).
//       For a q tile it computes S^T = K Q^T and dP^T = V dO^T, turns them
//       into P^T and dS^T in registers, writes both to shared memory in
//       bf16 (the 128-byte swizzle TMA writes), and issues dV += P^T dO
//       and dK += dS^T Q from there: every product is SS, so no register
//       of a product's operand is live across it, and a slice's dV and dK
//       run while the warpgroup issues its next slice's S^T and dP^T.
//     - Once both warpgroups have written a tile's dS^T (double buffered)
//       one of them, alternating, computes dQ = dS K for the tile as one
//       SS chain over its live kv slices in kv order, dS^T and K read
//       MN-major (both transpose bits): the fifth product, each dQ row
//       written once.
//     No atomics, every sum in a fixed order: two launches give the same
//     bytes. dS is rounded to bf16 before dK and dQ, as the contract says.
//     One block an SM (210 KB of shared memory, 384 threads). What is
//     left is the serial chain a warpgroup runs for each pair (products,
//     exponentials, stores, products) with two warpgroups an SM to hide
//     it, and each block's loads before its first product:
//     tools/flash_variants.py times the cuts (loads only, products only,
//     no statistics, no dQ); PERF.md has the readings. A block runs all
//     of its group's q heads, so under GQA a grid of fewer than
//     kMidMinKvHeads blocks leaves most SMs idle while each block runs 3
//     or 6 heads in turn; the "wgmma" design, whose Dq takes a block a
//     q head and 128 rows, is faster there (tools/flash_variants.py's
//     bwd_route study; without GQA "mid" is as fast or faster at every
//     B * H it timed, 12 to 384).
//   * "wgmma", bf16 at d = 64 (the model's head dim): TMA and warp-
//     specialised wgmma, after csrc/flash_fwd.cu and FA3's backward. The
//     mma.sync design below is bound by shared-memory reads: every operand
//     comes through ldmatrix from padded tiles and each ldmatrix feeds two
//     MMAs. Here wgmma reads its B operand (and A of the SS products)
//     straight from the 128-byte-swizzled tiles TMA wrote, and the A
//     operand of dV, dK and dQ is the previous product's accumulator,
//     packed to bf16 in registers: no thread loads an operand.
//     A block is one producer warpgroup (one thread issues every TMA load
//     and bulk copy; setmaxnreg gives its registers away) and two consumer
//     warpgroups of 64 rows each (128-row tiles). The producer streams
//     64-row tiles of the other side through a ring of kRing stages
//     (full/empty mbarrier pairs); Dkv's stages also carry the tile's row
//     statistics, which DeltaTiles lays out in 64-row blocks so that one
//     bulk copy moves them.
//     Dkv: S^T = K Q^T and dP^T = V dO^T are SS m64n64k16 with K-major
//     operands; P^T and dS^T stay in registers as the A fragments of dV +=
//     P^T dO and dK += dS^T Q, RS products whose B (dO, Q) is read
//     MN-major through the descriptor's transpose bit. Dq: S = Q K^T and
//     dP = dO V^T (SS), dQ += dS K (RS, K MN-major). At d = 64 a row is
//     one 128-byte swizzle atom, so Desc's offsets hold for both majors.
//     What bounds it is the elementwise work between the products (an
//     exponential a logit in each kernel), which sits on each consumer's
//     path from one product to the next. The design shortens and hides
//     it: a consumer issues step i's SS products before step i-1's RS
//     products and computes step i's P and dS while those run; the two
//     consumers take turns issuing (ping-pong), so one's elementwise work
//     runs under the other's products; P = exp2(S scale log2(e) - b) and
//     dS = P (dP scale - delta scale) take two instructions each, with b
//     = m log2(e) - log2(l_inv) and delta scale a row from DeltaTiles; and
//     only tiles that a causal or band edge crosses select P = 0 (padding
//     needs no mask, see EdgeCrosses).
//   * "mma_sync", bf16 at d = 32 and 128: bf16 products on mma.sync
//     m16n8k16 with operands read from shared memory by ldmatrix, 64-row
//     tiles (16 rows a warp), the next tile loading by cp.async into a
//     second stage while this one is computed.
//   * "f32": plain FMAs (wgmma has no f32 without TF32, which the contract
//     forbids).
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

#include "mma_sync.cuh"
#include "sm90.cuh"

namespace {

// Indices of the stride triples (batch, head, seq) in Params::st.
enum { kQ, kK, kV, kO, kDo, kDq, kDk, kDv, kTensors };

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  const float* l;   // [B, H, Sq] contiguous
  const float* m;   // [B, H, Sq] contiguous
  float* delta;     // [B, H, Sq] contiguous, written by Delta
  float* linv;      // [B, H, Sq] contiguous, l == 0 ? 1 : 1 / l, by Delta
  float* stats;     // "wgmma": [B * H, tiles, 2, 64], by DeltaTiles
  void* dq;
  void* dk;
  void* dv;
  int B, H, Hk, Sq, Sk;
  int tiles;  // 64-row q tiles: ceil(Sq / 64)
  long long st[kTensors][3];
  float scale;
  int causal;
  int window;  // 0: no window
};

template <typename T>
__device__ __forceinline__ const T* Base(const Params& p, const void* ptr,
                                         int which, int b, int h) {
  return static_cast<const T*>(ptr) + b * p.st[which][0] +
         h * p.st[which][1];
}

template <typename T>
__device__ __forceinline__ T* OutBase(const Params& p, void* ptr, int which,
                                      int b, int h) {
  return static_cast<T*>(ptr) + b * p.st[which][0] + h * p.st[which][1];
}

__device__ __forceinline__ bool Live(const Params& p, int row, int col) {
  if (row >= p.Sq || col >= p.Sk) return false;
  if (p.causal && col > row) return false;
  if (p.window > 0)
    return p.causal ? col > row - p.window : abs(col - row) < p.window;
  return true;
}

// Whether the tile pair (q rows [q0, q0 + bq), kv cols [k0, k0 + bk))
// needs the elementwise mask.
__device__ __forceinline__ bool NeedsMask(const Params& p, int q0, int bq,
                                          int k0, int bk) {
  return q0 + bq > p.Sq || k0 + bk > p.Sk || p.causal || p.window > 0;
}

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

// Half-open range of q rows that may see kv columns [k0, k0 + bk).
__device__ __forceinline__ void QRange(const Params& p, int k0, int bk,
                                       int* lo, int* hi) {
  int l = 0, h = p.Sq;
  if (p.causal) l = k0;
  if (p.window > 0) {
    h = min(h, k0 + bk + p.window - 1);
    if (!p.causal) l = max(l, k0 - (p.window - 1));
  }
  *lo = l;
  *hi = h;
}

__device__ __forceinline__ float ToF(float x) { return x; }
__device__ __forceinline__ float ToF(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// ----------------------------------------------------------------- delta

// delta[b, h, s] = sum_d f32(dO) * f32(o) and linv[b, h, s] = l == 0 ? 1 :
// 1 / l; one warp a row, 4 rows a block.
template <typename T, int D>
__global__ void __launch_bounds__(128) Delta(Params p) {
  const long long row = blockIdx.x * 4LL + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= static_cast<long long>(p.B) * p.H * p.Sq) return;
  const int s = static_cast<int>(row % p.Sq);
  const int h = static_cast<int>((row / p.Sq) % p.H);
  const int b = static_cast<int>(row / (static_cast<long long>(p.Sq) * p.H));
  const T* o = Base<T>(p, p.o, kO, b, h) + s * p.st[kO][2];
  const T* dout = Base<T>(p, p.dout, kDo, b, h) + s * p.st[kDo][2];
  float sum = 0.f;
#pragma unroll
  for (int x = lane; x < D; x += 32) sum = fmaf(ToF(dout[x]), ToF(o[x]), sum);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    sum += __shfl_xor_sync(0xffffffffu, sum, off);
  if (lane == 0) {
    p.delta[row] = sum;
    p.linv[row] = p.l[row] == 0.f ? 1.f : 1.f / p.l[row];
  }
}

// --------------------------------------------------- bf16 d=32, 128: mma_sync

using mma_sync::CpAsync16;
using mma_sync::CpAsync4;
using mma_sync::CpAsyncCommit;
using mma_sync::CpAsyncWait;
using mma_sync::LoadA;
using mma_sync::LoadB;
using mma_sync::LoadBt;
using mma_sync::Mma;
using mma_sync::PackA;
using mma_sync::PackBf16;

// Rows [r0, r0 + rows) of a [S, D] bf16 head into a tile of pitch ld,
// zeros past S, asynchronously.
template <int D>
__device__ __forceinline__ void LoadTile(__nv_bfloat16* tile, int ld,
                                         const __nv_bfloat16* src,
                                         long long sstride, int r0, int rows,
                                         int s) {
  for (int i = threadIdx.x; i < rows * D / 8; i += blockDim.x) {
    const int r = i / (D / 8), col = (i % (D / 8)) * 8;
    const bool in = r0 + r < s;
    CpAsync16(tile + r * ld + col, in ? src + (r0 + r) * sstride + col : src,
              in);
  }
}

// n values of a [S] f32 row statistic from row r0, zeros past S.
__device__ __forceinline__ void LoadStat(float* dst, const float* src, int r0,
                                         int n, int s) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const bool in = r0 + i < s;
    CpAsync4(dst + i, in ? src + r0 + i : src, in);
  }
}

constexpr int kPad = 8;  // bf16 of row padding: conflict-free ldmatrix
constexpr int kRowsB = 64;  // rows a block owns: 16 a warp, 4 warps

// q rows of one step of Dkv: 64, or 32 at d = 128 to keep dK, dV, S^T and
// dP^T in registers.
template <int D>
struct BqDkv {
  static constexpr int value = D == 128 ? 32 : 64;
};

// Two stages of Q, dO and the row statistics (Dkv), or of K and V (Dq): the
// next tile loads while this one is computed.
template <int D>
constexpr int SmemDkvBf16() {
  constexpr int bq = BqDkv<D>::value;
  return (2 * kRowsB + 4 * bq) * (D + kPad) * 2 + 6 * bq * 4;
}

template <int D>
constexpr int SmemDqBf16() { return 6 * kRowsB * (D + kPad) * 2; }

// dK and dV of 64 kv rows of one (batch, kv head). Each warp owns 16 kv
// rows and computes the transposed products S^T = K Q^T and dP^T = V dO^T,
// whose C fragments are the A fragments of dV += P^T dO and dK += dS^T Q.
// The block walks the q tiles of its band for each head of its group, one
// list of steps, with the next step's tiles loading during this one.
// Three blocks an SM at d <= 64 (at most 170 registers a thread).
template <int D>
__global__ void __launch_bounds__(128, D == 128 ? 1 : 3) DkvBf16(Params p) {
  constexpr int BQ = BqDkv<D>::value, LD = D + kPad;
  constexpr int NT = BQ / 8;  // n-tiles of S^T
  constexpr int DT = D / 8;   // n-tiles of dK, dV
  constexpr int KD = D / 16;  // k-steps over d
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* vs = ks + kRowsB * LD;
  __nv_bfloat16* qbuf = vs + kRowsB * LD;     // [2][BQ][LD]
  __nv_bfloat16* dobuf = qbuf + 2 * BQ * LD;  // [2][BQ][LD]
  float* stats = reinterpret_cast<float*>(dobuf + 2 * BQ * LD);  // [2][3][BQ]

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int k0 = blockIdx.x * kRowsB;
  const int b = blockIdx.z, hk = blockIdx.y;
  const int group = p.H / p.Hk;
  const int wr = warp * 16;

  LoadTile<D>(ks, LD, Base<__nv_bfloat16>(p, p.k, kK, b, hk), p.st[kK][2],
              k0, kRowsB, p.Sk);
  LoadTile<D>(vs, LD, Base<__nv_bfloat16>(p, p.v, kV, b, hk), p.st[kV][2],
              k0, kRowsB, p.Sk);

  int lo, hi;
  QRange(p, k0, kRowsB, &lo, &hi);
  const int first = (lo / BQ) * BQ;
  const int per_head = hi > first ? (hi - first + BQ - 1) / BQ : 0;
  const int steps = per_head * group;

  // Issues the loads of step `i` into stage `st`.
  auto issue = [&](int i, int st) {
    const int h = hk * group + i / per_head;
    const int q0 = first + (i % per_head) * BQ;
    const long long stat = (static_cast<long long>(b) * p.H + h) * p.Sq;
    LoadTile<D>(qbuf + st * BQ * LD, LD, Base<__nv_bfloat16>(p, p.q, kQ, b, h),
                p.st[kQ][2], q0, BQ, p.Sq);
    LoadTile<D>(dobuf + st * BQ * LD, LD,
                Base<__nv_bfloat16>(p, p.dout, kDo, b, h), p.st[kDo][2], q0,
                BQ, p.Sq);
    float* sd = stats + st * 3 * BQ;
    LoadStat(sd, p.m + stat, q0, BQ, p.Sq);
    LoadStat(sd + BQ, p.linv + stat, q0, BQ, p.Sq);
    LoadStat(sd + 2 * BQ, p.delta + stat, q0, BQ, p.Sq);
  };

  float dk[DT][4], dv[DT][4];
#pragma unroll
  for (int i = 0; i < DT; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[i][e] = dv[i][e] = 0.f;

  if (steps > 0) issue(0, 0);
  CpAsyncCommit();
  for (int i = 0; i < steps; ++i) {
    const int st = i & 1;
    if (i + 1 < steps) {
      issue(i + 1, st ^ 1);
      CpAsyncCommit();
      CpAsyncWait<1>();
    } else {
      CpAsyncWait<0>();
    }
    __syncthreads();
    const int q0 = first + (i % per_head) * BQ;
    const __nv_bfloat16* qs = qbuf + st * BQ * LD;
    const __nv_bfloat16* dos = dobuf + st * BQ * LD;
    const float* ms = stats + st * 3 * BQ;
    const float* lis = ms + BQ;
    const float* dls = lis + BQ;

    float sT[NT][4], dpt[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) sT[n][e] = dpt[n][e] = 0.f;
#pragma unroll
    for (int kd = 0; kd < KD; ++kd) {
      uint32_t ak[4], av[4];
      LoadA(ak, ks, LD, wr, kd * 16, lane);
      LoadA(av, vs, LD, wr, kd * 16, lane);
#pragma unroll
      for (int nt = 0; nt < NT; nt += 2) {
        uint32_t bq[4], bd[4];
        LoadBt(bq, qs, LD, nt * 8, kd * 16, lane);
        Mma(sT[nt], ak, bq[0], bq[1]);
        Mma(sT[nt + 1], ak, bq[2], bq[3]);
        LoadBt(bd, dos, LD, nt * 8, kd * 16, lane);
        Mma(dpt[nt], av, bd[0], bd[1]);
        Mma(dpt[nt + 1], av, bd[2], bd[3]);
      }
    }

    const bool masked = NeedsMask(p, q0, BQ, k0, kRowsB);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qc = nt * 8 + 2 * t + (e & 1);
        const int kvrow = k0 + wr + g + (e >> 1) * 8;
        float pe = 0.f;
        if (!masked || Live(p, q0 + qc, kvrow))
          pe = __expf(sT[nt][e] * p.scale - ms[qc]) * lis[qc];
        sT[nt][e] = pe;
        dpt[nt][e] = (pe * (dpt[nt][e] - dls[qc])) * p.scale;
      }
    }

    uint32_t pa[NT / 2][4], sa[NT / 2][4];
    PackA<NT>(pa, sT);
    PackA<NT>(sa, dpt);
#pragma unroll
    for (int kc = 0; kc < NT / 2; ++kc) {
#pragma unroll
      for (int dt = 0; dt < DT; dt += 2) {
        uint32_t bd[4], bq[4];
        LoadB(bd, dos, LD, kc * 16, dt * 8, lane);
        Mma(dv[dt], pa[kc], bd[0], bd[1]);
        Mma(dv[dt + 1], pa[kc], bd[2], bd[3]);
        LoadB(bq, qs, LD, kc * 16, dt * 8, lane);
        Mma(dk[dt], sa[kc], bq[0], bq[1]);
        Mma(dk[dt + 1], sa[kc], bq[2], bq[3]);
      }
    }
    __syncthreads();  // the next step's loads overwrite this stage
  }
  CpAsyncWait<0>();

  __nv_bfloat16* dkg = OutBase<__nv_bfloat16>(p, p.dk, kDk, b, hk);
  __nv_bfloat16* dvg = OutBase<__nv_bfloat16>(p, p.dv, kDv, b, hk);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = k0 + wr + g + half * 8;
    if (row >= p.Sk) continue;
#pragma unroll
    for (int dt = 0; dt < DT; ++dt) {
      const int col = dt * 8 + 2 * t;
      *reinterpret_cast<uint32_t*>(dkg + row * p.st[kDk][2] + col) =
          PackBf16(dk[dt][2 * half], dk[dt][2 * half + 1]);
      *reinterpret_cast<uint32_t*>(dvg + row * p.st[kDv][2] + col) =
          PackBf16(dv[dt][2 * half], dv[dt][2 * half + 1]);
    }
  }
}

// dQ of 64 q rows of one (batch, head); each warp owns 16 of them. The
// next kv tile loads while this one is computed.
template <int D>
__global__ void __launch_bounds__(128) DqBf16(Params p) {
  constexpr int BK = kRowsB, LD = D + kPad;
  constexpr int NT = BK / 8, DT = D / 8, KD = D / 16;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* dos = qs + kRowsB * LD;
  __nv_bfloat16* kbuf = dos + kRowsB * LD;  // [2][BK][LD]
  __nv_bfloat16* vbuf = kbuf + 2 * BK * LD;  // [2][BK][LD]

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * kRowsB;
  const int b = blockIdx.z, h = blockIdx.y;
  const int hk = h / (p.H / p.Hk);
  const int wr = warp * 16;
  const __nv_bfloat16* kg = Base<__nv_bfloat16>(p, p.k, kK, b, hk);
  const __nv_bfloat16* vg = Base<__nv_bfloat16>(p, p.v, kV, b, hk);

  int lo, hi;
  KvRange(p, q0, kRowsB, &lo, &hi);
  const int first = (lo / BK) * BK;
  const int steps = hi > first ? (hi - first + BK - 1) / BK : 0;

  LoadTile<D>(qs, LD, Base<__nv_bfloat16>(p, p.q, kQ, b, h), p.st[kQ][2],
              q0, kRowsB, p.Sq);
  LoadTile<D>(dos, LD, Base<__nv_bfloat16>(p, p.dout, kDo, b, h),
              p.st[kDo][2], q0, kRowsB, p.Sq);
  if (steps > 0) {
    LoadTile<D>(kbuf, LD, kg, p.st[kK][2], first, BK, p.Sk);
    LoadTile<D>(vbuf, LD, vg, p.st[kV][2], first, BK, p.Sk);
  }
  CpAsyncCommit();

  // Row statistics of this thread's two rows, g and g + 8.
  const long long stat = (static_cast<long long>(b) * p.H + h) * p.Sq;
  float mr[2], lir[2], dlr[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = q0 + wr + g + half * 8;
    const bool in = row < p.Sq;
    mr[half] = in ? p.m[stat + row] : 0.f;
    lir[half] = in ? p.linv[stat + row] : 0.f;
    dlr[half] = in ? p.delta[stat + row] : 0.f;
  }

  float acc[DT][4];
#pragma unroll
  for (int i = 0; i < DT; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;

  for (int i = 0; i < steps; ++i) {
    const int st = i & 1, k0 = first + i * BK;
    if (i + 1 < steps) {
      LoadTile<D>(kbuf + (st ^ 1) * BK * LD, LD, kg, p.st[kK][2], k0 + BK,
                  BK, p.Sk);
      LoadTile<D>(vbuf + (st ^ 1) * BK * LD, LD, vg, p.st[kV][2], k0 + BK,
                  BK, p.Sk);
      CpAsyncCommit();
      CpAsyncWait<1>();
    } else {
      CpAsyncWait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* ks = kbuf + st * BK * LD;
    const __nv_bfloat16* vs = vbuf + st * BK * LD;

    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int kd = 0; kd < KD; ++kd) {
      uint32_t aq[4], ad[4];
      LoadA(aq, qs, LD, wr, kd * 16, lane);
      LoadA(ad, dos, LD, wr, kd * 16, lane);
#pragma unroll
      for (int nt = 0; nt < NT; nt += 2) {
        uint32_t bk[4], bv[4];
        LoadBt(bk, ks, LD, nt * 8, kd * 16, lane);
        Mma(s[nt], aq, bk[0], bk[1]);
        Mma(s[nt + 1], aq, bk[2], bk[3]);
        LoadBt(bv, vs, LD, nt * 8, kd * 16, lane);
        Mma(dp[nt], ad, bv[0], bv[1]);
        Mma(dp[nt + 1], ad, bv[2], bv[3]);
      }
    }

    const bool masked = NeedsMask(p, q0, kRowsB, k0, BK);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int half = e >> 1;
        const int row = q0 + wr + g + half * 8;
        const int col = k0 + nt * 8 + 2 * t + (e & 1);
        float pe = 0.f;
        if (!masked || Live(p, row, col))
          pe = __expf(s[nt][e] * p.scale - mr[half]) * lir[half];
        s[nt][e] = (pe * (dp[nt][e] - dlr[half])) * p.scale;
      }
    }
    uint32_t sa[NT / 2][4];
    PackA<NT>(sa, s);
#pragma unroll
    for (int kc = 0; kc < NT / 2; ++kc) {
#pragma unroll
      for (int dt = 0; dt < DT; dt += 2) {
        uint32_t bk[4];
        LoadB(bk, ks, LD, kc * 16, dt * 8, lane);
        Mma(acc[dt], sa[kc], bk[0], bk[1]);
        Mma(acc[dt + 1], sa[kc], bk[2], bk[3]);
      }
    }
    __syncthreads();  // the next step's loads overwrite this stage
  }
  CpAsyncWait<0>();

  __nv_bfloat16* dqg = OutBase<__nv_bfloat16>(p, p.dq, kDq, b, h);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = q0 + wr + g + half * 8;
    if (row >= p.Sq) continue;
#pragma unroll
    for (int dt = 0; dt < DT; ++dt)
      *reinterpret_cast<uint32_t*>(dqg + row * p.st[kDq][2] + dt * 8 +
                                   2 * t) =
          PackBf16(acc[dt][2 * half], acc[dt][2 * half + 1]);
  }
}

// ------------------------------------------------------------------- f32

// 128 threads, 32 rows a block, 4 threads a row (sub = tid % 4 takes the
// columns sub, sub + 4, ...), tiles of 32 on the other side.
constexpr int kRowsF = 32;

template <int D>
__device__ __forceinline__ void LoadTileF32(float* tile, const float* src,
                                            long long sstride, int r0,
                                            int s) {
  constexpr int LD = D + 1;  // odd pitch: no bank conflicts
  for (int i = threadIdx.x; i < kRowsF * D / 4; i += blockDim.x) {
    const int r = i / (D / 4), col = (i % (D / 4)) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < s)
      val = *reinterpret_cast<const float4*>(src + (r0 + r) * sstride + col);
    float* dst = tile + r * LD + col;
    dst[0] = val.x; dst[1] = val.y; dst[2] = val.z; dst[3] = val.w;
  }
}

__device__ __forceinline__ float Dot(const float* a, const float* b, int d) {
  float acc = 0.f;
#pragma unroll 16
  for (int x = 0; x < d; ++x) acc = fmaf(a[x], b[x], acc);
  return acc;
}

template <int D>
constexpr int SmemDkvF32() {
  return (4 * kRowsF * (D + 1) + 2 * kRowsF * (kRowsF + 1) + 3 * kRowsF) * 4;
}

template <int D>
constexpr int SmemDqF32() {
  return (4 * kRowsF * (D + 1) + kRowsF * (kRowsF + 1)) * 4;
}

template <int D>
__global__ void __launch_bounds__(128) DkvF32(Params p) {
  constexpr int LD = D + 1, PLD = kRowsF + 1, DC = D / 4;
  extern __shared__ __align__(16) unsigned char smem[];
  float* ks = reinterpret_cast<float*>(smem);
  float* vs = ks + kRowsF * LD;
  float* qs = vs + kRowsF * LD;
  float* dos = qs + kRowsF * LD;
  float* ps = dos + kRowsF * LD;  // [kv][q]
  float* dss = ps + kRowsF * PLD;
  float* ms = dss + kRowsF * PLD;
  float* lis = ms + kRowsF;
  float* dls = lis + kRowsF;

  const int r = threadIdx.x >> 2, sub = threadIdx.x & 3;
  const int k0 = blockIdx.x * kRowsF;
  const int b = blockIdx.z, hk = blockIdx.y;
  const int group = p.H / p.Hk;
  const int kvrow = k0 + r;
  LoadTileF32<D>(ks, Base<float>(p, p.k, kK, b, hk), p.st[kK][2], k0, p.Sk);
  LoadTileF32<D>(vs, Base<float>(p, p.v, kV, b, hk), p.st[kV][2], k0, p.Sk);

  float dk[DC], dv[DC];
#pragma unroll
  for (int c = 0; c < DC; ++c) dk[c] = dv[c] = 0.f;

  int lo, hi;
  QRange(p, k0, kRowsF, &lo, &hi);
  for (int hh = 0; hh < group; ++hh) {
    const int h = hk * group + hh;
    const long long stat = (static_cast<long long>(b) * p.H + h) * p.Sq;
    for (int q0 = (lo / kRowsF) * kRowsF; q0 < hi; q0 += kRowsF) {
      __syncthreads();
      LoadTileF32<D>(qs, Base<float>(p, p.q, kQ, b, h), p.st[kQ][2], q0,
                     p.Sq);
      LoadTileF32<D>(dos, Base<float>(p, p.dout, kDo, b, h), p.st[kDo][2],
                     q0, p.Sq);
      if (threadIdx.x < kRowsF) {
        const int i = threadIdx.x;
        const bool in = q0 + i < p.Sq;
        ms[i] = in ? p.m[stat + q0 + i] : 0.f;
        lis[i] = in ? p.linv[stat + q0 + i] : 0.f;
        dls[i] = in ? p.delta[stat + q0 + i] : 0.f;
      }
      __syncthreads();
      const bool masked = NeedsMask(p, q0, kRowsF, k0, kRowsF);
#pragma unroll
      for (int ii = 0; ii < kRowsF / 4; ++ii) {
        const int i = sub + 4 * ii;
        float pe = 0.f, dsv = 0.f;
        if (!masked || Live(p, q0 + i, kvrow)) {
          const float s = Dot(ks + r * LD, qs + i * LD, D) * p.scale;
          const float dp = Dot(vs + r * LD, dos + i * LD, D);
          pe = expf(s - ms[i]) * lis[i];
          dsv = (pe * (dp - dls[i])) * p.scale;
        }
        ps[r * PLD + i] = pe;
        dss[r * PLD + i] = dsv;
      }
      __syncwarp();  // a row's 4 threads share one warp
      for (int i = 0; i < kRowsF; ++i) {
        const float pi = ps[r * PLD + i], di = dss[r * PLD + i];
#pragma unroll
        for (int c = 0; c < DC; ++c) {
          dv[c] = fmaf(pi, dos[i * LD + sub + 4 * c], dv[c]);
          dk[c] = fmaf(di, qs[i * LD + sub + 4 * c], dk[c]);
        }
      }
      __syncwarp();
    }
  }
  if (kvrow < p.Sk) {
    float* dkg = OutBase<float>(p, p.dk, kDk, b, hk) + kvrow * p.st[kDk][2];
    float* dvg = OutBase<float>(p, p.dv, kDv, b, hk) + kvrow * p.st[kDv][2];
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      dkg[sub + 4 * c] = dk[c];
      dvg[sub + 4 * c] = dv[c];
    }
  }
}

template <int D>
__global__ void __launch_bounds__(128) DqF32(Params p) {
  constexpr int LD = D + 1, PLD = kRowsF + 1, DC = D / 4;
  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);
  float* dos = qs + kRowsF * LD;
  float* ks = dos + kRowsF * LD;
  float* vs = ks + kRowsF * LD;
  float* dss = vs + kRowsF * LD;  // [q][kv]

  const int r = threadIdx.x >> 2, sub = threadIdx.x & 3;
  const int q0 = blockIdx.x * kRowsF;
  const int b = blockIdx.z, h = blockIdx.y;
  const int hk = h / (p.H / p.Hk);
  const int row = q0 + r;
  LoadTileF32<D>(qs, Base<float>(p, p.q, kQ, b, h), p.st[kQ][2], q0, p.Sq);
  LoadTileF32<D>(dos, Base<float>(p, p.dout, kDo, b, h), p.st[kDo][2], q0,
                 p.Sq);
  const long long at = (static_cast<long long>(b) * p.H + h) * p.Sq + row;
  const bool in = row < p.Sq;
  const float mrow = in ? p.m[at] : 0.f;
  const float li = in ? p.linv[at] : 0.f;
  const float dl = in ? p.delta[at] : 0.f;

  float acc[DC];
#pragma unroll
  for (int c = 0; c < DC; ++c) acc[c] = 0.f;
  int lo, hi;
  KvRange(p, q0, kRowsF, &lo, &hi);
  for (int k0 = (lo / kRowsF) * kRowsF; k0 < hi; k0 += kRowsF) {
    __syncthreads();
    LoadTileF32<D>(ks, Base<float>(p, p.k, kK, b, hk), p.st[kK][2], k0,
                   p.Sk);
    LoadTileF32<D>(vs, Base<float>(p, p.v, kV, b, hk), p.st[kV][2], k0,
                   p.Sk);
    __syncthreads();
    const bool masked = NeedsMask(p, q0, kRowsF, k0, kRowsF);
#pragma unroll
    for (int jj = 0; jj < kRowsF / 4; ++jj) {
      const int j = sub + 4 * jj;
      float dsv = 0.f;
      if (!masked || Live(p, row, k0 + j)) {
        const float s = Dot(qs + r * LD, ks + j * LD, D) * p.scale;
        const float dp = Dot(dos + r * LD, vs + j * LD, D);
        const float pe = expf(s - mrow) * li;
        dsv = (pe * (dp - dl)) * p.scale;
      }
      dss[r * PLD + j] = dsv;
    }
    __syncwarp();
    for (int j = 0; j < kRowsF; ++j) {
      const float dj = dss[r * PLD + j];
#pragma unroll
      for (int c = 0; c < DC; ++c)
        acc[c] = fmaf(dj, ks[j * LD + sub + 4 * c], acc[c]);
    }
    __syncwarp();
  }
  if (in) {
    float* dqg = OutBase<float>(p, p.dq, kDq, b, h) + row * p.st[kDq][2];
#pragma unroll
    for (int c = 0; c < DC; ++c) dqg[sub + 4 * c] = acc[c];
  }
}

// ---------------------------------------------------------------- launch

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

// ------------------------------------------------------ bf16 d=64: wgmma

constexpr int kD = 64;            // the head dim of this design
constexpr int kRowBytes = kD * 2;  // a tile row: one 128-byte swizzle atom
constexpr int kWgRows = 64;       // rows a consumer warpgroup owns
constexpr int kBlockRows = 2 * kWgRows;  // two consumer warpgroups
constexpr int kStep = 64;         // rows a ring stage streams
constexpr int kRing = 4;          // ring stages
constexpr int kTileBytes = kStep * kRowBytes;  // 8 KB
constexpr int kStatBytes = 2 * kStep * 4;     // b and delta of a tile
constexpr int kThreadsW = 3 * 128;            // producer + two consumers
constexpr int kProducerRegs = 24, kConsumerRegs = 240;
static_assert(128 * kProducerRegs + 256 * kConsumerRegs <= 65536,
              "register file");
constexpr float kLog2e = 1.4426950408889634f;

// Shared memory, from a 1024-aligned base: the block's two fixed 128-row
// tiles (Dkv: K, V; Dq: Q, dO), the ring's two tiles a stage (Dkv: Q, dO;
// Dq: K, V), Dkv's statistics a stage, then the mbarriers: fixed-full,
// full[kRing], empty[kRing].
constexpr int kFixedA = 0;
constexpr int kFixedB = kFixedA + 2 * kTileBytes;
constexpr int kRingA = kFixedB + 2 * kTileBytes;
constexpr int kRingB = kRingA + kRing * kTileBytes;
constexpr int kStats = kRingB + kRing * kTileBytes;
constexpr int kBars = kStats + kRing * kStatBytes;
constexpr int kSmemW = 1024 + kBars + 8 * (1 + 2 * kRing);

__device__ __forceinline__ uint32_t Full(uint32_t bar, int s) {
  return bar + 8 * (1 + s);
}
__device__ __forceinline__ uint32_t Empty(uint32_t bar, int s) {
  return bar + 8 * (1 + kRing + s);
}

// The statistics of 64-row q tile `tile` of (b, h): b and delta, 64
// floats each.
__device__ __forceinline__ const float* TileStats(const Params& p, int b,
                                                  int h, int tile) {
  return p.stats +
         ((static_cast<long long>(b) * p.H + h) * p.tiles + tile) * 2 * kStep;
}

// Delta's work for the wgmma design, in its layout: stats[b, h, tile] =
// (b, delta * scale) of the tile's 64 rows, b = m log2(e) - log2(l_inv),
// so that P = exp(S - m) l_inv = exp2(S log2(e) - b) is one FMA and one
// ex2 a logit, and dS = P (dP - delta) scale = P (dP scale - delta scale)
// one FMA and one multiply. Past Sq b is +inf and delta 0, so P and dS
// are 0 there (Q and dO read as zeros, so S and dP are 0, not garbage).
// Eight lanes a row, each reading 16 bytes of o and of dO: 16 rows a
// block of 128 threads.
__global__ void __launch_bounds__(128) DeltaTiles(Params p) {
  constexpr int kLanes = kD / 8;  // 8 bf16 a lane
  const long long row = blockIdx.x * (128LL / kLanes) + threadIdx.x / kLanes;
  const int part = threadIdx.x % kLanes;
  const long long padded = static_cast<long long>(p.tiles) * kStep;
  if (row >= static_cast<long long>(p.B) * p.H * padded) return;
  const int s = static_cast<int>(row % padded);
  const long long bh = row / padded;
  float sum = 0.f;
  if (s < p.Sq) {
    const int h = static_cast<int>(bh % p.H), b = static_cast<int>(bh / p.H);
    const uint4 o = *reinterpret_cast<const uint4*>(
        Base<__nv_bfloat16>(p, p.o, kO, b, h) + s * p.st[kO][2] + 8 * part);
    const uint4 dout = *reinterpret_cast<const uint4*>(
        Base<__nv_bfloat16>(p, p.dout, kDo, b, h) + s * p.st[kDo][2] +
        8 * part);
    const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&o);
    const __nv_bfloat162* d2 = reinterpret_cast<const __nv_bfloat162*>(&dout);
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const float2 of = __bfloat1622float2(o2[x]);
      const float2 df = __bfloat1622float2(d2[x]);
      sum = fmaf(df.x, of.x, sum);
      sum = fmaf(df.y, of.y, sum);
    }
  }
  // The row's eight lanes are neighbours of one warp.
#pragma unroll
  for (int off = kLanes / 2; off > 0; off >>= 1)
    sum += __shfl_xor_sync(0xffffffffu, sum, off);
  if (part == 0) {
    float bias = INFINITY;
    if (s < p.Sq) {
      const float l = p.l[bh * p.Sq + s];
      bias = p.m[bh * p.Sq + s] * kLog2e + (l == 0.f ? 0.f : log2f(l));
    }
    float* out = p.stats + (bh * p.tiles + s / kStep) * 2 * kStep + s % kStep;
    out[0] = bias;
    out[kStep] = sum * p.scale;
  }
}

// Whether an edge of the causal or band mask crosses the tile pair (q
// rows [q0, q0 + bq), kv cols [k0, k0 + bk)). Padding needs no mask in
// the wgmma design: past Sq, b = +inf makes P 0; a kv row past Sk in Dkv
// and a q row past Sq in Dq are never stored and feed no other row. Dq
// masks its kv columns past Sk as well, since those would reach dQ.
__device__ __forceinline__ bool EdgeCrosses(const Params& p, int q0, int bq,
                                            int k0, int bk) {
  bool need = false;
  if (p.causal) need |= k0 + bk - 1 > q0;
  if (p.window > 0) {
    need |= k0 <= q0 + bq - 1 - p.window;
    if (!p.causal) need |= k0 + bk - 1 >= q0 + p.window;
  }
  return need;
}

// Ping-pong of the two consumer warpgroups (FA3's, as csrc/flash_fwd.cu
// does it): each issues a step's products only after the other has issued
// its own, so one's elementwise work runs under the other's products
// instead of both idling the tensor cores at once. Warpgroup w waits on
// named barrier 1 + w; warpgroup 1 opens the ring and skips its last pass.
__device__ __forceinline__ void TurnWait(int wg) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(1 + wg) : "memory");
}
__device__ __forceinline__ void TurnPass(int wg) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(1 + (wg + 1) % 2) : "memory");
}

// The causal and band mask of Live() without branches: the wgmma design
// selects P = 0 with it, so its 32 exponentials a thread stay one
// straight run of code.
__device__ __forceinline__ bool BandLive(const Params& p, int row, int col) {
  bool live = !p.causal | (col <= row);
  const bool band = p.causal ? col > row - p.window
                             : abs(col - row) < p.window;
  live &= (p.window <= 0) | band;
  return live;
}

// acc = A B^T over d for a 64-row A tile and a 64-row B tile, both
// K-major (rows of d = 64), issued, not committed.
__device__ __forceinline__ void IssueSS(float* acc, uint32_t a, uint32_t b) {
  sm90::WgmmaFence();
  sm90::WgmmaSS64Init(acc, sm90::Desc(a, kRowBytes),
                      sm90::Desc(b, kRowBytes));
#pragma unroll
  for (int kk = 1; kk < kD / 16; ++kk)
    sm90::WgmmaSS64(acc, sm90::Desc(a + kk * 32, kRowBytes),
                    sm90::Desc(b + kk * 32, kRowBytes));
}

// acc += A B for A of 64 x 64 in registers (bf16 A fragments) and B a
// 64-row tile read MN-major (its rows are the k dimension), issued, not
// committed.
__device__ __forceinline__ void IssueRS(float* acc, uint32_t (*a)[4],
                                        uint32_t b) {
  sm90::WgmmaFence();
#pragma unroll
  for (int kk = 0; kk < kStep / 16; ++kk)
    sm90::WgmmaRS64(acc, a[kk],
                    sm90::Desc(b + kk * 16 * kRowBytes, kRowBytes));
}

// A 64 x 64 accumulator rounded to bf16 pairs: n-tiles 2kk and 2kk + 1
// are the A fragment of k-step kk (as the forward packs P).
__device__ __forceinline__ void PackAcc(const float* acc, uint32_t (*a)[4]) {
#pragma unroll
  for (int kk = 0; kk < kStep / 16; ++kk)
#pragma unroll
    for (int x = 0; x < 4; ++x)
      a[kk][x] = PackBf16(acc[8 * kk + 2 * x], acc[8 * kk + 2 * x + 1]);
}

__device__ __forceinline__ float Pick(float2 v, int odd) {
  return odd ? v.y : v.x;
}

// A warpgroup's 64 x 64 accumulator of rows [r0, r0 + 64) (its fragment:
// rows r0 + 16 warp + g and that + 8), rounded to bf16, into the rows below
// `rows` of `out`, whose row stride is `ss`.
__device__ __forceinline__ void StoreRows(__nv_bfloat16* out, long long ss,
                                          const float* acc, int r0, int rows,
                                          int warp, int g, int c) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + 16 * warp + g + 8 * r;
    if (row >= rows) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      *reinterpret_cast<uint32_t*>(out + row * ss + 8 * j + 2 * c) =
          PackBf16(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
  }
}

struct Step {
  int first, per_head, count;  // Dkv: q tiles a head; Dq: per_head = count
};

// One thread of Dkv's producer: K and V once, then Q, dO and the
// statistics of every step, each q head of the group over the band.
__device__ __forceinline__ void ProduceDkv(
    const CUtensorMap* tq, const CUtensorMap* tk, const CUtensorMap* tv,
    const CUtensorMap* tdo, const Params& p, uint32_t base, int k0, int hk,
    int b, const Step& st) {
  const uint32_t bar = base + kBars;
  const int halves = k0 + kStep < p.Sk ? 2 : 1;  // a box wholly past Sk
  sm90::MbarExpectTx(bar, 2 * halves * kTileBytes);
  for (int x = 0; x < halves; ++x) {
    sm90::TmaLoad4d(base + kFixedA + x * kTileBytes, tk, bar, 0,
                    k0 + x * kStep, hk, b);
    sm90::TmaLoad4d(base + kFixedB + x * kTileBytes, tv, bar, 0,
                    k0 + x * kStep, hk, b);
  }
  const int group = p.H / p.Hk;
  for (int i = 0; i < st.count; ++i) {
    const int s = i % kRing;
    if (i >= kRing) sm90::MbarWait(Empty(bar, s), (i / kRing - 1) & 1);
    const int h = hk * group + i / st.per_head;
    const int q0 = st.first + (i % st.per_head) * kStep;
    sm90::MbarExpectTx(Full(bar, s), 2 * kTileBytes + kStatBytes);
    sm90::TmaLoad4d(base + kRingA + s * kTileBytes, tq, Full(bar, s), 0, q0,
                    h, b);
    sm90::TmaLoad4d(base + kRingB + s * kTileBytes, tdo, Full(bar, s), 0, q0,
                    h, b);
    sm90::BulkLoad(base + kStats + s * kStatBytes,
                   TileStats(p, b, h, q0 / kStep), kStatBytes, Full(bar, s));
  }
}

// One thread of Dq's producer: Q and dO once, then K and V of every live
// kv tile.
__device__ __forceinline__ void ProduceDq(
    const CUtensorMap* tq, const CUtensorMap* tk, const CUtensorMap* tv,
    const CUtensorMap* tdo, const Params& p, uint32_t base, int q0, int h,
    int b, const Step& st) {
  const uint32_t bar = base + kBars;
  const int halves = q0 + kStep < p.Sq ? 2 : 1;  // a box wholly past Sq
  sm90::MbarExpectTx(bar, 2 * halves * kTileBytes);
  for (int x = 0; x < halves; ++x) {
    sm90::TmaLoad4d(base + kFixedA + x * kTileBytes, tq, bar, 0,
                    q0 + x * kStep, h, b);
    sm90::TmaLoad4d(base + kFixedB + x * kTileBytes, tdo, bar, 0,
                    q0 + x * kStep, h, b);
  }
  const int hk = h / (p.H / p.Hk);
  for (int i = 0; i < st.count; ++i) {
    const int s = i % kRing;
    if (i >= kRing) sm90::MbarWait(Empty(bar, s), (i / kRing - 1) & 1);
    const int k0 = st.first + i * kStep;
    sm90::MbarExpectTx(Full(bar, s), 2 * kTileBytes);
    sm90::TmaLoad4d(base + kRingA + s * kTileBytes, tk, Full(bar, s), 0, k0,
                    hk, b);
    sm90::TmaLoad4d(base + kRingB + s * kTileBytes, tv, Full(bar, s), 0, k0,
                    hk, b);
  }
}

// Dkv's elementwise work on one step, in place: S^T becomes P^T (f32)
// once its product is done, then dP^T becomes dS^T (f32, before its
// bf16 rounding). `stats` is the stage's b and delta * scale of q
// columns [q0, q0 + 64); the thread's kv rows are row0 and row0 + 8; c2
// = scale log2(e). A masked step drops kv rows past Sk too: the "mid"
// design's dS reaches dQ.
struct DkvStep {
  const Params& p;
  const float* stats;
  float c2;
  int q0, row0, c;
  bool masked;

  template <bool kMasked>
  __device__ __forceinline__ void ProbsAs(float* sT) const {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 bias =
          *reinterpret_cast<const float2*>(stats + 8 * j + 2 * c);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pe =
            sm90::Exp2(fmaf(sT[4 * j + e], c2, -Pick(bias, e & 1)));
        const int row = row0 + 8 * (e >> 1);
        sT[4 * j + e] =
            !kMasked || ((row < p.Sk) &
                         BandLive(p, q0 + 8 * j + 2 * c + (e & 1), row))
                ? pe
                : 0.f;
      }
    }
  }

  __device__ __forceinline__ void Probs(float* sT) const {
    if (masked) {
      ProbsAs<true>(sT);
    } else {
      ProbsAs<false>(sT);
    }
  }

  __device__ __forceinline__ void Grads(const float* pT, float* dpT) const {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 dl =
          *reinterpret_cast<const float2*>(stats + kStep + 8 * j + 2 * c);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dpT[4 * j + e] =
            pT[4 * j + e] * fmaf(dpT[4 * j + e], p.scale, -Pick(dl, e & 1));
    }
  }
};

// One consumer warpgroup of Dkv: dK and dV of kv rows [k0w, k0w + 64).
// Thread fragment (sm90.cuh), warp w, g = lane / 4, c = lane % 4: acc[4j +
// e] is kv row k0w + 16w + g + 8(e / 2), q column q0 + 8j + 2c + (e % 2);
// a row of S^T is a kv row, so the row statistics index the columns.
// Step i's S^T and dP^T are issued before step i-1's dV and dK, and the
// first step is peeled off the loop, so every wait in the loop leaves the
// same products in flight (ptxas keeps the wgmmas asynchronous only then).
// A half-tile wholly past Sk (left unloaded) gives rows that are never
// stored and feed no other row.
__device__ __forceinline__ void ConsumeDkv(const Params& p,
                                           unsigned char* smem,
                                           uint32_t base, int wg, int tw,
                                           int k0, int hk, int b,
                                           const Step& st) {
  const int warp = tw / 32, lane = tw % 32, g = lane >> 2, c = lane & 3;
  const int k0w = k0 + wg * kWgRows;
  const int row0 = k0w + warp * 16 + g;
  const uint32_t bar = base + kBars;
  const uint32_t kw = base + kFixedA + wg * kTileBytes;
  const uint32_t vw = base + kFixedB + wg * kTileBytes;
  auto step = [&](int i) {
    const int s = i % kRing, q0 = st.first + (i % st.per_head) * kStep;
    return DkvStep{p,
                   reinterpret_cast<const float*>(smem + kStats +
                                                  s * kStatBytes),
                   p.scale * kLog2e,
                   q0,
                   row0,
                   c,
                   EdgeCrosses(p, q0, kStep, k0w, kWgRows)};
  };
  float dk[32], dv[32], sT[32], dpT[32];
  uint32_t pa[4][4], sa[4][4];
#pragma unroll
  for (int x = 0; x < 32; ++x) dk[x] = dv[x] = 0.f;

  sm90::MbarWait(bar, 0);
  if (st.count > 0) {
    sm90::MbarWait(Full(bar, 0), 0);
    if (wg == 1) TurnPass(wg);
    TurnWait(wg);
    IssueSS(sT, kw, base + kRingA);   // S^T = K Q^T
    sm90::WgmmaCommit();
    IssueSS(dpT, vw, base + kRingB);  // dP^T = V dO^T
    sm90::WgmmaCommit();
    TurnPass(wg);
    const DkvStep first = step(0);
    sm90::WgmmaWait<1>();
    sm90::FenceRegs<32>(sT);
    first.Probs(sT);
    sm90::WgmmaWait<0>();
    sm90::FenceRegs<32>(dpT);
    first.Grads(sT, dpT);
    PackAcc(sT, pa);
    PackAcc(dpT, sa);
  }
  for (int i = 1; i < st.count; ++i) {
    const int s = i % kRing, prev = (i - 1) % kRing;
    sm90::MbarWait(Full(bar, s), (i / kRing) & 1);
    TurnWait(wg);
    IssueSS(sT, kw, base + kRingA + s * kTileBytes);
    sm90::WgmmaCommit();
    IssueSS(dpT, vw, base + kRingB + s * kTileBytes);
    sm90::WgmmaCommit();
    IssueRS(dv, pa, base + kRingB + prev * kTileBytes);  // dV += P^T dO
    IssueRS(dk, sa, base + kRingA + prev * kTileBytes);  // dK += dS^T Q
    sm90::WgmmaCommit();
    TurnPass(wg);
    const DkvStep cur = step(i);
    sm90::WgmmaWait<2>();
    sm90::FenceRegs<32>(sT);
    cur.Probs(sT);
    sm90::WgmmaWait<1>();
    sm90::FenceRegs<32>(dpT);
    cur.Grads(sT, dpT);
    sm90::WgmmaWait<0>();
    sm90::FenceRegs<32>(dv);
    sm90::FenceRegs<32>(dk);
    sm90::FenceRegs<16>(&pa[0][0]);
    sm90::FenceRegs<16>(&sa[0][0]);
    sm90::MbarArrive(Empty(bar, prev));
    PackAcc(sT, pa);
    PackAcc(dpT, sa);
  }
  if (st.count > 0) {
    const int last = (st.count - 1) % kRing;
    TurnWait(wg);
    IssueRS(dv, pa, base + kRingB + last * kTileBytes);
    IssueRS(dk, sa, base + kRingA + last * kTileBytes);
    sm90::WgmmaCommit();
    if (wg != 1) TurnPass(wg);
    sm90::WgmmaWait<0>();
    sm90::FenceRegs<32>(dv);
    sm90::FenceRegs<32>(dk);
    sm90::MbarArrive(Empty(bar, last));
  }

  StoreRows(OutBase<__nv_bfloat16>(p, p.dk, kDk, b, hk), p.st[kDk][2], dk,
            k0w, p.Sk, warp, g, c);
  StoreRows(OutBase<__nv_bfloat16>(p, p.dv, kDv, b, hk), p.st[kDv][2], dv,
            k0w, p.Sk, warp, g, c);
}

// Dq's elementwise work on one step, in place: S becomes P (f32), then
// dP becomes dS (f32). The thread's q rows are row0 and row0 + 8, with
// their b and delta * scale; kv columns [k0, k0 + 64); c2 = scale
// log2(e).
struct DqStep {
  const Params& p;
  float br[2], dlr[2];
  float c2;
  int k0, row0, c;
  bool masked;

  template <bool kMasked>
  __device__ __forceinline__ void ProbsAs(float* sc) const {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const float pe = sm90::Exp2(fmaf(sc[4 * j + e], c2, -br[r]));
        const int col = k0 + 8 * j + 2 * c + (e & 1);
        sc[4 * j + e] =
            !kMasked || ((col < p.Sk) & BandLive(p, row0 + 8 * r, col))
                ? pe
                : 0.f;
      }
    }
  }

  __device__ __forceinline__ void Probs(float* sc) const {
    if (masked) {
      ProbsAs<true>(sc);
    } else {
      ProbsAs<false>(sc);
    }
  }

  __device__ __forceinline__ void Grads(const float* pr, float* dp) const {
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dp[4 * j + e] =
            pr[4 * j + e] * fmaf(dp[4 * j + e], p.scale, -dlr[e >> 1]);
  }
};

// One consumer warpgroup of Dq: dQ of q rows [q0w, q0w + 64). acc[4j + e]
// is q row q0w + 16w + g + 8(e / 2), kv column k0 + 8j + 2c + (e % 2).
// The loop is ConsumeDkv's: step i's S and dP before step i-1's dQ, the
// first step peeled off. A half-tile wholly past Sq (left unloaded) gives
// rows that are never stored and feed no other row.
__device__ __forceinline__ void ConsumeDq(const Params& p, uint32_t base,
                                          int wg, int tw, int q0, int h,
                                          int b, const Step& st) {
  const int warp = tw / 32, lane = tw % 32, g = lane >> 2, c = lane & 3;
  const int q0w = q0 + wg * kWgRows;
  const int row0 = q0w + warp * 16 + g;
  const uint32_t bar = base + kBars;
  const uint32_t qw = base + kFixedA + wg * kTileBytes;
  const uint32_t dow = base + kFixedB + wg * kTileBytes;

  float br[2], dlr[2];  // this thread's rows, row0 and row0 + 8
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    const bool in = row < p.Sq;
    const float* t = TileStats(p, b, h, in ? row / kStep : 0) + row % kStep;
    br[r] = in ? t[0] : INFINITY;
    dlr[r] = in ? t[kStep] : 0.f;
  }
  auto step = [&](int i) {
    const int k0 = st.first + i * kStep;
    return DqStep{p,
                  {br[0], br[1]},
                  {dlr[0], dlr[1]},
                  p.scale * kLog2e,
                  k0,
                  row0,
                  c,
                  k0 + kStep > p.Sk ||
                      EdgeCrosses(p, q0w, kWgRows, k0, kStep)};
  };
  float dq[32], sc[32], dp[32];
  uint32_t da[4][4];
#pragma unroll
  for (int x = 0; x < 32; ++x) dq[x] = 0.f;

  sm90::MbarWait(bar, 0);
  if (st.count > 0) {
    sm90::MbarWait(Full(bar, 0), 0);
    if (wg == 1) TurnPass(wg);
    TurnWait(wg);
    IssueSS(sc, qw, base + kRingA);   // S = Q K^T
    sm90::WgmmaCommit();
    IssueSS(dp, dow, base + kRingB);  // dP = dO V^T
    sm90::WgmmaCommit();
    TurnPass(wg);
    const DqStep first = step(0);
    sm90::WgmmaWait<1>();
    sm90::FenceRegs<32>(sc);
    first.Probs(sc);
    sm90::WgmmaWait<0>();
    sm90::FenceRegs<32>(dp);
    first.Grads(sc, dp);
    PackAcc(dp, da);
  }
  for (int i = 1; i < st.count; ++i) {
    const int s = i % kRing, prev = (i - 1) % kRing;
    sm90::MbarWait(Full(bar, s), (i / kRing) & 1);
    TurnWait(wg);
    IssueSS(sc, qw, base + kRingA + s * kTileBytes);
    sm90::WgmmaCommit();
    IssueSS(dp, dow, base + kRingB + s * kTileBytes);
    sm90::WgmmaCommit();
    IssueRS(dq, da, base + kRingA + prev * kTileBytes);  // dQ += dS K
    sm90::WgmmaCommit();
    TurnPass(wg);
    const DqStep cur = step(i);
    sm90::WgmmaWait<2>();
    sm90::FenceRegs<32>(sc);
    cur.Probs(sc);
    sm90::WgmmaWait<1>();
    sm90::FenceRegs<32>(dp);
    cur.Grads(sc, dp);
    sm90::WgmmaWait<0>();
    sm90::FenceRegs<32>(dq);
    sm90::FenceRegs<16>(&da[0][0]);
    sm90::MbarArrive(Empty(bar, prev));
    PackAcc(dp, da);
  }
  if (st.count > 0) {
    const int last = (st.count - 1) % kRing;
    TurnWait(wg);
    IssueRS(dq, da, base + kRingA + last * kTileBytes);
    sm90::WgmmaCommit();
    if (wg != 1) TurnPass(wg);
    sm90::WgmmaWait<0>();
    sm90::FenceRegs<32>(dq);
    sm90::MbarArrive(Empty(bar, last));
  }
  StoreRows(OutBase<__nv_bfloat16>(p, p.dq, kDq, b, h), p.st[kDq][2], dq, q0w,
            p.Sq, warp, g, c);
}

// The barriers of a block: fixed-full and full[] take one arrival (the
// producer's, with its bytes), empty[] one from each consumer thread.
__device__ __forceinline__ void InitBars(uint32_t bar) {
  sm90::MbarInit(bar, 1);
  for (int s = 0; s < kRing; ++s) {
    sm90::MbarInit(Full(bar, s), 1);
    sm90::MbarInit(Empty(bar, s), 256);
  }
  sm90::FenceBarrierInit();
}

// dK and dV of 128 kv rows of one (batch, kv head).
__global__ void __launch_bounds__(kThreadsW, 1)
    DkvWgmma(const __grid_constant__ CUtensorMap tq,
             const __grid_constant__ CUtensorMap tk,
             const __grid_constant__ CUtensorMap tv,
             const __grid_constant__ CUtensorMap tdo, const Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = sm90::SmemAddr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  const int k0 = blockIdx.x * kBlockRows, hk = blockIdx.y, b = blockIdx.z;
  int lo, hi;
  QRange(p, k0, kBlockRows, &lo, &hi);
  Step st;
  st.first = (lo / kStep) * kStep;
  st.per_head = hi > st.first ? (hi - st.first + kStep - 1) / kStep : 0;
  st.count = st.per_head * (p.H / p.Hk);
  if (threadIdx.x == 0) InitBars(base + kBars);
  __syncthreads();
  if (threadIdx.x < 128) {
    sm90::SetMaxRegsDec<kProducerRegs>();
    if (threadIdx.x == 0)
      ProduceDkv(&tq, &tk, &tv, &tdo, p, base, k0, hk, b, st);
  } else {
    sm90::SetMaxRegsInc<kConsumerRegs>();
    ConsumeDkv(p, smem, base, threadIdx.x / 128 - 1, threadIdx.x % 128, k0,
               hk, b, st);
  }
}

// dQ of 128 q rows of one (batch, head).
__global__ void __launch_bounds__(kThreadsW, 1)
    DqWgmma(const __grid_constant__ CUtensorMap tq,
            const __grid_constant__ CUtensorMap tk,
            const __grid_constant__ CUtensorMap tv,
            const __grid_constant__ CUtensorMap tdo, const Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t base = (sm90::SmemAddr(smem_raw) + 1023) & ~1023u;
  const int q0 = blockIdx.x * kBlockRows, h = blockIdx.y, b = blockIdx.z;
  int lo, hi;
  KvRange(p, q0, kBlockRows, &lo, &hi);
  Step st;
  st.first = (lo / kStep) * kStep;
  st.count = hi > st.first ? (hi - st.first + kStep - 1) / kStep : 0;
  st.per_head = st.count;
  if (threadIdx.x == 0) InitBars(base + kBars);
  __syncthreads();
  if (threadIdx.x < 128) {
    sm90::SetMaxRegsDec<kProducerRegs>();
    if (threadIdx.x == 0)
      ProduceDq(&tq, &tk, &tv, &tdo, p, base, q0, h, b, st);
  } else {
    sm90::SetMaxRegsInc<kConsumerRegs>();
    ConsumeDq(p, base, threadIdx.x / 128 - 1, threadIdx.x % 128, q0, h, b,
              st);
  }
}

template <typename Kernel>
cudaError_t LaunchWgmmaKernel(Kernel kernel, dim3 grid,
                              const CUtensorMap* maps, const Params& p,
                              cudaStream_t stream) {
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemW);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreadsW, kSmemW, stream>>>(maps[0], maps[1], maps[2],
                                               maps[3], p);
  return cudaGetLastError();
}

// DeltaTiles, Dkv and Dq of the wgmma design (bf16, d = 64).
cudaError_t LaunchWgmma(const Params& p, cudaStream_t s) {
  CUtensorMap maps[4];  // q, k, v, dO in 64-row boxes
  if (!sm90::EncodeMap(&maps[0], p.q, kD, p.Sq, p.H, p.B, p.st[kQ][0],
                       p.st[kQ][1], p.st[kQ][2], kStep, kD) ||
      !sm90::EncodeMap(&maps[1], p.k, kD, p.Sk, p.Hk, p.B, p.st[kK][0],
                       p.st[kK][1], p.st[kK][2], kStep, kD) ||
      !sm90::EncodeMap(&maps[2], p.v, kD, p.Sk, p.Hk, p.B, p.st[kV][0],
                       p.st[kV][1], p.st[kV][2], kStep, kD) ||
      !sm90::EncodeMap(&maps[3], p.dout, kD, p.Sq, p.H, p.B, p.st[kDo][0],
                       p.st[kDo][1], p.st[kDo][2], kStep, kD))
    return cudaErrorInvalidValue;
  const long long rows = static_cast<long long>(p.B) * p.H * p.tiles * kStep;
  cudaError_t err = Launch(DeltaTiles, 0,
                           dim3(static_cast<unsigned>((rows + 15) / 16)), p, s);
  if (err != cudaSuccess) return err;
  // (tiles, heads, batch), as the forward's grid.
  const dim3 dkv((p.Sk + kBlockRows - 1) / kBlockRows, p.Hk, p.B);
  const dim3 dq((p.Sq + kBlockRows - 1) / kBlockRows, p.H, p.B);
  err = LaunchWgmmaKernel(DkvWgmma, dkv, maps, p, s);
  if (err != cudaSuccess) return err;
  return LaunchWgmmaKernel(DqWgmma, dq, maps, p, s);
}

// ------------------------------------------- bf16 d=64, mid-length sequences

constexpr int kMidMax = 256;  // max(Sq, Sk) up to which FlashBwdMid runs
constexpr int kMidSlices = kMidMax / kStep;  // 64-row kv slices, at most 4
// The fewest (batch, kv head) pairs, a block each, that FlashBwdMid takes
// under GQA: where the bwd_route study's readings cross on an H100 (132
// SMs), between 64 pairs ("wgmma" 8-17% faster) and 96 ("mid" 25%).
constexpr long long kMidMinKvHeads = 72;
constexpr int kMidRing = 4;   // Q/dO stages
constexpr int kMidStats = 2 * kStep;  // floats of one q tile's statistics

// Shared memory, from a 1024-aligned base: K and V of the kv head in 64-row
// slices; the ring's Q and dO tiles; dS^T of each slice for two q tiles
// and each consumer warpgroup's P^T (bf16, the 128-byte swizzle); the
// statistics of two q tiles (b, then delta * scale); then the mbarriers:
// a kv slice each, full[kMidRing], empty[kMidRing].
constexpr int kMidK = 0;
constexpr int kMidV = kMidK + kMidSlices * kTileBytes;
constexpr int kMidQ = kMidV + kMidSlices * kTileBytes;
constexpr int kMidDo = kMidQ + kMidRing * kTileBytes;
constexpr int kMidDs = kMidDo + kMidRing * kTileBytes;
constexpr int kMidP = kMidDs + 2 * kMidSlices * kTileBytes;
constexpr int kMidSt = kMidP + 2 * kTileBytes;
constexpr int kMidBar = kMidSt + 2 * kMidStats * 4;
constexpr int kSmemMid = 1024 + kMidBar + 8 * (kMidSlices + 2 * kMidRing);

__device__ __forceinline__ uint32_t MidFull(uint32_t bar, int s) {
  return bar + 8 * (kMidSlices + s);
}
__device__ __forceinline__ uint32_t MidEmpty(uint32_t bar, int s) {
  return bar + 8 * (kMidSlices + kMidRing + s);
}

// The two consumer warpgroups' barrier (named barrier 1), and consumer
// warpgroup wg's own (named barrier 2 + wg).
__device__ __forceinline__ void MidSync() {
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
}
__device__ __forceinline__ void MidWgSync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(2 + wg) : "memory");
}

// One thread of the producer: K and V of every slice, then Q and dO of
// each q tile of each q head of the group, in order, through the ring.
__device__ __forceinline__ void ProduceMid(
    const CUtensorMap* tq, const CUtensorMap* tk, const CUtensorMap* tv,
    const CUtensorMap* tdo, const Params& p, uint32_t base, int hk, int b,
    int slices, int tiles) {
  const uint32_t bar = base + kMidBar;
  for (int j = 0; j < slices; ++j) {
    sm90::MbarExpectTx(bar + 8 * j, 2 * kTileBytes);
    sm90::TmaLoad4d(base + kMidK + j * kTileBytes, tk, bar + 8 * j, 0,
                    j * kStep, hk, b);
    sm90::TmaLoad4d(base + kMidV + j * kTileBytes, tv, bar + 8 * j, 0,
                    j * kStep, hk, b);
  }
  const int group = p.H / p.Hk;
  for (int u = 0; u < group * tiles; ++u) {
    const int s = u % kMidRing;
    if (u >= kMidRing) sm90::MbarWait(MidEmpty(bar, s), (u / kMidRing - 1) & 1);
    const int h = hk * group + u / tiles, q0 = (u % tiles) * kStep;
    sm90::MbarExpectTx(MidFull(bar, s), 2 * kTileBytes);
    sm90::TmaLoad4d(base + kMidQ + s * kTileBytes, tq, MidFull(bar, s), 0, q0,
                    h, b);
    sm90::TmaLoad4d(base + kMidDo + s * kTileBytes, tdo, MidFull(bar, s), 0,
                    q0, h, b);
  }
}

// What a consumer thread loads for the statistics of a q tile: o and dO
// (16 bytes each) and l and m of two of its rows.
struct MidStatIn {
  uint4 o[2], dout[2];
  float l[2], m[2];
};

// Row q0 + ct / 8 + 32 i (i < 2) of q head (b, h) for consumer thread ct,
// eight lanes a row, each a 16-byte part; rows past Sq read row Sq - 1
// (MidStatStore replaces their sums).
__device__ __forceinline__ void MidStatLoad(const Params& p, int b, int h,
                                            int q0, int ct, MidStatIn* x) {
  constexpr int kLanes = kD / 8;
  const int part = ct % kLanes;
  const __nv_bfloat16* og = Base<__nv_bfloat16>(p, p.o, kO, b, h);
  const __nv_bfloat16* dg = Base<__nv_bfloat16>(p, p.dout, kDo, b, h);
  const long long at = (static_cast<long long>(b) * p.H + h) * p.Sq;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = min(q0 + 32 * i + ct / kLanes, p.Sq - 1);
    x->o[i] = __ldg(reinterpret_cast<const uint4*>(og + r * p.st[kO][2] +
                                                   8 * part));
    x->dout[i] = __ldg(reinterpret_cast<const uint4*>(
        dg + r * p.st[kDo][2] + 8 * part));
    x->l[i] = __ldg(p.l + at + r);
    x->m[i] = __ldg(p.m + at + r);
  }
}

// The q tile's statistics into `st`: each row's b = m log2(e) + log2(l)
// (l == 0: m log2(e)), then delta * scale = rowsum(dO * o) scale; past Sq
// b = +inf and delta 0, so P and dS are 0 there. The code has no branch:
// ptxas serializes every wgmma of a kernel once it finds register
// traffic for one in a divergent path; all eight lanes of a row store its
// sums.
__device__ __forceinline__ void MidStatStore(const Params& p,
                                             const MidStatIn& x, int q0,
                                             float* st, int ct) {
  constexpr int kLanes = kD / 8;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&x.o[i]);
    const __nv_bfloat162* d2 =
        reinterpret_cast<const __nv_bfloat162*>(&x.dout[i]);
    float sum = 0.f;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 of = __bfloat1622float2(o2[e]);
      const float2 df = __bfloat1622float2(d2[e]);
      sum = fmaf(df.x, of.x, sum);
      sum = fmaf(df.y, of.y, sum);
    }
#pragma unroll
    for (int off = kLanes / 2; off > 0; off >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
    const int r = 32 * i + ct / kLanes;
    const bool in = q0 + r < p.Sq;
    const float bias =
        x.m[i] * kLog2e + log2f(x.l[i] == 0.f ? 1.f : x.l[i]);
    st[r] = in ? bias : INFINITY;
    st[kStep + r] = in ? sum * p.scale : 0.f;
  }
}

// A 64 x 64 accumulator fragment (rows of the warpgroup, 64 columns),
// rounded to bf16 pairs, into a tile of shared memory: 64 columns of a row
// contiguous, the 128-byte swizzle (16-byte chunk k of row r at chunk
// k ^ (r % 8)), as TMA writes a tile and wgmma reads one, K-major (its
// columns the k dimension) or MN-major. acc[4j + e] is row 16 warp + g +
// 8 (e / 2), column 8j + 2c + (e % 2).
__device__ __forceinline__ void StoreTile(unsigned char* tile,
                                          const float* acc, int warp, int g,
                                          int c) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = 16 * warp + g + 8 * r;
      *reinterpret_cast<uint32_t*>(tile + row * kRowBytes +
                                   ((j ^ g) << 4) + 4 * c) =
          PackBf16(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
    }
}

// acc += A B over the 64 k rows of two staged tiles: A K-major (P^T or
// dS^T, kv rows by q columns), B MN-major (dO or Q, q rows by d), issued,
// not committed.
__device__ __forceinline__ void IssueSSKN(float* acc, uint32_t a,
                                          uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < kStep / 16; ++kk)
    sm90::WgmmaSS64KN(acc, sm90::Desc(a + kk * 32, kRowBytes),
                      sm90::Desc(b + kk * 16 * kRowBytes, kRowBytes));
}

// A (kv slice, q tile) pair of a consumer warpgroup, in three steps.
// MidSS: S^T = K Q^T and dP^T = V dO^T (SS), issued in two groups.
__device__ __forceinline__ void MidSS(float* sT, float* dpT, uint32_t kw,
                                      uint32_t vw, uint32_t qst,
                                      uint32_t dost) {
  IssueSS(sT, kw, qst);
  sm90::WgmmaCommit();
  IssueSS(dpT, vw, dost);
  sm90::WgmmaCommit();
}

// MidGrads: once those two groups are done (and whatever ran before
// them: the warpgroup's other slice's dV and dK), P^T and dS^T in
// registers, then both to shared memory in bf16: P^T to the warpgroup's
// tile `pt` (the wait retired the product that read it last), dS^T to the
// slice's tile of the q tile, `ds`, which the dQ product reads too; the
// warpgroup meets after, as a product reads rows of all its warps.
// Two alternatives read slower on an H100 (tools/flash_variants.py's
// sweep at the time): issuing one slice's S^T and dP^T ahead of the other
// slice's dV and dK (87 -> 101 us), and dV += P^T dO with P^T from
// registers (81 -> 91 us): both keep more registers live, and ptxas
// spilled.
__device__ __forceinline__ void MidGrads(const DkvStep& st, float* sT,
                                         float* dpT, unsigned char* pt,
                                         unsigned char* ds, int wg, int warp,
                                         int g) {
  sm90::WgmmaWait<1>();
  sm90::FenceRegs<32>(sT);
  st.Probs(sT);
  sm90::WgmmaWait<0>();
  sm90::FenceRegs<32>(dpT);
  st.Grads(sT, dpT);
  StoreTile(pt, sT, warp, g, st.c);
  StoreTile(ds, dpT, warp, g, st.c);
  sm90::FenceProxyAsync();  // the stores, before wgmma reads them
  MidWgSync(wg);
}

// MidDvDk: dV += P^T dO and dK += dS^T Q, SS products from the tiles
// MidGrads wrote, issued in one group. Every operand of every product is
// in shared memory; the registers a product uses are its accumulators.
__device__ __forceinline__ void MidDvDk(float* dk, float* dv,
                                        unsigned char* pt, unsigned char* ds,
                                        uint32_t qst, uint32_t dost) {
  sm90::WgmmaFence();
  IssueSSKN(dv, sm90::SmemAddr(pt), dost);  // dV += P^T dO
  IssueSSKN(dk, sm90::SmemAddr(ds), qst);   // dK += dS^T Q
  sm90::WgmmaCommit();
}

// dQ of the q tile [q0, q0 + 64) of head h: the sum over its live kv
// slices, in kv order, of dS K, one SS product chain reading the staged
// dS^T (`ds`, a tile a slice) and K, both MN-major; written once.
__device__ __forceinline__ void MidDq(const Params& p, uint32_t ds,
                                      uint32_t k, int q0, int h, int b,
                                      int warp, int g, int c) {
  int lo, hi;
  KvRange(p, q0, kStep, &lo, &hi);
  const int j0 = lo / kStep, j1 = (hi - 1) / kStep;
  float dq[32];
  sm90::WgmmaFence();
  const uint32_t first = j0 * kTileBytes;
  sm90::WgmmaSS64MNInit(dq, sm90::Desc(ds + first, kRowBytes),
                        sm90::Desc(k + first, kRowBytes));
#pragma unroll
  for (int kk = 1; kk < kStep / 16; ++kk)
    sm90::WgmmaSS64MN(dq, sm90::Desc(ds + first + kk * 16 * kRowBytes,
                                     kRowBytes),
                      sm90::Desc(k + first + kk * 16 * kRowBytes, kRowBytes));
  for (int j = j0 + 1; j <= j1; ++j) {
#pragma unroll
    for (int kk = 0; kk < kStep / 16; ++kk) {
      const uint32_t off = j * kTileBytes + kk * 16 * kRowBytes;
      sm90::WgmmaSS64MN(dq, sm90::Desc(ds + off, kRowBytes),
                        sm90::Desc(k + off, kRowBytes));
    }
  }
  sm90::WgmmaCommit();
  sm90::WgmmaWait<0>();
  sm90::FenceRegs<32>(dq);
  StoreRows(OutBase<__nv_bfloat16>(p, p.dq, kDq, b, h), p.st[kDq][2], dq, q0,
            p.Sq, warp, g, c);
}

// The consumer warpgroups: warpgroup wg owns kv slices wg and wg + 2 (where
// they exist), keeps their dK and dV in registers, and walks every q tile
// (task u) of every q head of the group in order. For each tile both write
// their slices' dS^T and meet; then warpgroup u % 2 computes the tile's dQ
// while the other goes on to the next tile (dS^T is double buffered).
// The statistics of tile u + 1 are stored before that meeting, from the
// loads a thread issued a tile earlier (double buffered too), so their
// latency is spent under a tile's products.
__device__ __forceinline__ void ConsumeMid(const Params& p,
                                           unsigned char* smem, uint32_t base,
                                           int wg, int tw, int hk, int b,
                                           int slices, int tiles) {
  const int warp = tw / 32, lane = tw % 32, g = lane >> 2, c = lane & 3;
  const int ct = wg * 128 + tw;
  const uint32_t bar = base + kMidBar;
  const int ja = wg, jb = wg + 2;
  const bool has_a = ja < slices, has_b = jb < slices;
  const int group = p.H / p.Hk;
  const int tasks = group * tiles;
  const float c2 = p.scale * kLog2e;
  float dka[32], dva[32], dkb[32], dvb[32], sT[32], dpT[32];
#pragma unroll
  for (int x = 0; x < 32; ++x) dka[x] = dva[x] = dkb[x] = dvb[x] = 0.f;
  unsigned char* pt = smem + kMidP + wg * kTileBytes;
  float* stats = reinterpret_cast<float*>(smem + kMidSt);
  MidStatIn in;
  MidStatLoad(p, b, hk * group, 0, ct, &in);
  MidStatStore(p, in, 0, stats, ct);
  if (tasks > 1)
    MidStatLoad(p, b, hk * group + 1 / tiles, (1 % tiles) * kStep, ct, &in);
  if (has_a) sm90::MbarWait(bar + 8 * ja, 0);
  if (has_b) sm90::MbarWait(bar + 8 * jb, 0);
  MidSync();

  for (int u = 0; u < tasks; ++u) {
    const int h = hk * group + u / tiles, t = u % tiles, s = u % kMidRing;
    const int q0 = t * kStep;
    const uint32_t qst = base + kMidQ + s * kTileBytes;
    const uint32_t dost = base + kMidDo + s * kTileBytes;
    unsigned char* ds = smem + kMidDs + (u % 2) * kMidSlices * kTileBytes;
    const float* st = stats + (u % 2) * kMidStats;
    int lo, hi;
    KvRange(p, q0, kStep, &lo, &hi);
    auto live = [&](int j) { return j * kStep < hi && j * kStep + kStep > lo; };
    auto step = [&](int j) {
      const int k0 = j * kStep;
      return DkvStep{p, st, c2, q0, k0 + 16 * warp + g, c,
                     k0 + kStep > p.Sk || EdgeCrosses(p, q0, kStep, k0,
                                                      kStep)};
    };
    const bool la = has_a && live(ja), lb = has_b && live(jb);
    unsigned char* dsa = ds + ja * kTileBytes;
    unsigned char* dsb = ds + jb * kTileBytes;
    sm90::MbarWait(MidFull(bar, s), (u / kMidRing) & 1);
    if (la) {
      MidSS(sT, dpT, base + kMidK + ja * kTileBytes,
            base + kMidV + ja * kTileBytes, qst, dost);
      MidGrads(step(ja), sT, dpT, pt, dsa, wg, warp, g);
      MidDvDk(dka, dva, pt, dsa, qst, dost);
    }
    if (lb) {
      MidSS(sT, dpT, base + kMidK + jb * kTileBytes,
            base + kMidV + jb * kTileBytes, qst, dost);
      MidGrads(step(jb), sT, dpT, pt, dsb, wg, warp, g);
      MidDvDk(dkb, dvb, pt, dsb, qst, dost);
    }
    sm90::WgmmaWait<0>();
    sm90::MbarArrive(MidEmpty(bar, s));
    if (u + 1 < tasks) {
      const int v = u + 1;
      MidStatStore(p, in, (v % tiles) * kStep, stats + (v % 2) * kMidStats,
                   ct);
      if (v + 1 < tasks)
        MidStatLoad(p, b, hk * group + (v + 1) / tiles,
                    ((v + 1) % tiles) * kStep, ct, &in);
    }
    MidSync();
    if (u % 2 == wg)
      MidDq(p, base + kMidDs + (u % 2) * kMidSlices * kTileBytes,
            base + kMidK, q0, h, b, warp, g, c);
  }
  sm90::FenceRegs<32>(dka);
  sm90::FenceRegs<32>(dva);
  sm90::FenceRegs<32>(dkb);
  sm90::FenceRegs<32>(dvb);
  __nv_bfloat16* dkg = OutBase<__nv_bfloat16>(p, p.dk, kDk, b, hk);
  __nv_bfloat16* dvg = OutBase<__nv_bfloat16>(p, p.dv, kDv, b, hk);
  if (has_a) {
    StoreRows(dkg, p.st[kDk][2], dka, ja * kStep, p.Sk, warp, g, c);
    StoreRows(dvg, p.st[kDv][2], dva, ja * kStep, p.Sk, warp, g, c);
  }
  if (has_b) {
    StoreRows(dkg, p.st[kDk][2], dkb, jb * kStep, p.Sk, warp, g, c);
    StoreRows(dvg, p.st[kDv][2], dvb, jb * kStep, p.Sk, warp, g, c);
  }
}

// dQ, dK and dV of one (batch, kv head) in one launch: one producer
// warpgroup and two consumer warpgroups (ConsumeMid).
__global__ void __launch_bounds__(kThreadsW, 1)
    FlashBwdMid(const __grid_constant__ CUtensorMap tq,
                const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv,
                const __grid_constant__ CUtensorMap tdo, const Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = sm90::SmemAddr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  const long long kv = blockIdx.x;
  const int b = static_cast<int>(kv / p.Hk);
  const int hk = static_cast<int>(kv % p.Hk);
  const int slices = (p.Sk + kStep - 1) / kStep;
  const int tiles = (p.Sq + kStep - 1) / kStep;
  if (threadIdx.x == 0) {
    const uint32_t bar = base + kMidBar;
    for (int j = 0; j < kMidSlices; ++j) sm90::MbarInit(bar + 8 * j, 1);
    for (int s = 0; s < kMidRing; ++s) {
      sm90::MbarInit(MidFull(bar, s), 1);
      sm90::MbarInit(MidEmpty(bar, s), 256);
    }
    sm90::FenceBarrierInit();
  }
  __syncthreads();
  if (threadIdx.x < 128) {
    sm90::SetMaxRegsDec<kProducerRegs>();
    if (threadIdx.x == 0)
      ProduceMid(&tq, &tk, &tv, &tdo, p, base, hk, b, slices, tiles);
  } else {
    sm90::SetMaxRegsInc<kConsumerRegs>();
    // The warpgroup, broadcast from lane 0 so that the compiler sees it
    // uniform: wgmma under a branch it takes for divergent is serialized.
    const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128 - 1, 0);
    ConsumeMid(p, smem, base, wg, threadIdx.x % 128, hk, b, slices, tiles);
  }
}

// FlashBwdMid on a 1-D grid of B * Hk blocks.
cudaError_t LaunchMidBwd(const Params& p, cudaStream_t s) {
  CUtensorMap maps[4];  // q, k, v, dO in 64-row boxes
  if (!sm90::EncodeMap(&maps[0], p.q, kD, p.Sq, p.H, p.B, p.st[kQ][0],
                       p.st[kQ][1], p.st[kQ][2], kStep, kD) ||
      !sm90::EncodeMap(&maps[1], p.k, kD, p.Sk, p.Hk, p.B, p.st[kK][0],
                       p.st[kK][1], p.st[kK][2], kStep, kD) ||
      !sm90::EncodeMap(&maps[2], p.v, kD, p.Sk, p.Hk, p.B, p.st[kV][0],
                       p.st[kV][1], p.st[kV][2], kStep, kD) ||
      !sm90::EncodeMap(&maps[3], p.dout, kD, p.Sq, p.H, p.B, p.st[kDo][0],
                       p.st[kDo][1], p.st[kDo][2], kStep, kD))
    return cudaErrorInvalidValue;
  const long long blocks = static_cast<long long>(p.B) * p.Hk;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  const cudaError_t err = cudaFuncSetAttribute(
      FlashBwdMid, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMid);
  if (err != cudaSuccess) return err;
  FlashBwdMid<<<static_cast<unsigned>(blocks), kThreadsW, kSmemMid, s>>>(
      maps[0], maps[1], maps[2], maps[3], p);
  return cudaGetLastError();
}

// ------------------------------------------------ bf16, short sequences

constexpr int kShortMax = 64;     // Sq and Sk up to which FlashBwdShort runs
constexpr int kShortWarps = 4;    // warps a block
constexpr int kSmemMax = 232448;  // shared memory a block may take (227 KB)

// Shared memory of a FlashBwdShort block: K and V of `heads` kv heads (Sk
// rounded up to 16 rows), then either the staged q side of `qc` q heads of
// each (Q, dO, o, and each row's b and delta) or, once those are done,
// the dK/dV partials of the warps past the first of each split.
template <int D>
int SmemBwdShort(int heads, int qc, int split, int skp, int sqp) {
  const int kv = 2 * heads * skp * (D + kPad) * 2;
  const int stage = heads * qc * sqp * (3 * (D + kPad) * 2 + 2 * 4);
  const int red = (split - 1) * (kShortWarps / split) * 32 * D * 4;
  return kv + (stage > red ? stage : red);
}

// Each staged row's bias b = m log2(e) + log2(l) (l == 0: m log2(e)) and
// delta = rowsum(dO * o), written over the row's l (`bl`) and m (`dm`),
// which the staging copied there: eight lanes a row, each a D / 8 slice of
// o and dO. `live_row(r)` says whether staged row r is a row of a live
// head below Sq; the others get b = delta = 0 (Live masks their P). Every
// lane of the block runs the same passes, so every lane reaches the
// shuffles.
template <int D, typename LiveRow>
__device__ __forceinline__ void RowStats(const __nv_bfloat16* os,
                                         const __nv_bfloat16* dos, float* bl,
                                         float* dm, int rows,
                                         LiveRow live_row) {
  constexpr int LD = D + kPad, PER = D / 8;
  const int part = threadIdx.x % 8;
  for (int base = 0; base < rows; base += blockDim.x / 8) {
    const int r = base + threadIdx.x / 8;
    const bool in = r < rows && live_row(r);
    float sum = 0.f;
    if (in) {
      const __nv_bfloat162* o2 =
          reinterpret_cast<const __nv_bfloat162*>(os + r * LD + part * PER);
      const __nv_bfloat162* d2 =
          reinterpret_cast<const __nv_bfloat162*>(dos + r * LD + part * PER);
#pragma unroll
      for (int x = 0; x < PER / 2; ++x) {
        const float2 of = __bfloat1622float2(o2[x]);
        const float2 df = __bfloat1622float2(d2[x]);
        sum = fmaf(df.x, of.x, sum);
        sum = fmaf(df.y, of.y, sum);
      }
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 4);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    if (r < rows && part == 0) {
      const float l = bl[r];
      bl[r] = in ? dm[r] * kLog2e + (l == 0.f ? 0.f : log2f(l)) : 0.f;
      dm[r] = in ? sum : 0.f;
    }
  }
}

// dQ, dK and dV of `heads` kv heads (b * Hk + hk, from blockIdx.x * heads)
// in one launch, for Sq and Sk <= 64. The block stages each kv head's K
// and V once; then, `qc` q heads of each group at a time, their Q, dO and
// o, and computes each row's delta = rowsum(dO * o) and b = m log2(e) +
// log2(l) (l == 0: b = m log2(e)), so that P = exp2(S scale log2(e) - b)
// = exp(S scale - m) * l_inv. Two passes a step, each warp on 16 rows:
//   * dK, dV: warp w owns the 16-row kv slice w % (heads * tk) (tk = its
//     head's 16-row slices) and, where a slice has more warps than one
//     (`split`), the group's q heads h with h % split == w / (heads * tk).
//     It walks the 16-column q chunks of its band in order, computing S^T
//     = K Q^T and dP^T = V dO^T; P^T and dS^T, packed to bf16 in
//     registers, are the A fragments of dV += P^T dO and dK += dS^T Q,
//     whose sums stay in f32 registers across the whole group. At the end
//     the split's partials add into the first warp's, in order, through
//     shared memory.
//   * dQ: the staged q heads' 16-row q tiles, a warp a tile: S = Q K^T and
//     dP = dO V^T over the tile's 16-column kv chunks, dQ += dS K.
// S and dP are computed in both passes (no bytes, a few products: the
// block holds every operand). Each output element has one writer, in a
// fixed order, and nothing uses atomics: two launches give the same bytes.
// At d <= 64 registers are capped for 3 blocks an SM (168 a thread),
// which runs faster than 2 at the twin's band on an H100
// (tools/flash_variants.py); the row statistics come in with the
// staging's cp.async, and eight lanes a row sum delta.
template <int D>
__global__ void __launch_bounds__(kShortWarps * 32, D <= 64 ? 3 : 1)
    FlashBwdShort(const Params p, int heads, int qc, int split) {
  constexpr int LD = D + kPad, DT = D / 8, KD = D / 16;
  extern __shared__ __align__(16) unsigned char smem[];
  const int skp = (p.Sk + 15) / 16 * 16, sqp = (p.Sq + 15) / 16 * 16;
  const int tk = skp / 16, tq = sqp / 16;
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* vs = ks + heads * skp * LD;
  __nv_bfloat16* qs = vs + heads * skp * LD;  // [heads * qc][sqp][LD]
  __nv_bfloat16* dos = qs + heads * qc * sqp * LD;
  __nv_bfloat16* os = dos + heads * qc * sqp * LD;
  float* bst = reinterpret_cast<float*>(os + heads * qc * sqp * LD);
  float* dst = bst + heads * qc * sqp;
  float* red = reinterpret_cast<float*>(qs);  // after the last step

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int group = p.H / p.Hk;
  const long long first = static_cast<long long>(blockIdx.x) * heads;
  const int live =
      static_cast<int>(min(static_cast<long long>(heads),
                           static_cast<long long>(p.B) * p.Hk - first));
  const float c2 = p.scale * kLog2e;

  for (int jj = 0; jj < live; ++jj) {
    const int b = static_cast<int>((first + jj) / p.Hk);
    const int hk = static_cast<int>((first + jj) % p.Hk);
    LoadTile<D>(ks + jj * skp * LD, LD, Base<__nv_bfloat16>(p, p.k, kK, b, hk),
                p.st[kK][2], 0, skp, p.Sk);
    LoadTile<D>(vs + jj * skp * LD, LD, Base<__nv_bfloat16>(p, p.v, kV, b, hk),
                p.st[kV][2], 0, skp, p.Sk);
  }

  // The dK/dV pass's slice of this warp.
  const int kv_tasks = heads * tk;
  const int kvt = warp % kv_tasks, sp = warp / kv_tasks;
  const int own = kvt / tk, k0 = (kvt % tk) * 16;
  const bool owner = warp < kv_tasks * split && own < live;
  int qlo, qhi;
  QRange(p, k0, 16, &qlo, &qhi);
  const int qp_lo = qlo / 16, qp_hi = min((qhi + 15) / 16, tq);
  float dk[DT][4], dv[DT][4];
#pragma unroll
  for (int i = 0; i < DT; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[i][e] = dv[i][e] = 0.f;

  for (int c0 = 0; c0 < group; c0 += qc) {
    const int n = min(qc, group - c0);
    __syncthreads();  // the last step's readers are done with the stage
    for (int jj = 0; jj < live; ++jj) {
      const int b = static_cast<int>((first + jj) / p.Hk);
      const int h0 = static_cast<int>((first + jj) % p.Hk) * group + c0;
      for (int i = 0; i < n; ++i) {
        const int at = ((jj * qc + i) * sqp) * LD;
        LoadTile<D>(qs + at, LD, Base<__nv_bfloat16>(p, p.q, kQ, b, h0 + i),
                    p.st[kQ][2], 0, sqp, p.Sq);
        LoadTile<D>(dos + at, LD,
                    Base<__nv_bfloat16>(p, p.dout, kDo, b, h0 + i),
                    p.st[kDo][2], 0, sqp, p.Sq);
        LoadTile<D>(os + at, LD, Base<__nv_bfloat16>(p, p.o, kO, b, h0 + i),
                    p.st[kO][2], 0, sqp, p.Sq);
        const long long stat = (static_cast<long long>(b) * p.H + h0 + i) *
                               p.Sq;
        LoadStat(bst + at / LD, p.l + stat, 0, sqp, p.Sq);
        LoadStat(dst + at / LD, p.m + stat, 0, sqp, p.Sq);
      }
    }
    CpAsyncCommit();
    CpAsyncWait<0>();
    __syncthreads();
    RowStats<D>(os, dos, bst, dst, heads * qc * sqp, [&](int r) {
      const int slot = r / sqp;
      return slot / qc < live && slot % qc < n && r % sqp < p.Sq;
    });
    __syncthreads();

    // dK, dV: this warp's kv slice against its q heads of the step.
    if (owner) {
      const __nv_bfloat16* kt = ks + own * skp * LD;
      const __nv_bfloat16* vt = vs + own * skp * LD;
      for (int i = 0; i < n; ++i) {
        if ((c0 + i) % split != sp) continue;
        const int at = (own * qc + i) * sqp;
        const __nv_bfloat16* qt = qs + at * LD;
        const __nv_bfloat16* dot = dos + at * LD;
        const float* bs = bst + at;
        const float* ds = dst + at;
        for (int qp = qp_lo; qp < qp_hi; ++qp) {
          const int q0 = qp * 16;
          float sT[2][4], dpt[2][4];
#pragma unroll
          for (int nt = 0; nt < 2; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) sT[nt][e] = dpt[nt][e] = 0.f;
#pragma unroll
          for (int kd = 0; kd < KD; ++kd) {
            uint32_t ak[4], av[4], bq[4], bd[4];
            LoadA(ak, kt, LD, k0, kd * 16, lane);
            LoadBt(bq, qt, LD, q0, kd * 16, lane);
            Mma(sT[0], ak, bq[0], bq[1]);
            Mma(sT[1], ak, bq[2], bq[3]);
            LoadA(av, vt, LD, k0, kd * 16, lane);
            LoadBt(bd, dot, LD, q0, kd * 16, lane);
            Mma(dpt[0], av, bd[0], bd[1]);
            Mma(dpt[1], av, bd[2], bd[3]);
          }
          // sT[nt][e]: kv row k0 + g + 8 (e / 2), q column q0 + 8 nt + 2t +
          // (e % 2).
#pragma unroll
          for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int qc_ = q0 + 8 * nt + 2 * t + (e & 1);
              const int kvrow = k0 + g + 8 * (e >> 1);
              float pe = 0.f;
              if (Live(p, qc_, kvrow))
                pe = sm90::Exp2(fmaf(sT[nt][e], c2, -bs[qc_]));
              sT[nt][e] = pe;
              dpt[nt][e] = (pe * (dpt[nt][e] - ds[qc_])) * p.scale;
            }
          }
          uint32_t pa[1][4], sa[1][4];
          PackA<2>(pa, sT);
          PackA<2>(sa, dpt);
#pragma unroll
          for (int dt = 0; dt < DT; dt += 2) {
            uint32_t bd[4], bq[4];
            LoadB(bd, dot, LD, q0, dt * 8, lane);
            Mma(dv[dt], pa[0], bd[0], bd[1]);
            Mma(dv[dt + 1], pa[0], bd[2], bd[3]);
            LoadB(bq, qt, LD, q0, dt * 8, lane);
            Mma(dk[dt], sa[0], bq[0], bq[1]);
            Mma(dk[dt + 1], sa[0], bq[2], bq[3]);
          }
        }
      }
    }

    // dQ: the step's q tiles, a warp a tile.
    for (int task = warp; task < live * n * tq; task += kShortWarps) {
      const int si = task / tq, r0 = (task % tq) * 16;
      const int jj = si / n, i = si % n, at = (jj * qc + i) * sqp;
      const __nv_bfloat16* kt = ks + jj * skp * LD;
      const __nv_bfloat16* vt = vs + jj * skp * LD;
      const __nv_bfloat16* qt = qs + at * LD;
      const __nv_bfloat16* dot = dos + at * LD;
      float br[2], dr[2];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        br[half] = bst[at + r0 + g + 8 * half];
        dr[half] = dst[at + r0 + g + 8 * half];
      }
      int lo, hi;
      KvRange(p, r0, 16, &lo, &hi);
      const int kp_hi = min((hi + 15) / 16, tk);
      float acc[DT][4];
#pragma unroll
      for (int x = 0; x < DT; ++x)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[x][e] = 0.f;
      for (int kp = lo / 16; kp < kp_hi; ++kp) {
        const int kc = kp * 16;
        float s[2][4], dp[2][4];
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.f;
#pragma unroll
        for (int kd = 0; kd < KD; ++kd) {
          uint32_t aq[4], ad[4], bk[4], bv[4];
          LoadA(aq, qt, LD, r0, kd * 16, lane);
          LoadBt(bk, kt, LD, kc, kd * 16, lane);
          Mma(s[0], aq, bk[0], bk[1]);
          Mma(s[1], aq, bk[2], bk[3]);
          LoadA(ad, dot, LD, r0, kd * 16, lane);
          LoadBt(bv, vt, LD, kc, kd * 16, lane);
          Mma(dp[0], ad, bv[0], bv[1]);
          Mma(dp[1], ad, bv[2], bv[3]);
        }
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int half = e >> 1;
            const int row = r0 + g + 8 * half;
            const int col = kc + 8 * nt + 2 * t + (e & 1);
            float pe = 0.f;
            if (Live(p, row, col))
              pe = sm90::Exp2(fmaf(s[nt][e], c2, -br[half]));
            s[nt][e] = (pe * (dp[nt][e] - dr[half])) * p.scale;
          }
        }
        uint32_t sa[1][4];
        PackA<2>(sa, s);
#pragma unroll
        for (int dt = 0; dt < DT; dt += 2) {
          uint32_t bk[4];
          LoadB(bk, kt, LD, kc, dt * 8, lane);
          Mma(acc[dt], sa[0], bk[0], bk[1]);
          Mma(acc[dt + 1], sa[0], bk[2], bk[3]);
        }
      }
      const long long kv = first + jj;
      const int b = static_cast<int>(kv / p.Hk);
      const int h = static_cast<int>(kv % p.Hk) * group + c0 + i;
      __nv_bfloat16* dqg = OutBase<__nv_bfloat16>(p, p.dq, kDq, b, h);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = r0 + g + 8 * half;
        if (row >= p.Sq) continue;
#pragma unroll
        for (int dt = 0; dt < DT; ++dt)
          *reinterpret_cast<uint32_t*>(dqg + row * p.st[kDq][2] + dt * 8 +
                                       2 * t) =
              PackBf16(acc[dt][2 * half], acc[dt][2 * half + 1]);
      }
    }
  }

  // The split's partials into its first warp's, in order of the split.
  if (split > 1) {
    __syncthreads();  // the stage is free: the partials go there
    if (owner && sp > 0) {
      float* mine = red + ((sp - 1) * kv_tasks + kvt) * 2 * DT * 4 * 32;
#pragma unroll
      for (int x = 0; x < DT; ++x)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          mine[(x * 4 + e) * 32 + lane] = dk[x][e];
          mine[((DT + x) * 4 + e) * 32 + lane] = dv[x][e];
        }
    }
    __syncthreads();
    if (owner && sp == 0) {
      for (int o = 1; o < split; ++o) {
        const float* theirs = red + ((o - 1) * kv_tasks + kvt) * 2 * DT * 4 * 32;
#pragma unroll
        for (int x = 0; x < DT; ++x)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            dk[x][e] += theirs[(x * 4 + e) * 32 + lane];
            dv[x][e] += theirs[((DT + x) * 4 + e) * 32 + lane];
          }
      }
    }
  }
  if (!owner || sp != 0) return;
  const long long kv = first + own;
  const int b = static_cast<int>(kv / p.Hk), hk = static_cast<int>(kv % p.Hk);
  __nv_bfloat16* dkg = OutBase<__nv_bfloat16>(p, p.dk, kDk, b, hk);
  __nv_bfloat16* dvg = OutBase<__nv_bfloat16>(p, p.dv, kDv, b, hk);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = k0 + g + half * 8;
    if (row >= p.Sk) continue;
#pragma unroll
    for (int dt = 0; dt < DT; ++dt) {
      const int col = dt * 8 + 2 * t;
      *reinterpret_cast<uint32_t*>(dkg + row * p.st[kDk][2] + col) =
          PackBf16(dk[dt][2 * half], dk[dt][2 * half + 1]);
      *reinterpret_cast<uint32_t*>(dvg + row * p.st[kDv][2] + col) =
          PackBf16(dv[dt][2 * half], dv[dt][2 * half + 1]);
    }
  }
}

// Heads of S <= kPackMax rows (MHA self-attention) packed 16 / S to a
// 16-row tile: FlashBwdPacked.
constexpr int kPackMax = 8;

// Whether rows rq and rk of a tile of packed heads of s rows each are a
// live pair: the same head, one of the tile's `pack`, and Live there.
__device__ __forceinline__ bool LivePacked(const Params& p, int pack, int s,
                                           int rq, int rk) {
  const int hq = rq / s;
  return hq == rk / s && hq < pack && Live(p, rq - hq * s, rk - hq * s);
}

// FlashBwdShort for MHA self-attention at S <= kPackMax, where a 16-row
// tile of one head would be at least half padding (three quarters at the
// factorized ViT-B's S = 4): each 16-row tile holds `pack` = 16 / S heads,
// head i of the tile at rows [i S, (i + 1) S), so a block of 4 warps takes
// 4 * pack heads, one tile a warp, in the shared memory and the products
// the unpacked design spends on 4. A logit is live only within its head's
// diagonal block (LivePacked), so the packed heads do not see each other:
// P = 0 exactly off it. Per tile: dK, dV (S^T = K Q^T, dP^T = V dO^T, one
// 16 x 16 step each) written as soon as they are summed, then dQ (S and dP
// again), each output element written once.
template <int D>
__global__ void __launch_bounds__(kShortWarps * 32)
    FlashBwdPacked(const Params p, int pack) {
  constexpr int LD = D + kPad, DT = D / 8, KD = D / 16;
  constexpr int R = 16 * kShortWarps;  // staged rows: a tile a warp
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* vs = ks + R * LD;
  __nv_bfloat16* qs = vs + R * LD;
  __nv_bfloat16* dos = qs + R * LD;
  __nv_bfloat16* os = dos + R * LD;
  float* bst = reinterpret_cast<float*>(os + R * LD);
  float* dst = bst + R;
  const int s = p.Sq;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const long long first =
      static_cast<long long>(blockIdx.x) * kShortWarps * pack;
  const long long heads = static_cast<long long>(p.B) * p.H;
  const float c2 = p.scale * kLog2e;

  // Row r of the staged tiles: head first + (r / 16) * pack + i, row lr of
  // it, with i = (r % 16) / s; `in` where that is a row of a live head.
  auto row_of = [&](int r, long long* head, int* lr) {
    const int i = (r % 16) / s;
    *head = first + (r / 16) * pack + i;
    *lr = r % 16 - i * s;
    return i < pack && *head < heads;
  };
  for (int i = threadIdx.x; i < R * (D / 8); i += blockDim.x) {
    const int r = i / (D / 8), col = (i % (D / 8)) * 8;
    long long head;
    int lr;
    const bool in = row_of(r, &head, &lr);
    const int b = in ? static_cast<int>(head / p.H) : 0;
    const int h = in ? static_cast<int>(head % p.H) : 0;
    const int at = r * LD + col;
    const long long qo = in ? lr : 0;
    CpAsync16(ks + at, Base<__nv_bfloat16>(p, p.k, kK, b, h) +
                           qo * p.st[kK][2] + col, in);
    CpAsync16(vs + at, Base<__nv_bfloat16>(p, p.v, kV, b, h) +
                           qo * p.st[kV][2] + col, in);
    CpAsync16(qs + at, Base<__nv_bfloat16>(p, p.q, kQ, b, h) +
                           qo * p.st[kQ][2] + col, in);
    CpAsync16(dos + at, Base<__nv_bfloat16>(p, p.dout, kDo, b, h) +
                            qo * p.st[kDo][2] + col, in);
    CpAsync16(os + at, Base<__nv_bfloat16>(p, p.o, kO, b, h) +
                           qo * p.st[kO][2] + col, in);
  }
  for (int r = threadIdx.x; r < R; r += blockDim.x) {
    long long head;
    int lr;
    const bool in = row_of(r, &head, &lr);
    const long long stat = in ? head * p.Sq + lr : 0;
    CpAsync4(bst + r, p.l + stat, in);
    CpAsync4(dst + r, p.m + stat, in);
  }
  CpAsyncCommit();
  CpAsyncWait<0>();
  __syncthreads();
  RowStats<D>(os, dos, bst, dst, R, [&](int r) {
    long long head;
    int lr;
    return row_of(r, &head, &lr);
  });
  __syncthreads();

  const int r0 = 16 * warp;  // this warp's tile
  const float* bs = bst + r0;
  const float* ds = dst + r0;
  // The output rows of this lane: tile rows g and g + 8.
  long long head[2];
  int lrow[2];
  bool out[2];
#pragma unroll
  for (int half = 0; half < 2; ++half)
    out[half] = row_of(r0 + g + 8 * half, &head[half], &lrow[half]);

  {  // dK, dV: S^T = K Q^T and dP^T = V dO^T over the tile.
    float sT[2][4], dpt[2][4];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) sT[nt][e] = dpt[nt][e] = 0.f;
#pragma unroll
    for (int kd = 0; kd < KD; ++kd) {
      uint32_t ak[4], av[4], bq[4], bd[4];
      LoadA(ak, ks, LD, r0, kd * 16, lane);
      LoadBt(bq, qs, LD, r0, kd * 16, lane);
      Mma(sT[0], ak, bq[0], bq[1]);
      Mma(sT[1], ak, bq[2], bq[3]);
      LoadA(av, vs, LD, r0, kd * 16, lane);
      LoadBt(bd, dos, LD, r0, kd * 16, lane);
      Mma(dpt[0], av, bd[0], bd[1]);
      Mma(dpt[1], av, bd[2], bd[3]);
    }
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qr = 8 * nt + 2 * t + (e & 1);  // q row of the tile
        const int kr = g + 8 * (e >> 1);          // kv row of the tile
        float pe = 0.f;
        if (LivePacked(p, pack, s, qr, kr))
          pe = sm90::Exp2(fmaf(sT[nt][e], c2, -bs[qr]));
        sT[nt][e] = pe;
        dpt[nt][e] = (pe * (dpt[nt][e] - ds[qr])) * p.scale;
      }
    }
    uint32_t pa[1][4], sa[1][4];
    PackA<2>(pa, sT);
    PackA<2>(sa, dpt);
    float dk[DT][4], dv[DT][4];
#pragma unroll
    for (int x = 0; x < DT; ++x)
#pragma unroll
      for (int e = 0; e < 4; ++e) dk[x][e] = dv[x][e] = 0.f;
#pragma unroll
    for (int dt = 0; dt < DT; dt += 2) {
      uint32_t bd[4], bq[4];
      LoadB(bd, dos, LD, r0, dt * 8, lane);
      Mma(dv[dt], pa[0], bd[0], bd[1]);
      Mma(dv[dt + 1], pa[0], bd[2], bd[3]);
      LoadB(bq, qs, LD, r0, dt * 8, lane);
      Mma(dk[dt], sa[0], bq[0], bq[1]);
      Mma(dk[dt + 1], sa[0], bq[2], bq[3]);
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      if (!out[half]) continue;
      const int b = static_cast<int>(head[half] / p.H);
      const int h = static_cast<int>(head[half] % p.H);
      __nv_bfloat16* dkg = OutBase<__nv_bfloat16>(p, p.dk, kDk, b, h) +
                           lrow[half] * p.st[kDk][2];
      __nv_bfloat16* dvg = OutBase<__nv_bfloat16>(p, p.dv, kDv, b, h) +
                           lrow[half] * p.st[kDv][2];
#pragma unroll
      for (int dt = 0; dt < DT; ++dt) {
        *reinterpret_cast<uint32_t*>(dkg + dt * 8 + 2 * t) =
            PackBf16(dk[dt][2 * half], dk[dt][2 * half + 1]);
        *reinterpret_cast<uint32_t*>(dvg + dt * 8 + 2 * t) =
            PackBf16(dv[dt][2 * half], dv[dt][2 * half + 1]);
      }
    }
  }

  // dQ: S = Q K^T and dP = dO V^T over the tile, dQ = dS K.
  float sq[2][4], dp[2][4];
#pragma unroll
  for (int nt = 0; nt < 2; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) sq[nt][e] = dp[nt][e] = 0.f;
#pragma unroll
  for (int kd = 0; kd < KD; ++kd) {
    uint32_t aq[4], ad[4], bk[4], bv[4];
    LoadA(aq, qs, LD, r0, kd * 16, lane);
    LoadBt(bk, ks, LD, r0, kd * 16, lane);
    Mma(sq[0], aq, bk[0], bk[1]);
    Mma(sq[1], aq, bk[2], bk[3]);
    LoadA(ad, dos, LD, r0, kd * 16, lane);
    LoadBt(bv, vs, LD, r0, kd * 16, lane);
    Mma(dp[0], ad, bv[0], bv[1]);
    Mma(dp[1], ad, bv[2], bv[3]);
  }
#pragma unroll
  for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int qr = g + 8 * (e >> 1);
      const int kr = 8 * nt + 2 * t + (e & 1);
      float pe = 0.f;
      if (LivePacked(p, pack, s, qr, kr))
        pe = sm90::Exp2(fmaf(sq[nt][e], c2, -bs[qr]));
      sq[nt][e] = (pe * (dp[nt][e] - ds[qr])) * p.scale;
    }
  }
  uint32_t sa[1][4];
  PackA<2>(sa, sq);
  float acc[DT][4];
#pragma unroll
  for (int x = 0; x < DT; ++x)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[x][e] = 0.f;
#pragma unroll
  for (int dt = 0; dt < DT; dt += 2) {
    uint32_t bk[4];
    LoadB(bk, ks, LD, r0, dt * 8, lane);
    Mma(acc[dt], sa[0], bk[0], bk[1]);
    Mma(acc[dt + 1], sa[0], bk[2], bk[3]);
  }
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    if (!out[half]) continue;
    const int b = static_cast<int>(head[half] / p.H);
    const int h = static_cast<int>(head[half] % p.H);
    __nv_bfloat16* dqg = OutBase<__nv_bfloat16>(p, p.dq, kDq, b, h) +
                         lrow[half] * p.st[kDq][2];
#pragma unroll
    for (int dt = 0; dt < DT; ++dt)
      *reinterpret_cast<uint32_t*>(dqg + dt * 8 + 2 * t) =
          PackBf16(acc[dt][2 * half], acc[dt][2 * half + 1]);
  }
}

template <int D>
constexpr int SmemBwdPacked() {
  return 16 * kShortWarps * (5 * (D + kPad) * 2 + 2 * 4);
}

// The launch plan of the short design at a shape. FlashBwdPacked serves
// MHA self-attention at S <= kPackMax: 16 / S heads a 16-row tile, a tile
// a warp. FlashBwdShort serves the rest: as many kv heads a block as give
// its warps a 16-row q tile each in the dQ pass (4 under MHA at S <= 16,
// as the forward's short design), no more than give each warp a kv slice
// of its own; the warps left over share a slice's q heads (GQA); the q
// heads of a group staged all at once where they fit in shared memory,
// else in halves until they do.
struct ShortBwdPlan {
  int pack;    // heads a 16-row tile: above 1 for FlashBwdPacked
  int heads;   // kv heads a block
  int qc;      // q heads of a group staged at once
  int split;   // warps that share a kv slice
  int smem;    // dynamic shared memory a block
  int blocks;
};

// Fills `plan` and opts the kernel it names in to its shared memory.
template <int D>
cudaError_t PlanShortBwd(const Params& p, ShortBwdPlan* plan) {
  const bool packed = p.H == p.Hk && p.Sq == p.Sk && p.Sq <= kPackMax;
  const int tk = (p.Sk + 15) / 16, tq = (p.Sq + 15) / 16;
  const int group = p.H / p.Hk;
  ShortBwdPlan& x = *plan;
  if (packed) {
    x.pack = 16 / p.Sq;
    x.heads = kShortWarps * x.pack;
    x.qc = x.split = 1;
    x.smem = SmemBwdPacked<D>();
  } else {
    x.pack = 1;
    x.heads = group * tq >= kShortWarps ? 1 : kShortWarps / (group * tq);
    if (x.heads > kShortWarps / tk) x.heads = kShortWarps / tk;
    x.split = kShortWarps / (x.heads * tk);
    if (x.split > group) x.split = group;
    x.qc = group;
    x.smem = SmemBwdShort<D>(x.heads, x.qc, x.split, 16 * tk, 16 * tq);
    while (x.smem > kSmemMax && x.qc > 1) {
      x.qc = (x.qc + 1) / 2;
      x.smem = SmemBwdShort<D>(x.heads, x.qc, x.split, 16 * tk, 16 * tq);
    }
  }
  const long long blocks =
      (static_cast<long long>(p.B) * p.Hk + x.heads - 1) / x.heads;
  x.blocks = static_cast<int>(blocks);
  if (x.smem > kSmemMax || blocks > 0x7fffffff) return cudaErrorInvalidValue;
  if (x.smem <= 48 * 1024) return cudaSuccess;
  return packed ? cudaFuncSetAttribute(
                      FlashBwdPacked<D>,
                      cudaFuncAttributeMaxDynamicSharedMemorySize, x.smem)
                : cudaFuncSetAttribute(
                      FlashBwdShort<D>,
                      cudaFuncAttributeMaxDynamicSharedMemorySize, x.smem);
}

template <int D>
cudaError_t LaunchShortBwd(const Params& p, cudaStream_t s) {
  ShortBwdPlan x;
  const cudaError_t err = PlanShortBwd<D>(p, &x);
  if (err != cudaSuccess) return err;
  if (x.pack > 1)
    FlashBwdPacked<D><<<x.blocks, kShortWarps * 32, x.smem, s>>>(p, x.pack);
  else
    FlashBwdShort<D><<<x.blocks, kShortWarps * 32, x.smem, s>>>(
        p, x.heads, x.qc, x.split);
  return cudaGetLastError();
}

// --------------------------------------------------------------- dispatch

// The design that serves (dtype, d, B, H, Hk, Sq, Sk): 0 "wgmma", 1
// "mma_sync", 2 "f32", 3 "short" (bf16 at Sq and Sk <= kShortMax, ahead of
// the other bf16 designs), 4 "mid" (bf16 at d = 64 and Sq, Sk <= kMidMax,
// one of them past kShortMax, with H == Hk or B * Hk >= kMidMinKvHeads),
// or -1 for a head dim or dtype no kernel takes.
int Design(int dtype, int d, int B, int H, int Hk, int sq, int sk) {
  if (d != 32 && d != 64 && d != 128) return -1;
  if (dtype == 0) {
    if (sq <= kShortMax && sk <= kShortMax) return 3;
    if (d == kD && sq <= kMidMax && sk <= kMidMax &&
        (H == Hk || static_cast<long long>(B) * Hk >= kMidMinKvHeads))
      return 4;
    return d == kD ? 0 : 1;
  }
  return dtype == 1 ? 2 : -1;
}

// Delta, Dkv and Dq of the mma.sync (bf16) or FMA (f32) design.
template <typename T, int D>
cudaError_t LaunchAll(const Params& p, cudaStream_t s) {
  const long long rows = static_cast<long long>(p.B) * p.H * p.Sq;
  cudaError_t err = Launch(Delta<T, D>, 0,
                           dim3(static_cast<unsigned>((rows + 3) / 4)), p, s);
  if (err != cudaSuccess) return err;
  constexpr bool kBf16 = sizeof(T) == 2;
  constexpr int rows_b = kBf16 ? kRowsB : kRowsF;
  // (tiles, heads, batch), as the forward's grid.
  const dim3 dkv((p.Sk + rows_b - 1) / rows_b, p.Hk, p.B);
  const dim3 dq((p.Sq + rows_b - 1) / rows_b, p.H, p.B);
  if (kBf16) {
    err = Launch(DkvBf16<D>, SmemDkvBf16<D>(), dkv, p, s);
    if (err != cudaSuccess) return err;
    return Launch(DqBf16<D>, SmemDqBf16<D>(), dq, p, s);
  }
  err = Launch(DkvF32<D>, SmemDkvF32<D>(), dkv, p, s);
  if (err != cudaSuccess) return err;
  return Launch(DqF32<D>, SmemDqF32<D>(), dq, p, s);
}

template <typename T>
cudaError_t ByHeadDim(int d, const Params& p, cudaStream_t s) {
  switch (d) {
    case 32: return LaunchAll<T, 32>(p, s);
    case 64: return LaunchAll<T, 64>(p, s);
    case 128: return LaunchAll<T, 128>(p, s);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 bf16, 1 f32. d: 32, 64 or 128. `strides` holds 24 values in
// elements: the (batch, head, seq) strides of q, k, v, o, dout, dq, dk and
// dv in that order; the last dimension of each is contiguous. l and m are
// [B, H, Sq] f32, contiguous. `scratch` holds 2 * B * H * ceil(Sq / 64) *
// 64 floats, which the call fills (delta and l_inv, or the wgmma design's
// tiled statistics); the "short" and "mid" designs read and write none of
// it, and scratch may then be null.
// Every output element is written. Returns a cudaError_t (0 on success,
// cudaErrorInvalidValue for a head dim or dtype the kernels do not take,
// or for bf16 strides that TMA cannot describe).
extern "C" int ts_flash_bwd(const void* q, const void* k, const void* v,
                            const void* o, const void* dout, const float* l,
                            const float* m, float* scratch, void* dq,
                            void* dk, void* dv, int dtype, int B, int H,
                            int Hk, int Sq, int Sk, int d,
                            const long long* strides, float scale,
                            int causal, int window, void* stream) {
  Params p{};
  p.q = q; p.k = k; p.v = v; p.o = o; p.dout = dout;
  p.l = l; p.m = m;
  p.delta = scratch;
  p.linv = scratch + static_cast<long long>(B) * H * Sq;
  p.stats = scratch;
  p.dq = dq; p.dk = dk; p.dv = dv;
  p.B = B; p.H = H; p.Hk = Hk; p.Sq = Sq; p.Sk = Sk;
  p.tiles = (Sq + kStep - 1) / kStep;
  for (int i = 0; i < kTensors; ++i)
    for (int j = 0; j < 3; ++j) p.st[i][j] = strides[3 * i + j];
  p.scale = scale;
  p.causal = causal;
  p.window = window;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (Design(dtype, d, B, H, Hk, Sq, Sk)) {
    case 0: return static_cast<int>(LaunchWgmma(p, s));
    case 1: return static_cast<int>(ByHeadDim<__nv_bfloat16>(d, p, s));
    case 2: return static_cast<int>(ByHeadDim<float>(d, p, s));
    case 3:
      switch (d) {
        case 32: return static_cast<int>(LaunchShortBwd<32>(p, s));
        case 64: return static_cast<int>(LaunchShortBwd<64>(p, s));
        case 128: return static_cast<int>(LaunchShortBwd<128>(p, s));
      }
      break;
    case 4: return static_cast<int>(LaunchMidBwd(p, s));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// The design ts_flash_bwd launches for (dtype, d, B, H, Hk, Sq, Sk), as
// Design() above.
extern "C" int ts_flash_bwd_design(int dtype, int d, int B, int H, int Hk,
                                   int sq, int sk) {
  return Design(dtype, d, B, H, Hk, sq, sk);
}

// The launch plan of the "short" design (Design() == 3) at a shape, for a
// caller that reports it: out[0] the kv heads a block, out[1] the q heads
// of a group staged at once, out[2] the warps that share a kv slice, out[3]
// the shared memory a block, out[4] the blocks, out[5] the blocks an SM
// holds, out[6] the heads a 16-row tile (FlashBwdPacked where above 1).
// Returns a cudaError_t.
template <int D>
cudaError_t ReportShortBwd(const Params& p, int* out) {
  ShortBwdPlan x;
  cudaError_t err = PlanShortBwd<D>(p, &x);
  const int plan[] = {x.heads, x.qc, x.split, x.smem, x.blocks, 0, x.pack};
  for (int i = 0; i < 7; ++i) out[i] = plan[i];
  if (err != cudaSuccess) return err;
  return x.pack > 1 ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                          &out[5], FlashBwdPacked<D>, kShortWarps * 32, x.smem)
                    : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                          &out[5], FlashBwdShort<D>, kShortWarps * 32, x.smem);
}

extern "C" int ts_flash_bwd_short_plan(int d, int B, int H, int Hk, int Sq,
                                       int Sk, int* out) {
  Params p{};
  p.B = B; p.H = H; p.Hk = Hk; p.Sq = Sq; p.Sk = Sk;
  switch (d) {
    case 32: return static_cast<int>(ReportShortBwd<32>(p, out));
    case 64: return static_cast<int>(ReportShortBwd<64>(p, out));
    case 128: return static_cast<int>(ReportShortBwd<128>(p, out));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// The launch plan of the "mid" design (Design() == 4) at a shape, for a
// caller that reports it: out[0] the blocks, out[1] the blocks an SM
// holds, out[2] the shared memory a block, out[3] the kv slices a block,
// out[4] the q tiles a block walks. Returns a cudaError_t.
extern "C" int ts_flash_bwd_mid_plan(int d, int B, int H, int Hk, int Sq,
                                     int Sk, int* out) {
  if (d != kD) return static_cast<int>(cudaErrorInvalidValue);
  out[0] = B * Hk;
  out[2] = kSmemMid;
  out[3] = (Sk + kStep - 1) / kStep;
  out[4] = H / Hk * ((Sq + kStep - 1) / kStep);
  cudaError_t err = cudaFuncSetAttribute(
      FlashBwdMid, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMid);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &out[1], FlashBwdMid, kThreadsW, kSmemMid));
}
