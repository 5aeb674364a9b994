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
//   * Delta: one warp a row; it also writes l_inv.
//   * Dkv: one block per (kv tile, batch * kv head). It loops over the g =
//     H / Hk q heads of its group and over the q tiles of its kv tile's
//     live row band (causal starts at the tile's first column; a window
//     ends W - 1 rows past its last column and, symmetric, starts W - 1
//     before its first), so a window costs O(S * W) like _flash_bwd's
//     banded_bwd. dK and dV of the group sum in registers.
//   * Dq: one block per (q tile, batch * head), looping over the live kv
//     tiles as the forward does.
// No block writes what another writes and nothing uses atomics: two
// launches on the same inputs give the same bytes. The price is that S
// and dP are computed in both Dkv and Dq: seven products a tile pair
// where one pass with atomic dQ sums would need five.
//
// Bound: at the training shape [4, 12, 1568, 64] bf16 the five products
// are 10 * B*H*Sq*Sk*d = 75.5 GFLOP, 76 us at 989 TFLOP/s, against ~77 MB
// of q, k, v, o, dO, l, m and the three outputs (23 us at 3.35 TB/s): the
// tensor cores bound it. This first design is simple: bf16 products on
// mma.sync m16n8k16 with operands read from shared memory by ldmatrix,
// 64-row tiles (16 rows a warp), the next tile loading by cp.async into a
// second stage while this one is computed; f32 on plain FMAs (no TF32). A
// TMA ring with wgmma, as csrc/flash_fwd.cu, is later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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
  void* dq;
  void* dk;
  void* dv;
  int B, H, Hk, Sq, Sk;
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

// ------------------------------------------------------------------ bf16

__device__ __forceinline__ uint32_t SmemAddr(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

__device__ __forceinline__ void Mma(float* d, const uint32_t* a, uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void Ldsm4(uint32_t* r, const __nv_bfloat16* ptr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(SmemAddr(ptr)));
}

__device__ __forceinline__ void Ldsm4T(uint32_t* r,
                                       const __nv_bfloat16* ptr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(SmemAddr(ptr)));
}

__device__ __forceinline__ uint32_t PackBf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// mma.sync m16n8k16 fragments, g = lane / 4, t = lane % 4:
//   A (16x16, row-major): a0 (g, 2t..2t+1), a1 (g+8, 2t..), a2 (g, 2t+8..),
//     a3 (g+8, 2t+8..).
//   B (16x8, k by n): b0 (k = 2t..2t+1, n = g), b1 (k = 2t+8.., n = g).
//   C (16x8): c0, c1 (g, 2t..2t+1), c2, c3 (g+8, 2t..2t+1).
// The C fragments of two neighbouring n-tiles are the A fragment of one
// k-step, so P and dS go from one product to the next in registers.

// The A fragment of rows [r0, r0 + 16), columns [c0, c0 + 16) of a
// row-major tile with row pitch ld.
__device__ __forceinline__ void LoadA(uint32_t* a, const __nv_bfloat16* tile,
                                      int ld, int r0, int c0, int lane) {
  Ldsm4(a, tile + (r0 + (lane & 7) + ((lane >> 3) & 1) * 8) * ld + c0 +
               (lane >> 4) * 8);
}

// B fragments of the n-tiles n0 and n0 + 8 for k in [k0, k0 + 16), from a
// tile stored [n][k] (B = tile^T): b[0..1] for n0, b[2..3] for n0 + 8.
__device__ __forceinline__ void LoadBt(uint32_t* b, const __nv_bfloat16* tile,
                                       int ld, int n0, int k0, int lane) {
  Ldsm4(b, tile + (n0 + (lane & 7) + (lane >> 4) * 8) * ld + k0 +
               ((lane >> 3) & 1) * 8);
}

// The same from a tile stored [k][n] (B = tile), through ldmatrix.trans.
__device__ __forceinline__ void LoadB(uint32_t* b, const __nv_bfloat16* tile,
                                      int ld, int k0, int n0, int lane) {
  Ldsm4T(b, tile + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * ld + n0 +
                (lane >> 4) * 8);
}

// A fragments of a [16 x 8*NT] product held as C fragments, cast to bf16.
template <int NT>
__device__ __forceinline__ void PackA(uint32_t (*a)[4], const float (*c)[4]) {
#pragma unroll
  for (int kc = 0; kc < NT / 2; ++kc) {
    a[kc][0] = PackBf16(c[2 * kc][0], c[2 * kc][1]);
    a[kc][1] = PackBf16(c[2 * kc][2], c[2 * kc][3]);
    a[kc][2] = PackBf16(c[2 * kc + 1][0], c[2 * kc + 1][1]);
    a[kc][3] = PackBf16(c[2 * kc + 1][2], c[2 * kc + 1][3]);
  }
}

// cp.async copies global -> shared without registers; a source size of 0
// writes zeros (rows past S), and the source must still be a valid address.
__device__ __forceinline__ void CpAsync16(void* dst, const void* src,
                                          bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   SmemAddr(dst)),
               "l"(src), "r"(full ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void CpAsync4(void* dst, const void* src,
                                         bool full) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   SmemAddr(dst)),
               "l"(src), "r"(full ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void CpAsyncCommit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most N committed groups are still in flight.
template <int N>
__device__ __forceinline__ void CpAsyncWait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

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
// dv in that order; the last dimension of each is contiguous. l, m and
// delta and linv are [B, H, Sq] f32, contiguous; delta and linv are scratch
// the call fills.
// Every output element is written. Returns a cudaError_t (0 on success,
// cudaErrorInvalidValue for a head dim or dtype the kernels do not take).
extern "C" int ts_flash_bwd(const void* q, const void* k, const void* v,
                            const void* o, const void* dout, const float* l,
                            const float* m, float* delta, float* linv,
                            void* dq, void* dk, void* dv, int dtype, int B,
                            int H, int Hk, int Sq, int Sk, int d,
                            const long long* strides,
                            float scale, int causal, int window,
                            void* stream) {
  Params p{};
  p.q = q; p.k = k; p.v = v; p.o = o; p.dout = dout;
  p.l = l; p.m = m; p.delta = delta; p.linv = linv;
  p.dq = dq; p.dk = dk; p.dv = dv;
  p.B = B; p.H = H; p.Hk = Hk; p.Sq = Sq; p.Sk = Sk;
  for (int i = 0; i < kTensors; ++i)
    for (int j = 0; j < 3; ++j) p.st[i][j] = strides[3 * i + j];
  p.scale = scale;
  p.causal = causal;
  p.window = window;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return static_cast<int>(ByHeadDim<__nv_bfloat16>(d, p, s));
  if (dtype == 1) return static_cast<int>(ByHeadDim<float>(d, p, s));
  return static_cast<int>(cudaErrorInvalidValue);
}
