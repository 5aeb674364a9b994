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
//   * The block masks q rows >= Sq and kv columns >= Sk itself (no padding
//     copies). Masked logits get -0.7 * FLT_MAX, never -inf. GQA maps q
//     head h to kv head h / (H / Hk). Cross-attention (Sq != Sk) works when
//     not causal.
//   * Inputs are [B, H, S, d] with any B/H/S strides and a contiguous last
//     dimension, so the model's [B, S, H, d] projections go in without a
//     transpose copy. The output takes its own strides.
//
// Numerics, as the JAX _reference states them: logits accumulate in f32
// and are scaled after the product; m and l are kept online in f32; P is
// cast to the input dtype before P@V, which accumulates in f32; the output
// is acc * (l == 0 ? 1 : 1/l), cast to q's dtype; l is the f32 sum of p
// (the TPU's ones-augmented V column is a TPU workaround and is not here).
//   * bf16: both products on the tensor cores, mma.sync m16n8k16 with f32
//     accumulation. 4 warps, 64 q rows (16 a warp), kv tiles of 64.
//   * f32: plain f32 FMAs, no TF32. 128 threads, 32 q rows (4 threads a
//     row), kv tiles of 32.
//
// Bound at the headline shape [2, 12, 1568, 64] bf16, non-causal:
// operations, 4*B*H*Sq*Sk*d = 15.1 GFLOP -> 15.3 us at 989 TFLOP/s bf16,
// against 19.3 MB of q, k, v and o -> 5.8 us at 3.35 TB/s. This first
// version is simple and right: tiles load through registers with no
// copy/compute overlap, and each block keeps one kv tile in shared memory.
// wgmma and TMA are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

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

__device__ __forceinline__ void MmaBf16(float* d, const uint32_t* a,
                                        uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t PackBf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t Ld32(const __nv_bfloat16* ptr) {
  return *reinterpret_cast<const uint32_t*>(ptr);
}

constexpr int kBqB = 64;   // q rows a block (16 a warp)
constexpr int kBkB = 64;   // kv columns a tile
constexpr int kPad = 8;    // bf16 elements of row padding: no bank conflicts

template <int D>
constexpr int SmemBf16() {
  return (kBqB * (D + kPad) + kBkB * (D + kPad) + D * (kBkB + kPad)) * 2;
}

// mma.sync m16n8k16 fragments, g = lane / 4, c = lane % 4:
//   A (16x16, row-major): a0 (g, 2c..2c+1), a1 (g+8, 2c..), a2 (g, 2c+8..),
//     a3 (g+8, 2c+8..).
//   B (16x8, k by n): b0 (k = 2c..2c+1, n = g), b1 (k = 2c+8.., n = g).
//   C (16x8): c0, c1 (g, 2c..2c+1), c2, c3 (g+8, 2c..2c+1).
// The C fragments of two neighbouring n-tiles of S are exactly the A
// fragment of P for one k-step of P@V, so P never leaves registers.
template <int D>
__global__ void __launch_bounds__(128) FlashFwdBf16(Params p) {
  constexpr int QLD = D + kPad, KLD = D + kPad, VLD = kBkB + kPad;
  constexpr int NT = kBkB / 8;  // n-tiles of S
  constexpr int DT = D / 8;     // n-tiles of O
  constexpr int KS = D / 16;    // k-steps of Q K^T
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* ks = qs + kBqB * QLD;
  __nv_bfloat16* vt = ks + kBkB * KLD;  // V transposed: [D][kv]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, c = lane & 3;
  const int q0 = blockIdx.x * kBqB, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (p.H / p.Hk);
  const __nv_bfloat16* qg = static_cast<const __nv_bfloat16*>(p.q) +
                            b * p.qsb + h * p.qsh;
  const __nv_bfloat16* kg = static_cast<const __nv_bfloat16*>(p.k) +
                            b * p.ksb + hk * p.ksh;
  const __nv_bfloat16* vg = static_cast<const __nv_bfloat16*>(p.v) +
                            b * p.vsb + hk * p.vsh;

  for (int i = tid; i < kBqB * D / 8; i += 128) {
    const int r = i / (D / 8), col = (i % (D / 8)) * 8;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (q0 + r < p.Sq)
      val = *reinterpret_cast<const uint4*>(qg + (q0 + r) * p.qss + col);
    *reinterpret_cast<uint4*>(qs + r * QLD + col) = val;
  }
  __syncthreads();
  const int wr = warp * 16;
  uint32_t qf[KS][4];
#pragma unroll
  for (int s = 0; s < KS; ++s) {
    qf[s][0] = Ld32(qs + (wr + g) * QLD + s * 16 + 2 * c);
    qf[s][1] = Ld32(qs + (wr + g + 8) * QLD + s * 16 + 2 * c);
    qf[s][2] = Ld32(qs + (wr + g) * QLD + s * 16 + 8 + 2 * c);
    qf[s][3] = Ld32(qs + (wr + g + 8) * QLD + s * 16 + 8 + 2 * c);
  }

  float acc[DT][4];
#pragma unroll
  for (int t = 0; t < DT; ++t) acc[t][0] = acc[t][1] = acc[t][2] = acc[t][3] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};
  const int row0 = q0 + wr + g;  // this thread's rows: row0 and row0 + 8

  int lo, hi;
  KvRange(p, q0, kBqB, &lo, &hi);
  for (int k0 = (lo / kBkB) * kBkB; k0 < hi; k0 += kBkB) {
    __syncthreads();  // every warp is done with the previous tile
    for (int i = tid; i < kBkB * D / 8; i += 128) {
      const int r = i / (D / 8), col = (i % (D / 8)) * 8;
      uint4 val = make_uint4(0, 0, 0, 0);
      if (k0 + r < p.Sk)
        val = *reinterpret_cast<const uint4*>(kg + (k0 + r) * p.kss + col);
      *reinterpret_cast<uint4*>(ks + r * KLD + col) = val;
    }
    for (int i = tid; i < kBkB * D / 8; i += 128) {
      const int j = i % kBkB, col = (i / kBkB) * 8;
      uint4 val = make_uint4(0, 0, 0, 0);
      if (k0 + j < p.Sk)
        val = *reinterpret_cast<const uint4*>(vg + (k0 + j) * p.vss + col);
      const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&val);
#pragma unroll
      for (int x = 0; x < 8; ++x) vt[(col + x) * VLD + j] = e[x];
    }
    __syncthreads();

    float s[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int st = 0; st < KS; ++st) {
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const __nv_bfloat16* kr = ks + (n * 8 + g) * KLD + st * 16 + 2 * c;
        MmaBf16(s[n], qf[st], Ld32(kr), Ld32(kr + 8));
      }
    }
    const bool masked = TileNeedsMask(p, q0, kBqB, k0, kBkB);
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[n][e] * p.scale;
        if (masked && !Live(p, row0 + (e >> 1) * 8, k0 + n * 8 + 2 * c + (e & 1)))
          x = kMask;
        s[n][e] = x;
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mx = kMask;
#pragma unroll
      for (int n = 0; n < NT; ++n)
        mx = fmaxf(mx, fmaxf(s[n][2 * i], s[n][2 * i + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_run[i], mx);
      const float alpha = expf(m_run[i] - m_new);
      m_run[i] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        s[n][2 * i] = expf(s[n][2 * i] - m_new);
        s[n][2 * i + 1] = expf(s[n][2 * i + 1] - m_new);
        sum += s[n][2 * i] + s[n][2 * i + 1];
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      l_run[i] = l_run[i] * alpha + sum;
#pragma unroll
      for (int t = 0; t < DT; ++t) {
        acc[t][2 * i] *= alpha;
        acc[t][2 * i + 1] *= alpha;
      }
    }
#pragma unroll
    for (int kk = 0; kk < kBkB / 16; ++kk) {
      const uint32_t a[4] = {PackBf16(s[2 * kk][0], s[2 * kk][1]),
                             PackBf16(s[2 * kk][2], s[2 * kk][3]),
                             PackBf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             PackBf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int t = 0; t < DT; ++t) {
        const __nv_bfloat16* vr = vt + (t * 8 + g) * VLD + kk * 16 + 2 * c;
        MmaBf16(acc[t], a, Ld32(vr), Ld32(vr + 8));
      }
    }
  }

  __nv_bfloat16* og = static_cast<__nv_bfloat16*>(p.o) + b * p.osb + h * p.osh;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + 8 * i;
    if (row >= p.Sq) continue;
    const float inv = l_run[i] == 0.f ? 1.f : 1.f / l_run[i];
#pragma unroll
    for (int t = 0; t < DT; ++t) {
      const uint32_t packed = PackBf16(acc[t][2 * i] * inv, acc[t][2 * i + 1] * inv);
      *reinterpret_cast<uint32_t*>(og + row * p.oss + t * 8 + 2 * c) = packed;
    }
    if (c == 0 && p.l != nullptr) {
      const long long at = (static_cast<long long>(b) * p.H + h) * p.Sq + row;
      p.l[at] = l_run[i];
      p.m[at] = m_run[i];
    }
  }
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

}  // namespace

// dtype: 0 bf16, 1 f32. d: 32, 64 or 128. Strides in elements; the last
// dimension of every tensor is contiguous. l and m may both be null.
// Returns a cudaError_t (0 on success, cudaErrorInvalidValue for a head
// dim or dtype the kernel does not take).
extern "C" int ts_flash_fwd(
    const void* q, const void* k, const void* v, void* o, float* l, float* m,
    int dtype, int B, int H, int Hk, int Sq, int Sk, int d,
    long long qsb, long long qsh, long long qss,
    long long ksb, long long ksh, long long kss,
    long long vsb, long long vsh, long long vss,
    long long osb, long long osh, long long oss,
    float scale, int causal, int window, void* stream) {
  Params p{q, k, v, o, l, m, B, H, Hk, Sq, Sk,
           qsb, qsh, qss, ksb, ksh, kss, vsb, vsh, vss, osb, osh, oss,
           scale, causal, window};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    const dim3 grid((Sq + kBqB - 1) / kBqB, H, B);
    switch (d) {
      case 32: return Launch(FlashFwdBf16<32>, SmemBf16<32>(), grid, p, s);
      case 64: return Launch(FlashFwdBf16<64>, SmemBf16<64>(), grid, p, s);
      case 128: return Launch(FlashFwdBf16<128>, SmemBf16<128>(), grid, p, s);
    }
  } else if (dtype == 1) {
    const dim3 grid((Sq + kBqF - 1) / kBqF, H, B);
    switch (d) {
      case 32: return Launch(FlashFwdF32<32>, SmemF32<32>(), grid, p, s);
      case 64: return Launch(FlashFwdF32<64>, SmemF32<64>(), grid, p, s);
      case 128: return Launch(FlashFwdF32<128>, SmemF32<128>(), grid, p, s);
    }
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
