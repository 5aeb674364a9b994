// The ViT blocks' LayerNorm seams and MLP activation on Hopper (sm_90a),
// forward and backward.
//
// Replaces the XLA fusions (not Pallas kernels) that the JAX package's
// ViT blocks compile to (its models/video_vit.py):
// - each LayerNorm with the astype(compute_dtype) after it and, where a
//   sublayer's output joins the residual stream just before it, that
//   sublayer's Dense bias and the residual add (:263-278 factorized,
//   :309-319 joint): ts_ln_cast and ts_ln_cast_bwd;
// - fc1's bias with the tanh GELU after it (:205): ts_bias_gelu and
//   ts_bias_gelu_bwd.
// Same functions as the plain torch versions in
// tensor_stream_torch/ops/block_fusions.py (ln_cast_plain, ...), which are
// the port's unfused op sequence, rounding for rounding:
//   t  = C(y + C(b))                  the Dense bias, in the compute dtype C
//   x' = X(x + X(t))                  the residual add, in the residual dtype X
//   h  = C(LayerNorm_f32(f32(x')))    eps as given, biased variance
//   g  = C(gelu_tanh(f32(C(y + C(b)))))
// X and C are bf16 or f32 each (codes 0 and 1, ops/block_fusions.py
// _DTYPES); the main paths run X = C = bf16.
//
// Bound: device-memory bytes. A LayerNorm row of D values does some 10
// operations a value; a GELU value some 20 (a tanh). At 3.35 TB/s, at the
// factorized ViT-B step's 6,272 rows, D = 768, bf16:
//   ts_ln_cast with the residual (x, y in; x', h out)  38.5 MB -> 11.5 us
//   ts_ln_cast without it (x in; h out)                19.3 MB ->  5.8 us
//   ts_ln_cast_bwd with the residual (dh, dres, x' in; dx out)
//                                                      38.5 MB -> 11.5 us
//   ts_bias_gelu over [6272, 3072] (y in; g out)       77.1 MB -> 23.0 us
//   ts_bias_gelu_bwd (dg, y in; dy out)               115.6 MB -> 34.5 us
// The unfused ops move about four times these bytes (f32 copies of x' and
// of the LayerNorm's output and gradient, the bias add's own pass, the
// GELU's saved pre-activation).
//
// Design, simple and memory-bound:
// - ts_ln_cast: a warp a row, 8 rows a 256-thread block. A lane holds
//   J groups of 8 consecutive values (group lane + 32 j, J = ceil(D /
//   256)) loaded with 16-byte vector loads; the row's sum and its sum of
//   squared deviations are warp butterflies (every lane ends with the same
//   bits), so the statistics never leave registers: mean = sum / D, then
//   var = sum((v - mean)^2) / D (two passes over the registers, not flax's
//   E[x^2] - E[x]^2), rstd = 1 / sqrt(var + eps), each an IEEE operation.
//   x and y are read at their strides (up to three leading dims: the
//   temporal sublayer hands y in as a transposed view); x' and h are
//   written contiguous; each row's mean and rstd (f32) are kept for the
//   backward.
// - ts_ln_cast_bwd: a warp a row again, over a fixed grid of
//   LnBwdGroups(rows) blocks of 8 warps, warp w of block g taking rows
//   g * 8 + w, + 8 G, ... With xhat = (x' - mean) rstd and dh in f32:
//   dxf = rstd (dh gamma - mean(dh gamma) - xhat mean(dh gamma xhat)),
//   dx = X(dres + X(dxf)) (the residual stream's gradient, when given,
//   added after the rounding, as autograd accumulates), and with the
//   residual the bias's share C(dx). The column sums (dgamma, dbeta and the
//   bias's db) are deterministic: each lane sums its columns over its rows
//   in order, the block's 8 warps are summed in warp order through shared
//   memory into one partial row a block, and ColumnSums adds the partial
//   rows in a fixed order (eight strided runs of blocks, then the eight
//   runs in turn). No float atomics: the same inputs give the same
//   bytes, so a graphed training step equals the eager one bit for bit.
//   db is rounded to C once summed, as the compute-dtype sum of the bias
//   add's gradient is.
// - ts_bias_gelu: a grid-stride pass over 8-value vectors (16-byte loads
//   and stores in bf16), the bias column of each vector from its index.
// - ts_bias_gelu_bwd: recomputes the pre-activation from y and b (nothing
//   else is saved), dy = C(dg gelu'(u)), over a grid of (1024-column slabs,
//   GeluBwdGroups(rows) row groups), a thread 8 columns of a slab summing
//   its dy over its group's rows in order; ColumnSums then adds the
//   groups' partial rows in its fixed order, as above.
// The GELU and its derivative are ATen's tanh-approximation formulas in
// f32 (kBeta = sqrt(2/pi), kKappa = 0.044715). nvcc may contract a
// multiply and an add into an FMA anywhere here: the outputs are held to
// their plain versions within one bf16 step (h, g) or a relative f32 rule
// (the gradients), not bit for bit; x' is one rounding of an add and
// equals the plain version's bits.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRowsPerBlock = 8;     // ts_ln_cast(_bwd): warps a block
constexpr int kMaxGroups = 4;        // J: D <= 32 lanes x 8 x 4 = 1024
constexpr int kLnBwdMaxBlocks = 264;
constexpr int kGeluThreads = 128;    // a slab: 128 threads x 8 columns
constexpr int kGeluSlab = kGeluThreads * 8;
constexpr int kGeluBwdMaxGroups = 384;
constexpr int kSumWarps = 8;
constexpr int kSumThreads = kSumWarps * 32;

__device__ __forceinline__ float Bf16Lo(uint32_t w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float Bf16Hi(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}

__device__ __forceinline__ void Load8(const __nv_bfloat16* p, float v[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  v[0] = Bf16Lo(u.x); v[1] = Bf16Hi(u.x);
  v[2] = Bf16Lo(u.y); v[3] = Bf16Hi(u.y);
  v[4] = Bf16Lo(u.z); v[5] = Bf16Hi(u.z);
  v[6] = Bf16Lo(u.w); v[7] = Bf16Hi(u.w);
}

__device__ __forceinline__ void Load8(const float* p, float v[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ uint32_t Pack(float lo, float hi) {
  return static_cast<uint32_t>(
             __bfloat16_as_ushort(__float2bfloat16_rn(lo))) |
         (static_cast<uint32_t>(
              __bfloat16_as_ushort(__float2bfloat16_rn(hi))) << 16);
}

__device__ __forceinline__ void Store8(__nv_bfloat16* p, const float v[8]) {
  uint4 u;
  u.x = Pack(v[0], v[1]); u.y = Pack(v[2], v[3]);
  u.z = Pack(v[4], v[5]); u.w = Pack(v[6], v[7]);
  *reinterpret_cast<uint4*>(p) = u;
}

__device__ __forceinline__ void Store8(float* p, const float v[8]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  *reinterpret_cast<float4*>(p + 4) = make_float4(v[4], v[5], v[6], v[7]);
}

// v rounded to T and read back as f32.
template <typename T> __device__ __forceinline__ float Round(float v);
template <> __device__ __forceinline__ float Round<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ float Round<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// A tensor's rows: up to three leading dims (sizes n1, n2 of the last two,
// strides s0, s1, s2 in elements) over a contiguous last dim.
struct Rows {
  long long n1, n2, s0, s1, s2;
  __device__ __forceinline__ long long Offset(long long r) const {
    const long long i2 = r % n2, q = r / n2;
    return (q / n1) * s0 + (q % n1) * s1 + i2 * s2;
  }
};

__device__ __forceinline__ float WarpSum(float s) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  return s;
}

template <typename X, typename C, int J>
__global__ void __launch_bounds__(kRowsPerBlock * 32)
    LnCast(const X* __restrict__ x, Rows xr, const C* __restrict__ y,
           Rows yr, const float* __restrict__ b,
           const float* __restrict__ gamma, const float* __restrict__ beta,
           X* __restrict__ xp, C* __restrict__ h, float* __restrict__ mean_out,
           float* __restrict__ rstd_out, long long rows, int d, float eps) {
  const int lane = threadIdx.x & 31;
  const long long row =
      static_cast<long long>(blockIdx.x) * kRowsPerBlock + (threadIdx.x >> 5);
  if (row >= rows) return;
  float v[J][8];
  const X* xrow = x + xr.Offset(row);
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int c = (lane + 32 * j) * 8;
    if (c < d) {
      Load8(xrow + c, v[j]);
    } else {
#pragma unroll
      for (int k = 0; k < 8; ++k) v[j][k] = 0.f;
    }
  }
  if (y != nullptr) {
    const C* yrow = y + yr.Offset(row);
    X* out = xp + row * d;
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int c = (lane + 32 * j) * 8;
      if (c < d) {
        float yv[8], bv[8];
        Load8(yrow + c, yv);
        Load8(b + c, bv);
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const float t = Round<C>(yv[k] + Round<C>(bv[k]));
          v[j][k] = Round<X>(v[j][k] + Round<X>(t));
        }
        Store8(out + c, v[j]);
      }
    }
  }
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < J; ++j) {
#pragma unroll
    for (int k = 0; k < 8; ++k) s += v[j][k];
  }
  const float mean = WarpSum(s) / static_cast<float>(d);
  float q = 0.f;
#pragma unroll
  for (int j = 0; j < J; ++j) {
    if ((lane + 32 * j) * 8 < d) {
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const float dv = v[j][k] - mean;
        q += dv * dv;
      }
    }
  }
  const float var = WarpSum(q) / static_cast<float>(d);
  const float rstd = 1.f / sqrtf(var + eps);
  C* hrow = h + row * d;
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int c = (lane + 32 * j) * 8;
    if (c < d) {
      float g[8], be[8], o[8];
      Load8(gamma + c, g);
      Load8(beta + c, be);
#pragma unroll
      for (int k = 0; k < 8; ++k) o[k] = (v[j][k] - mean) * rstd * g[k] + be[k];
      Store8(hrow + c, o);
    }
  }
  if (lane == 0) {
    mean_out[row] = mean;
    rstd_out[row] = rstd;
  }
}

// The rows' count of groups of ts_ln_cast_bwd: one partial row a block.
inline int LnBwdGroups(long long rows) {
  const long long blocks = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  return static_cast<int>(blocks < kLnBwdMaxBlocks ? blocks
                                                   : kLnBwdMaxBlocks);
}

// partial: [Q][groups][d] f32, Q = 2 (dgamma, dbeta) or 3 (and db). A
// row is read twice: once for the two row sums, then again (from L1) for
// dx, so that a lane keeps only its column sums across rows.
template <typename X, typename C, int J>
__global__ void __launch_bounds__(kRowsPerBlock * 32, 2)
    LnCastBwd(const C* __restrict__ dh, Rows dhr, const X* __restrict__ dres,
              Rows dresr, const X* __restrict__ xp, Rows xpr,
              const float* __restrict__ mean_in,
              const float* __restrict__ rstd_in,
              const float* __restrict__ gamma, X* __restrict__ dx,
              float* __restrict__ partial, int with_bias, long long rows,
              int d) {
  __shared__ float red[kRowsPerBlock * 32 * 8 * kMaxGroups];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int groups = gridDim.x;
  float ag[J][8], ab[J][8], ad[J][8];
#pragma unroll
  for (int j = 0; j < J; ++j) {
#pragma unroll
    for (int k = 0; k < 8; ++k) ag[j][k] = ab[j][k] = ad[j][k] = 0.f;
  }
  const float inv_d = 1.f / static_cast<float>(d);
  for (long long row = static_cast<long long>(blockIdx.x) * kRowsPerBlock +
                       warp;
       row < rows; row += static_cast<long long>(groups) * kRowsPerBlock) {
    const float mean = mean_in[row], rstd = rstd_in[row];
    const C* dhrow = dh + dhr.Offset(row);
    const X* xrow = xp + xpr.Offset(row);
    float sg = 0.f, sgx = 0.f;
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int c = (lane + 32 * j) * 8;
      if (c < d) {
        float g[8], xh[8], gm[8];
        Load8(dhrow + c, g);
        Load8(xrow + c, xh);
        Load8(gamma + c, gm);
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const float xn = (xh[k] - mean) * rstd;
          ag[j][k] += g[k] * xn;
          ab[j][k] += g[k];
          const float gg = g[k] * gm[k];
          sg += gg;
          sgx += gg * xn;
        }
      }
    }
    const float mg = WarpSum(sg) * inv_d, mgx = WarpSum(sgx) * inv_d;
    const X* rrow = dres != nullptr ? dres + dresr.Offset(row) : nullptr;
    X* out = dx + row * d;
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int c = (lane + 32 * j) * 8;
      if (c < d) {
        float g[8], xh[8], gm[8], o[8];
        Load8(dhrow + c, g);
        Load8(xrow + c, xh);
        Load8(gamma + c, gm);
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const float xn = (xh[k] - mean) * rstd;
          o[k] = Round<X>(rstd * (g[k] * gm[k] - mg - xn * mgx));
        }
        if (rrow != nullptr) {
          float r[8];
          Load8(rrow + c, r);
#pragma unroll
          for (int k = 0; k < 8; ++k) o[k] = Round<X>(r[k] + o[k]);
        }
        if (with_bias) {
#pragma unroll
          for (int k = 0; k < 8; ++k) ad[j][k] += Round<C>(o[k]);
        }
        Store8(out + c, o);
      }
    }
  }
  // The block's warps in warp order, one sum at a time.
  const int nq = with_bias ? 3 : 2;
  for (int qi = 0; qi < nq; ++qi) {
    __syncthreads();
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int c = (lane + 32 * j) * 8;
      if (c < d) {
#pragma unroll
        for (int k = 0; k < 8; ++k)
          red[warp * d + c + k] = qi == 0 ? ag[j][k]
                                  : qi == 1 ? ab[j][k] : ad[j][k];
      }
    }
    __syncthreads();
    float* dst = partial + (static_cast<long long>(qi) * groups + blockIdx.x) *
                               static_cast<long long>(d);
    for (int c = threadIdx.x; c < d; c += blockDim.x) {
      float acc = 0.f;
      for (int w = 0; w < kRowsPerBlock; ++w) acc += red[w * d + c];
      dst[c] = acc;
    }
  }
}

// out_q[c] = the sum over g of partial[q][g][c], in a fixed order; the
// last of the nq sums rounded to C where round_last (db). A block takes 32
// columns of one q: warp w sums the groups w, w + 8, w + 16, ... of its
// lane's column in order (a warp reads 128 contiguous bytes a group, and
// the unrolled loop keeps eight loads in flight), then warp 0 adds the 8
// warps' sums in warp order.
template <typename C>
__global__ void __launch_bounds__(kSumThreads)
    ColumnSums(const float* __restrict__ partial, int groups, int cols,
               int nq, float* __restrict__ out0, float* __restrict__ out1,
               float* __restrict__ out2, int round_last) {
  __shared__ float red[kSumWarps][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int chunks = (cols + 31) / 32;
  const int qi = blockIdx.x / chunks;
  const int c = (blockIdx.x % chunks) * 32 + lane;
  float acc = 0.f;
  if (c < cols) {
    const float* src =
        partial + static_cast<long long>(qi) * groups * cols + c;
#pragma unroll 8
    for (int g = warp; g < groups; g += kSumWarps)
      acc += src[static_cast<long long>(g) * cols];
  }
  red[warp][lane] = acc;
  __syncthreads();
  if (warp != 0 || c >= cols) return;
  float sum = 0.f;
#pragma unroll
  for (int w = 0; w < kSumWarps; ++w) sum += red[w][lane];
  if (round_last && qi == nq - 1) sum = Round<C>(sum);
  float* out = qi == 0 ? out0 : qi == 1 ? out1 : out2;
  out[c] = sum;
}

// ATen's tanh GELU (aten/src/ATen/native/cuda/ActivationGeluKernel.cu) in
// f32.
constexpr float kBeta = 0.7978845608028654f;  // M_SQRT2 * M_2_SQRTPI / 2
constexpr float kKappa = 0.044715f;

__device__ __forceinline__ float Gelu(float u) {
  const float cube = u * u * u;
  const float inner = kBeta * (u + kKappa * cube);
  return 0.5f * u * (1.f + tanhf(inner));
}

__device__ __forceinline__ float GeluGrad(float u) {
  const float sq = u * u;
  const float cube = sq * u;
  const float inner = kBeta * (u + kKappa * cube);
  const float th = tanhf(inner);
  const float left = 0.5f * u;
  const float right = 1.f + th;
  const float left_derivative = 0.5f * right;
  const float tanh_derivative = 1.f - th * th;
  const float inner_derivative = kBeta * (1.f + 3.f * kKappa * sq);
  const float right_derivative = left * tanh_derivative * inner_derivative;
  return left_derivative + right_derivative;
}

template <typename C>
__global__ void __launch_bounds__(256)
    BiasGelu(const C* __restrict__ y, const float* __restrict__ b,
             C* __restrict__ g, long long vecs, int vecs_a_row) {
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < vecs; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int c = static_cast<int>(i % vecs_a_row) * 8;
    float yv[8], bv[8], o[8];
    Load8(y + i * 8, yv);
    Load8(b + c, bv);
#pragma unroll
    for (int k = 0; k < 8; ++k)
      o[k] = Gelu(Round<C>(yv[k] + Round<C>(bv[k])));
    Store8(g + i * 8, o);
  }
}

inline int GeluBwdGroups(long long rows) {
  return static_cast<int>(rows < kGeluBwdMaxGroups ? rows
                                                   : kGeluBwdMaxGroups);
}

// grid (slabs, groups); partial [groups][n].
template <typename C>
__global__ void __launch_bounds__(kGeluThreads)
    BiasGeluBwd(const C* __restrict__ dg, const C* __restrict__ y,
                const float* __restrict__ b, C* __restrict__ dy,
                float* __restrict__ partial, long long rows, int n) {
  const int c = (blockIdx.x * kGeluThreads + threadIdx.x) * 8;
  if (c >= n) return;
  float bv[8], acc[8];
  Load8(b + c, bv);
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    bv[k] = Round<C>(bv[k]);
    acc[k] = 0.f;
  }
  for (long long row = blockIdx.y; row < rows; row += gridDim.y) {
    const long long at = row * n + c;
    float gv[8], yv[8], o[8];
    Load8(dg + at, gv);
    Load8(y + at, yv);
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      o[k] = Round<C>(gv[k] * GeluGrad(Round<C>(yv[k] + bv[k])));
      acc[k] += o[k];
    }
    Store8(dy + at, o);
  }
  float* dst = partial + static_cast<long long>(blockIdx.y) * n + c;
  Store8(dst, acc);
}

inline Rows ReadRows(const long long* r) { return Rows{r[0], r[1], r[2], r[3], r[4]}; }

inline int Groups(int d) { return (d / 8 + 31) / 32; }

template <typename X, typename C, int J>
void LaunchLn(const void* x, Rows xr, const void* y, Rows yr, const void* b,
              const void* gamma, const void* beta, void* xp, void* h,
              void* mean, void* rstd, long long rows, int d, float eps,
              cudaStream_t stream) {
  const long long blocks = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  LnCast<X, C, J><<<static_cast<unsigned>(blocks), kRowsPerBlock * 32, 0,
                    stream>>>(
      static_cast<const X*>(x), xr, static_cast<const C*>(y), yr,
      static_cast<const float*>(b), static_cast<const float*>(gamma),
      static_cast<const float*>(beta), static_cast<X*>(xp),
      static_cast<C*>(h), static_cast<float*>(mean),
      static_cast<float*>(rstd), rows, d, eps);
}

template <typename X, typename C>
void LnByGroups(int groups, const void* x, Rows xr, const void* y, Rows yr,
                const void* b, const void* gamma, const void* beta, void* xp,
                void* h, void* mean, void* rstd, long long rows, int d,
                float eps, cudaStream_t stream) {
  switch (groups) {
    case 1: LaunchLn<X, C, 1>(x, xr, y, yr, b, gamma, beta, xp, h, mean, rstd, rows, d, eps, stream); break;
    case 2: LaunchLn<X, C, 2>(x, xr, y, yr, b, gamma, beta, xp, h, mean, rstd, rows, d, eps, stream); break;
    case 3: LaunchLn<X, C, 3>(x, xr, y, yr, b, gamma, beta, xp, h, mean, rstd, rows, d, eps, stream); break;
    default: LaunchLn<X, C, 4>(x, xr, y, yr, b, gamma, beta, xp, h, mean, rstd, rows, d, eps, stream); break;
  }
}

template <typename X, typename C, int J>
cudaError_t LaunchLnBwd(const void* dh, Rows dhr, const void* dres,
                        Rows dresr, const void* xp, Rows xpr,
                        const void* mean, const void* rstd, const void* gamma,
                        void* dx, void* partial, int with_bias,
                        long long rows, int d, cudaStream_t stream) {
  LnCastBwd<X, C, J><<<LnBwdGroups(rows), kRowsPerBlock * 32, 0, stream>>>(
      static_cast<const C*>(dh), dhr, static_cast<const X*>(dres), dresr,
      static_cast<const X*>(xp), xpr, static_cast<const float*>(mean),
      static_cast<const float*>(rstd), static_cast<const float*>(gamma),
      static_cast<X*>(dx), static_cast<float*>(partial), with_bias, rows, d);
  return cudaSuccess;
}

template <typename X, typename C>
cudaError_t LnBwdByGroups(int groups, const void* dh, Rows dhr,
                          const void* dres, Rows dresr, const void* xp,
                          Rows xpr, const void* mean, const void* rstd,
                          const void* gamma, void* dx, void* partial,
                          int with_bias, long long rows, int d,
                          cudaStream_t stream) {
  switch (groups) {
    case 1: return LaunchLnBwd<X, C, 1>(dh, dhr, dres, dresr, xp, xpr, mean, rstd, gamma, dx, partial, with_bias, rows, d, stream);
    case 2: return LaunchLnBwd<X, C, 2>(dh, dhr, dres, dresr, xp, xpr, mean, rstd, gamma, dx, partial, with_bias, rows, d, stream);
    case 3: return LaunchLnBwd<X, C, 3>(dh, dhr, dres, dresr, xp, xpr, mean, rstd, gamma, dx, partial, with_bias, rows, d, stream);
    default: return LaunchLnBwd<X, C, 4>(dh, dhr, dres, dresr, xp, xpr, mean, rstd, gamma, dx, partial, with_bias, rows, d, stream);
  }
}

template <typename C>
void LaunchSums(const void* partial, int groups, int cols, int nq, void* out0,
                void* out1, void* out2, int round_last, cudaStream_t stream) {
  ColumnSums<C><<<nq * ((cols + 31) / 32), kSumThreads, 0, stream>>>(
      static_cast<const float*>(partial), groups, cols, nq,
      static_cast<float*>(out0), static_cast<float*>(out1),
      static_cast<float*>(out2), round_last);
}

bool Valid(int d, int x_dtype, int c_dtype) {
  return d > 0 && d % 8 == 0 && Groups(d) <= kMaxGroups &&
         (x_dtype == 0 || x_dtype == 1) && (c_dtype == 0 || c_dtype == 1);
}

}  // namespace

// Partial rows the backward kernels write (the wrapper allocates them):
// ts_ln_cast_bwd [3][groups][d] f32, ts_bias_gelu_bwd [groups][n] f32.
extern "C" int ts_ln_cast_bwd_groups(long long rows) {
  return LnBwdGroups(rows);
}

extern "C" int ts_bias_gelu_bwd_groups(long long rows) {
  return GeluBwdGroups(rows);
}

// x: [rows, d] of x_dtype at the strides x_rows = (n1, n2, s0, s1, s2);
// y (c_dtype, y_rows), b (f32 [d]) and xp (x_dtype, contiguous) all null
// or all given; gamma, beta f32 [d]; h (c_dtype), mean, rstd (f32 [rows])
// contiguous.
extern "C" int ts_ln_cast(const void* x, const long long* x_rows, int x_dtype,
                          const void* y, const long long* y_rows,
                          const void* b, const void* gamma, const void* beta,
                          void* xp, void* h, int c_dtype, void* mean,
                          void* rstd, long long rows, int d, float eps,
                          void* stream) {
  if (!Valid(d, x_dtype, c_dtype) || rows <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Rows xr = ReadRows(x_rows);
  const Rows yr = y != nullptr ? ReadRows(y_rows) : Rows{1, 1, 0, 0, 0};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int j = Groups(d);
  if (x_dtype == 0 && c_dtype == 0)
    LnByGroups<__nv_bfloat16, __nv_bfloat16>(j, x, xr, y, yr, b, gamma, beta, xp, h, mean, rstd, rows, d, eps, s);
  else if (x_dtype == 1 && c_dtype == 0)
    LnByGroups<float, __nv_bfloat16>(j, x, xr, y, yr, b, gamma, beta, xp, h, mean, rstd, rows, d, eps, s);
  else if (x_dtype == 0 && c_dtype == 1)
    LnByGroups<__nv_bfloat16, float>(j, x, xr, y, yr, b, gamma, beta, xp, h, mean, rstd, rows, d, eps, s);
  else
    LnByGroups<float, float>(j, x, xr, y, yr, b, gamma, beta, xp, h, mean, rstd, rows, d, eps, s);
  return static_cast<int>(cudaGetLastError());
}

// dh (c_dtype), dres (x_dtype, or null) and xp (x_dtype) at their strides;
// mean, rstd f32 [rows]; gamma f32 [d]; dx (x_dtype) contiguous; partial
// f32 [3][ts_ln_cast_bwd_groups(rows)][d]; dgamma, dbeta and, with_bias,
// db f32 [d].
extern "C" int ts_ln_cast_bwd(const void* dh, const long long* dh_rows,
                              const void* dres, const long long* dres_rows,
                              const void* xp, const long long* xp_rows,
                              int x_dtype, int c_dtype, const void* mean,
                              const void* rstd, const void* gamma, void* dx,
                              void* partial, void* dgamma, void* dbeta,
                              void* db, int with_bias, long long rows, int d,
                              void* stream) {
  if (!Valid(d, x_dtype, c_dtype) || rows <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Rows dhr = ReadRows(dh_rows), xpr = ReadRows(xp_rows);
  const Rows rr = dres != nullptr ? ReadRows(dres_rows) : Rows{1, 1, 0, 0, 0};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int j = Groups(d);
  cudaError_t err;
  if (x_dtype == 0 && c_dtype == 0)
    err = LnBwdByGroups<__nv_bfloat16, __nv_bfloat16>(j, dh, dhr, dres, rr, xp, xpr, mean, rstd, gamma, dx, partial, with_bias, rows, d, s);
  else if (x_dtype == 1 && c_dtype == 0)
    err = LnBwdByGroups<float, __nv_bfloat16>(j, dh, dhr, dres, rr, xp, xpr, mean, rstd, gamma, dx, partial, with_bias, rows, d, s);
  else if (x_dtype == 0 && c_dtype == 1)
    err = LnBwdByGroups<__nv_bfloat16, float>(j, dh, dhr, dres, rr, xp, xpr, mean, rstd, gamma, dx, partial, with_bias, rows, d, s);
  else
    err = LnBwdByGroups<float, float>(j, dh, dhr, dres, rr, xp, xpr, mean, rstd, gamma, dx, partial, with_bias, rows, d, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int groups = LnBwdGroups(rows), nq = with_bias ? 3 : 2;
  if (c_dtype == 0)
    LaunchSums<__nv_bfloat16>(partial, groups, d, nq, dgamma, dbeta, db, with_bias, s);
  else
    LaunchSums<float>(partial, groups, d, nq, dgamma, dbeta, db, with_bias, s);
  return static_cast<int>(cudaGetLastError());
}

// y, g (c_dtype) contiguous [rows, n], b f32 [n], n % 8 == 0.
extern "C" int ts_bias_gelu(const void* y, const void* b, void* g,
                            int c_dtype, long long rows, int n,
                            void* stream) {
  if (n <= 0 || n % 8 || rows <= 0 || (c_dtype != 0 && c_dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long vecs = rows * (n / 8);
  long long blocks = (vecs + 255) / 256;
  if (blocks > 132 * 16) blocks = 132 * 16;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (c_dtype == 0)
    BiasGelu<__nv_bfloat16><<<static_cast<unsigned>(blocks), 256, 0, s>>>(
        static_cast<const __nv_bfloat16*>(y), static_cast<const float*>(b),
        static_cast<__nv_bfloat16*>(g), vecs, n / 8);
  else
    BiasGelu<float><<<static_cast<unsigned>(blocks), 256, 0, s>>>(
        static_cast<const float*>(y), static_cast<const float*>(b),
        static_cast<float*>(g), vecs, n / 8);
  return static_cast<int>(cudaGetLastError());
}

// dg, y, dy (c_dtype) contiguous [rows, n]; b, db f32 [n]; partial f32
// [ts_bias_gelu_bwd_groups(rows)][n].
extern "C" int ts_bias_gelu_bwd(const void* dg, const void* y, const void* b,
                                void* dy, void* partial, void* db,
                                int c_dtype, long long rows, int n,
                                void* stream) {
  if (n <= 0 || n % 8 || rows <= 0 || (c_dtype != 0 && c_dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const int groups = GeluBwdGroups(rows);
  const dim3 grid((n + kGeluSlab - 1) / kGeluSlab, groups);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (c_dtype == 0)
    BiasGeluBwd<__nv_bfloat16><<<grid, kGeluThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(dg),
        static_cast<const __nv_bfloat16*>(y), static_cast<const float*>(b),
        static_cast<__nv_bfloat16*>(dy), static_cast<float*>(partial), rows,
        n);
  else
    BiasGeluBwd<float><<<grid, kGeluThreads, 0, s>>>(
        static_cast<const float*>(dg), static_cast<const float*>(y),
        static_cast<const float*>(b), static_cast<float*>(dy),
        static_cast<float*>(partial), rows, n);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (c_dtype == 0)
    LaunchSums<__nv_bfloat16>(partial, groups, n, 1, db, nullptr, nullptr, 1, s);
  else
    LaunchSums<float>(partial, groups, n, 1, db, nullptr, nullptr, 1, s);
  return static_cast<int>(cudaGetLastError());
}
