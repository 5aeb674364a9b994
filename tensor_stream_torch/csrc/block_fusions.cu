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
// factorized ViT-B step's 6,272 rows, D = 768, bf16 (a device copy of as
// many bytes read and written takes about twice these under chip_smoke's
// held timer, which finds L2 full of dirty lines):
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
// Design, memory-bound: where a warp has more than one row, a persistent
// grid whose rows arrive by 1-D bulk copies (cp.async.bulk, csrc/sm90.cuh)
// into rings in shared memory, so the next rows' loads are in flight while
// a row is reduced and stored.
// - ts_ln_cast: two plans, routed by the row count (LnFwdRing, mirrored by
//   ops/block_fusions.py::ln_fwd_plan). The ring (LnCast): blocks of 8
//   warps, kFwdBlocksPerSm an SM; each warp owns a ring of `stages` slots
//   (x's row and, with y, y's row) and takes rows w, w + W, w + 2W, ...
//   (W warps in the grid); its lane 0 fills a slot by bulk copy on the
//   slot's mbarrier and refills it with the warp's row `stages` further on
//   as soon as the row's values are in registers; gamma, beta and b are
//   read into shared memory once a block. Where each warp of that grid
//   would have one row or none, the wave plan (LnCastWave: a warp a row,
//   every row's loads in flight at once, the parameters through L1) is
//   faster, and runs instead. In both a lane holds J groups of 8
//   consecutive values (group lane + 32 j, J = ceil(D / 256)); the row's
//   sum and its sum of squared deviations are warp butterflies (every lane
//   ends with the same bits), so the statistics never leave registers:
//   mean = sum / D, then var = sum((v - mean)^2) / D (two passes over the
//   registers, not flax's E[x^2] - E[x]^2), rstd = 1 / sqrt(var + eps),
//   each an IEEE operation. x and y are read at their strides (up to three
//   leading dims: the temporal sublayer hands y in as a transposed view;
//   each row is contiguous and 16-byte aligned, as a bulk copy needs); x'
//   and h are written contiguous with 16-byte stores; each row's mean and
//   rstd (f32) are kept for the backward.
// - ts_ln_cast_bwd (LnCastBwd): blocks of 8 warps, at most
//   kBwdBlocksPerSm an SM, block g taking the rows [g R / G, (g + 1) R /
//   G) (R rows, G blocks) in tiles of 8 consecutive rows, in a ring of
//   `stages` tile slots (dh, x' and, with the residual, dres) that lane 0
//   of warp w fills with row w of a tile by bulk copy. For each tile, warp
//   w takes the tile's row w: with xhat =
//   (x' - mean) rstd and dh in f32, dxf = rstd (dh gamma - mean(dh gamma)
//   - xhat mean(dh gamma xhat)) (the two means are warp butterflies),
//   dx = X(dres + X(dxf)) (the residual stream's gradient, when given,
//   added after the rounding, as autograd accumulates), stored to global
//   memory and, with the bias, over dres in the slot. Then the block's
//   threads sum the tile's columns from the same slot: thread t owns the 8
//   columns 8 (t mod D/8) and the tile's rows r = t div (D/8) + k S (S =
//   256 div (D/8) subsets), summing dh xhat, dh and the bias's share C(dx)
//   over them in order; a thread keeps 24 sums, not a row's worth. At the
//   end the subsets are added in subset order into one partial row a
//   block, and ColumnSums adds the blocks' partial rows in a fixed order
//   (eight strided runs of blocks, then the eight runs in turn). No float
//   atomics and no work-stealing: the same inputs on the same card give
//   the same bytes, so a graphed training step equals the eager one bit
//   for bit. db is rounded to C once summed, as the compute-dtype sum of
//   the bias add's gradient is. ops/block_fusions.py::ln_bwd_plan mirrors
//   the rows' assignment.
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

#include <type_traits>

#include "sm90.cuh"

namespace {

constexpr int kWarps = 8;            // ts_ln_cast(_bwd): warps a block
constexpr int kLnThreads = kWarps * 32;
constexpr int kMaxGroups = 4;        // J: D <= 32 lanes x 8 x 4 = 1024
constexpr int kMaxStages = 4;        // ring slots: a warp's (fwd), a block's (bwd)
constexpr int kBarBytes = kWarps * kMaxStages * 8;  // the rings' mbarriers
constexpr int kTile = kWarps;        // ts_ln_cast_bwd: rows a tile, one a warp
// The blocks an SM each kernel's grid is sized for, and the shared memory
// a block's ring may take, so that they fit an SM together at bf16 and
// D 768 (3 forward blocks of 57 KB with the residual, 2 backward ones of
// 83 KB); wider f32 rows take fewer blocks an SM.
constexpr int kFwdBlocksPerSm = 3;
constexpr int kBwdBlocksPerSm = 2;
constexpr int kFwdRingBudget = 72 * 1024;
constexpr int kBwdRingBudget = 104 * 1024;
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
// strides s0, s1, s2 in elements) over a contiguous last dim. Row indices
// and sizes fit 32 bits (Valid), so the divisions are 32-bit ones, and
// none is taken for a row of the first n2 (a contiguous tensor's every
// row).
struct Rows {
  long long n1, n2, s0, s1, s2;
  __device__ __forceinline__ long long Offset(long long r) const {
    const unsigned ur = static_cast<unsigned>(r);
    const unsigned un2 = static_cast<unsigned>(n2);
    if (ur < un2) return static_cast<long long>(ur) * s2;
    const unsigned q = ur / un2, un1 = static_cast<unsigned>(n1);
    return static_cast<long long>(q / un1) * s0 +
           static_cast<long long>(q % un1) * s1 +
           static_cast<long long>(ur - q * un2) * s2;
  }
};

__device__ __forceinline__ float WarpSum(float s) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  return s;
}

using sm90::SmCount;

// Ring slots that fit `budget` next to `fixed` bytes, 2 to kMaxStages.
inline int Stages(int budget, int fixed, int slot_bytes, int slots_a_stage) {
  const int s = (budget - fixed) / (slot_bytes * slots_a_stage);
  return s < 2 ? 2 : s > kMaxStages ? kMaxStages : s;
}

// ---------------------------------------------------------- ts_ln_cast

// Shared memory: the rings' mbarriers, gamma, beta (and b with y) f32 [d],
// then each warp's ring of `stages` slots of x's row (and y's).
struct FwdLayout {
  int params, row_x, row_bytes, stages, bytes;
  FwdLayout(int d, int x_size, int c_size, bool with_y) {
    params = (with_y ? 3 : 2) * d * 4;
    row_x = d * x_size;
    row_bytes = row_x + (with_y ? d * c_size : 0);
    stages = Stages(kFwdRingBudget, kBarBytes + params, row_bytes, kWarps);
    bytes = kBarBytes + params + kWarps * stages * row_bytes;
  }
};

template <typename X, typename C>
__device__ __forceinline__ void FetchRow(uint32_t slot, uint32_t bar,
                                         const X* x, Rows xr, const C* y,
                                         Rows yr, long long row, int d) {
  const uint32_t xb = d * sizeof(X), yb = y != nullptr ? d * sizeof(C) : 0;
  sm90::MbarExpectTx(bar, xb + yb);
  sm90::BulkLoad(slot, x + xr.Offset(row), xb, bar);
  if (y != nullptr) sm90::BulkLoad(slot + xb, y + yr.Offset(row), yb, bar);
}

// A lane's J groups of 8 values of a row (0 past d), as f32.
template <typename T, int J>
__device__ __forceinline__ void LoadRow(const T* row, int lane, int d,
                                        float v[J][8]) {
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int c = (lane + 32 * j) * 8;
    if (c < d) {
      Load8(row + c, v[j]);
    } else {
#pragma unroll
      for (int k = 0; k < 8; ++k) v[j][k] = 0.f;
    }
  }
}

// v = x' = X(x + X(C(y + C(b)))) over a lane's groups, x in v, y read
// from `yrow` (shared or global memory). Where X is C, X(t) of the
// C-rounded t is t itself and is not taken again.
template <typename X, typename C, int J>
__device__ __forceinline__ void AddBiasResidual(float v[J][8],
                                                const C* yrow,
                                                const float* bias, int lane,
                                                int d) {
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int c = (lane + 32 * j) * 8;
    if (c < d) {
      float yv[8], bv[8];
      Load8(yrow + c, yv);
      Load8(bias + c, bv);
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const float t = Round<C>(yv[k] + Round<C>(bv[k]));
        v[j][k] = Round<X>(v[j][k] + (std::is_same<X, C>::value ? t
                                                                : Round<X>(t)));
      }
    }
  }
}

// The row's mean: the lanes' sums in group order, a warp butterfly.
template <int J>
__device__ __forceinline__ float RowMean(const float v[J][8], int d) {
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < J; ++j) {
#pragma unroll
    for (int k = 0; k < 8; ++k) s += v[j][k];
  }
  return WarpSum(s) / static_cast<float>(d);
}

// The rest of a row once its mean is known: x' stored (with y), the
// variance's second pass, h = (v - mean) rstd gamma + beta, the
// statistics.
template <typename X, typename C, int J>
__device__ __forceinline__ void FinishRow(const float v[J][8], float mean,
                                          long long row, int lane, int d,
                                          float eps, const float* gs,
                                          const float* bs, X* xp, C* h,
                                          float* mean_out, float* rstd_out) {
  if (xp != nullptr) {
    X* out = xp + row * d;
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int c = (lane + 32 * j) * 8;
      if (c < d) Store8(out + c, v[j]);
    }
  }
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
      Load8(gs + c, g);
      Load8(bs + c, be);
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

// gamma, beta (and b with y) into shared memory, once a block.
__device__ __forceinline__ void LoadParams(float* gs, const float* gamma,
                                           const float* beta, const float* b,
                                           int d) {
  float* bs = gs + d;
  float* ys_bias = bs + d;
  for (int c = threadIdx.x * 4; c < d; c += blockDim.x * 4) {
    *reinterpret_cast<float4*>(gs + c) =
        *reinterpret_cast<const float4*>(gamma + c);
    *reinterpret_cast<float4*>(bs + c) =
        *reinterpret_cast<const float4*>(beta + c);
    if (b != nullptr)
      *reinterpret_cast<float4*>(ys_bias + c) =
          *reinterpret_cast<const float4*>(b + c);
  }
}

template <typename X, typename C, int J>
__global__ void __launch_bounds__(kLnThreads, kFwdBlocksPerSm)
    LnCast(const X* __restrict__ x, Rows xr, const C* __restrict__ y,
           Rows yr, const float* __restrict__ b,
           const float* __restrict__ gamma, const float* __restrict__ beta,
           X* __restrict__ xp, C* __restrict__ h, float* __restrict__ mean_out,
           float* __restrict__ rstd_out, long long rows, int d, float eps,
           int stages) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const bool with_y = y != nullptr;
  float* gs = reinterpret_cast<float*>(smem + kBarBytes);
  const int row_x = d * sizeof(X);
  const int row_bytes = row_x + (with_y ? d * static_cast<int>(sizeof(C)) : 0);
  unsigned char* ring = smem + kBarBytes + (with_y ? 3 : 2) * d * 4 +
                        warp * stages * row_bytes;
  const uint32_t bar0 = sm90::SmemAddr(smem) + warp * kMaxStages * 8;
  const uint32_t ring0 = sm90::SmemAddr(ring);
  const long long step = static_cast<long long>(gridDim.x) * kWarps;
  const long long first = static_cast<long long>(blockIdx.x) * kWarps + warp;
  if (lane == 0) {
    for (int s = 0; s < stages; ++s) sm90::MbarInit(bar0 + 8 * s, 1);
    sm90::FenceBarrierInit();
    for (int s = 0; s < stages; ++s) {
      const long long row = first + s * step;
      if (row < rows)
        FetchRow(ring0 + s * row_bytes, bar0 + 8 * s, x, xr, y, yr, row, d);
    }
  }
  LoadParams(gs, gamma, beta, with_y ? b : nullptr, d);  // while rows arrive
  __syncthreads();
  int slot = 0;
  uint32_t phase = 0;
  for (long long row = first; row < rows; row += step) {
    sm90::MbarWait(bar0 + 8 * slot, phase);
    const unsigned char* at = ring + slot * row_bytes;
    float v[J][8];
    LoadRow<X, J>(reinterpret_cast<const X*>(at), lane, d, v);
    if (with_y)
      AddBiasResidual<X, C, J>(v, reinterpret_cast<const C*>(at + row_x),
                               gs + 2 * d, lane, d);
    // Every lane's reads of the slot are in its sum: refill the slot.
    const float mean = RowMean<J>(v, d);
    if (lane == 0 && row + stages * step < rows)
      FetchRow(ring0 + slot * row_bytes, bar0 + 8 * slot, x, xr, y, yr,
               row + stages * step, d);
    if (++slot == stages) {
      slot = 0;
      phase ^= 1;
    }
    FinishRow<X, C, J>(v, mean, row, lane, d, eps, gs, gs + d,
                       with_y ? xp : nullptr, h, mean_out, rstd_out);
  }
}

// The plan of ts_ln_cast for `rows`: the ring where a warp of its grid
// streams more than one row, else the wave plan (LnCastWave), which has
// every row's loads in flight at once and more warps an SM to reduce them
// (tools/ln_variants.py times both plans on both sides of the line).
// ops/block_fusions.py::ln_fwd_plan mirrors it.
inline bool LnFwdRing(long long rows) {
  return rows > static_cast<long long>(SmCount()) * kFwdBlocksPerSm * kWarps;
}

// The wave plan of ts_ln_cast (the design before the ring): a warp a row,
// a block 8 rows, the grid one wave over the rows; each lane loads its
// groups of x and y from global memory and gamma, beta and b through L1.
template <typename X, typename C, int J>
__global__ void __launch_bounds__(kLnThreads)
    LnCastWave(const X* __restrict__ x, Rows xr, const C* __restrict__ y,
               Rows yr, const float* __restrict__ b,
               const float* __restrict__ gamma,
               const float* __restrict__ beta, X* __restrict__ xp,
               C* __restrict__ h, float* __restrict__ mean_out,
               float* __restrict__ rstd_out, long long rows, int d,
               float eps) {
  const int lane = threadIdx.x & 31;
  const long long row =
      static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;
  float v[J][8];
  LoadRow<X, J>(x + xr.Offset(row), lane, d, v);
  if (y != nullptr) AddBiasResidual<X, C, J>(v, y + yr.Offset(row), b, lane, d);
  const float mean = RowMean<J>(v, d);
  FinishRow<X, C, J>(v, mean, row, lane, d, eps, gamma, beta,
                     y != nullptr ? xp : nullptr, h, mean_out, rstd_out);
}

// ------------------------------------------------------ ts_ln_cast_bwd

// The backward's blocks: one a tile up to kBwdBlocksPerSm an SM.
inline int LnBwdBlocks(long long rows) {
  const long long cap = static_cast<long long>(SmCount()) * kBwdBlocksPerSm;
  const long long tiles = (rows + kTile - 1) / kTile;
  return static_cast<int>(tiles < cap ? tiles : cap);
}

// Shared memory: the ring's mbarriers, gamma f32 [d], the tile's mean and
// rstd, the subsets' sums [256 / (d/8)][d] f32 (at most 8 KB), then
// `stages` tile slots of dh [8][d] (C), x' [8][d] (X) and, with dres or
// the bias, rd [8][d] (X: dres in, dx over it).
struct BwdLayout {
  int dh, xp, rd, tile, red, fixed, stages, bytes;
  BwdLayout(int d, int x_size, int c_size, bool with_rd) {
    dh = kTile * d * c_size;
    xp = kTile * d * x_size;
    rd = with_rd ? xp : 0;
    tile = dh + xp + rd;
    red = kLnThreads * 8 * 4;
    fixed = kBarBytes + d * 4 + kTile * 8 + red;
    stages = Stages(kBwdRingBudget, fixed, tile, 1);
    bytes = fixed + stages * tile;
  }
};

// partial: [Q][gridDim.x][d] f32, Q = 2 (dgamma, dbeta) or 3 (and db).
template <typename X, typename C, int J>
__global__ void __launch_bounds__(kLnThreads, J <= 3 ? kBwdBlocksPerSm : 1)
    LnCastBwd(const C* __restrict__ dh, Rows dhr, const X* __restrict__ dres,
              Rows dresr, const X* __restrict__ xp, Rows xpr,
              const float* __restrict__ mean_in,
              const float* __restrict__ rstd_in,
              const float* __restrict__ gamma, X* __restrict__ dx,
              float* __restrict__ partial, int with_bias, long long rows,
              int d, int stages) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const bool with_rd = dres != nullptr || with_bias;
  float* gs = reinterpret_cast<float*>(smem + kBarBytes);
  float* stats = gs + d;                 // [kTile][2]: mean, rstd
  float* red = stats + 2 * kTile;        // [subsets][d]
  const int dh_bytes = kTile * d * static_cast<int>(sizeof(C));
  const int xp_bytes = kTile * d * static_cast<int>(sizeof(X));
  const int tile_bytes = dh_bytes + xp_bytes + (with_rd ? xp_bytes : 0);
  unsigned char* ring = reinterpret_cast<unsigned char*>(red) +
                        kLnThreads * 8 * 4;
  const uint32_t bar0 = sm90::SmemAddr(smem), ring0 = sm90::SmemAddr(ring);
  // This block's rows [r0, r1), tiles of kTile consecutive rows.
  const long long r0 = rows * blockIdx.x / gridDim.x;
  const long long r1 = rows * (blockIdx.x + 1) / gridDim.x;
  const int tiles = static_cast<int>((r1 - r0 + kTile - 1) / kTile);
  // Lane 0 of warp w: row w of tile t into the tile's slot, or a bare
  // arrival past the block's last row (the slot's mbarrier counts 8).
  auto fetch = [&](int t) {
    const int s = t % stages;
    const long long row = r0 + static_cast<long long>(t) * kTile + warp;
    const uint32_t bar = bar0 + 8 * s;
    if (row >= r1) {
      sm90::MbarArrive(bar);
      return;
    }
    const uint32_t slot = ring0 + s * tile_bytes;
    const uint32_t dhb = d * sizeof(C), xb = d * sizeof(X);
    sm90::MbarExpectTx(bar, dhb + xb + (dres != nullptr ? xb : 0));
    sm90::BulkLoad(slot + warp * dhb, dh + dhr.Offset(row), dhb, bar);
    sm90::BulkLoad(slot + dh_bytes + warp * xb, xp + xpr.Offset(row), xb,
                   bar);
    if (dres != nullptr)
      sm90::BulkLoad(slot + dh_bytes + xp_bytes + warp * xb,
                     dres + dresr.Offset(row), xb, bar);
  };
  if (tid == 0) {
    for (int s = 0; s < stages; ++s) sm90::MbarInit(bar0 + 8 * s, kWarps);
    sm90::FenceBarrierInit();
  }
  __syncthreads();
  if (lane == 0) {
    for (int t = 0; t < stages && t < tiles; ++t) fetch(t);
  }
  for (int c = tid * 4; c < d; c += kLnThreads * 4)
    *reinterpret_cast<float4*>(gs + c) =
        *reinterpret_cast<const float4*>(gamma + c);
  // The column phase's owner: 8 columns, one subset of a tile's rows.
  const int chunks = d / 8, subsets = kLnThreads / chunks;
  const int cc = (tid % chunks) * 8, sub = tid / chunks;
  float ag[8], ab[8], ad[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) ag[k] = ab[k] = ad[k] = 0.f;
  const float inv_d = 1.f / static_cast<float>(d);
  __syncthreads();
  for (int t = 0; t < tiles; ++t) {
    const long long a = r0 + static_cast<long long>(t) * kTile;
    const int n = static_cast<int>(r1 - a < kTile ? r1 - a : kTile);
    const int s = t % stages;
    const C* dhs = reinterpret_cast<const C*>(ring + s * tile_bytes);
    const X* xs = reinterpret_cast<const X*>(ring + s * tile_bytes +
                                             dh_bytes);
    X* rs = reinterpret_cast<X*>(ring + s * tile_bytes + dh_bytes + xp_bytes);
    float mean = 0.f, rstd = 0.f;
    if (warp < n) {
      mean = mean_in[a + warp];
      rstd = rstd_in[a + warp];
    }
    sm90::MbarWait(bar0 + 8 * s, (t / stages) & 1);
    // The row phase: warp w, the tile's row w; dh gamma and xhat stay in
    // registers between the two passes.
    if (warp < n) {
      const C* grow = dhs + warp * d;
      const X* xrow = xs + warp * d;
      float gg[J][8], xn[J][8];
      float sg = 0.f, sgx = 0.f;
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const int c = (lane + 32 * j) * 8;
        if (c < d) {
          float g[8], xh[8], gm[8];
          Load8(grow + c, g);
          Load8(xrow + c, xh);
          Load8(gs + c, gm);
#pragma unroll
          for (int k = 0; k < 8; ++k) {
            xn[j][k] = (xh[k] - mean) * rstd;
            gg[j][k] = g[k] * gm[k];
            sg += gg[j][k];
            sgx += gg[j][k] * xn[j][k];
          }
        }
      }
      const float mg = WarpSum(sg) * inv_d, mgx = WarpSum(sgx) * inv_d;
      X* rrow = rs + warp * d;
      X* out = dx + (a + warp) * d;
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const int c = (lane + 32 * j) * 8;
        if (c < d) {
          float o[8];
#pragma unroll
          for (int k = 0; k < 8; ++k)
            o[k] = Round<X>(rstd * (gg[j][k] - mg - xn[j][k] * mgx));
          if (dres != nullptr) {
            float r[8];
            Load8(rrow + c, r);
#pragma unroll
            for (int k = 0; k < 8; ++k) o[k] = Round<X>(r[k] + o[k]);
          }
          Store8(out + c, o);
          if (with_bias) Store8(rrow + c, o);
        }
      }
      if (lane == 0) {
        stats[2 * warp] = mean;
        stats[2 * warp + 1] = rstd;
      }
      // dx over dres in the slot, before the slot's next bulk copy.
      if (with_bias) sm90::FenceProxyAsync();
    }
    __syncthreads();
    // The column phase: this thread's columns over its subset's rows.
    if (sub < subsets) {
      for (int r = sub; r < n; r += subsets) {
        const float m = stats[2 * r], rs_ = stats[2 * r + 1];
        float g[8], xh[8];
        Load8(dhs + r * d + cc, g);
        Load8(xs + r * d + cc, xh);
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const float xn = (xh[k] - m) * rs_;
          ag[k] += g[k] * xn;
          ab[k] += g[k];
        }
        if (with_bias) {
          float o[8];
          Load8(rs + r * d + cc, o);
#pragma unroll
          for (int k = 0; k < 8; ++k)  // C(dx): dx itself where X is C
            ad[k] += std::is_same<X, C>::value ? o[k] : Round<C>(o[k]);
        }
      }
    }
    __syncthreads();
    if (lane == 0 && t + stages < tiles) fetch(t + stages);
  }
  // The subsets in subset order, one sum at a time, into the block's row.
  const int nq = with_bias ? 3 : 2;
  for (int qi = 0; qi < nq; ++qi) {
    if (sub < subsets) {
#pragma unroll
      for (int k = 0; k < 8; ++k)
        red[sub * d + cc + k] = qi == 0 ? ag[k] : qi == 1 ? ab[k] : ad[k];
    }
    __syncthreads();
    float* dst = partial + (static_cast<long long>(qi) * gridDim.x +
                            blockIdx.x) * static_cast<long long>(d);
    for (int c = tid; c < d; c += kLnThreads) {
      float acc = 0.f;
      for (int u = 0; u < subsets; ++u) acc += red[u * d + c];
      dst[c] = acc;
    }
    __syncthreads();
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
cudaError_t LaunchLn(const void* x, Rows xr, const void* y, Rows yr,
                     const void* b, const void* gamma, const void* beta,
                     void* xp, void* h, void* mean, void* rstd,
                     long long rows, int d, float eps, cudaStream_t stream) {
  const long long need = (rows + kWarps - 1) / kWarps;
  if (!LnFwdRing(rows)) {
    LnCastWave<X, C, J><<<static_cast<unsigned>(need), kLnThreads, 0,
                          stream>>>(
        static_cast<const X*>(x), xr, static_cast<const C*>(y), yr,
        static_cast<const float*>(b), static_cast<const float*>(gamma),
        static_cast<const float*>(beta), static_cast<X*>(xp),
        static_cast<C*>(h), static_cast<float*>(mean),
        static_cast<float*>(rstd), rows, d, eps);
    return cudaGetLastError();
  }
  const FwdLayout lay(d, sizeof(X), sizeof(C), y != nullptr);
  const cudaError_t err = cudaFuncSetAttribute(
      LnCast<X, C, J>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      lay.bytes);
  if (err != cudaSuccess) return err;
  const long long cap = static_cast<long long>(SmCount()) * kFwdBlocksPerSm;
  LnCast<X, C, J><<<static_cast<unsigned>(need < cap ? need : cap),
                    kLnThreads, lay.bytes, stream>>>(
      static_cast<const X*>(x), xr, static_cast<const C*>(y), yr,
      static_cast<const float*>(b), static_cast<const float*>(gamma),
      static_cast<const float*>(beta), static_cast<X*>(xp),
      static_cast<C*>(h), static_cast<float*>(mean),
      static_cast<float*>(rstd), rows, d, eps, lay.stages);
  return cudaGetLastError();
}

template <typename X, typename C>
cudaError_t LnByGroups(int groups, const void* x, Rows xr, const void* y,
                       Rows yr, const void* b, const void* gamma,
                       const void* beta, void* xp, void* h, void* mean,
                       void* rstd, long long rows, int d, float eps,
                       cudaStream_t stream) {
  switch (groups) {
    case 1: return LaunchLn<X, C, 1>(x, xr, y, yr, b, gamma, beta, xp, h, mean, rstd, rows, d, eps, stream);
    case 2: return LaunchLn<X, C, 2>(x, xr, y, yr, b, gamma, beta, xp, h, mean, rstd, rows, d, eps, stream);
    case 3: return LaunchLn<X, C, 3>(x, xr, y, yr, b, gamma, beta, xp, h, mean, rstd, rows, d, eps, stream);
    default: return LaunchLn<X, C, 4>(x, xr, y, yr, b, gamma, beta, xp, h, mean, rstd, rows, d, eps, stream);
  }
}

template <typename X, typename C, int J>
cudaError_t LaunchLnBwd(const void* dh, Rows dhr, const void* dres,
                        Rows dresr, const void* xp, Rows xpr,
                        const void* mean, const void* rstd, const void* gamma,
                        void* dx, void* partial, int with_bias,
                        long long rows, int d, cudaStream_t stream) {
  const BwdLayout lay(d, sizeof(X), sizeof(C), dres != nullptr || with_bias);
  const cudaError_t err = cudaFuncSetAttribute(
      LnCastBwd<X, C, J>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      lay.bytes);
  if (err != cudaSuccess) return err;
  LnCastBwd<X, C, J><<<LnBwdBlocks(rows), kLnThreads, lay.bytes, stream>>>(
      static_cast<const C*>(dh), dhr, static_cast<const X*>(dres), dresr,
      static_cast<const X*>(xp), xpr, static_cast<const float*>(mean),
      static_cast<const float*>(rstd), static_cast<const float*>(gamma),
      static_cast<X*>(dx), static_cast<float*>(partial), with_bias, rows, d,
      lay.stages);
  return cudaGetLastError();
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

bool Valid(int d, int x_dtype, int c_dtype, long long rows) {
  return rows > 0 && rows < (1ll << 31) && d > 0 && d % 8 == 0 &&
         Groups(d) <= kMaxGroups &&
         (x_dtype == 0 || x_dtype == 1) && (c_dtype == 0 || c_dtype == 1);
}

}  // namespace

// Partial rows the backward kernels write (the wrapper allocates them):
// ts_ln_cast_bwd [3][groups][d] f32, ts_bias_gelu_bwd [groups][n] f32.
extern "C" int ts_ln_cast_bwd_groups(long long rows) {
  return LnBwdBlocks(rows);
}

// 1 where ts_ln_cast runs `rows` on the ring (LnCast), 0 on the wave plan.
extern "C" int ts_ln_cast_ring(long long rows) { return LnFwdRing(rows); }


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
  if (!Valid(d, x_dtype, c_dtype, rows))
    return static_cast<int>(cudaErrorInvalidValue);
  const Rows xr = ReadRows(x_rows);
  const Rows yr = y != nullptr ? ReadRows(y_rows) : Rows{1, 1, 0, 0, 0};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int j = Groups(d);
  cudaError_t err;
  if (x_dtype == 0 && c_dtype == 0)
    err = LnByGroups<__nv_bfloat16, __nv_bfloat16>(j, x, xr, y, yr, b, gamma, beta, xp, h, mean, rstd, rows, d, eps, s);
  else if (x_dtype == 1 && c_dtype == 0)
    err = LnByGroups<float, __nv_bfloat16>(j, x, xr, y, yr, b, gamma, beta, xp, h, mean, rstd, rows, d, eps, s);
  else if (x_dtype == 0 && c_dtype == 1)
    err = LnByGroups<__nv_bfloat16, float>(j, x, xr, y, yr, b, gamma, beta, xp, h, mean, rstd, rows, d, eps, s);
  else
    err = LnByGroups<float, float>(j, x, xr, y, yr, b, gamma, beta, xp, h, mean, rstd, rows, d, eps, s);
  return static_cast<int>(err);
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
  if (!Valid(d, x_dtype, c_dtype, rows))
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
  const int groups = LnBwdBlocks(rows), nq = with_bias ? 3 : 2;
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
