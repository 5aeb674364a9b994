// NV12-domain resize on Hopper (sm_90a): BILINEAR, BICUBIC and AREA.
//
// Replaces the JAX package's XLA fusions (not Pallas kernels)
// ops/resize.py::resize_bilinear (with AREA's upscale branch, the same
// blend with coverage weights), ::resize_bicubic and ::resize_area's
// downscale branch. Same function as the plain torch versions of
// tensor_stream_torch/ops/resize.py, byte for byte, and as the native host
// resize (csrc/vpp_host.cpp), whose explicit fmaf order reproduces the
// reference's nvcc-contracted float32 (src/Resize.cu:160-473).
//
// Every index and weight depends only on the output row or column, so the
// host builds per-axis tables once per geometry (ops/resize.py
// plane_tables) and the kernels read them; a mismatch with the plain
// version can then only come from the blend. Each table kind holds the Y
// plane's rows (or columns) and then the UV plane's:
//   rows   int32 [dh + dh/2][rt]   source row of each row tap
//   cols   int32 [dw + dw][ct]     source column of each column tap; the UV
//                                  plane's columns interleave U and V taps
//   row_w  [dh + dh/2][rk]         row weights (float; double for bicubic)
//   col_w  [dw + dw][ck]           column weights
// Output row r of the grid is Y row r for r < dh, else UV row r - dh.
//
// Design: one launch for the batch and both planes. BILINEAR and BICUBIC
// run one thread per output byte on a grid (ceil(dw / block), dh + dh/2,
// N); a block's threads share one output row, so its row taps and
// weights are uniform and each thread reads its own column's. Sources are read in place through a row pitch
// and a batch stride, so a crop's strided view needs no copy. Outputs are
// contiguous [N, dh, dw] and [N, dh/2, dw]. AREA-down stages a band of
// source rows in shared memory (its own section below).
//
// Bound: device-memory bytes. A launch must write the output and read the
// 32-byte sectors its taps touch; the arithmetic (13 float ops a byte for
// bilinear, 35 double ops for bicubic, 4 float ops a tap for AREA) is far
// below the card's rate. chip_smoke.py computes the bound of
// each timed shape from the tables.
//
// Rounding: the library builds with -fmad=false and every multiply, add,
// fma and divide is an _rn intrinsic in csrc/vpp_host.cpp's order:
// - bilinear (Blend4): s = fmaf(a*omx, omy, (b*wx)*omy);
//   s = fmaf(c*wy, omx, s); s = fmaf(d, wx*wy, s); (uint8_t)(int)s;
// - bicubic (BicubicPlane): ((c0 p0 + c1 p1) + c2 p2) + c3 p3 in double,
//   round() half away from zero, clamp to [0, 255], per row tap and then
//   over the four rows;
// - AREA (AreaDownPlane): per tap w2d = wy*wx, div = div + w2d,
//   acc = fmaf(p, w2d, acc); then (uint8_t)(int)(acc / div) with the IEEE
//   division (never --use_fast_math, which would approximate it).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// The two planes, in named fields: a kernel picks one with a select. (An
// array indexed by the plane put the whole struct on each thread's stack:
// a 72-byte frame in every kernel of the first build.)
struct Planes {
  const uint8_t *y, *uv;
  long long y_pitch, uv_pitch;
  long long y_batch, uv_batch;
  uint8_t *out_y, *out_uv;
  int dw, dh;
};

// This thread's output row (and row-table index), column-table index,
// source plane and output byte; false past the row's end.
struct Site {
  int row, col;
  const uint8_t* src;
  long long pitch;
  uint8_t* out;
};

__device__ __forceinline__ bool locate(const Planes& p, Site& s) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= p.dw) return false;
  const int r = blockIdx.y;
  const long long n = blockIdx.z;
  const bool uv = r >= p.dh;
  const int i = uv ? r - p.dh : r;
  const long long out_h = uv ? p.dh / 2 : p.dh;
  s.row = r;
  s.col = uv ? p.dw + j : j;
  s.src = (uv ? p.uv : p.y) + n * (uv ? p.uv_batch : p.y_batch);
  s.pitch = uv ? p.uv_pitch : p.y_pitch;
  s.out = (uv ? p.out_uv : p.out_y) + (n * out_h + i) * p.dw + j;
  return true;
}

__global__ void BilinearKernel(Planes p, const int* __restrict__ rows,
                               const int* __restrict__ cols,
                               const float* __restrict__ row_w,
                               const float* __restrict__ col_w) {
  Site s;
  if (!locate(p, s)) return;
  const uint8_t* row_a = s.src + rows[2 * s.row] * s.pitch;
  const uint8_t* row_c = s.src + rows[2 * s.row + 1] * s.pitch;
  const int ca = cols[2 * s.col], cb = cols[2 * s.col + 1];
  const float wy = row_w[s.row], wx = col_w[s.col];
  const float a = row_a[ca], b = row_a[cb], c = row_c[ca], d = row_c[cb];
  const float omx = __fsub_rn(1.0f, wx), omy = __fsub_rn(1.0f, wy);
  float v = __fmaf_rn(__fmul_rn(a, omx), omy,
                      __fmul_rn(__fmul_rn(b, wx), omy));
  v = __fmaf_rn(__fmul_rn(c, wy), omx, v);
  v = __fmaf_rn(d, __fmul_rn(wx, wy), v);
  *s.out = static_cast<uint8_t>(__float2int_rz(v));
}

__device__ __forceinline__ double RoundClamp(double x) {
  const int v = static_cast<int>(round(x));  // half away from zero
  return static_cast<double>(min(max(v, 0), 255));
}

__global__ void BicubicKernel(Planes p, const int* __restrict__ rows,
                              const int* __restrict__ cols,
                              const double* __restrict__ row_w,
                              const double* __restrict__ col_w) {
  Site s;
  if (!locate(p, s)) return;
  int ct[4];
  double cx[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    ct[k] = cols[4 * s.col + k];
    cx[k] = col_w[4 * s.col + k];
  }
  double acc = 0.0;
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    const uint8_t* row = s.src + rows[4 * s.row + t] * s.pitch;
    double h = __dmul_rn(cx[0], static_cast<double>(row[ct[0]]));
#pragma unroll
    for (int k = 1; k < 4; ++k)
      h = __dadd_rn(h, __dmul_rn(cx[k], static_cast<double>(row[ct[k]])));
    const double term = __dmul_rn(row_w[4 * s.row + t], RoundClamp(h));
    acc = t == 0 ? term : __dadd_rn(acc, term);
  }
  *s.out = static_cast<uint8_t>(RoundClamp(acc));
}

// ------------------------------------------------------------- AREA-down
//
// AREA-down reads ceil(ratio) taps an axis, 5 x 9 a byte at 1080p -> 224²,
// so a thread an output byte that gathers its taps from device memory
// spends its time on L1 wavefronts: lanes sit ratio bytes apart, and each
// tap also reloaded the column's index and weight. Here:
//
// - A block owns one plane of `frames` frames (1 or 2), a band of `band`
//   output rows and a tile of `tile` output columns, one thread a column.
//   The host plan (ops/resize.py area_plan) gives each band's source rows,
//   each tile's source columns ("spans") and each band's row taps.
// - The block stages those source bytes in shared memory with 16-byte
//   cp.async: each row as the aligned chunks that hold its bytes (a crop's
//   view is read in place through its pitch; a chunk never crosses a page,
//   so the bytes around a crop's are mapped); where the tile reaches past
//   the row's end, the last chunk byte by byte and the row's last byte
//   repeated after it. The tables clamp a tap at the last column, so with
//   those bytes a column's taps are c0, c0 + S,
//   ..., c0 + S (tx - 1) with no clamp left (S = 1 on Y, 2 on the UV
//   plane, whose U and V columns interleave).
// - "registers" variant (tx <= kRegisterTaps, a template on tx): a thread
//   keeps its column's tx weights in registers, reads a row's taps as
//   aligned 32-bit words from shared memory, funnel-shifts them into place
//   and turns each byte into a float with one byte permute (0x4B0000bb is
//   2^23 + b) and one exact subtraction. Two frames a block share each
//   product w2d = wy*wx, and read each output's sum of w2d (`div`, which
//   depends on the weights alone) as the host summed it; one frame sums
//   its own.
//   Measured (chip_smoke.py area_split): at N=128 1080p -> 224² staging
//   alone runs at about 84% of the memory rate and the blend alone takes
//   about four fifths of that time; the kernel overlaps them partly.
// - "table" variant (any tx; one output row of one frame a block): the
//   tile's column weights in shared memory as [tx][tile], conflict-free,
//   and the source rows staged in chunks as the row taps reach them.
//
// Bound: device-memory bytes, the source read once (398 MB at N=128
// 1080p), as the other kernels. Each output keeps the order y taps outer,
// x taps inner: w2d = wy*wx, div += w2d, acc = fmaf(p, w2d, acc), then
// (int)(acc / div); the box is not separable under that order.

constexpr int kRegisterTaps = 16;
constexpr int kMaxBand = 4;  // output rows a band, the registers variant

// A plan from the host (ops/resize.py area_plan), and the tables.
struct AreaPlan {
  const int* rows;
  const int* cols;
  const float* row_w;
  const float* col_w;
  // Each output's sum of w2d in the blend's order, Y [dh][dw] then UV
  // [dh/2][uvw] (registers variant).
  const float* div;
  // [bands][2] (first source row, rows) for the Y bands then the UV
  // bands; then [2][tiles][2] (first source column, columns) for the Y
  // tiles then the UV tiles.
  const int* spans;
  // Registers variant: [bands][band * ty] (source row - the band's first,
  // weight bits) of each row tap of the band's output rows.
  const int2* taps;
  int ty, tx;
  int sw, sh;        // source width (both planes' row bytes) and height
  int uvw;           // the UV plane's output columns
  int band;          // output rows a block
  int tile;          // output columns a block
  int frames, n;     // frames a block, and the batch
  int ybands;
  int pitch;         // staged row pitch, a multiple of 16 (see Stage)
  int rows_cap;      // staged rows a frame (table variant: a chunk)
  int rows_bytes;    // shared bytes of a frame's staged rows
  int taps_bytes;    // registers variant: shared bytes of a band's taps
  int wbytes;        // table variant: shared bytes of the column weights
  // 0x4B000000, the bits of 2^23, as a launch parameter: with it in the
  // constant bank ptxas keeps the byte permute's selector immediate
  // (given two immediates it held the four selectors in registers and
  // rebuilt them every row tap).
  uint32_t two23;
};

// This block's plane, frames, band and tile, and this thread's column.
struct AreaBlock {
  bool uv;
  int out_h, out_w;        // the plane's output rows and columns
  int band;                // the band's index in `spans` and `taps`
  int first, last;         // the band's output rows, [first, last)
  int row_lo, nrows;       // its source rows
  int trow, tcol;          // the plane's first entry in the packed tables
  int j;                   // this thread's output column, or -1
  int col_lo, ncols;       // the tile's source columns
  int inside;              // of them inside the row (the rest repeat)
  int nf;                  // frames (<= frames)
  const uint8_t* src;      // the first frame's source plane
  long long pitch, batch;
  int step;                // staged row step: a.pitch + pitch mod 16
  int src_h;
  const float* div;        // the plane's sums of weights
  uint8_t* out;            // the first frame's output plane, rows dw apart
  long long out_batch;
};

__device__ __forceinline__ AreaBlock Locate(const Planes& p,
                                            const AreaPlan& a) {
  AreaBlock b;
  b.band = blockIdx.y;
  b.uv = b.band >= a.ybands;
  b.out_h = b.uv ? p.dh / 2 : p.dh;
  b.out_w = b.uv ? a.uvw : p.dw;
  b.first = (b.uv ? b.band - a.ybands : b.band) * a.band;
  b.last = min(b.first + a.band, b.out_h);
  b.row_lo = a.spans[2 * b.band];
  b.nrows = a.spans[2 * b.band + 1];
  b.trow = b.uv ? p.dh : 0;
  b.tcol = b.uv ? p.dw : 0;
  const int j = blockIdx.x * a.tile + threadIdx.x;
  b.j = threadIdx.x < a.tile && j < b.out_w ? j : -1;
  const int* cs =
      a.spans + 2 * gridDim.y + 2 * ((b.uv ? gridDim.x : 0) + blockIdx.x);
  b.col_lo = cs[0];
  b.ncols = cs[1];
  b.inside = min(b.col_lo + b.ncols, a.sw) - b.col_lo;
  const int n0 = blockIdx.z * a.frames;
  b.nf = min(a.frames, a.n - n0);
  b.batch = b.uv ? p.uv_batch : p.y_batch;
  b.src = (b.uv ? p.uv : p.y) + n0 * b.batch;
  b.pitch = b.uv ? p.uv_pitch : p.y_pitch;
  b.step = a.pitch + static_cast<int>(b.pitch & 15);
  b.src_h = b.uv ? a.sh / 2 : a.sh;
  b.div = a.div + (b.uv ? p.dh * p.dw : 0);
  b.out_batch = static_cast<long long>(b.out_h) * p.dw;
  b.out = (b.uv ? p.out_uv : p.out_y) + n0 * b.out_batch;
  return b;
}

// Offset in 16 of byte `col` of source row `row`.
__device__ __forceinline__ int Mod16(const uint8_t* src, long long pitch,
                                     int row, int col) {
  return static_cast<int>(
      reinterpret_cast<uintptr_t>(src + row * pitch + col) & 15);
}

__device__ __forceinline__ void CpAsync16(void* dst, const void* src) {
  const unsigned s =
      static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void CpAsync8(void* dst, const void* src) {
  const unsigned s =
      static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

// Waits for every cp.async of this thread, then for the block's.
__device__ __forceinline__ void CpAsyncLanded() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
}

// Staged rows: source row `first` + k starts at k * step + shift, shift
// being the first row's first byte's offset in 16. Since step is the
// staged pitch (a multiple of 16) plus the source pitch mod 16, every
// row's first byte keeps its offset in 16, and each row is copied as the
// 16-byte aligned chunks that hold its bytes. Where the tile reaches past
// the row's end, the last chunk is copied byte by byte instead and the
// row's last byte repeated after it (what the tables' clamp reads there),
// so no copy lands on those bytes. Returns the shift; the bytes are
// readable after CpAsyncLanded.
__device__ int Stage(uint8_t* band, const uint8_t* src, const AreaBlock& b,
                     int first, int count) {
  const int shift = Mod16(src, b.pitch, first, b.col_lo);
  const int extra = b.ncols - b.inside;
  const int lane = threadIdx.x & 31;
  for (int k = threadIdx.x >> 5; k < count; k += blockDim.x >> 5) {
    const uint8_t* a0 = src + (first + k) * b.pitch + b.col_lo;
    const int head = Mod16(src, b.pitch, first + k, b.col_lo);
    const uint8_t* g = a0 - head;
    uint8_t* s = band + k * b.step + shift - head;
    const int end = head + b.inside;  // past the row's last staged byte
    const int chunks = extra ? end >> 4 : (end + 15) >> 4;
    for (int q = lane; q < chunks; q += 32) CpAsync16(s + 16 * q, g + 16 * q);
    if (extra && lane == 0) {
      for (int e = 16 * chunks; e < end; ++e) s[e] = g[e];
      for (int e = end; e < end + extra; ++e) s[e] = g[end - 1];
    }
  }
  return shift;
}

// A byte as float: 0x4B000000 | b is 2^23 + b, exactly.
__device__ __forceinline__ float ByteFloat(uint32_t bits) {
  return __fsub_rn(__int_as_float(bits), 8388608.0f);
}

// Words a thread reads for a row's taps: those that hold bytes S*tj +
// (0..3) of its run; the last tap's byte, at a word's start, never
// reaches the next.
template <int TX, int S>
__host__ __device__ constexpr int RunWords() {
  return ((S * (TX - 1)) & 3) == 0 ? ((S * (TX - 1)) >> 2) + 1
                                   : ((S * (TX - 1)) >> 2) + 2;
}

// The registers variant over NF frames: a frame past the batch's end reads
// the first frame's bytes and stores nothing.
template <int TX, int S, int NF>
__device__ void RegisterBand(uint8_t* smem, const AreaBlock& b,
                             const AreaPlan& a, int dw) {
  constexpr int kWords = RunWords<TX, S>();
  float wx[TX];
  int off = 0;
  if (b.j >= 0) {  // loaded while the band is staged
    const int col = b.tcol + b.j;
    off = a.cols[col * TX] - b.col_lo;
#pragma unroll
    for (int tj = 0; tj < TX; ++tj) wx[tj] = a.col_w[col * TX + tj];
  }
  const int2* band_taps = a.taps + b.band * a.band * a.ty;
  int2* taps = reinterpret_cast<int2*>(smem);
  for (int t = threadIdx.x; t < a.band * a.ty; t += blockDim.x)
    CpAsync8(taps + t, band_taps + t);
  int shift[NF];
#pragma unroll
  for (int f = 0; f < NF; ++f)
    shift[f] = f < b.nf ? Stage(smem + a.taps_bytes + f * a.rows_bytes,
                                b.src + f * b.batch, b, b.row_lo, b.nrows)
                        : 0;
  CpAsyncLanded();
  if (b.j < 0) return;
  const uint32_t* words[NF];
  int base[NF];
#pragma unroll
  for (int f = 0; f < NF; ++f) {
    const int g = f < b.nf ? f : 0;
    words[f] = reinterpret_cast<const uint32_t*>(smem + a.taps_bytes +
                                                 g * a.rows_bytes);
    base[f] = (f < b.nf ? shift[f] : shift[0]) + off;
  }
  for (int i = b.first; i < b.last; ++i, taps += a.ty) {
    // Two frames read the host's sum of weights (its load hides behind the
    // row); one frame sums its own, which keeps a load off the critical
    // path of a one-frame launch.
    float div = NF > 1 ? b.div[i * b.out_w + b.j] : 0.0f;
    float acc[NF];
#pragma unroll
    for (int f = 0; f < NF; ++f) acc[f] = 0.0f;
    for (int ti = 0; ti < a.ty; ++ti) {
      const int2 tap = taps[ti];
      const float wy = __int_as_float(tap.y);
      uint32_t w[NF][kWords];
      uint32_t sh[NF];
#pragma unroll
      for (int f = 0; f < NF; ++f) {
        const int at = tap.x * b.step + base[f];
        sh[f] = (at & 3) * 8;
        const uint32_t* wp = words[f] + (at >> 2);
#pragma unroll
        for (int q = 0; q < kWords; ++q) w[f][q] = wp[q];
      }
#pragma unroll
      for (int tj = 0; tj < TX; ++tj) {
        const int byte = S * tj;
        const float w2d = __fmul_rn(wy, wx[tj]);
        if (NF == 1) div = __fadd_rn(div, w2d);
#pragma unroll
        for (int f = 0; f < NF; ++f) {
          const int q = byte >> 2;  // one shift a word, shared by its taps
          const uint32_t bits = __funnelshift_r(
              w[f][q], q + 1 < kWords ? w[f][q + 1] : 0u, sh[f]);
          const float px = ByteFloat(
              __byte_perm(bits, a.two23, 0x7650u | (byte & 3)));
          acc[f] = __fmaf_rn(px, w2d, acc[f]);
        }
      }
    }
#pragma unroll
    for (int f = 0; f < NF; ++f)
      if (f < b.nf)
        b.out[f * b.out_batch + i * dw + b.j] = static_cast<uint8_t>(
            __float2int_rz(__fdiv_rn(acc[f], div)));
  }
}

// The table variant: one output row of one frame a block (band and frames
// 1).
template <int S>
__device__ void TableRow(uint8_t* smem, const AreaBlock& b,
                         const AreaPlan& a, int dw) {
  float* wsm = reinterpret_cast<float*>(smem);
  uint8_t* band = smem + a.wbytes;
  for (int i = threadIdx.x; i < a.tx * a.tile; i += blockDim.x) {
    const int tj = i / a.tile;
    const int j = blockIdx.x * a.tile + (i - tj * a.tile);
    wsm[i] = j < b.out_w ? a.col_w[(b.tcol + j) * a.tx + tj] : 0.0f;
  }  // published by the first chunk's barrier
  const int i = b.first;
  const int tr = (b.trow + i) * a.ty;
  const int off = b.j >= 0 ? a.cols[(b.tcol + b.j) * a.tx] - b.col_lo : 0;
  float acc = 0.0f, div = 0.0f;
  int lo = 0, hi = 0, shift = 0;  // the staged source rows
  for (int ti = 0; ti < a.ty; ++ti) {
    const int row = a.rows[tr + ti];
    if (row < lo || row >= hi) {  // the same for the whole block
      __syncthreads();            // done with the last chunk
      lo = row;
      hi = min(row + a.rows_cap, b.src_h);
      shift = Stage(band, b.src, b, lo, hi - lo);
      CpAsyncLanded();
    }
    if (b.j < 0) continue;
    const float wy = a.row_w[tr + ti];
    const uint8_t* px = band + (row - lo) * b.step + shift + off;
    for (int tj = 0; tj < a.tx; ++tj) {
      const float w2d = __fmul_rn(wy, wsm[tj * a.tile + threadIdx.x]);
      div = __fadd_rn(div, w2d);
      acc = __fmaf_rn(ByteFloat(0x4B000000u | px[S * tj]), w2d, acc);
    }
  }
  if (b.j >= 0)
    b.out[i * dw + b.j] =
        static_cast<uint8_t>(__float2int_rz(__fdiv_rn(acc, div)));
}

// TX > 0: the registers variant at tx == TX over NF frames a block, held
// to 64 registers for 4 blocks of 256 threads an SM where its words fit;
// TX == 0: the table variant.
template <int TX, int NF>
__global__ void __launch_bounds__(256, TX * NF <= 18 ? 4 : 2)
    AreaDownKernel(Planes p, AreaPlan a) {
  extern __shared__ __align__(16) uint8_t smem[];
  const AreaBlock b = Locate(p, a);
  if (b.ncols == 0) return;  // a tile past the UV plane's last column
  if constexpr (TX == 0) {
    if (b.uv)
      TableRow<2>(smem, b, a, p.dw);
    else
      TableRow<1>(smem, b, a, p.dw);
  } else {
    if (b.uv)
      RegisterBand<TX, 2, NF>(smem, b, a, p.dw);
    else
      RegisterBand<TX, 1, NF>(smem, b, a, p.dw);
  }
}

template <int TX, int NF>
int LaunchArea(const Planes& p, const AreaPlan& a, dim3 grid, int threads,
               int smem, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        AreaDownKernel<TX, NF>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  AreaDownKernel<TX, NF><<<grid, threads, smem, stream>>>(p, a);
  return static_cast<int>(cudaGetLastError());
}

Planes MakePlanes(const uint8_t* y, long long y_pitch, long long y_batch,
                  const uint8_t* uv, long long uv_pitch, long long uv_batch,
                  uint8_t* out_y, uint8_t* out_uv, int dw, int dh) {
  Planes p;
  p.y = y;
  p.uv = uv;
  p.y_pitch = y_pitch;
  p.uv_pitch = uv_pitch;
  p.y_batch = y_batch;
  p.uv_batch = uv_batch;
  p.out_y = out_y;
  p.out_uv = out_uv;
  p.dw = dw;
  p.dh = dh;
  return p;
}

// One warp-multiple block a row, up to 256 threads.
dim3 Block(int dw) { return dim3(min(256, (dw + 31) / 32 * 32)); }

dim3 Grid(int n, int dw, int dh) {
  const dim3 block = Block(dw);
  return dim3((dw + block.x - 1) / block.x, dh + dh / 2, n);
}

}  // namespace

#define TS_RESIZE_ARGS                                                       \
  const uint8_t *y, long long y_pitch, long long y_batch, const uint8_t *uv, \
      long long uv_pitch, long long uv_batch, uint8_t *out_y,               \
      uint8_t *out_uv, int n, int dw, int dh, const int *rows,              \
      const int *cols, const void *row_w, const void *col_w, int rt, int ct, \
      cudaStream_t stream

// Each entry point launches once and returns cudaGetLastError(): 0, or the
// error of a refused launch. The wrapper (ops/resize.py) checks shapes,
// types and devices before the call.
extern "C" int ts_resize_bilinear_nv12(TS_RESIZE_ARGS) {
  if (rt != 2 || ct != 2) return cudaErrorInvalidValue;
  const Planes p = MakePlanes(y, y_pitch, y_batch, uv, uv_pitch, uv_batch,
                              out_y, out_uv, dw, dh);
  BilinearKernel<<<Grid(n, dw, dh), Block(dw), 0, stream>>>(
      p, rows, cols, static_cast<const float*>(row_w),
      static_cast<const float*>(col_w));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ts_resize_bicubic_nv12(TS_RESIZE_ARGS) {
  if (rt != 4 || ct != 4) return cudaErrorInvalidValue;
  const Planes p = MakePlanes(y, y_pitch, y_batch, uv, uv_pitch, uv_batch,
                              out_y, out_uv, dw, dh);
  BicubicKernel<<<Grid(n, dw, dh), Block(dw), 0, stream>>>(
      p, rows, cols, static_cast<const double*>(row_w),
      static_cast<const double*>(col_w));
  return static_cast<int>(cudaGetLastError());
}

// AREA-down takes the host plan besides the tables: `div` (float32, the
// sums of weights), `spans` (int32) and `taps` (int32 pairs), on the
// device (the table variant reads only `spans`); the source's width and
// height, the UV plane's output columns, the band, the tile, the frames a
// block, the staged row pitch and rows, the dynamic shared bytes and the
// variant (0 registers, 1 table).
extern "C" int ts_resize_area_down_nv12(TS_RESIZE_ARGS, const float* div,
                                        const int* spans, const int* taps,
                                        int sw, int sh, int uvw, int band,
                                        int tile, int frames, int pitch,
                                        int rows_cap, int smem,
                                        int variant) {
  if (rt < 1 || ct < 1 || band < 1 || band > kMaxBand || tile < 1 ||
      tile > 256 || pitch % 16 != 0 || frames < 1 || frames > 2 ||
      variant < 0 || variant > 1 || (variant == 0 && ct > kRegisterTaps) ||
      (variant == 1 && (band != 1 || frames != 1)))
    return cudaErrorInvalidValue;
  const Planes p = MakePlanes(y, y_pitch, y_batch, uv, uv_pitch, uv_batch,
                              out_y, out_uv, dw, dh);
  AreaPlan a;
  a.rows = rows;
  a.cols = cols;
  a.row_w = static_cast<const float*>(row_w);
  a.col_w = static_cast<const float*>(col_w);
  a.div = div;
  a.spans = spans;
  a.taps = reinterpret_cast<const int2*>(taps);
  a.ty = rt;
  a.tx = ct;
  a.sw = sw;
  a.sh = sh;
  a.uvw = uvw;
  a.band = band;
  a.tile = tile;
  a.frames = frames;
  a.n = n;
  a.ybands = (dh + band - 1) / band;
  a.pitch = pitch;
  a.rows_cap = rows_cap;
  // Shared bytes: the band's row taps, then each frame's staged rows
  // (their steps exceed the pitch by up to 15 bytes, and the first starts
  // up to 15 bytes in); the table variant's column weights, then its rows.
  a.taps_bytes = (band * rt * 8 + 15) / 16 * 16;
  a.rows_bytes = rows_cap * (pitch + 16) + 16;
  a.wbytes = variant == 1 ? (ct * tile * 4 + 15) / 16 * 16 : 0;
  a.two23 = 0x4B000000u;
  const dim3 grid((dw + tile - 1) / tile,
                  a.ybands + (dh / 2 + band - 1) / band,
                  (n + frames - 1) / frames);
  const int threads = (tile + 31) / 32 * 32;
  if (variant == 1)
    return LaunchArea<0, 1>(p, a, grid, threads, smem, stream);
  switch (ct) {
#define TS_AREA_CASE(k)                                              \
  case k:                                                            \
    return frames == 2                                               \
               ? LaunchArea<k, 2>(p, a, grid, threads, smem, stream) \
               : LaunchArea<k, 1>(p, a, grid, threads, smem, stream);
    TS_AREA_CASE(1) TS_AREA_CASE(2) TS_AREA_CASE(3) TS_AREA_CASE(4)
    TS_AREA_CASE(5) TS_AREA_CASE(6) TS_AREA_CASE(7) TS_AREA_CASE(8)
    TS_AREA_CASE(9) TS_AREA_CASE(10) TS_AREA_CASE(11) TS_AREA_CASE(12)
    TS_AREA_CASE(13) TS_AREA_CASE(14) TS_AREA_CASE(15) TS_AREA_CASE(16)
#undef TS_AREA_CASE
  }
  return cudaErrorInvalidValue;
}
