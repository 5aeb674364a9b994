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
// Design: one thread per output byte, one launch for the batch and both
// planes. Grid (ceil(dw / block), dh + dh/2, N); a block's threads share
// one output row, so its row taps and weights are uniform and each thread
// reads its own column's. Sources are read in place through a row pitch
// and a batch stride, so a crop's strided view needs no copy. Outputs are
// contiguous [N, dh, dw] and [N, dh/2, dw].
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

__global__ void AreaDownKernel(Planes p, const int* __restrict__ rows,
                               const int* __restrict__ cols,
                               const float* __restrict__ row_w,
                               const float* __restrict__ col_w, int ty,
                               int tx) {
  Site s;
  if (!locate(p, s)) return;
  float acc = 0.0f, div = 0.0f;
  for (int ti = 0; ti < ty; ++ti) {
    const uint8_t* row = s.src + rows[s.row * ty + ti] * s.pitch;
    const float wy = row_w[s.row * ty + ti];
    for (int tj = 0; tj < tx; ++tj) {
      const float w2d = __fmul_rn(wy, col_w[s.col * tx + tj]);
      div = __fadd_rn(div, w2d);
      acc = __fmaf_rn(static_cast<float>(row[cols[s.col * tx + tj]]), w2d,
                      acc);
    }
  }
  *s.out = static_cast<uint8_t>(__float2int_rz(__fdiv_rn(acc, div)));
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

extern "C" int ts_resize_area_down_nv12(TS_RESIZE_ARGS) {
  if (rt < 1 || ct < 1) return cudaErrorInvalidValue;
  const Planes p = MakePlanes(y, y_pitch, y_batch, uv, uv_pitch, uv_batch,
                              out_y, out_uv, dw, dh);
  AreaDownKernel<<<Grid(n, dw, dh), Block(dw), 0, stream>>>(
      p, rows, cols, static_cast<const float*>(row_w),
      static_cast<const float*>(col_w), rt, ct);
  return static_cast<int>(cudaGetLastError());
}
