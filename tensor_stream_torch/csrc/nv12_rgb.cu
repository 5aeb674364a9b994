// Full-frame NV12 -> RGB24/BGR24 on Hopper (sm_90a).
//
// Replaces the JAX package's Pallas TPU kernel
// ops/pallas_color.py::_nv12_rgb_kernel (behind its ops/vpp.py full-frame
// RGB path). Same function as tensor_stream_torch/ops/color.py::
// nv12_to_rgb, byte for byte: 2x2 chroma upsample, the BT.601/709
// limited/full matrix with the +0.5 bias, truncating int cast, clamp to
// [0, 255], and an optionally correctly rounded x/255, written planar
// [N,3,H,W] or merged [N,H,W,3].
//
// Input is the flat staging layout of build_vpp_batched_flat: all N Y
// planes [N,H,W], then all N UV planes [N,H/2,W] (the wrapper passes the
// two base pointers, so separate Y/UV tensors work as well).
//
// Bound: device-memory bytes. Each pixel reads 1.5 B (Y + its share of
// UV) and writes 3 B (u8) or 12 B (f32); the arithmetic is ~20 flops a
// pixel, far below the card's rate. At 3.35 TB/s:
//   N=128, 224x224, planar f32: 128*50176*(1.5+12) B = 86.7 MB -> 25.9 us
//   N=1, 1920x1080, merged u8:  2073600*(1.5+3) B     =  9.3 MB ->  2.8 us
// Design: one thread per 2x2 luma quad, so each U/V pair is loaded once
// and serves four pixels; the grid is (quads of one frame, N). Any even
// H and W work (H=1080 included): there is no block tiling to satisfy.
// This first version is simple and right; coalesced wide stores are
// later work.
//
// Rounding: every multiply and add uses an _rn intrinsic in the source
// order of ops/color.py, so nvcc cannot contract them into FMAs (the
// library is also built with -fmad=false); the float cast truncates
// toward zero like astype(int32); x/255 is the IEEE division
// __fdiv_rn, never a reciprocal multiply.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct Coefs {
  float rv, bu, gv, gu, y_coef, y_off;
};

// ops/color.py _STANDARD_COEFS bit for bit, as hex float literals
// (tests/test_torch_color.py parses and checks them).
__constant__ Coefs kCoefs[4] = {
    // 0: BT601 (the reference's constants)
    {0x1.98937p+0f, 0x1.024ddp+1f, -0x1.a0418p-1f, -0x1.90624p-2f,
     0x1.29fbep+0f, 0x1p+4f},
    // 1: BT709 limited
    {0x1.caf114p+0f, 0x1.0e632ep+1f, -0x1.10d97ep-1f, -0x1.b4bbbp-3f,
     0x1.29fbep+0f, 0x1p+4f},
    // 2: BT601 full
    {0x1.66e978p+0f, 0x1.c5a1cap+0f, -0x1.6da346p-1f, -0x1.606544p-2f,
     0x1p+0f, 0x0p+0f},
    // 3: BT709 full
    {0x1.932618p+0f, 0x1.db089ap+0f, -0x1.df5bf8p-2f, -0x1.7fa3dep-3f,
     0x1p+0f, 0x0p+0f},
};

__device__ __forceinline__ int Clamp255(int v) { return min(max(v, 0), 255); }

template <typename T>
__device__ __forceinline__ T Store(int c);

template <>
__device__ __forceinline__ uint8_t Store<uint8_t>(int c) {
  return static_cast<uint8_t>(c);
}

template <>
__device__ __forceinline__ float Store<float>(int c) {
  return __fdiv_rn(static_cast<float>(c), 255.0f);
}

// ops/color.py nv12_to_rgb_channels for one pixel.
__device__ __forceinline__ void Rgb(float yv, float ui, float vi,
                                    const Coefs& k, int* r, int* g, int* b) {
  const float yf = __fmul_rn(fmaxf(0.0f, __fsub_rn(yv, k.y_off)), k.y_coef);
  *r = Clamp255(__float2int_rz(
      __fadd_rn(yf, __fadd_rn(__fmul_rn(vi, k.rv), 0.5f))));
  *b = Clamp255(__float2int_rz(
      __fadd_rn(yf, __fadd_rn(__fmul_rn(ui, k.bu), 0.5f))));
  *g = Clamp255(__float2int_rz(__fadd_rn(
      yf, __fadd_rn(__fadd_rn(__fmul_rn(vi, k.gv), __fmul_rn(ui, k.gu)),
                    0.5f))));
}

template <typename T, bool kPlanar>
__global__ void Nv12RgbKernel(const uint8_t* __restrict__ y,
                              const uint8_t* __restrict__ uv,
                              T* __restrict__ out, int h, int w, int swap_rb,
                              int standard) {
  const int qw = w >> 1;
  const long long quads = static_cast<long long>(h >> 1) * qw;
  const long long q =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (q >= quads) return;
  const int qr = static_cast<int>(q / qw);
  const int qc = static_cast<int>(q - static_cast<long long>(qr) * qw);
  const size_t plane = static_cast<size_t>(h) * w;
  const size_t n = blockIdx.y;
  const uint8_t* yp = y + n * plane;
  const uint8_t* uvp = uv + n * (plane / 2) + static_cast<size_t>(qr) * w +
                       2 * qc;
  T* op = out + n * 3 * plane;
  const Coefs k = kCoefs[standard];
  const float ui = static_cast<float>(static_cast<int>(uvp[0]) - 128);
  const float vi = static_cast<float>(static_cast<int>(uvp[1]) - 128);
#pragma unroll
  for (int dy = 0; dy < 2; ++dy) {
#pragma unroll
    for (int dx = 0; dx < 2; ++dx) {
      const size_t px = static_cast<size_t>(2 * qr + dy) * w + 2 * qc + dx;
      int r, g, b;
      Rgb(static_cast<float>(yp[px]), ui, vi, k, &r, &g, &b);
      if (swap_rb) {
        const int t = r;
        r = b;
        b = t;
      }
      if (kPlanar) {
        op[px] = Store<T>(r);
        op[plane + px] = Store<T>(g);
        op[2 * plane + px] = Store<T>(b);
      } else {
        op[3 * px] = Store<T>(r);
        op[3 * px + 1] = Store<T>(g);
        op[3 * px + 2] = Store<T>(b);
      }
    }
  }
}

template <typename T, bool kPlanar>
void Launch(const uint8_t* y, const uint8_t* uv, void* out, int n, int h,
            int w, int swap_rb, int standard, cudaStream_t stream) {
  constexpr int kThreads = 256;
  const long long quads = static_cast<long long>(h / 2) * (w / 2);
  const dim3 grid(static_cast<unsigned>((quads + kThreads - 1) / kThreads),
                  static_cast<unsigned>(n));
  Nv12RgbKernel<T, kPlanar><<<grid, kThreads, 0, stream>>>(
      y, uv, static_cast<T*>(out), h, w, swap_rb, standard);
}

}  // namespace

// Plain C entry point (bound with ctypes). Launches on `stream` without
// synchronising and returns cudaGetLastError() (0 on success).
extern "C" int ts_nv12_rgb(const void* y, const void* uv, void* out, int n,
                           int h, int w, int swap_rb, int planar,
                           int normalization, int standard, void* stream) {
  if (n <= 0 || n > 65535 || h <= 0 || w <= 0 || (h & 1) || (w & 1) ||
      standard < 0 || standard > 3) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* yp = static_cast<const uint8_t*>(y);
  const auto* uvp = static_cast<const uint8_t*>(uv);
  const auto s = static_cast<cudaStream_t>(stream);
  if (normalization) {
    if (planar)
      Launch<float, true>(yp, uvp, out, n, h, w, swap_rb, standard, s);
    else
      Launch<float, false>(yp, uvp, out, n, h, w, swap_rb, standard, s);
  } else {
    if (planar)
      Launch<uint8_t, true>(yp, uvp, out, n, h, w, swap_rb, standard, s);
    else
      Launch<uint8_t, false>(yp, uvp, out, n, h, w, swap_rb, standard, s);
  }
  return static_cast<int>(cudaGetLastError());
}
