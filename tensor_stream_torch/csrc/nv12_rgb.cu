// Full-frame NV12 -> RGB24/BGR24 on Hopper (sm_90a).
//
// Replaces the JAX package's Pallas TPU kernel
// ops/pallas_color.py::_nv12_rgb_kernel (behind its ops/vpp.py full-frame
// RGB path). Same function as
// tensor_stream_torch/ops/color.py::nv12_to_rgb, byte for byte: 2x2 chroma
// upsample, the BT.601/709 limited/full matrix with the +0.5 bias,
// truncating int cast, clamp to [0, 255], and an optionally correctly
// rounded x/255, written planar [N,3,H,W] or merged [N,H,W,3].
//
// Input is the flat staging layout of build_vpp_batched_flat: all N Y
// planes [N,H,W], then all N UV planes [N,H/2,W] (the wrapper passes the
// two base pointers, so separate Y/UV tensors work as well).
//
// Bound: device-memory bytes. A pixel reads 1.5 B (Y and its share of UV)
// and writes 3 B (u8) or 12 B (f32); the arithmetic, some 20 flops a
// pixel, is far below the card's rate. At 3.35 TB/s:
//   N=128, 224x224, planar f32 (the headline loader): 86.70 MB -> 25.88 us
//   N=1, 1920x1080, merged u8:                          9.33 MB ->  2.79 us
//   N=16, 224x224, merged f32 (serving, one stream):   10.84 MB ->  3.24 us
//
// Two variants; ops/nv12_rgb.py::variant picks one from the shape and the
// pointers before the launch.
//
// ts_nv12_rgb_vec, the vector kernel, takes W % 16 == 0 (W <= 4096) with
// 16-byte aligned planes and output, which every layout of the main paths
// has. It rests on one fact: a band of whole rows of one frame is a
// contiguous span in every layout (Y rows, UV rows, each planar output
// channel, the merged output). What each part of its design does about
// what held the first design (the edge kernel below) back:
// - A block of 256 threads owns a band of row pairs (as many as give each
//   thread one 4-pixel group) and brings its Y and UV rows into shared
//   memory with two 1-D cp.async.bulk copies on one mbarrier, where the
//   first design made six 1-byte loads a thread for 4 pixels.
// - The grid is (bands, frames), so every index is 32-bit within a frame
//   and only the frame offset is 64-bit. A thread walks the band's
//   4-pixel groups by adding and subtracting; there is no division, where
//   the first design divided a 64-bit index in every thread (a software
//   routine of dozens of instructions).
// - x/255 is a lookup in kDiv255, the 256 correctly rounded quotients,
//   copied into shared memory by each block: the first design ran three
//   IEEE divisions (__fdiv_rn, a multi-instruction routine) a pixel.
// - A byte becomes a float through its bit pattern (0x4B0000bb is
//   2^23 + bb) and one exact subtraction, not a conversion instruction.
// - Consecutive lanes write consecutive 16-byte (f32) or 4-byte (u8)
//   pieces of the band's output into shared memory, free of bank
//   conflicts in every layout, and one thread writes the band out with at
//   most three cp.async.bulk stores (one a planar channel), which write
//   whole lines. The first design stored 4-byte or 1-byte values at
//   strides of 8, 12 or 3 bytes. A thread a strip of 16 columns x 2 rows
//   storing its 16-byte pieces straight to global memory was tried and
//   was slower than the first design at the headline: a warp's store then
//   touches 32 lines (PERF.md).
//
// ts_nv12_rgb, the edge kernel, takes every other even H and W: W not a
// multiple of 16, or a plane that is not 16-byte aligned, such as the UV
// plane of a flat staging buffer whose N*H*W is not a multiple of 16. It
// is the first design, unchanged: one thread per 2x2 luma quad with 64-bit
// indices.
//
// Rounding: every multiply and add uses an _rn intrinsic in the source
// order of ops/color.py (Rgb), so nvcc cannot contract them into FMAs (the
// library is also built with -fmad=false); the float cast truncates
// toward zero like astype(int32); x/255 is the IEEE quotient, computed by
// __fdiv_rn in the edge kernel and read from kDiv255 in the vector one.
#include <cuda_runtime.h>
#include <stdint.h>

#include "nv12.cuh"
#include "sm90.cuh"

namespace {

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

// ------------------------------------------------------------ edge kernel

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

// ---------------------------------------------------------- vector kernel

constexpr int kBandThreads = 256;

// Four channel values v (0..255) of a row: as the bytes of one word, first
// value lowest, or as v/255 read from the block's copy of kDiv255.
__device__ __forceinline__ void Put4(uint8_t* dst, const int* v,
                                     const float*) {
  *reinterpret_cast<uint32_t*>(dst) =
      __byte_perm(__byte_perm(v[0], v[1], 0x0040),
                  __byte_perm(v[2], v[3], 0x0040), 0x5410);
}

__device__ __forceinline__ void Put4(float* dst, const int* v,
                                     const float* div255) {
  *reinterpret_cast<float4*>(dst) =
      make_float4(div255[v[0]], div255[v[1]], div255[v[2]], div255[v[3]]);
}

// Block b of frame f converts row pairs [b*band, b*band + np) of the frame.
// Shared memory: the band's Y rows, its UV rows, then its output in the
// output's own layout (3 channel spans planar, one span merged).
template <typename T, bool kPlanar>
__global__ void __launch_bounds__(kBandThreads)
    Nv12RgbBandKernel(const uint8_t* __restrict__ y,
                      const uint8_t* __restrict__ uv, T* __restrict__ out,
                      int h, int w, int band, int swap_rb, int standard) {
  extern __shared__ __align__(128) uint8_t smem[];
  __shared__ float div255[256];
  __shared__ __align__(8) uint64_t bar;
  const int p0 = blockIdx.x * band;
  const int np = min(band, (h >> 1) - p0);
  const int plane = h * w;
  const int span = 2 * np * w;  // a channel's pixels in the band
  const size_t frame = blockIdx.y;
  uint8_t* const ys = smem;
  uint8_t* const uvs = smem + 2 * band * w;
  T* const os = reinterpret_cast<T*>(smem + 3 * band * w);
  const uint32_t bar_addr = sm90::SmemAddr(&bar);
  if (threadIdx.x == 0) {
    sm90::MbarInit(bar_addr, 1);
    sm90::FenceBarrierInit();
  }
  for (int i = threadIdx.x; i < 256; i += kBandThreads) div255[i] = kDiv255[i];
  __syncthreads();
  if (threadIdx.x == 0) {
    sm90::MbarExpectTx(bar_addr, 3 * np * w);
    sm90::BulkLoad(sm90::SmemAddr(ys), y + frame * plane + 2 * p0 * w, span,
                   bar_addr);
    sm90::BulkLoad(sm90::SmemAddr(uvs), uv + frame * (plane >> 1) + p0 * w,
                   np * w, bar_addr);
  }
  const Coefs k = kCoefs[standard];
  const int groups = w >> 2;  // 4-pixel groups a row
  int p = 0, g = threadIdx.x;  // this thread's row pair and group
  while (g >= groups) g -= groups, ++p;
  sm90::MbarWait(bar_addr, 0);
  while (p < np) {
    const uint32_t c = *reinterpret_cast<const uint32_t*>(uvs + p * w + 4 * g);
#pragma unroll
    for (int dy = 0; dy < 2; ++dy) {
      const int at = (2 * p + dy) * w + 4 * g;  // first pixel, in the band
      const uint32_t yw = *reinterpret_cast<const uint32_t*>(ys + at);
      int rgb[3][4];
#pragma unroll
      for (int px = 0; px < 4; ++px) {
        // Pixel px takes U/V pair px/2: bytes 2*(px/2) and 2*(px/2) + 1.
        int r, gr, b;
        Rgb(ByteF(yw, px, 0.0f), ByteF(c, px & 2, 128.0f),
            ByteF(c, (px & 2) + 1, 128.0f), k, &r, &gr, &b);
        if (swap_rb) {
          const int t = r;
          r = b;
          b = t;
        }
        rgb[0][px] = r;
        rgb[1][px] = gr;
        rgb[2][px] = b;
      }
      if (kPlanar) {
#pragma unroll
        for (int ch = 0; ch < 3; ++ch) {
          Put4(os + ch * span + at, rgb[ch], div255);
        }
      } else {
        int m[12];
#pragma unroll
        for (int px = 0; px < 4; ++px) {
#pragma unroll
          for (int ch = 0; ch < 3; ++ch) m[3 * px + ch] = rgb[ch][px];
        }
#pragma unroll
        for (int q = 0; q < 3; ++q) {
          Put4(os + 3 * at + 4 * q, m + 4 * q, div255);
        }
      }
    }
    g += kBandThreads;
    while (g >= groups) g -= groups, ++p;
  }
  sm90::FenceProxyAsync();
  __syncthreads();
  if (threadIdx.x == 0) {
    T* const dst = out + frame * 3 * plane + (kPlanar ? 1 : 3) * 2 * p0 * w;
    if (kPlanar) {
      for (int ch = 0; ch < 3; ++ch) {
        sm90::BulkStore(dst + ch * plane, sm90::SmemAddr(os + ch * span),
                        span * sizeof(T));
      }
    } else {
      sm90::BulkStore(dst, sm90::SmemAddr(os), 3 * span * sizeof(T));
    }
    sm90::BulkStoreDrain();
  }
}

template <typename T, bool kPlanar>
void Launch(bool vec, const uint8_t* y, const uint8_t* uv, void* out, int n,
            int h, int w, int swap_rb, int standard, cudaStream_t stream) {
  T* const o = static_cast<T*>(out);
  if (!vec) {
    constexpr int kThreads = 256;
    const long long quads = static_cast<long long>(h / 2) * (w / 2);
    const dim3 grid(static_cast<unsigned>((quads + kThreads - 1) / kThreads),
                    static_cast<unsigned>(n));
    Nv12RgbKernel<T, kPlanar><<<grid, kThreads, 0, stream>>>(
        y, uv, o, h, w, swap_rb, standard);
    return;
  }
  const int pairs = h / 2;
  const int pair_out = 6 * w * static_cast<int>(sizeof(T));  // output bytes
  // As many row pairs as give each thread at most one 4-pixel group; one
  // pair where a row has more groups than the block has threads.
  int band = 4 * kBandThreads / w;
  band = band < 1 ? 1 : (band > pairs ? pairs : band);
  const int smem = band * (3 * w + pair_out);  // at most 110,592 B (W 4096)
  cudaFuncSetAttribute(Nv12RgbBandKernel<T, kPlanar>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  const dim3 grid((pairs + band - 1) / band, n);
  Nv12RgbBandKernel<T, kPlanar><<<grid, kBandThreads, smem, stream>>>(
      y, uv, o, h, w, band, swap_rb, standard);
}

bool Aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

int Convert(bool vec, const void* y, const void* uv, void* out, int n, int h,
            int w, int swap_rb, int planar, int normalization, int standard,
            void* stream) {
  if (n <= 0 || n > 65535 || h <= 0 || w <= 0 || (h & 1) || (w & 1) ||
      standard < 0 || standard > 3) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // The vector kernel's rule, as ops/nv12_rgb.py::variant states it.
  if (vec && (w % 16 || w > 4096 || h >= 65536 || !Aligned16(y) ||
              !Aligned16(uv) || !Aligned16(out))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* yp = static_cast<const uint8_t*>(y);
  const auto* uvp = static_cast<const uint8_t*>(uv);
  const auto s = static_cast<cudaStream_t>(stream);
  if (normalization) {
    if (planar)
      Launch<float, true>(vec, yp, uvp, out, n, h, w, swap_rb, standard, s);
    else
      Launch<float, false>(vec, yp, uvp, out, n, h, w, swap_rb, standard, s);
  } else {
    if (planar)
      Launch<uint8_t, true>(vec, yp, uvp, out, n, h, w, swap_rb, standard, s);
    else
      Launch<uint8_t, false>(vec, yp, uvp, out, n, h, w, swap_rb, standard,
                             s);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points (bound with ctypes), one per variant, with the same
// arguments. Each launches on `stream` without synchronising and returns
// cudaGetLastError() (0 on success); the vector one returns
// cudaErrorInvalidValue for a shape or pointer outside its rule.
extern "C" int ts_nv12_rgb(const void* y, const void* uv, void* out, int n,
                           int h, int w, int swap_rb, int planar,
                           int normalization, int standard, void* stream) {
  return Convert(false, y, uv, out, n, h, w, swap_rb, planar, normalization,
                 standard, stream);
}

extern "C" int ts_nv12_rgb_vec(const void* y, const void* uv, void* out,
                               int n, int h, int w, int swap_rb, int planar,
                               int normalization, int standard,
                               void* stream) {
  return Convert(true, y, uv, out, n, h, w, swap_rb, planar, normalization,
                 standard, stream);
}
