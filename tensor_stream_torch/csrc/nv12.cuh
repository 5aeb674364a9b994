// NV12 -> RGB of one pixel, shared by the kernels that convert NV12:
// csrc/nv12_rgb.cu (the full-frame conversion) and csrc/clip_augment.cu
// (the clip augmentation that reads NV12 and converts in its taps). Both
// must give the bytes of ops/color.py::nv12_to_rgb, so both take the
// coefficient table, the x/255 table and the per-pixel arithmetic from
// here. Each including file is its own library; the tables are internal
// to it.
#pragma once

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

// i/255 for i = 0..255, each the IEEE quotient float(i) / 255.0f, as hex
// float literals (tests/test_torch_nv12.py parses and checks every entry).
__constant__ float kDiv255[256] = {
    0x0p+0f, 0x1.010102p-8f, 0x1.010102p-7f, 0x1.818182p-7f,
    0x1.010102p-6f, 0x1.414142p-6f, 0x1.818182p-6f, 0x1.c1c1c2p-6f,
    0x1.010102p-5f, 0x1.212122p-5f, 0x1.414142p-5f, 0x1.616162p-5f,
    0x1.818182p-5f, 0x1.a1a1a2p-5f, 0x1.c1c1c2p-5f, 0x1.e1e1e2p-5f,
    0x1.010102p-4f, 0x1.111112p-4f, 0x1.212122p-4f, 0x1.313132p-4f,
    0x1.414142p-4f, 0x1.515152p-4f, 0x1.616162p-4f, 0x1.717172p-4f,
    0x1.818182p-4f, 0x1.919192p-4f, 0x1.a1a1a2p-4f, 0x1.b1b1b2p-4f,
    0x1.c1c1c2p-4f, 0x1.d1d1d2p-4f, 0x1.e1e1e2p-4f, 0x1.f1f1f2p-4f,
    0x1.010102p-3f, 0x1.09090ap-3f, 0x1.111112p-3f, 0x1.19191ap-3f,
    0x1.212122p-3f, 0x1.29292ap-3f, 0x1.313132p-3f, 0x1.39393ap-3f,
    0x1.414142p-3f, 0x1.49494ap-3f, 0x1.515152p-3f, 0x1.59595ap-3f,
    0x1.616162p-3f, 0x1.69696ap-3f, 0x1.717172p-3f, 0x1.79797ap-3f,
    0x1.818182p-3f, 0x1.89898ap-3f, 0x1.919192p-3f, 0x1.99999ap-3f,
    0x1.a1a1a2p-3f, 0x1.a9a9aap-3f, 0x1.b1b1b2p-3f, 0x1.b9b9bap-3f,
    0x1.c1c1c2p-3f, 0x1.c9c9cap-3f, 0x1.d1d1d2p-3f, 0x1.d9d9dap-3f,
    0x1.e1e1e2p-3f, 0x1.e9e9eap-3f, 0x1.f1f1f2p-3f, 0x1.f9f9fap-3f,
    0x1.010102p-2f, 0x1.050506p-2f, 0x1.09090ap-2f, 0x1.0d0d0ep-2f,
    0x1.111112p-2f, 0x1.151516p-2f, 0x1.19191ap-2f, 0x1.1d1d1ep-2f,
    0x1.212122p-2f, 0x1.252526p-2f, 0x1.29292ap-2f, 0x1.2d2d2ep-2f,
    0x1.313132p-2f, 0x1.353536p-2f, 0x1.39393ap-2f, 0x1.3d3d3ep-2f,
    0x1.414142p-2f, 0x1.454546p-2f, 0x1.49494ap-2f, 0x1.4d4d4ep-2f,
    0x1.515152p-2f, 0x1.555556p-2f, 0x1.59595ap-2f, 0x1.5d5d5ep-2f,
    0x1.616162p-2f, 0x1.656566p-2f, 0x1.69696ap-2f, 0x1.6d6d6ep-2f,
    0x1.717172p-2f, 0x1.757576p-2f, 0x1.79797ap-2f, 0x1.7d7d7ep-2f,
    0x1.818182p-2f, 0x1.858586p-2f, 0x1.89898ap-2f, 0x1.8d8d8ep-2f,
    0x1.919192p-2f, 0x1.959596p-2f, 0x1.99999ap-2f, 0x1.9d9d9ep-2f,
    0x1.a1a1a2p-2f, 0x1.a5a5a6p-2f, 0x1.a9a9aap-2f, 0x1.adadaep-2f,
    0x1.b1b1b2p-2f, 0x1.b5b5b6p-2f, 0x1.b9b9bap-2f, 0x1.bdbdbep-2f,
    0x1.c1c1c2p-2f, 0x1.c5c5c6p-2f, 0x1.c9c9cap-2f, 0x1.cdcdcep-2f,
    0x1.d1d1d2p-2f, 0x1.d5d5d6p-2f, 0x1.d9d9dap-2f, 0x1.dddddep-2f,
    0x1.e1e1e2p-2f, 0x1.e5e5e6p-2f, 0x1.e9e9eap-2f, 0x1.ededeep-2f,
    0x1.f1f1f2p-2f, 0x1.f5f5f6p-2f, 0x1.f9f9fap-2f, 0x1.fdfdfep-2f,
    0x1.010102p-1f, 0x1.030304p-1f, 0x1.050506p-1f, 0x1.070708p-1f,
    0x1.09090ap-1f, 0x1.0b0b0cp-1f, 0x1.0d0d0ep-1f, 0x1.0f0f1p-1f,
    0x1.111112p-1f, 0x1.131314p-1f, 0x1.151516p-1f, 0x1.171718p-1f,
    0x1.19191ap-1f, 0x1.1b1b1cp-1f, 0x1.1d1d1ep-1f, 0x1.1f1f2p-1f,
    0x1.212122p-1f, 0x1.232324p-1f, 0x1.252526p-1f, 0x1.272728p-1f,
    0x1.29292ap-1f, 0x1.2b2b2cp-1f, 0x1.2d2d2ep-1f, 0x1.2f2f3p-1f,
    0x1.313132p-1f, 0x1.333334p-1f, 0x1.353536p-1f, 0x1.373738p-1f,
    0x1.39393ap-1f, 0x1.3b3b3cp-1f, 0x1.3d3d3ep-1f, 0x1.3f3f4p-1f,
    0x1.414142p-1f, 0x1.434344p-1f, 0x1.454546p-1f, 0x1.474748p-1f,
    0x1.49494ap-1f, 0x1.4b4b4cp-1f, 0x1.4d4d4ep-1f, 0x1.4f4f5p-1f,
    0x1.515152p-1f, 0x1.535354p-1f, 0x1.555556p-1f, 0x1.575758p-1f,
    0x1.59595ap-1f, 0x1.5b5b5cp-1f, 0x1.5d5d5ep-1f, 0x1.5f5f6p-1f,
    0x1.616162p-1f, 0x1.636364p-1f, 0x1.656566p-1f, 0x1.676768p-1f,
    0x1.69696ap-1f, 0x1.6b6b6cp-1f, 0x1.6d6d6ep-1f, 0x1.6f6f7p-1f,
    0x1.717172p-1f, 0x1.737374p-1f, 0x1.757576p-1f, 0x1.777778p-1f,
    0x1.79797ap-1f, 0x1.7b7b7cp-1f, 0x1.7d7d7ep-1f, 0x1.7f7f8p-1f,
    0x1.818182p-1f, 0x1.838384p-1f, 0x1.858586p-1f, 0x1.878788p-1f,
    0x1.89898ap-1f, 0x1.8b8b8cp-1f, 0x1.8d8d8ep-1f, 0x1.8f8f9p-1f,
    0x1.919192p-1f, 0x1.939394p-1f, 0x1.959596p-1f, 0x1.979798p-1f,
    0x1.99999ap-1f, 0x1.9b9b9cp-1f, 0x1.9d9d9ep-1f, 0x1.9f9fap-1f,
    0x1.a1a1a2p-1f, 0x1.a3a3a4p-1f, 0x1.a5a5a6p-1f, 0x1.a7a7a8p-1f,
    0x1.a9a9aap-1f, 0x1.ababacp-1f, 0x1.adadaep-1f, 0x1.afafbp-1f,
    0x1.b1b1b2p-1f, 0x1.b3b3b4p-1f, 0x1.b5b5b6p-1f, 0x1.b7b7b8p-1f,
    0x1.b9b9bap-1f, 0x1.bbbbbcp-1f, 0x1.bdbdbep-1f, 0x1.bfbfcp-1f,
    0x1.c1c1c2p-1f, 0x1.c3c3c4p-1f, 0x1.c5c5c6p-1f, 0x1.c7c7c8p-1f,
    0x1.c9c9cap-1f, 0x1.cbcbccp-1f, 0x1.cdcdcep-1f, 0x1.cfcfdp-1f,
    0x1.d1d1d2p-1f, 0x1.d3d3d4p-1f, 0x1.d5d5d6p-1f, 0x1.d7d7d8p-1f,
    0x1.d9d9dap-1f, 0x1.dbdbdcp-1f, 0x1.dddddep-1f, 0x1.dfdfep-1f,
    0x1.e1e1e2p-1f, 0x1.e3e3e4p-1f, 0x1.e5e5e6p-1f, 0x1.e7e7e8p-1f,
    0x1.e9e9eap-1f, 0x1.ebebecp-1f, 0x1.ededeep-1f, 0x1.efeffp-1f,
    0x1.f1f1f2p-1f, 0x1.f3f3f4p-1f, 0x1.f5f5f6p-1f, 0x1.f7f7f8p-1f,
    0x1.f9f9fap-1f, 0x1.fbfbfcp-1f, 0x1.fdfdfep-1f, 0x1p+0f,
};

__device__ __forceinline__ int Clamp255(int v) { return min(max(v, 0), 255); }

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

// Byte `sel` of `word` as a float, minus `bias` (0 or 128), bit for bit
// static_cast<float>(byte - bias): 0x4B0000bb is the float 2^23 + bb, and
// subtracting 2^23 + bias from it is exact.
__device__ __forceinline__ float ByteF(uint32_t word, int sel, float bias) {
  return __fsub_rn(
      __uint_as_float(__byte_perm(word, 0x4B000000u, 0x7440u | sel)),
      8388608.0f + bias);
}

}  // namespace
