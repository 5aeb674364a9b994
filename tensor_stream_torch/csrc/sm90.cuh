// Hopper (sm_90a) building blocks in inline PTX: mbarriers, TMA tile
// loads, 1-D bulk copies, wgmma shared-memory descriptors and the wgmma
// shapes the flash kernels issue. Each wrapper is one or a few PTX
// instructions; the PTX ISA's sections on mbarrier, cp.async.bulk,
// cp.async.bulk.tensor and wgmma.mma_async define what they do. On the
// host side, EncodeMap builds the TMA tensor map of a [B, heads, S, d]
// bf16 tensor.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace sm90 {

__device__ __forceinline__ uint32_t SmemAddr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ------------------------------------------------------------ mbarriers

__device__ __forceinline__ void MbarInit(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

// Makes the initialised barriers visible to the async proxy (TMA).
__device__ __forceinline__ void FenceBarrierInit() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void MbarArrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Arrives once and adds `bytes` to the transactions the phase waits for.
__device__ __forceinline__ void MbarExpectTx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

// Returns once the phase of parity `parity` has completed. The retry loop
// is inside the PTX (its labels are local to the braces), so a warp leaves
// it converged, as the .aligned wgmma instructions after it require.
__device__ __forceinline__ void MbarWait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra LAB_WAIT;\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// ------------------------------------------------------------------ TMA

// One contiguous span of `bytes` (a multiple of 16, both addresses 16-byte
// aligned), global -> shared; completion is counted in bytes on `bar`.
__device__ __forceinline__ void BulkLoad(uint32_t dst, const void* src,
                                         uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// One contiguous span, shared -> global, in the thread's bulk group.
__device__ __forceinline__ void BulkStore(void* dst, uint32_t src,
                                          uint32_t bytes) {
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(
          dst),
      "r"(src), "r"(bytes)
      : "memory");
}

// Commits the thread's bulk stores and waits until they have read shared
// memory; the writes to global memory then complete on their own.
__device__ __forceinline__ void BulkStoreDrain() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// Orders this thread's shared-memory writes before later reads by the
// async proxy (a bulk store); a barrier must follow before the store.
__device__ __forceinline__ void FenceProxyAsync() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// One box of a 4-D tensor map, global -> shared; completion is counted
// in bytes on `bar`. Out-of-bounds elements of the box are zero-filled.
__device__ __forceinline__ void TmaLoad4d(uint32_t dst, const CUtensorMap* map,
                                          uint32_t bar, int c0, int c1,
                                          int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// ----------------------------------------------------------------- math

// 2^x in one MUFU.EX2 (max relative error 2^-22); results below the
// smallest normal float flush to 0. exp2f without fast math adds a range
// check and two predicated multiplies around it to keep those denormals.
__device__ __forceinline__ float Exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// ---------------------------------------------------------------- wgmma

// Shared-memory matrix descriptor for a tile that TMA wrote with a 64- or
// 128-byte swizzle: rows of `row_bytes` (64 or 128), 8-row groups
// 8 * row_bytes apart, the tile 8 * row_bytes aligned. Both byte offsets
// are set to the 8-row stride: an operand that spans one swizzle atom in
// its contiguous dimension (K for K-major, N for MN-major) reads only
// that one, whichever field the layout takes it from.
__device__ __forceinline__ uint64_t Desc(uint32_t addr, int row_bytes) {
  const uint64_t group = static_cast<uint64_t>(8 * row_bytes) >> 4;
  const uint64_t layout = row_bytes == 128 ? 1 : 2;  // 128B or 64B swizzle
  return static_cast<uint64_t>((addr >> 4) & 0x3FFF) | (group << 16) |
         (group << 32) | (layout << 62);
}

__device__ __forceinline__ void WgmmaFence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void WgmmaCommit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Waits until at most N committed wgmma groups are still in flight.
template <int N>
__device__ __forceinline__ void WgmmaWait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Ties registers to the point after a wait: the compiler may not read an
// accumulator before the wgmma that writes it has been waited for.
template <int N>
__device__ __forceinline__ void FenceRegs(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void FenceRegs(uint32_t* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// Moves registers between warpgroups: the calling warpgroup's threads
// drop to (dec) or grow to (inc) N registers each.
template <int N>
__device__ __forceinline__ void SetMaxRegsDec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void SetMaxRegsInc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// D[64 x 128] (+)= A[64 x 16] B[16 x 128], A and B K-major in shared
// memory. Accumulator fragment of thread t of the warpgroup, warp w = t/32,
// g = (t%32)/4, c = t%4: d[4j+e] is row 16w + g + 8(e/2), column
// 8j + 2c + (e%2).
__device__ __forceinline__ void WgmmaSS128(float* d, uint64_t da, uint64_t db,
                                           int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D[64 x 64] += A[64 x 16] B[16 x 64], A and B K-major in shared memory;
// the accumulator fragment as WgmmaSS128's, 8 columns fewer a j.
__device__ __forceinline__ void WgmmaSS64(float* d, uint64_t da,
                                          uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

// D[64 x 64] = A[64 x 16] B[16 x 64], as WgmmaSS64 with scale-d false,
// its registers outputs only. It is the first k-step of a product whose
// accumulator is not carried over, so the compiler sees no use of the
// old value (with "+f" it may copy the registers between the wgmmas of a
// loop, which makes ptxas serialize them).
__device__ __forceinline__ void WgmmaSS64Init(float* d, uint64_t da,
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]),
        "=f"(d[4]), "=f"(d[5]), "=f"(d[6]), "=f"(d[7]),
        "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]),
        "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15]),
        "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]),
        "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]),
        "=f"(d[24]), "=f"(d[25]), "=f"(d[26]), "=f"(d[27]),
        "=f"(d[28]), "=f"(d[29]), "=f"(d[30]), "=f"(d[31])
      : "l"(da), "l"(db), "r"(0));
}

// D[64 x 16] = A[64 x 16] B[16 x 16] and D += A B, A and B K-major in
// shared memory: WgmmaSS64Init and WgmmaSS64 at N = 16 (d[4j + e], j < 2).
__device__ __forceinline__ void WgmmaSS16Init(float* d, uint64_t da,
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, %8, %9, p, 1, 1, 0, 0;\n}\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]),
        "=f"(d[4]), "=f"(d[5]), "=f"(d[6]), "=f"(d[7])
      : "l"(da), "l"(db), "r"(0));
}

__device__ __forceinline__ void WgmmaSS16(float* d, uint64_t da,
                                          uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, %8, %9, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(1));
}

// D[64 x 64] (+)= A[64 x 16] B[16 x 64] from shared memory, B MN-major
// (its transpose bit set: B's 64 columns are one swizzle atom's contiguous
// run, the 16 k rows two 8-row groups) and A K-major (WgmmaSS64KN) or
// MN-major too (WgmmaSS64MN, the same for A's 64 rows); the Init forms
// with scale-d false, their registers outputs only (see WgmmaSS64Init).
#define TS_WGMMA_SS64_TRANS(NAME, TA, OUT, SCALE)                            \
  __device__ __forceinline__ void NAME(float* d, uint64_t da, uint64_t db) { \
    asm volatile(                                                            \
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"                        \
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"             \
        "%0, %1, %2, %3, %4, %5, %6, %7, "                                   \
        "%8, %9, %10, %11, %12, %13, %14, %15, "                             \
        "%16, %17, %18, %19, %20, %21, %22, %23, "                           \
        "%24, %25, %26, %27, %28, %29, %30, %31"                             \
        "}, %32, %33, p, 1, 1, " TA ", 1;\n}\n"                              \
        : OUT(d[0]), OUT(d[1]), OUT(d[2]), OUT(d[3]), OUT(d[4]), OUT(d[5]),  \
          OUT(d[6]), OUT(d[7]), OUT(d[8]), OUT(d[9]), OUT(d[10]),            \
          OUT(d[11]), OUT(d[12]), OUT(d[13]), OUT(d[14]), OUT(d[15]),        \
          OUT(d[16]), OUT(d[17]), OUT(d[18]), OUT(d[19]), OUT(d[20]),        \
          OUT(d[21]), OUT(d[22]), OUT(d[23]), OUT(d[24]), OUT(d[25]),        \
          OUT(d[26]), OUT(d[27]), OUT(d[28]), OUT(d[29]), OUT(d[30]),        \
          OUT(d[31])                                                         \
        : "l"(da), "l"(db), "r"(SCALE));                                     \
  }
TS_WGMMA_SS64_TRANS(WgmmaSS64KN, "0", "+f", 1)
TS_WGMMA_SS64_TRANS(WgmmaSS64MN, "1", "+f", 1)
TS_WGMMA_SS64_TRANS(WgmmaSS64MNInit, "1", "=f", 0)
#undef TS_WGMMA_SS64_TRANS

// D[64 x 64] += A[64 x 16] B[16 x 64], A from registers (the mma.sync
// m16n8k16 A fragment of warp w's 16 rows: a0 (row g, k 2c..2c+1),
// a1 (g+8, 2c..), a2 (g, 2c+8..), a3 (g+8, 2c+8..)), B MN-major in shared
// memory (the transpose bit set). WgmmaRS32 is the same at N = 32.
__device__ __forceinline__ void WgmmaRS64(float* d, const uint32_t* a,
                                          uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void WgmmaRS32(float* d, const uint32_t* a,
                                          uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// ------------------------------------------------------------ host side

// libcuda's cuTensorMapEncodeTiled, looked up through the CUDA runtime,
// so a library links no -lcuda.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

inline EncodeTiled Encoder() {
  static const EncodeTiled fn = [] {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(ptr)
               : nullptr;
  }();
  return fn;
}

// A bf16 [B, heads, S, d] tensor with element strides (sb, sh, ss) as the
// 4-D map (d, S, heads, B), in boxes of `rows` rows by `cols` columns
// with the 128-byte swizzle (64-byte where a box row is 64 bytes).
// Elements of a box past S read as zeros.
inline bool EncodeMap(CUtensorMap* map, const void* ptr, int d, int s,
                      int heads, int batch, long long sb, long long sh,
                      long long ss, int rows, int cols) {
  const EncodeTiled encode = Encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(d),
                              static_cast<cuuint64_t>(s),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(batch)};
  cuuint64_t strides[3] = {static_cast<cuuint64_t>(ss) * 2,
                           static_cast<cuuint64_t>(sh) * 2,
                           static_cast<cuuint64_t>(sb) * 2};
  // A dimension of extent 1 is never stepped over: give it a stride the
  // map accepts whatever the caller's was.
  for (int i = 0; i < 3; ++i) {
    if (dims[i + 1] == 1)
      strides[i] = i == 0 ? dims[0] * 2 : strides[i - 1] * dims[i];
  }
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(cols),
                             static_cast<cuuint32_t>(rows), 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(ptr), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE,
                cols * 2 == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                                : CU_TENSOR_MAP_SWIZZLE_64B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The SMs of the current device, read once a device.
inline int SmCount() {
  static int counts[64];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 132;
  if (counts[dev] == 0) {
    int n = 0;
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    counts[dev] = n > 0 ? n : 132;
  }
  return counts[dev];
}

}  // namespace sm90
