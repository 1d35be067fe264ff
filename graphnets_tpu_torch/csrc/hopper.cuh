// Hopper (sm_90a) building blocks shared by the port's tensor-core
// kernels (fused_ffn.cu, fused_ffn_bwd.cu, ln_linear_bwd.cu, and the edge
// updates' edge_wgmma.cuh): mbarriers, TMA tile loads and stores and their
// tensor maps, and the warpgroup matrix multiply (wgmma) with its
// shared-memory descriptors.
//
// Conventions.  Every operand tile in shared memory is bf16 in the
// 128-byte-swizzled layout that a TMA load with CU_TENSOR_MAP_SWIZZLE_128B
// writes: rows of 64 values (128 bytes), 8-row groups 1024 bytes apart,
// the 16-byte chunk c of row r stored at chunk c ^ (r % 8).  Tiles start
// on 1024-byte boundaries.  A K-major operand has K along those 128-byte
// rows; an MN-major one has M (or N) along them, one 128-byte row per k.
//
// Accumulator layout of wgmma m64nNk16 with f32 results: register i of a
// thread (warp w of the warpgroup, lane l) holds row
// 16 * w + l / 4 + 8 * ((i / 2) % 2) and column 8 * (i / 4) + 2 * (l % 4)
// + i % 2.  For the product with A from registers, the A fragment of one
// k16 step is four 32-bit registers of bf16 pairs in the same order:
// (row, k) = (r, 2 (l % 4)), (r + 8, ...), (r, 8 + 2 (l % 4)),
// (r + 8, ...), so the f32 accumulator of m64n16 packs pairwise into it.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>

namespace hopper {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count));
}

// After the barriers are initialised, before any thread uses them.
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Returns once the phase of parity `parity` of the barrier has completed.
// A wait that never ends (a fault in a kernel's protocol) traps after about
// 2^28 polls, seconds past any legitimate wait: the launch then fails with
// an error instead of holding the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t polls = 0; !done; ++polls) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (polls == (1u << 28)) __trap();
  }
}

// One box of `map` at (c0 = column, c1 = row) into shared memory; its
// bytes complete on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

// One box of `map` from shared memory to (c0 = column, c1 = row); rows and
// columns past the matrix are not written.  Completes in the thread's
// current bulk group (bulk_commit()).
__device__ __forceinline__ void tma_store(const CUtensorMap* map,
                                          uint32_t src, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%1, %2}], "
      "[%3];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(c0), "r"(c1), "r"(src)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// Waits until at most N of the thread's bulk groups still read their shared
// memory source (.read) or are still writing device memory.
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}
template <int N>
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group %0;\n" ::"n"(N) : "memory");
}

// Makes the thread's ordinary shared-memory stores visible to the async
// proxy (wgmma operand reads, TMA).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Barrier `ID` over the first `N` threads of the block (N % 32 == 0).
template <int ID, int N>
__device__ __forceinline__ void named_sync() {
  asm volatile("bar.sync %0, %1;\n" ::"n"(ID), "n"(N) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving accumulator registers across the
// asynchronous products.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Shared-memory matrix descriptor, 128-byte swizzle.  K-major tiles: rows
// of 128 bytes, 8-row groups 1024 bytes apart (SBO); the leading offset is
// unused.  MN-major tiles: each k is a 128-byte row of 64 MN values, 8-k
// groups 1024 bytes apart (SBO), the next 64 MN values `lbo` bytes on.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo) {
  uint64_t d = (uint64_t)((addr & 0x3FFFF) >> 4);
  d |= (uint64_t)((lbo >> 4) & 0x3FFF) << 16;
  d |= (uint64_t)(1024 >> 4) << 32;
  d |= (uint64_t)1 << 62;
  return d;
}

// d[64 x 128] += A[64 x 16] @ B[16 x 128], both operands in shared memory
// (128-byte swizzle), f32 accumulate.  TA / TB: 0 for a K-major operand,
// 1 for an MN-major one.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da,
                                                 uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, %67, %68;\n"
      "}\n"
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
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

// d[64 x 64] += A[64 x 16] @ B[16 x 64], both operands in shared memory.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], uint64_t da,
                                                uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, %35, %36;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

// d[64 x 64] += A[64 x 16] @ B[16 x 64] with A from registers (four bf16
// pairs a thread, in the accumulator's order; see the top of this file)
// and B in shared memory (TB as above).
template <int TB>
__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[32],
                                                   const uint32_t (&a)[4],
                                                   uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1),
        "n"(TB));
}

// Two f32 values rounded to a bf16 pair in one 32-bit register (the first
// in the low half).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Byte offset of the 16-byte chunk `c` of row `r` in a 128-byte-swizzled
// tile of 128-byte rows.
__device__ __forceinline__ uint32_t swz128(int r, int c) {
  return (uint32_t)(r * 128 + ((c ^ (r & 7)) << 4));
}

// ---- host side -------------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up in libcuda.so.1 as the runtime has
// loaded it (so a kernel library links against nothing but the runtime).
inline EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (lib == nullptr) lib = dlopen("libcuda.so.1", RTLD_NOW);
    if (lib != nullptr)
      fn = reinterpret_cast<EncodeTiled>(dlsym(lib, "cuTensorMapEncodeTiled"));
  }
  return fn;
}

// A tensor map of the row-major bf16 (or, with elem_bytes = 4, f32)
// [rows, cols] matrix at `ptr` whose boxes are [box_rows, 128 bytes] (64
// bf16 or 32 f32 values a row, 128-byte swizzle); reads past the matrix
// return zeros.  Returns 0 or a cudaError_t.
inline int make_map(CUtensorMap* map, const void* ptr, int rows, int cols,
                    int box_rows, int elem_bytes = 2) {
  EncodeTiled fn = encoder();
  if (fn == nullptr) return cudaErrorSharedObjectSymbolNotFound;
  // The encoder is a driver call and needs the context of the pointer's
  // device current on this thread.  A thread on which this library's
  // runtime has made no call yet (a framework's worker thread, such as
  // autograd's) may have none: selecting the device binds it.
  cudaPointerAttributes attr;
  cudaError_t err = cudaPointerGetAttributes(&attr, ptr);
  if (err == cudaSuccess) err = cudaSetDevice(attr.device);
  if (err != cudaSuccess) return err;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * elem_bytes};
  const cuuint32_t box[2] = {(cuuint32_t)(128 / elem_bytes),
                             (cuuint32_t)box_rows};
  const cuuint32_t estr[2] = {1, 1};
  const CUresult r = fn(map,
                        elem_bytes == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                        : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                        2,
                        const_cast<void*>(ptr), dims, strides, box, estr,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : cudaErrorInvalidValue;
}

}  // namespace hopper
