// Helpers shared by the deformable-attention kernels (deform_attn_2d.cu and
// deform_attn_2d_bwd.cu): value loads, mbarriers, the TMA tile copy and the
// tensor map that describes a value tensor to the TMA unit.  Each kernel
// source builds into its own library, so everything here has internal
// linkage.  ops/build.py hashes this header into every library's name.

#pragma once

#include <cuda.h>  // CUtensorMap; the encoder comes through the runtime
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// values a lane loads at once: one fp32, or a bf16 pair
template <typename T> struct LaneVals;
template <> struct LaneVals<float> { static constexpr int kN = 1; };
template <> struct LaneVals<__nv_bfloat16> { static constexpr int kN = 2; };

__device__ __forceinline__ void load_vals(const float* p, float (&v)[1]) {
  v[0] = *p;
}
__device__ __forceinline__ void load_vals(const __nv_bfloat16* p,
                                          float (&v)[2]) {
  const float2 f =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
  v[0] = f.x;
  v[1] = f.y;
}
__device__ __forceinline__ void store_val(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_val(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar))
               : "memory");
}
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}
// Returns once the phase of the given parity has completed.  A wait that
// outlasts 2^26 tries (each try suspends the thread for a while; seconds
// in all, where a tile takes microseconds) traps, so a fault in the
// barrier protocol ends the launch with an error instead of hanging it.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done;
  for (uint32_t tries = 0;; ++tries) {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.b32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (tries == (1u << 26)) __trap();
  }
}
// TMA copy of the box at (c0, c1, c2, c3) of a 4D tensor map into `dst`.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            int c0, int c1, int c2, int c3,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(smem_u32(bar))
      : "memory");
}

// The row `off` bytes past `vs`, the lane's first value in the tile.
template <typename T>
__device__ __forceinline__ const T* row_at(const T* vs, int off) {
  return reinterpret_cast<const T*>(reinterpret_cast<const char*>(vs) + off);
}

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// Describes value (bs, H*W, heads, d) as the 4D tensor (d, heads, W, bs*H),
// innermost first, whose box (d, 1, W, H) is one (slot, head) tile.  The
// driver's encoder comes through the runtime, so the library links no
// driver library.
inline cudaError_t encode_value_map(CUtensorMap* map, const void* value,
                                    int bf16, int bs, int H, int W, int heads,
                                    int d) {
  static EncodeTiledFn encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &fn, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess || fn == nullptr)
      return cudaErrorNotSupported;
    encode = reinterpret_cast<EncodeTiledFn>(fn);
  }
  const cuuint64_t elt = bf16 ? 2 : 4;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(d),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(W),
                              static_cast<cuuint64_t>(bs) * H};
  const cuuint64_t strides[3] = {d * elt, heads * d * elt,
                                 static_cast<cuuint64_t>(W) * heads * d * elt};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(d), 1,
                             static_cast<cuuint32_t>(W),
                             static_cast<cuuint32_t>(H)};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUtensorMapDataType type = bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                        : CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  const CUresult res = encode(
      map, type, 4, const_cast<void*>(value), dims, strides, box, unit,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The TMA unit takes rows of a multiple of 16 bytes at a 16-byte aligned
// address, and boxes of at most 256 a side.
inline bool tma_takes(const void* value, int d, int elt, int row_stride,
                      int H, int W) {
  return (d * elt) % 16 == 0 && row_stride == d && H <= 256 && W <= 256 &&
         reinterpret_cast<uintptr_t>(value) % 16 == 0;
}

}  // namespace
