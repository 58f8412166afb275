// Pieces the two Hopper (sm_90a) conv bodies share (bf16_conv_sm90.cuh,
// int8_conv_sm90.cuh): shared-memory addresses, mbarriers, the TMA tile
// load, wgmma matrix descriptors and fences, the warpgroup barrier, and the
// host's one-time set-up of a launch (the tensor-map encoder looked up
// through the runtime, so no library needs -lcuda; the shared-memory
// attribute and SM count per device; each layer's weight map encoded once
// per pointer).

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <map>
#include <mutex>
#include <utility>

namespace sm90 {
// internal linkage: a function-local static of a template with external
// linkage is one object across every loaded library that instantiates it
namespace {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                            uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

// matrix descriptor: start address, leading and stride byte offsets, layout
// (0: no swizzle, 1: 128-byte swizzle)
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                         uint64_t layout) {
  return static_cast<uint64_t>((addr >> 4) & 0x3FFF) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (layout << 62);
}

__device__ __forceinline__ void st_zero16(uint32_t addr) {
  asm volatile("st.shared.v4.u32 [%0], {%1, %1, %1, %1};\n" ::"r"(addr), "r"(0) : "memory");
}

// the warpgroup's own barrier (id 1 + wg; 0 is __syncthreads)
__device__ __forceinline__ void wg_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
}

// keep the compiler from moving accumulator registers across the
// asynchronous products
template <int N>
__device__ __forceinline__ void fence_operands(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_operands(int (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

constexpr int MAX_DEVICES = 64;
constexpr size_t MAX_MAPS = 4096;  // cached weight maps before the cache starts over

// What a kernel's launches need besides their arguments, set up once: the
// encoder cuTensorMapEncodeTiled, per device the SM count (0 until the
// kernel's attribute is set), the weight maps by pointer and row count.
struct HostState {
  std::mutex mu;
  EncodeTiled encode = nullptr;
  int sms[MAX_DEVICES] = {};
  std::map<std::pair<uintptr_t, cuuint64_t>, CUtensorMap> maps;
};

// A layer's weights as the kernel's TMA reads them: a 2-D tensor of
// `dtype`, dims[0] elements a row (stride row_bytes), dims[1] rows, loaded
// in boxes of box[0] x box[1] with the 128-byte swizzle wgmma reads.
struct WeightMap {
  CUtensorMapDataType dtype;
  cuuint64_t dims[2];
  cuuint64_t row_bytes;
  cuuint32_t box[2];
};

// Sets up a launch of `kernel` on the current device: the encoder, the
// kernel's shared-memory attribute and the SM count (once per device), and
// the weight map of `w` (once per pointer and row count). Returns 0, a cudaError_t, or
// minus a CUresult of the encoder.
int prepare_launch(HostState& host, const void* kernel, int smem_bytes, const void* w,
                   const WeightMap& layout, CUtensorMap* wmap, int* sms) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev >= MAX_DEVICES) return static_cast<int>(cudaErrorInvalidDevice);
  std::lock_guard<std::mutex> lock(host.mu);
  if (!host.encode) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &fn, 12000, cudaEnableDefault,
                                         &found);
#else
    e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
#endif
    if (e != cudaSuccess) return static_cast<int>(e);
    if (found != cudaDriverEntryPointSuccess || !fn) return static_cast<int>(cudaErrorNotSupported);
    host.encode = reinterpret_cast<EncodeTiled>(fn);
  }
  if (!host.sms[dev]) {
    if ((e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  smem_bytes)) != cudaSuccess ||
        (e = cudaDeviceGetAttribute(&host.sms[dev], cudaDevAttrMultiProcessorCount, dev)) !=
            cudaSuccess)
      return static_cast<int>(e);
  }
  *sms = host.sms[dev];
  const std::pair<uintptr_t, cuuint64_t> key(reinterpret_cast<uintptr_t>(w), layout.dims[1]);
  auto it = host.maps.find(key);
  if (it == host.maps.end()) {
    if (host.maps.size() >= MAX_MAPS) host.maps.clear();
    CUtensorMap map;
    const cuuint64_t strides[1] = {layout.row_bytes};
    const cuuint32_t ones[2] = {1, 1};
    CUresult r = host.encode(&map, layout.dtype, 2, const_cast<void*>(w), layout.dims, strides,
                             layout.box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE,
                             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    if (r != CUDA_SUCCESS) return -static_cast<int>(r);
    it = host.maps.emplace(key, map).first;
  }
  *wmap = it->second;
  return 0;
}

}  // namespace
}  // namespace sm90
