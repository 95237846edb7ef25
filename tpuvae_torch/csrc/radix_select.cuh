// Order-preserving int32 keys and the warp helpers of an exact radix
// select over them.
//
// Included by cluster_select.cuh (the cluster-wide median rank of the
// tuning kernel, tuning.cu, and of the masked-median select kernel,
// select.cu).  A float is mapped to a "biased" int32 key whose signed
// order is the float's total order (tpuvae.dsp.chroma _float_order_key
// viewed as int32): non-negative floats keep their bits, negative floats
// flip their 31 low bits.  Masked-out elements carry the sentinel
// INT32_MAX, which sorts above every finite key.  The select fixes a key
// 8 bits at a time, most significant first, from 256-counter digit
// histograms (kRadixBins); the result is the exact order statistic.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace tpuvae {

constexpr int32_t kKeySentinel = 0x7FFFFFFF;
constexpr int kRadixBins = 256;

__device__ __forceinline__ int32_t float_order_key(float x) {
  const int32_t b = __float_as_int(x);
  return b >= 0 ? b : (b ^ 0x7FFFFFFF);
}

__device__ __forceinline__ float key_to_float(int32_t k) {
  return __int_as_float(k >= 0 ? k : (k ^ 0x7FFFFFFF));
}

// unsigned view whose ascending order equals the signed key order
__device__ __forceinline__ uint32_t key_to_u(int32_t k) {
  return static_cast<uint32_t>(k) ^ 0x80000000u;
}

__device__ __forceinline__ int32_t u_to_key(uint32_t u) {
  return static_cast<int32_t>(u ^ 0x80000000u);
}

// Warp-aggregated histogram increment.  All 32 lanes of the warp must call
// it together (callers loop with a block-uniform trip count); lanes with
// active == false add nothing.  Aggregation matters: a run of equal keys
// lands in one bin and would serialise on its counter.
__device__ __forceinline__ void hist_add(uint32_t* hist, uint32_t bin,
                                         bool active) {
  const uint32_t tag = active ? bin : 0xFFFFFFFFu;
  const unsigned peers = __match_any_sync(0xFFFFFFFFu, tag);
  const int leader = __ffs(peers) - 1;
  if (active && static_cast<int>(threadIdx.x & 31) == leader) {
    atomicAdd(&hist[bin], static_cast<uint32_t>(__popc(peers)));
  }
}

__device__ __forceinline__ int32_t warp_min(int32_t v) {
  for (int o = 16; o > 0; o >>= 1) {
    v = min(v, __shfl_xor_sync(0xFFFFFFFFu, v, o));
  }
  return v;
}

}  // namespace tpuvae
