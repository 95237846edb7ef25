// Block-wide exact order statistics over order-preserving int32 keys.
//
// Shared by the tuning kernel (tuning.cu) and the masked-median select
// kernel (select.cu).  A float is mapped to a "biased" int32 key whose
// signed order is the float's total order (tpuvae.dsp.chroma
// _float_order_key viewed as int32): non-negative floats keep their bits,
// negative floats flip their 31 low bits.  Masked-out elements carry the
// sentinel INT32_MAX, which sorts above every finite key.
//
// The (k+1)-th smallest key is found by an MSB-first radix select in four
// 8-bit digit passes, each a 256-counter shared-memory histogram of the
// elements that still match the prefix fixed so far.  The result is the
// exact order statistic, whatever the digit width.
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
// active == false add nothing.  Aggregation matters: the sentinel keys of
// a sparse mask all land in one bin and would serialise on its counter.
__device__ __forceinline__ void hist_add(uint32_t* hist, uint32_t bin,
                                         bool active) {
  const uint32_t tag = active ? bin : 0xFFFFFFFFu;
  const unsigned peers = __match_any_sync(0xFFFFFFFFu, tag);
  const int leader = __ffs(peers) - 1;
  if (active && static_cast<int>(threadIdx.x & 31) == leader) {
    atomicAdd(&hist[bin], static_cast<uint32_t>(__popc(peers)));
  }
}

__device__ __forceinline__ int warp_sum(int v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xFFFFFFFFu, v, o);
  return v;
}

__device__ __forceinline__ int32_t warp_min(int32_t v) {
  for (int o = 16; o > 0; o >>= 1) {
    v = min(v, __shfl_xor_sync(0xFFFFFFFFu, v, o));
  }
  return v;
}

// Shared scratch of one select: the digit histogram plus broadcast slots.
struct SelectScratch {
  uint32_t hist[kRadixBins];
  uint32_t bcast[2];
  int count;
  int32_t minimum;
};

// Median-rank select over n_elems keys given by key_at(i) -> (int32 key,
// counted).  ``counted`` marks the elements of the mask; uncounted ones
// must carry kKeySentinel.  Returns the (k_lo+1)-th smallest key over ALL
// elements, with k_lo = max((n-1)/2, 0) and n the number counted (stored in
// *n_out) — the key ops/select.py's kernel reports.  Every thread of the
// block must call it; it ends with a __syncthreads().
template <class KeyAt>
__device__ int32_t block_median_rank_key(const KeyAt& key_at, long long n_elems,
                                         SelectScratch* sc, int* n_out) {
  const int tid = threadIdx.x;
  uint32_t prefix = 0;
  uint32_t k = 0;
  for (int pass = 0; pass < 4; ++pass) {
    const int shift = 24 - 8 * pass;
    for (int i = tid; i < kRadixBins; i += blockDim.x) sc->hist[i] = 0;
    if (tid == 0 && pass == 0) sc->count = 0;
    __syncthreads();
    int counted_local = 0;
    for (long long base = 0; base < n_elems; base += blockDim.x) {
      const long long i = base + tid;
      const bool valid = i < n_elems;
      bool counted = false;
      const int32_t key = valid ? key_at(i, counted) : kKeySentinel;
      const uint32_t u = key_to_u(key);
      bool match = valid;
      if (pass > 0) match = match && ((u >> (shift + 8)) == (prefix >> (shift + 8)));
      if (pass == 0) counted_local += (valid && counted) ? 1 : 0;
      hist_add(sc->hist, (u >> shift) & 0xFFu, match);
    }
    if (pass == 0) {
      counted_local = warp_sum(counted_local);
      if ((tid & 31) == 0) atomicAdd(&sc->count, counted_local);
    }
    __syncthreads();
    if (tid == 0) {
      if (pass == 0) {
        const int n = sc->count;
        k = static_cast<uint32_t>(n > 0 ? (n - 1) / 2 : 0);
      }
      uint32_t below = 0;
      uint32_t d = 0;
      for (; d < kRadixBins - 1; ++d) {
        if (below + sc->hist[d] > k) break;
        below += sc->hist[d];
      }
      sc->bcast[0] = prefix | (d << shift);
      sc->bcast[1] = k - below;
    }
    __syncthreads();
    prefix = sc->bcast[0];
    k = sc->bcast[1];
    __syncthreads();
  }
  // sc->count holds n since pass 0; read it before anyone reuses sc
  *n_out = sc->count;
  __syncthreads();
  return u_to_key(prefix);
}

// cnt_le = #{keys <= key_lo} and min_above = min{keys > key_lo} (INT32_MAX
// if none) over all elements.  Every thread of the block must call it.
template <class KeyAt>
__device__ void block_rank_neighbours(const KeyAt& key_at, long long n_elems,
                                      int32_t key_lo, SelectScratch* sc,
                                      int* cnt_le, int32_t* min_above) {
  const int tid = threadIdx.x;
  if (tid == 0) {
    sc->count = 0;
    sc->minimum = kKeySentinel;
  }
  __syncthreads();
  int cnt = 0;
  int32_t mn = kKeySentinel;
  for (long long i = tid; i < n_elems; i += blockDim.x) {
    bool counted = false;
    const int32_t key = key_at(i, counted);
    if (key <= key_lo) {
      ++cnt;
    } else {
      mn = min(mn, key);
    }
  }
  cnt = warp_sum(cnt);
  mn = warp_min(mn);
  if ((tid & 31) == 0) {
    atomicAdd(&sc->count, cnt);
    atomicMin(&sc->minimum, mn);
  }
  __syncthreads();
  *cnt_le = sc->count;
  *min_above = sc->minimum;
  __syncthreads();
}

}  // namespace tpuvae
