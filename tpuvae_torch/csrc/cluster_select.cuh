// Exact median rank of int32 order keys spread over the CTAs of a thread
// block cluster (Hopper), each CTA holding a compacted list of its own keys.
//
// Used by the tuning kernel (tuning.cu) and the masked-median select kernel
// (select.cu).  The keys and their helpers are those of radix_select.cuh: a
// float's biased int32 key, whose signed order is the float's total order.
// Every key in a list is counted: there are no sentinels to skip.  A list
// may lie in two pieces (shared memory, then a global spill past its
// capacity): KeyList reads them as one.
//
// An MSB-first radix select in four 8-bit digit passes.  In each pass every
// CTA builds a 256-counter histogram of its keys that match the prefix
// fixed so far; after a cluster barrier every CTA reads all the cluster's
// histograms through distributed shared memory and adds them (integers:
// any order gives the same counts), and a parallel scan of the 256 merged
// counters finds the digit that holds the wanted rank.  All CTAs compute
// the same prefix.  Two histogram buffers alternate between passes, so one
// cluster barrier a pass suffices: a buffer is cleared two passes after it
// was read, and every CTA has finished that read before it arrives at the
// barrier in between.
#pragma once

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

#include "radix_select.cuh"

namespace tpuvae {

struct ClusterSelectScratch {
  uint32_t hist[2][kRadixBins];   // this CTA's, alternating passes
  uint32_t merged[kRadixBins];    // the cluster's, this pass
  uint32_t warp_tot[kRadixBins / 32];
  uint32_t bcast[2];              // digit, count below it
  int count;                      // keys in this CTA's list
  int total;                      // keys in the cluster's lists
  int32_t minimum;                // smallest key above the median rank's
};

// A CTA's list of keys: head[0 .. n_head) then tail[0 .. n_tail).
struct KeyList {
  const int32_t* head;
  int n_head;
  const int32_t* tail;
  int n_tail;
  __device__ __forceinline__ int size() const { return n_head + n_tail; }
  __device__ __forceinline__ int32_t operator[](int i) const {
    return i < n_head ? head[i] : tail[i - n_head];
  }
};

// What the median of the cluster's keys needs (numpy's convention: the mean
// of the two middle values for an even count).
struct MedianRank {
  int n;              // keys in the cluster
  int32_t key_lo;     // the (k_lo + 1)-th smallest, k_lo = (n - 1) / 2
  int cnt_le;         // keys <= key_lo
  int32_t min_above;  // smallest key > key_lo (kKeySentinel if none)
};

// merged[i] = sum over the cluster's CTAs of their hist[buf][i]; the
// remote reads of up to 8 CTAs (the portable cluster size) in flight at once
__device__ __forceinline__ void cluster_merge_hist(ClusterSelectScratch* sc,
                                                   int buf) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x;
  const unsigned nb = cluster.num_blocks();
  if (tid < kRadixBins) {
    uint32_t part[8];
#pragma unroll
    for (unsigned r = 0; r < 8; ++r) {
      part[r] = r < nb ? cluster.map_shared_rank(sc, r)->hist[buf][tid] : 0u;
    }
    uint32_t s = 0;
#pragma unroll
    for (int r = 0; r < 8; ++r) s += part[r];
    for (unsigned r = 8; r < nb; ++r) {
      s += cluster.map_shared_rank(sc, r)->hist[buf][tid];
    }
    sc->merged[tid] = s;
  }
}

// The digit d whose merged count holds rank k (counts below d <= k < counts
// up to and including d): bcast = (d, counts below d).  A parallel scan by
// the first 256 threads.  The caller guarantees k < the merged total.
__device__ __forceinline__ void find_rank_digit(ClusterSelectScratch* sc,
                                                uint32_t k) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  uint32_t v = 0, incl = 0;
  if (tid < kRadixBins) {
    v = sc->merged[tid];
    incl = v;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const uint32_t up = __shfl_up_sync(0xFFFFFFFFu, incl, o);
      if (lane >= o) incl += up;
    }
    if (lane == 31) sc->warp_tot[tid >> 5] = incl;
  }
  __syncthreads();
  if (tid < kRadixBins) {
    uint32_t below = incl - v;
    for (int w = 0; w < (tid >> 5); ++w) below += sc->warp_tot[w];
    if (v > 0 && below <= k && k < below + v) {
      sc->bcast[0] = static_cast<uint32_t>(tid);
      sc->bcast[1] = below;
    }
  }
  __syncthreads();
}

// The median rank of the keys of every CTA's list `keys` in the cluster.
// min_above is computed when an even count needs it (its upper middle key
// lies above key_lo) or, with `always_min_above`, whenever a key lies above
// key_lo; otherwise it is kKeySentinel.  For an empty cluster key_lo and
// min_above are kKeySentinel and cnt_le is 0.  Every thread of every CTA
// of the cluster must call it.  It ends with a cluster barrier: once it
// returns, no CTA reads another's scratch any more.
__device__ MedianRank cluster_median_rank(const KeyList& keys,
                                          ClusterSelectScratch* sc,
                                          bool always_min_above) {
  namespace cg = cooperative_groups;
  const int n_local = keys.size();
  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  for (int i = tid; i < 2 * kRadixBins; i += nthreads) {
    sc->hist[i / kRadixBins][i % kRadixBins] = 0;
  }
  if (tid == 0) {
    sc->count = n_local;
    sc->minimum = kKeySentinel;
  }
  __syncthreads();

  MedianRank res;
  uint32_t prefix = 0, k = 0, below_all = 0;
  for (int pass = 0; pass < 4; ++pass) {
    const int shift = 24 - 8 * pass;
    const int buf = pass & 1;
    if (pass >= 2) {
      for (int i = tid; i < kRadixBins; i += nthreads) sc->hist[buf][i] = 0;
      __syncthreads();
    }
    for (int base = 0; base < n_local; base += nthreads) {
      const int i = base + tid;
      const uint32_t u = i < n_local ? key_to_u(keys[i]) : 0u;
      const bool match = i < n_local &&
                         (pass == 0 || (u >> (shift + 8)) == (prefix >> (shift + 8)));
      hist_add(sc->hist[buf], (u >> shift) & 0xFFu, match);
    }
    __syncthreads();
    cluster.sync();               // every CTA's histogram of this pass
    if (pass == 0) {
      if (tid < 32) {             // a lane per CTA (clusters of <= 32 CTAs)
        int n = tid < static_cast<int>(cluster.num_blocks())
                    ? cluster.map_shared_rank(sc, tid)->count
                    : 0;
        for (int o = 16; o > 0; o >>= 1) n += __shfl_xor_sync(0xFFFFFFFFu, n, o);
        if (tid == 0) sc->total = n;
      }
      __syncthreads();
      res.n = sc->total;
      if (res.n == 0) break;      // the same for every CTA of the cluster
      k = static_cast<uint32_t>((res.n - 1) / 2);
    }
    cluster_merge_hist(sc, buf);
    __syncthreads();
    find_rank_digit(sc, k);
    const uint32_t d = sc->bcast[0];
    const uint32_t below = sc->bcast[1];
    prefix |= d << shift;
    k -= below;
    below_all += below;
    if (pass == 3) res.cnt_le = static_cast<int>(below_all + sc->merged[d]);
    __syncthreads();              // bcast and merged are read before reuse
  }
  if (res.n == 0) {
    res.key_lo = kKeySentinel;
    res.cnt_le = 0;
    res.min_above = kKeySentinel;
    cluster.sync();
    return res;
  }
  res.key_lo = u_to_key(prefix);
  // the smallest key above: the median needs it only for an even count
  // whose lower middle key ends its run of equal keys
  const int k_lo = (res.n - 1) / 2;
  const int k_hi = res.n / 2;
  res.min_above = kKeySentinel;
  if ((always_min_above && res.cnt_le < res.n) ||
      (k_hi != k_lo && res.cnt_le < k_hi + 1)) {
    int32_t mn = kKeySentinel;
    for (int i = tid; i < n_local; i += nthreads) {
      const int32_t key = keys[i];
      if (key > res.key_lo) mn = min(mn, key);
    }
    mn = warp_min(mn);
    if ((tid & 31) == 0) atomicMin(&sc->minimum, mn);
    __syncthreads();
    cluster.sync();
    if (tid < 32) {               // a lane per CTA
      int32_t m = tid < static_cast<int>(cluster.num_blocks())
                      ? cluster.map_shared_rank(sc, tid)->minimum
                      : kKeySentinel;
      m = warp_min(m);
      if (tid == 0) sc->bcast[0] = static_cast<uint32_t>(m);
    }
    __syncthreads();
    res.min_above = static_cast<int32_t>(sc->bcast[0]);
  }
  cluster.sync();
  return res;
}

// The median rank of the keys keys[0 .. n_local) of every CTA of the
// cluster, min_above only where the median needs it.
__device__ __forceinline__ MedianRank cluster_median_rank(
    const int32_t* keys, int n_local, ClusterSelectScratch* sc) {
  return cluster_median_rank(KeyList{keys, n_local, nullptr, 0}, sc, false);
}

}  // namespace tpuvae
