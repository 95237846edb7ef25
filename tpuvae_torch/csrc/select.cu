// Masked-median order statistics on a thread block cluster per row
// (kernel 3).
//
// Replaces the Pallas kernel tpuvae/ops/select.py:32 (_select_kernel),
// which keeps one clip's keys in VMEM and runs a 32-round binary search.
// Per row of biased int32 keys (masked-out = INT32_MAX) it writes
// (n, key_lo, cnt_le, min_above): the mask count, the (k_lo+1)-th smallest
// key with k_lo = max((n-1)/2, 0), the count of keys <= key_lo, and the
// smallest key above it.  ops/select.py finishes the numpy-convention
// median from these four numbers.
//
// Bound on the H100: bytes.  The function must read each key once
// (4 B/element, ~1.9 MB per row at the main path's band, 59.5 MB at 32
// rows); the work per key is a compare.
//
// Design: a cluster of 8 CTAs of 512 threads per row, CTA r over the slice
// [r S, (r + 1) S) of the row (S from ops/select.py:slice_geometry), two
// CTAs per SM, so that 32 rows fill the card in one wave.
// * Each CTA reads its slice ONCE, with 16-byte streaming loads, kUnroll
//   of them in flight a thread, and compacts the keys below the sentinel
//   (the mask) into a list: a warp's at once (a scan of the counts, one
//   shared atomic).  n is the sum of the lists' lengths.
// * The first `capacity` entries of a list lie in shared memory; a slice
//   whose keys may be more (a general row can be all valid) gets a global
//   spill of S - capacity entries a CTA from the wrapper, so that the
//   lists are exact whatever the mask.  At the main path a row holds at
//   most ceil(r8 / 2) candidates a frame, a slice ~1/8 of that, and the
//   spill is never written.
// * The exact rank is found on the lists by cluster_median_rank
//   (cluster_select.cuh): four 8-bit digit passes whose histograms are
//   summed across the cluster through distributed shared memory, a
//   parallel prefix over the bins, one cluster barrier a pass, and one
//   more pass for the smallest key above key_lo.
// * The statistics are order statistics and counts: they do not depend on
//   the order in which keys are compacted, and every merge adds integers.
//   An empty row gives (0, INT32_MAX, N, INT32_MAX), as the plain version
//   and the Pallas kernel do (every key <= the sentinel).
//
// A line marked `// ablate: NAME` is one that tools/kernel_ab.py --ablate
// replaces to time the kernel without that part of its work.
#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

#include "cluster_select.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int kCluster = 8;
constexpr int kThreads = 512;
constexpr int kUnroll = 4;               // 16-byte loads in flight a thread
// the longest list a CTA keeps in shared memory (4 bytes an entry), two
// CTAs an SM beside their static scratch; ops/select.py holds the same
// number
constexpr int kSmemListEntries = 27000;

struct Params {
  const int32_t* keys;   // (rows, n_cols)
  int32_t* spill;        // (rows * kCluster, spill_per_cta) or null
  int32_t* out;          // (rows, 4)
  long long n_cols;
  int slice;             // S: keys a CTA reads
  int capacity;          // list entries in shared memory
  int spill_per_cta;     // S - capacity, or 0
};

// Appends the valid keys of each lane's q (up to 4; the sentinel marks the
// others) to the CTA's list.  All 32 lanes of the warp call it together.
__device__ __forceinline__ void append_valid(const int4& q, int* n_local,
                                             int32_t* list, int capacity,
                                             int32_t* spill) {
  const int lane = threadIdx.x & 31;
  const int32_t k[4] = {q.x, q.y, q.z, q.w};
  int c = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) c += k[j] < tpuvae::kKeySentinel ? 1 : 0;
  int incl = c;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int up = __shfl_up_sync(0xFFFFFFFFu, incl, o);
    if (lane >= o) incl += up;
  }
  const int total = __shfl_sync(0xFFFFFFFFu, incl, 31);
  if (total == 0) return;                   // the same for the whole warp
  int at = 0;
  if (lane == 31) at = atomicAdd(n_local, total);
  at = __shfl_sync(0xFFFFFFFFu, at, 31) + incl - c;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (k[j] < tpuvae::kKeySentinel) {
      if (at < capacity) {
        list[at] = k[j];
      } else {
        spill[at - capacity] = k[j];
      }
      ++at;
    }
  }
}

__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads, 2)
masked_median_select_kernel(Params p) {
  extern __shared__ __align__(16) int32_t list_smem[];
  __shared__ tpuvae::ClusterSelectScratch sc;
  __shared__ int n_local;

  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int rank = static_cast<int>(cluster.block_rank());
  const long long row = blockIdx.x / kCluster;
  const long long lo = min(static_cast<long long>(rank) * p.slice, p.n_cols);
  const long long len = min(lo + p.slice, p.n_cols) - lo;
  const int32_t* a = p.keys + row * p.n_cols + lo;
  int32_t* spill = p.spill == nullptr
                       ? nullptr
                       : p.spill + static_cast<long long>(blockIdx.x) *
                                       p.spill_per_cta;
  if (tid == 0) n_local = 0;
  __syncthreads();

  // ---- one pass over the slice: 16-byte loads, valid keys compacted ------
  // keys before the first 16-byte boundary (head) and after the last
  // (tail) go through the first warp, one a lane
  const int to_boundary =
      static_cast<int>((16 - (reinterpret_cast<uintptr_t>(a) & 15)) & 15) / 4;
  const int head = static_cast<int>(min(static_cast<long long>(to_boundary), len));
  const long long n_vec = (len - head) / 4;
  const int tail = static_cast<int>(len - head - 4 * n_vec);
  if (tid < 32) {
    int4 q = make_int4(tpuvae::kKeySentinel, tpuvae::kKeySentinel,
                       tpuvae::kKeySentinel, tpuvae::kKeySentinel);
    if (lane < head) {
      q.x = a[lane];
    } else if (lane >= 4 && lane < 4 + tail) {
      q.x = a[head + 4 * n_vec + (lane - 4)];
    }
    append_valid(q, &n_local, list_smem, p.capacity, spill);
  }
  const int4* v = reinterpret_cast<const int4*>(a + head);
  for (long long base = 0; base < n_vec; base += kThreads * kUnroll) {
    int4 q[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = base + u * kThreads + tid;
      q[u] = i < n_vec ? __ldcs(v + i)
                       : make_int4(tpuvae::kKeySentinel, tpuvae::kKeySentinel,
                                   tpuvae::kKeySentinel, tpuvae::kKeySentinel);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      append_valid(q[u], &n_local, list_smem, p.capacity, spill);
    }
  }
  __syncthreads();
  const int n_mine = n_local;
  const int n_head = min(n_mine, p.capacity);
  const tpuvae::KeyList list{list_smem, n_head, spill, n_mine - n_head};

  // ---- the exact rank across the cluster ---------------------------------
  const tpuvae::MedianRank med = tpuvae::cluster_median_rank(list, &sc, true);  // ablate: rank
  if (rank == 0 && tid == 0) {
    int32_t* o = p.out + 4 * row;
    o[0] = med.n;
    o[1] = med.key_lo;
    // an empty row: every key is the sentinel, <= key_lo
    o[2] = med.n == 0 ? static_cast<int32_t>(p.n_cols) : med.cnt_le;
    o[3] = med.min_above;
  }
}

}  // namespace

// `slice`, `capacity`, `spill_per_cta`: ops/select.py:slice_geometry.
// `spill`: null when spill_per_cta is 0, else at least
// n_rows * kCluster * spill_per_cta entries (`spill_entries`).
extern "C" int tpuvae_masked_median_select(const void* keys, long long n_rows,
                                           long long n_cols, int slice,
                                           int capacity, int spill_per_cta,
                                           void* spill,
                                           long long spill_entries, void* out,
                                           void* stream) {
  if (n_rows <= 0) return 0;
  if (n_cols < 0 || n_cols > 2147483647LL || slice <= 0 ||
      static_cast<long long>(slice) * kCluster < n_cols || capacity <= 0 ||
      capacity > kSmemListEntries || capacity > slice ||
      spill_per_cta != slice - capacity ||
      (spill_per_cta > 0) != (spill != nullptr) ||
      (spill != nullptr &&
       spill_entries < n_rows * kCluster * static_cast<long long>(spill_per_cta)) ||
      n_rows * kCluster > 2147483647LL)
    return static_cast<int>(cudaErrorInvalidValue);
  Params prm;
  prm.keys = static_cast<const int32_t*>(keys);
  prm.spill = static_cast<int32_t*>(spill);
  prm.out = static_cast<int32_t*>(out);
  prm.n_cols = n_cols;
  prm.slice = slice;
  prm.capacity = capacity;
  prm.spill_per_cta = spill_per_cta;
  const size_t smem = static_cast<size_t>(capacity) * 4;
  cudaError_t rc = cudaFuncSetAttribute(
      masked_median_select_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (rc != cudaSuccess) return static_cast<int>(rc);
  // two CTAs of ~111 KB an SM need the largest carveout
  rc = cudaFuncSetAttribute(masked_median_select_kernel,
                            cudaFuncAttributePreferredSharedMemoryCarveout,
                            100);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  masked_median_select_kernel<<<static_cast<unsigned>(n_rows * kCluster),
                                kThreads, smem,
                                static_cast<cudaStream_t>(stream)>>>(prm);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* tpuvae_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
