// Masked-median order statistics, one CTA per row (kernel 3).
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
// (4 B/element, ~1.9 MB per clip at the main path's band); the work per
// key is a compare and a histogram increment.  Design: the radix select
// takes four 8-bit digit passes plus one neighbour pass over the row
// instead of 32 binary-search rounds; a row (1.9 MB) stays in the 50 MB
// L2 across passes for a whole 32-clip batch, so HBM sees it about once.
#include <cstdint>
#include <cuda_runtime.h>

#include "radix_select.cuh"

namespace {

constexpr int kThreads = 1024;

struct RowKeys {
  const int32_t* keys;
  __device__ int32_t operator()(long long i, bool& counted) const {
    const int32_t k = keys[i];
    counted = k < tpuvae::kKeySentinel;
    return k;
  }
};

__global__ void __launch_bounds__(kThreads)
masked_median_select_kernel(const int32_t* __restrict__ keys, long long n_cols,
                            int32_t* __restrict__ out) {
  __shared__ tpuvae::SelectScratch sc;
  const RowKeys row{keys + static_cast<long long>(blockIdx.x) * n_cols};
  int n = 0;
  const int32_t key_lo = tpuvae::block_median_rank_key(row, n_cols, &sc, &n);
  int cnt_le = 0;
  int32_t min_above = 0;
  tpuvae::block_rank_neighbours(row, n_cols, key_lo, &sc, &cnt_le, &min_above);
  if (threadIdx.x == 0) {
    int32_t* o = out + 4 * static_cast<long long>(blockIdx.x);
    o[0] = n;
    o[1] = key_lo;
    o[2] = cnt_le;
    o[3] = min_above;
  }
}

}  // namespace

extern "C" int tpuvae_masked_median_select(const void* keys, long long n_rows,
                                           long long n_cols, void* out,
                                           void* stream) {
  if (n_rows <= 0) return 0;
  masked_median_select_kernel<<<static_cast<unsigned>(n_rows), kThreads, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(keys), n_cols, static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* tpuvae_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
