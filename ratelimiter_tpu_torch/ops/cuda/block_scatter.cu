// In-place row scatter into the resident slot state, for Hopper (sm_90a).
//
// Replaces: ratelimiter_tpu/ops/pallas/block_scatter.py:_block_scatter
// (kernel _kernel; entries scatter_rows and scatter_rows_presorted).
//
// Function: state[slots[j], :] = rows[j, :] for every lane j with mask[j]
// and 0 <= slots[j] < num_rows; every other state row is left as it was.
// Live slots are unique (one write per segment, at its last lane), or carry
// identical rows (resets write zeros), so the writes never conflict.
//
// Bound on the H100: bytes.  The work is B lanes of slot (8 B) and mask
// (1 B) read, and for each live lane its row (4 L B) read and written:
// about 0.27 MB for 8192 sliding-window lanes (L = 6) of which half are
// live, 0.08 us at 3.35 TB/s, so at micro-batch sizes the launch
// dominates.  Padding and masked lanes read no row.  The written rows land
// at scattered addresses in a 24 MB table, one 16 or 24 B row each.
//
// Design: one thread per (lane, column); neighbouring threads of a warp
// cover neighbouring columns and lanes, so the reads of rows are coalesced
// and each row's store is one contiguous run.  The TPU kernel's compaction
// sort, window map and (T, T) f32 match matmuls existed because Mosaic had
// no indexed store; none of them is needed.  Any table size and any lane
// count is served, including micro batches below 512 lanes and tables that
// are not a multiple of 256 rows.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__global__ void scatter_rows_kernel(int32_t* __restrict__ state,
                                    int64_t num_rows, int lanes,
                                    const int64_t* __restrict__ slots,
                                    const bool* __restrict__ mask,
                                    const int32_t* __restrict__ rows,
                                    int64_t n) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (t >= n * lanes) return;
  const int64_t j = t / lanes;
  const int64_t c = t - j * lanes;
  const int64_t s = slots[j];
  if (!mask[j] || s < 0 || s >= num_rows) return;
  state[s * lanes + c] = rows[t];
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success).
extern "C" int rl_scatter_rows(int32_t* state, int64_t num_rows, int lanes,
                               const int64_t* slots, const bool* mask,
                               const int32_t* rows, int64_t n,
                               cudaStream_t stream) {
  if (n <= 0 || lanes <= 0) return 0;
  const int threads = 256;
  const int64_t blocks = (n * lanes + threads - 1) / threads;
  scatter_rows_kernel<<<static_cast<unsigned>(blocks), threads, 0, stream>>>(
      state, num_rows, lanes, slots, mask, rows, n);
  return static_cast<int>(cudaGetLastError());
}
