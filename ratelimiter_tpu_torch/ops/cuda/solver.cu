// Segmented threshold-recurrence solver for Hopper (sm_90a).
//
// Replaces: ratelimiter_tpu/ops/pallas/solver.py:pallas_solve (kernel
// _solver_kernel, entry solve_threshold_recurrence_auto).
//
// Function: over a slot-sorted batch, for every segment (run of equal slots,
// heads marked in `first`) and every lane j of it in order,
//     inc[j] = (S <= u[j]);  S += w[j] * inc[j]      (S starts at 0)
// which is the unique sequential solution of
//     inc[j] = [ sum_{i<j in segment} w[i] * inc[i] <= u[j] ].
// All arithmetic is native int64.  The TPU kernel shifted u and w into i32
// and saturated its scans at 2^30-1 because Mosaic had no i64; none of that
// is needed here.  S cannot overflow on the decision path: it grows only by
// admitted weight, and every admitted lane had S + w <= v1, the refilled
// token count (or the window limit).
//
// Bound on the H100: bytes are tiny (u, w, inc at 8 B and first at 1 B per
// lane: 200 KB for 8192 lanes, tens of nanoseconds at 3.35 TB/s).  What
// bounds the function is its dependent walk: S is carried through a whole
// segment, so no schedule beats (longest segment) x (one int64
// compare-and-add, about 12 cycles: 6 ns at 1.98 GHz).  The longest
// segments on the micro path are the hot key of a Zipf batch and the
// padding run (slot -1 lanes sort first) of a bucket just under half full.
//
// Design: one thread per segment head walks its segment in order.  Heads
// are independent, so short segments run in parallel across the grid; a
// long segment is one thread's chain of steps.  The loads of u, w and
// first do not depend on S, but the loop waits on each lane's `first` load
// to know whether the walk goes on, so a step costs a cache round trip,
// not the 12-cycle compare-and-add: the kernel runs about 20x above the
// walk bound on long segments (PERF.md has the numbers).  This is exact by
// construction.  The sandwich iteration
// of the reference (ops/segments.py) exists to avoid a sequential scan on a
// vector machine and is not carried over.  A warp-per-segment scan for long
// segments is later work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__global__ void solve_segments_kernel(const int64_t* __restrict__ u,
                                      const int64_t* __restrict__ w,
                                      const bool* __restrict__ first,
                                      int64_t* __restrict__ inc,
                                      int64_t n) {
  const int64_t head = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                       threadIdx.x;
  // Lane 0 always starts a segment, whatever `first[0]` says (the plain
  // version's running-max base is 0 before the first marked head).
  if (head >= n || (head != 0 && !first[head])) return;
  int64_t s = 0;
  int64_t j = head;
  do {
    const bool pass = s <= u[j];
    inc[j] = pass ? 1 : 0;
    if (pass) s += w[j];
    ++j;
  } while (j < n && !first[j]);
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success).
extern "C" int rl_solve_segments(const int64_t* u, const int64_t* w,
                                 const bool* first, int64_t* inc, int64_t n,
                                 cudaStream_t stream) {
  if (n <= 0) return 0;
  const int threads = 256;
  const int64_t blocks = (n + threads - 1) / threads;
  solve_segments_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                          stream>>>(u, w, first, inc, n);
  return static_cast<int>(cudaGetLastError());
}
