// Fused digest relay step for Hopper (sm_90a): per unique slot of a stream
// chunk, gather its row, roll (sliding window) or refill (token bucket) it
// to `now`, decide how many of the slot's unit-permit requests pass, write
// the row back in place and emit that count.
//
// Replaces: ratelimiter_tpu/ops/pallas/relay_step.py:_call_kernel (kernel
// _kernel; entries tb_relay_counts_fused and sw_relay_counts_fused; row
// math _tb_row_update / _sw_row_update).  Function: the port's
// ops/relay.py:_tb_counts_core / _sw_counts_core (its plain version), for
// one limiter id.
//
// Input word per lane, read as uint32 (the wrapper carries the bits in an
// int32 tensor):
//   bits 1 .. rank_bits      the slot's request count, clamped at
//                            2^rank_bits - 1 (exact: n_allowed never
//                            exceeds max_permits < the clamp)
//   bits rank_bits+1 .. 31   slot; the all-ones padding word decodes to a
//                            slot >= num_rows: no row is touched, count 0
// Slots are unique within a dispatch, so no two threads touch one row.
//
// Bound on the H100: bytes.  Each lane reads its word (4 B) and writes its
// count (1 or 2 B); each live lane reads and writes its row (16 B token
// bucket, 24 B sliding window): U * 5 + live * 8 * L bytes, about 37 MB or
// 11 us at 3.35 TB/s for 10^6 token-bucket uniques.  The rows sit at
// scattered addresses of a 32-48 MB table, one 32 B sector for each 16 or
// 24 B row, so the kernel runs above that bound unless the table stays in
// the 50 MB L2; sorting the uniques by slot on the host only orders the
// addresses.
//
// Design: one thread per lane, native int64 arithmetic, the policy scalars
// of `lid` read from the device table (no host sync).  The Pallas kernel's
// i32-pair arithmetic, (T, T) match matmuls, window map, sigma and
// binary-search divide were Mosaic workarounds and have no counterpart.
// Floor division and modulo follow Python (operands and `now` can be
// negative); C's / and % truncate, so both are corrected here.  A sliding-
// window lane writes its rolled row even when it allows nothing (its window
// start and deadlines move to `now`); a token-bucket lane that allows
// nothing leaves its row as it was.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int64_t kFpOne = 1000LL << 20;  // core/config.py: TOKEN_FP_ONE

__device__ __forceinline__ int64_t floor_div(int64_t a, int64_t b) {
  const int64_t q = a / b;
  return (a % b != 0 && ((a < 0) != (b < 0))) ? q - 1 : q;
}

__device__ __forceinline__ int64_t floor_mod(int64_t a, int64_t b) {
  const int64_t r = a % b;
  return (r != 0 && ((r < 0) != (b < 0))) ? r + b : r;
}

__device__ __forceinline__ int64_t join(int32_t lo, int32_t hi) {
  return static_cast<int64_t>(
      (static_cast<uint64_t>(static_cast<uint32_t>(hi)) << 32) |
      static_cast<uint64_t>(static_cast<uint32_t>(lo)));
}

__device__ __forceinline__ void split(int64_t v, int32_t* lo_hi) {
  lo_hi[0] = static_cast<int32_t>(static_cast<uint32_t>(v));
  lo_hi[1] = static_cast<int32_t>(static_cast<uint32_t>(
      static_cast<uint64_t>(v) >> 32));
}

__device__ __forceinline__ int64_t imin(int64_t a, int64_t b) {
  return a < b ? a : b;
}

__device__ __forceinline__ int64_t imax(int64_t a, int64_t b) {
  return a > b ? a : b;
}

template <typename CountT>
__global__ void tb_relay_kernel(int32_t* __restrict__ state, int64_t num_rows,
                                const uint32_t* __restrict__ uwords,
                                int64_t u, int rank_bits,
                                const int64_t* __restrict__ cap_fp,
                                const int64_t* __restrict__ rate_fp,
                                const int64_t* __restrict__ max_permits,
                                const int64_t* __restrict__ ttl2_ms,
                                int64_t lid, int64_t now,
                                CountT* __restrict__ counts,
                                int64_t count_max) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (i >= u) return;
  const uint32_t w = uwords[i];
  const uint64_t slot = w >> (rank_bits + 1);
  const int64_t count = (w >> 1) & ((1u << rank_bits) - 1u);
  int64_t n_alw = 0;
  if (slot < static_cast<uint64_t>(num_rows)) {
    int32_t* row = state + slot * 4;
    const int64_t tokens = join(row[0], row[1]);
    const int64_t last = join(row[2], row[3]);
    const int64_t cap = cap_fp[lid];
    const int64_t rate = rate_fp[lid];
    const int64_t maxp = max_permits[lid];
    // Lazy init + exact fixed-point refill (ops/token_bucket.py:_refilled).
    const bool expired = last == 0 || now >= last + ttl2_ms[lid];
    const int64_t v0 = expired ? cap : tokens;
    const int64_t last_e = expired ? now : last;
    const int64_t hi = floor_div(cap, imax(rate, 1)) + 1;
    const int64_t elapsed = imin(imax(now - last_e, 0), hi);
    const int64_t v1 = imin(cap, v0 + elapsed * rate);
    const int64_t room = maxp >= 1 ? v1 - kFpOne : -1;
    const int64_t avail = room >= 0 ? room / kFpOne + 1 : 0;
    n_alw = imin(avail, count);
    if (n_alw > 0) {
      split(v1 - n_alw * kFpOne, row);
      split(imax(now, 1), row + 2);
    }
  }
  counts[i] = static_cast<CountT>(imin(n_alw, count_max));
}

template <typename CountT>
__global__ void sw_relay_kernel(int32_t* __restrict__ state, int64_t num_rows,
                                const uint32_t* __restrict__ uwords,
                                int64_t u, int rank_bits,
                                const int64_t* __restrict__ max_permits,
                                const int64_t* __restrict__ window_ms,
                                int64_t lid, int64_t now,
                                CountT* __restrict__ counts,
                                int64_t count_max) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (i >= u) return;
  const uint32_t w = uwords[i];
  const uint64_t slot = w >> (rank_bits + 1);
  const int64_t count = (w >> 1) & ((1u << rank_bits) - 1u);
  int64_t tot = 0;
  if (slot < static_cast<uint64_t>(num_rows)) {
    int32_t* row = state + slot * 6;
    // Row codec (ops/sliding_window.py:_sw_decode): deadlines are stored
    // as offsets from the row's own window start.
    const int64_t ws0 = join(row[0], row[1]);
    const int64_t curr = row[2];
    const int64_t prev = row[3];
    const int64_t cdl = ws0 + row[4];
    const int64_t pdl = ws0 + row[5];
    const int64_t maxp = max_permits[lid];
    const int64_t win = window_ms[lid];
    // Roll to now's window (ops/sliding_window.py:_rolled).
    const int64_t rem = floor_mod(now, win);
    const int64_t curr_ws = now - rem;
    const bool same = ws0 == curr_ws;
    const bool next1 = ws0 == curr_ws - win;
    const int64_t curr_e = same ? curr : 0;
    const int64_t prev_e = same ? (now < pdl ? prev : 0)
                                : ((next1 && now < cdl) ? curr : 0);
    const int64_t prev_dl_e = same ? pdl : (next1 ? cdl : 0);
    const int64_t base = floor_div(prev_e * (win - rem), win);
    tot = imin(count, imax(maxp - base - curr_e, 0));
    const int64_t cdl_new = tot > 0 ? now + win : (same ? cdl : 0);
    split(curr_ws, row);
    row[2] = static_cast<int32_t>(curr_e + tot);
    row[3] = static_cast<int32_t>(prev_e);
    row[4] = static_cast<int32_t>(imax(cdl_new - curr_ws, 0));
    row[5] = static_cast<int32_t>(imax(prev_dl_e - curr_ws, 0));
  }
  counts[i] = static_cast<CountT>(imin(tot, count_max));
}

constexpr int kThreads = 256;

inline unsigned blocks_for(int64_t u) {
  return static_cast<unsigned>((u + kThreads - 1) / kThreads);
}

}  // namespace

// Each entry returns the cudaError_t of the launch (0 on success).
// count_bytes: 1 (uint8 counts) or 2 (uint16 counts).
extern "C" int rl_tb_relay_counts(int32_t* state, int64_t num_rows,
                                  const uint32_t* uwords, int64_t u,
                                  int rank_bits, const int64_t* cap_fp,
                                  const int64_t* rate_fp,
                                  const int64_t* max_permits,
                                  const int64_t* ttl2_ms, int64_t lid,
                                  int64_t now, void* counts, int count_bytes,
                                  cudaStream_t stream) {
  if (u <= 0) return 0;
  if (count_bytes == 1) {
    tb_relay_kernel<uint8_t><<<blocks_for(u), kThreads, 0, stream>>>(
        state, num_rows, uwords, u, rank_bits, cap_fp, rate_fp, max_permits,
        ttl2_ms, lid, now, static_cast<uint8_t*>(counts), 0xFF);
  } else if (count_bytes == 2) {
    tb_relay_kernel<uint16_t><<<blocks_for(u), kThreads, 0, stream>>>(
        state, num_rows, uwords, u, rank_bits, cap_fp, rate_fp, max_permits,
        ttl2_ms, lid, now, static_cast<uint16_t*>(counts), 0xFFFF);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int rl_sw_relay_counts(int32_t* state, int64_t num_rows,
                                  const uint32_t* uwords, int64_t u,
                                  int rank_bits, const int64_t* max_permits,
                                  const int64_t* window_ms, int64_t lid,
                                  int64_t now, void* counts, int count_bytes,
                                  cudaStream_t stream) {
  if (u <= 0) return 0;
  if (count_bytes == 1) {
    sw_relay_kernel<uint8_t><<<blocks_for(u), kThreads, 0, stream>>>(
        state, num_rows, uwords, u, rank_bits, max_permits, window_ms, lid,
        now, static_cast<uint8_t*>(counts), 0xFF);
  } else if (count_bytes == 2) {
    sw_relay_kernel<uint16_t><<<blocks_for(u), kThreads, 0, stream>>>(
        state, num_rows, uwords, u, rank_bits, max_permits, window_ms, lid,
        now, static_cast<uint16_t*>(counts), 0xFFFF);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
