// Segmented threshold-recurrence solver for Hopper (sm_90a).
//
// Replaces: ratelimiter_tpu/ops/pallas/solver.py:pallas_solve (kernel
// _solver_kernel, entry solve_threshold_recurrence_auto).
//
// Function: over a slot-sorted batch, for every segment (run of equal slots,
// heads marked in `first`; lane 0 always starts one) and every lane j of it
// in order,
//     inc[j] = (S <= u[j]);  S += w[j] * inc[j]      (S starts at 0)
// which is the unique sequential solution of
//     inc[j] = [ sum_{i<j in segment} w[i] * inc[i] <= u[j] ].
// All arithmetic is native int64.  The TPU kernel shifted u and w into i32
// and saturated its scans at 2^30-1 because Mosaic had no i64; none of that
// is needed here.  S cannot overflow on the decision path: it grows only by
// admitted weight, and every admitted lane had S + w <= v1, the refilled
// token count (or the window limit).
//
// Dead lanes.  w >= 0 is the solver's contract (ops/segments.py:68-70; the
// reference clips w into [0, SAT] at ratelimiter_tpu/ops/pallas/solver.py:310),
// so S starts at 0 and never falls: a lane with u < 0 can never pass, and it
// adds nothing to S.  Such lanes (the padding run that every power-of-two
// bucket sorts first, token-bucket lanes rejected before the solver) get
// inc = 0 in parallel and never enter a walk.  The result is exact only
// because S >= 0.
//
// Bound on the H100: bytes are tiny (u, w, inc at 8 B and first at 1 B per
// lane: 200 KB for 8192 lanes, tens of nanoseconds at 3.35 TB/s).  What
// bounds the function is its dependent chain: S is carried through the live
// lanes of a segment, so no schedule beats (live lanes of the largest
// segment) x (one int64 compare-select-add, about 12 cycles: 6 ns at
// 1.98 GHz).  Where no segment has many live lanes, the launch floor
// (a few microseconds) bounds the call instead.
//
// Design.  One block of TILE threads per TILE lanes:
// - The block loads its tile (coalesced, one lane a thread), writes inc = 0
//   for dead lanes, and publishes per-warp ballots of segment heads and live
//   lanes.  One warp scans the ballots: the tile's first and last heads and
//   the live lanes before each word.  The live lanes are then compacted, in
//   order, into shared memory as (u, w) pairs, and each thread finds the end
//   of its segment from the head words (__ffs).
// - Each head thread walks the compacted live lanes of its segment in a
//   counted loop: no load decides whether the walk goes on, and no address
//   depends on S, so the shared-memory loads of GROUP entries go out ahead of
//   the chain and a step costs the compare-select-add, not a load.  The
//   step is written so that the sum is formed beside the compare and only
//   the compare and a select stay on the chain.  Short segments run in
//   parallel, one walker each.
// - A segment that runs past the tile stays with the block of its head (no
//   inter-block carry, no atomics): its head thread carries S on through the
//   following lanes, CHUNK at a time (SPAN lanes a thread).  The block
//   stages each chunk (ballots, scan, compaction) while the next chunk's
//   global loads are in flight behind the walk; the first head in a chunk
//   ends the walk.  Lanes of a segment that no walker reaches are the dead
//   ones, written by their own tile.
// The sandwich iteration of the reference (ops/segments.py) exists to avoid
// a sequential scan on a vector machine and is not carried over.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int TILE = 256;            // lanes of a block's tile, one a thread
constexpr int SPAN = 4;              // lanes a thread in a later chunk
constexpr int CHUNK = TILE * SPAN;   // lanes of a later chunk
constexpr int GROUP = 16;            // walk steps whose loads go out together

struct Stage {
  longlong2 uw[CHUNK];               // live lanes' (u, w), in lane order
  uint8_t pass[CHUNK];               // the walk's inc for each entry of uw
  unsigned heads[CHUNK / 32];        // ballots of segment heads
  unsigned live[CHUNK / 32];         // ballots of live lanes (u >= 0)
  int before[CHUNK / 32];            // live lanes before each word
  int count;                         // live lanes of the chunk
  int first_head, last_head;         // CHUNK / -1 when there is none
  bool next_is_head;                 // the lane after the tile
};

// Lanes [0, k) of a 32-lane word.
__device__ __forceinline__ unsigned below(int k) {
  return k <= 0 ? 0u : k >= 32 ? ~0u : (1u << k) - 1u;
}

// Live lanes of the staged chunk before lane i (0 <= i <= 32 * words).
template <int WORDS>
__device__ __forceinline__ int live_before(const Stage& st, int i) {
  if (i >= 32 * WORDS) return st.count;
  return st.before[i >> 5] + __popc(st.live[i >> 5] & below(i & 31));
}

// Lanes of a chunk that one thread holds: lane base + r * TILE + t.
template <int N>
struct Lanes {
  int64_t u[N], w[N];
  int head[N];                       // the raw `first` byte
};

// Starts the loads of one thread's lanes.  Lanes past the batch read as
// dead heads: they end the last segment.  Nothing here waits for a load.
template <int N>
__device__ __forceinline__ void load_lanes(Lanes<N>& l,
                                           const int64_t* __restrict__ u,
                                           const int64_t* __restrict__ w,
                                           const uint8_t* __restrict__ first,
                                           int64_t base, int64_t n) {
#pragma unroll
  for (int r = 0; r < N; ++r) {
    const int64_t j = base + r * TILE + threadIdx.x;
    l.u[r] = -1;
    l.w[r] = 0;
    l.head[r] = 1;
    if (j < n) {
      l.u[r] = u[j];
      l.w[r] = w[j];
      l.head[r] = first[j];
    }
  }
}

// Ballots of heads and live lanes, one word per warp and lane row.
template <int N>
__device__ __forceinline__ void publish(Stage& st, const Lanes<N>& l) {
#pragma unroll
  for (int r = 0; r < N; ++r) {
    const unsigned h = __ballot_sync(~0u, l.head[r] != 0);
    const unsigned v = __ballot_sync(~0u, l.u[r] >= 0);
    if ((threadIdx.x & 31) == 0) {
      st.heads[r * (TILE / 32) + (threadIdx.x >> 5)] = h;
      st.live[r * (TILE / 32) + (threadIdx.x >> 5)] = v;
    }
  }
}

// Warp 0 over the published words: the first and last heads, the live
// lanes before each word and in all.  With `cut`, only lanes before the
// first head count as live (a later chunk of a running segment).
template <int WORDS>
__device__ __forceinline__ void scan(Stage& st, bool cut) {
  const int i = threadIdx.x;
  const unsigned h = i < WORDS ? st.heads[i] : 0u;
  unsigned v = i < WORDS ? st.live[i] : 0u;
  const unsigned any = __ballot_sync(~0u, h != 0);
  int first = 32 * WORDS, last = -1;
  if (any) {
    const int wf = __ffs(any) - 1, wl = 31 - __clz(any);
    first = 32 * wf + __ffs(__shfl_sync(~0u, h, wf)) - 1;
    last = 32 * wl + 31 - __clz(__shfl_sync(~0u, h, wl));
  }
  if (cut) v &= below(first - 32 * i);
  int c = __popc(v);
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int x = __shfl_up_sync(~0u, c, d);
    if (i >= d) c += x;
  }
  if (i < WORDS) {
    st.live[i] = v;
    st.before[i] = c - __popc(v);
  }
  if (i == 31) st.count = c;
  if (i == 0) {
    st.first_head = first;
    st.last_head = last;
  }
}

// Stores one thread's live lanes into the compacted (u, w) list; returns
// each lane's entry in `pos` (-1 for a lane that is not walked here).
template <int N>
__device__ __forceinline__ void compact(Stage& st, const Lanes<N>& l,
                                        int (&pos)[N]) {
#pragma unroll
  for (int r = 0; r < N; ++r) {
    const int i = r * TILE + threadIdx.x;
    pos[r] = -1;
    if ((st.live[i >> 5] >> (i & 31)) & 1u) {
      pos[r] = live_before<N * TILE / 32>(st, i);
      st.uw[pos[r]] = make_longlong2(l.u[r], l.w[r]);
    }
  }
}

// One step of the chain: inc = (s <= u); s += inc ? w : 0.  The sum is
// formed beside the compare and selected after it, so the chain is the
// compare and the select.
__device__ __forceinline__ int64_t step(int64_t s, longlong2 v,
                                        unsigned& inc) {
  int64_t out;
  asm("{\n\t.reg .pred q;\n\t.reg .s64 t;\n\t"
      "setp.le.s64 q, %2, %3;\n\t"
      "add.s64 t, %2, %4;\n\t"
      "selp.b64 %0, t, %2, q;\n\t"
      "selp.u32 %1, 1, 0, q;\n\t}"
      : "=l"(out), "=r"(inc)
      : "l"(s), "l"(v.x), "l"(v.y));
  return out;
}

// Walks entries [k, end) of the compacted live lanes from S = s, writes
// each entry's decision to `pass` and returns S.  The trip count is known
// before the loop starts, and no address depends on S: a GROUP's loads all
// go out at its top and land steps before the chain reaches them.
__device__ __forceinline__ int64_t walk(const longlong2* __restrict__ uw,
                                        uint8_t* __restrict__ pass, int k,
                                        int end, int64_t s) {
  for (; k + GROUP <= end; k += GROUP) {
    longlong2 v[GROUP];
#pragma unroll
    for (int i = 0; i < GROUP; ++i) v[i] = uw[k + i];
#pragma unroll
    for (int i = 0; i < GROUP; ++i) {
      unsigned inc;
      s = step(s, v[i], inc);
      pass[k + i] = static_cast<uint8_t>(inc);
    }
  }
  for (; k < end; ++k) {
    unsigned inc;
    s = step(s, uw[k], inc);
    pass[k] = static_cast<uint8_t>(inc);
  }
  return s;
}

__global__ void __launch_bounds__(TILE)
solve_segments_kernel(const int64_t* __restrict__ u,
                      const int64_t* __restrict__ w,
                      const uint8_t* __restrict__ first,
                      int64_t* __restrict__ inc, int64_t n) {
  __shared__ Stage st;
  const int t = threadIdx.x;
  const int64_t t0 = static_cast<int64_t>(blockIdx.x) * TILE;
  const int64_t j = t0 + t;

  // The tile: dead lanes are decided here, whoever owns their segment.
  Lanes<1> lane;
  load_lanes(lane, u, w, first, t0, n);
  if (j == 0) lane.head[0] = 1;
  if (j < n && lane.u[0] < 0) inc[j] = 0;
  if (t == TILE - 1) st.next_is_head = t0 + TILE >= n || first[t0 + TILE];
  publish(st, lane);
  __syncthreads();
  if (t < 32) scan<TILE / 32>(st, false);
  __syncthreads();
  int pos[1];
  compact(st, lane, pos);
  // Live lanes before the tile's first head belong to an earlier tile's
  // segment; the last head's segment runs on past the tile unless the next
  // lane starts one.
  const int first_head = st.first_head, owner = st.last_head;
  const bool crossing = owner >= 0 && !st.next_is_head;
  Lanes<SPAN> ahead;
  if (crossing) load_lanes(ahead, u, w, first, t0 + TILE, n);
  // A head's segment ends at the next head, or at the tile's end.
  const bool walker = lane.head[0] && j < n;
  int end = TILE;
  for (int k = (t + 1) >> 5; walker && k < TILE / 32; ++k) {
    const unsigned x = st.heads[k] & ~below(t + 1 - 32 * k);
    if (x) {
      end = 32 * k + __ffs(x) - 1;
      break;
    }
  }
  __syncthreads();
  int64_t s = 0;
  if (walker)
    s = walk(st.uw, st.pass, live_before<TILE / 32>(st, t),
             live_before<TILE / 32>(st, end), 0);
  __syncthreads();
  if (pos[0] >= 0 && t >= first_head) inc[j] = st.pass[pos[0]];
  if (!crossing) return;  // uniform across the block

  // The owner's segment through the following lanes, a chunk at a time,
  // the next chunk's loads in flight while this one is staged and walked.
  for (int64_t base = t0 + TILE;; base += CHUNK) {
    publish(st, ahead);
    __syncthreads();
    if (t < 32) scan<CHUNK / 32>(st, true);
    __syncthreads();
    int at[SPAN];
    compact(st, ahead, at);
    const bool more = st.first_head == CHUNK && base + CHUNK < n;
    if (more) load_lanes(ahead, u, w, first, base + CHUNK, n);
    __syncthreads();
    if (t == owner) s = walk(st.uw, st.pass, 0, st.count, s);
    __syncthreads();
#pragma unroll
    for (int r = 0; r < SPAN; ++r)
      if (at[r] >= 0) inc[base + r * TILE + t] = st.pass[at[r]];
    if (!more) return;
  }
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success).
extern "C" int rl_solve_segments(const int64_t* u, const int64_t* w,
                                 const bool* first, int64_t* inc, int64_t n,
                                 cudaStream_t stream) {
  if (n <= 0) return 0;
  const int64_t blocks = (n + TILE - 1) / TILE;
  solve_segments_kernel<<<static_cast<unsigned>(blocks), TILE, 0, stream>>>(
      u, w, reinterpret_cast<const uint8_t*>(first), inc, n);
  return static_cast<int>(cudaGetLastError());
}
