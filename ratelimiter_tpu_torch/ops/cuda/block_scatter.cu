// The micro step's write-back into the resident slot state, for Hopper
// (sm_90a): two kernels that build the rows they store, and the plain row
// scatter.
//
// Replaces: ratelimiter_tpu/ops/pallas/block_scatter.py:_block_scatter
// (kernel _kernel; entries scatter_rows and scatter_rows_presorted), and
// absorbs the XLA epilogue that fed it in the steps:
// ratelimiter_tpu/ops/token_bucket.py:137-151 (rl_tb_writeback) and
// ratelimiter_tpu/ops/sliding_window.py:162-175 (rl_sw_writeback).
//
// rl_tb_writeback / rl_sw_writeback.  Over a slot-sorted batch, for every
// lane j that is the last of its segment (j == n-1 or s[j+1] != s[j]) and
// holds a valid slot (0 <= s[j] < num_rows):
//   1. the segment's totals: tb tot_w = sum(req * inc), any = sum(inc) > 0;
//      sw tot = sum(inc), any = tot > 0;
//   2. the new row: tb tokens = any ? v1 - tot_w : old tokens, last = any ?
//      max(now, 1) : old last; sw curr = curr_e + tot, cdl = any ? now + win
//      : (old win_start == curr_ws ? old curr_dl : 0), prev_e, prev_dl_e;
//   3. its packed encoding: tb 4 i32 (tokens, last as little-endian i64);
//      sw 6 i32 (curr_ws as i64, curr, prev, clamp(cdl - curr_ws, 0),
//      clamp(prev_dl_e - curr_ws, 0)), each count truncated to i32;
//   4. the store into state[s[j]], in place.
// Every other state row is left as it was.  Native int64 throughout.  The
// totals count inc, not weight, for `any`, so weightless (req = 0) lanes are
// exact.  No atomics: each segment is summed by the one block that holds its
// last lane, in a fixed order.
//
// rl_scatter_rows: state[slots[j], :] = rows[j, :] for every lane j with
// mask[j] and 0 <= slots[j] < num_rows.  Live slots are unique, or carry
// identical rows (resets write zeros), so the writes never conflict.  It
// serves the resets, the engine's row writes and the relay's row writes
// (weighted relay, words mode, resident digest), not the steps.
//
// Bound on the H100, write-backs: bytes.  A write-back reads each lane's
// slot, inc (and req for tb) to find the totals, and each written
// segment's row inputs (3 i64 for tb, 5-7 for sw), and writes 16 or 24 B a
// segment: about 0.5-0.8 MB at B = 8192 counting every column of every
// lane, 0.15-0.25 us at 3.35 TB/s, far below the launch floor (~1.9 us).
// So what bounds the step's write-back is launches, and the TPU's XLA
// fused the epilogue into the scatter's producers where PyTorch eager
// launches each of its ~25 ops.
//
// Design of the write-backs.  One launch does the epilogue and the store.
// One block of TILE threads per TILE lanes, one lane a thread; every load
// a lane may need starts at the top.  The work is a few loads a lane
// behind a launch, so a small tile, which spreads a batch's loads over
// more SMs, beats a large one (8192 lanes: 32 blocks).  The totals come
// from an inclusive segmented scan of (weight, count) over the tile: warp
// shuffles, then one warp over the warps' parts in shared memory.  A
// segment's last lane reads its totals from the scan when the segment's
// head is in the tile.  Only the tile's first segment can begin before the
// tile; if it also ends in the tile, the whole block walks back from the
// tile's start, CHUNK lanes a step (SPAN loads of each column a thread in
// flight), each chunk summed by a block-wide reduction, until a chunk
// holds the segment's head.  A segment that runs past the tile is left to
// the block of its last lane.
//
// Bound on the H100, row scatter: bytes, and at the relay's shapes the
// bytes of row writes at the memory's 32-byte sector granularity, not the
// launch.  Words mode writes 3.07M live 24-byte rows of 2^22 lanes: the
// lanes (9 B each) and the live rows (24 B read, 24 B written) are 185 MB,
// 0.055 ms.  Its live slots fill a dense 74 MB run of the state, more than
// the 50 MB L2, in arrival order, so a sector takes parts of two rows at
// different times, and a part that reaches the memory alone costs the
// memory a read of the sector beside its write: about 1.5 sectors a row,
// 64 B of traffic each, ~0.12 ms with the lanes and rows.  The admin reset
// (one lane) sits at the launch floor.
//
// Design of the row scatter.  One thread a row, not an element: a thread
// loads a lane's slot and mask once and drops a dead or out-of-range lane
// before it loads its row.  The width is a template on L: L = 4 moves a row
// as one 16-byte load and one 16-byte store, L = 6 as a 16 + 8 or 8 + 16
// pair chosen by each address's alignment (a select, so a warp makes the
// same two accesses), any other L, or base pointers the vectors cannot
// take (checked once a launch), element by element in the same kernel.
// One block for every 256 lanes: the SMs' warps keep enough rows in
// flight, and did better than fewer threads holding several rows each.
// Lanes and rows are read once, with streaming loads, which leave the L2
// to the state.  State stores are streaming when the state is larger than
// the L2, and keep the default policy when it fits (streaming stores were
// faster on words mode's 300 MB state and slower on a 48 MB one).  The
// measurements behind each choice are in PERF.md.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int TILE = 256;             // lanes of a block's tile, one a thread
constexpr int WARPS = TILE / 32;      // at most 32: one warp scans them
constexpr int SPAN = 8;               // lanes a thread in a walk-back chunk
constexpr int CHUNK = TILE * SPAN;    // lanes of a walk-back chunk
static_assert(WARPS <= 32 && TILE % 32 == 0, "one warp scans the warps");

unsigned tiles(int64_t n) {
  return static_cast<unsigned>((n + TILE - 1) / TILE);
}

// What a run of lanes admitted: weight (token bucket only) and lanes.
struct Sum {
  long long w;
  int c;
};

template <bool WEIGHTED>
__device__ __forceinline__ Sum plus(Sum a, Sum b) {
  return {WEIGHTED ? a.w + b.w : 0, a.c + b.c};
}

template <bool WEIGHTED>
__device__ __forceinline__ Sum lane_sum(const int64_t* __restrict__ inc,
                                        const int64_t* __restrict__ req,
                                        int64_t j) {
  const int64_t i = inc[j];
  return {WEIGHTED ? static_cast<long long>(req[j] * i) : 0,
          static_cast<int>(i)};
}

// One round of an inclusive segmented scan: a lane with no head at or
// before it (within the scanned span) adds the value `d` lanes back.
template <bool WEIGHTED>
__device__ __forceinline__ void scan_round(Sum& v, int& f, int d) {
  Sum u{0, 0};
  if (WEIGHTED) u.w = __shfl_up_sync(~0u, v.w, d);
  u.c = __shfl_up_sync(~0u, v.c, d);
  const int g = __shfl_up_sync(~0u, f, d);
  if ((threadIdx.x & 31) >= d && !f) {
    v = plus<WEIGHTED>(u, v);
    f = g;
  }
}

template <bool WEIGHTED>
__device__ __forceinline__ void warp_scan(Sum& v, int& f) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) scan_round<WEIGHTED>(v, f, d);
}

template <bool WEIGHTED>
__device__ __forceinline__ Sum warp_sum(Sum v) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    if (WEIGHTED) v.w += __shfl_xor_sync(~0u, v.w, d);
    v.c += __shfl_xor_sync(~0u, v.c, d);
  }
  return v;
}

// The block-wide sum of `v`, on every thread.  `red` holds WARPS + 1.
template <bool WEIGHTED>
__device__ __forceinline__ Sum block_sum(Sum v, Sum* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = warp_sum<WEIGHTED>(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = warp_sum<WEIGHTED>(lane < WARPS ? red[lane] : Sum{0, 0});
    if (lane == 0) red[WARPS] = v;
  }
  __syncthreads();
  return red[WARPS];
}

// The segment totals of the block's tile.  Returns true on the lanes that
// write a row (the last lane of a segment with a slot >= 0), with the slot
// in `slot` and the segment's totals in `tot`.  Every thread of the block
// must call it (it synchronises the block).
template <bool WEIGHTED>
__device__ __forceinline__ bool segment_totals(
    const int64_t* __restrict__ s, const int64_t* __restrict__ inc,
    const int64_t* __restrict__ req, int64_t n, int64_t& slot, Sum& tot) {
  __shared__ Sum part[WARPS + 1];
  __shared__ int part_head[WARPS];
  __shared__ int walk;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int64_t t0 = static_cast<int64_t>(blockIdx.x) * TILE;
  const int64_t j = t0 + t;

  // Lanes past the batch are empty heads: they end the last segment.
  slot = -1;
  int head = 1;
  bool last = false;
  Sum v{0, 0};
  if (j < n) {
    slot = s[j];
    head = j == 0 || s[j - 1] != slot;
    last = j == n - 1 || s[j + 1] != slot;
    v = lane_sum<WEIGHTED>(inc, req, j);
  }
  if (t == 0) walk = 0;

  // Inclusive segmented scan over the tile: the warps, then warp 0 over
  // the warps' parts (made exclusive), then each lane that saw no head in
  // its warp adds the part before its warp.  `head` ends as: a head lies
  // in [t0, j].
  warp_scan<WEIGHTED>(v, head);
  if (lane == 31) {
    part[warp] = v;
    part_head[warp] = head;
  }
  __syncthreads();
  if (warp == 0) {
    Sum x{0, 0};
    int g = 1;
    if (lane < WARPS) {
      x = part[lane];
      g = part_head[lane];
    }
    warp_scan<WEIGHTED>(x, g);
    Sum ex{0, 0};
    if (WEIGHTED) ex.w = __shfl_up_sync(~0u, x.w, 1);
    ex.c = __shfl_up_sync(~0u, x.c, 1);
    int eg = __shfl_up_sync(~0u, g, 1);
    if (lane == 0) {
      ex = {0, 0};
      eg = 0;
    }
    if (lane < WARPS) {
      part[lane] = ex;
      part_head[lane] = eg;
    }
  }
  __syncthreads();
  if (!head) {
    v = plus<WEIGHTED>(part[warp], v);
    head = part_head[warp];
  }

  // The tile's first segment began before the tile and ends in it: the
  // block sums its lanes before the tile, a chunk at a time.
  const bool write = last && slot >= 0;
  if (write && !head) walk = 1;
  __syncthreads();
  if (walk) {  // uniform across the block
    const int64_t key = s[t0];
    Sum acc{0, 0};
    for (int64_t end = t0;;) {
      const int64_t begin = end > CHUNK ? end - CHUNK : 0;
      int64_t ks[SPAN], is[SPAN], rs[SPAN];
#pragma unroll
      for (int r = 0; r < SPAN; ++r) {
        const int64_t k = begin + r * TILE + t;
        ks[r] = -1;
        is[r] = rs[r] = 0;
        if (k < end) {
          ks[r] = s[k];
          is[r] = inc[k];
          if (WEIGHTED) rs[r] = req[k];
        }
      }
      Sum p{0, 0};
#pragma unroll
      for (int r = 0; r < SPAN; ++r)
        if (ks[r] == key)
          p = plus<WEIGHTED>(p, {static_cast<long long>(rs[r] * is[r]),
                                 static_cast<int>(is[r])});
      acc = plus<WEIGHTED>(acc, block_sum<WEIGHTED>(p, part));
      if (begin == 0 || s[begin] != key) break;
      end = begin;
    }
    if (write && !head) v = plus<WEIGHTED>(v, acc);
  }
  tot = v;
  return write;
}

__global__ void __launch_bounds__(TILE)
tb_writeback_kernel(int32_t* __restrict__ state, int64_t num_rows,
                    const int64_t* __restrict__ s,
                    const int64_t* __restrict__ inc,
                    const int64_t* __restrict__ req,
                    const int64_t* __restrict__ v1,
                    const int64_t* __restrict__ tok_old,
                    const int64_t* __restrict__ last_old,
                    const int64_t* __restrict__ now, int64_t n) {
  const int64_t j = static_cast<int64_t>(blockIdx.x) * TILE + threadIdx.x;
  // The row inputs, in flight while the block finds the totals.
  int64_t v = 0, tok = 0, lst = 0;
  if (j < n) {
    v = v1[j];
    tok = tok_old[j];
    lst = last_old[j];
  }
  const int64_t t_now = *now;
  int64_t slot;
  Sum tot;
  if (!segment_totals<true>(s, inc, req, n, slot, tot) || slot >= num_rows)
    return;
  const bool any = tot.c > 0;
  // max(now, 1): a write at epoch instant 0 must not alias the absent-key
  // sentinel (last_refill == 0).
  const longlong2 row = make_longlong2(any ? v - tot.w : tok,
                                       any ? (t_now > 1 ? t_now : 1) : lst);
  reinterpret_cast<longlong2*>(state)[slot] = row;
}

__global__ void __launch_bounds__(TILE)
sw_writeback_kernel(int32_t* __restrict__ state, int64_t num_rows,
                    const int64_t* __restrict__ s,
                    const int64_t* __restrict__ inc,
                    const int64_t* __restrict__ curr_e,
                    const int64_t* __restrict__ prev_e,
                    const int64_t* __restrict__ prev_dl_e,
                    const int64_t* __restrict__ ws_old,
                    const int64_t* __restrict__ cdl_old,
                    const int64_t* __restrict__ win, int win_step,
                    const int64_t* __restrict__ curr_ws, int ws_step,
                    const int64_t* __restrict__ now, int64_t n) {
  const int64_t j = static_cast<int64_t>(blockIdx.x) * TILE + threadIdx.x;
  // The row inputs, in flight while the block finds the totals.
  int64_t ce = 0, pe = 0, pdl = 0, ws0 = 0, cdl0 = 0, w = 0, ws = 0;
  if (j < n) {
    ce = curr_e[j];
    pe = prev_e[j];
    pdl = prev_dl_e[j];
    ws0 = ws_old[j];
    cdl0 = cdl_old[j];
    w = win[j * win_step];
    ws = curr_ws[j * ws_step];
  }
  const int64_t t_now = *now;
  int64_t slot;
  Sum tot;
  if (!segment_totals<false>(s, inc, nullptr, n, slot, tot) ||
      slot >= num_rows)
    return;
  const int64_t cdl = tot.c > 0 ? t_now + w : (ws0 == ws ? cdl0 : 0);
  const int64_t c_off = cdl - ws > 0 ? cdl - ws : 0;
  const int64_t p_off = pdl - ws > 0 ? pdl - ws : 0;
  // [ws_lo, ws_hi, curr, prev, cdl_off, pdl_off]: a 24 B row, 8 B aligned.
  int32_t* row = state + slot * 6;
  *reinterpret_cast<long long*>(row) = ws;
  *reinterpret_cast<int2*>(row + 2) =
      make_int2(static_cast<int32_t>(ce + tot.c), static_cast<int32_t>(pe));
  *reinterpret_cast<int2*>(row + 4) =
      make_int2(static_cast<int32_t>(c_off), static_cast<int32_t>(p_off));
}

// Lanes and rows are read once: streaming loads leave the L2 to the state.
template <typename T>
__device__ __forceinline__ T load_once(const T* p) {
  return __ldcs(p);
}

// `stream`: a streaming (evict-first) store, else the default policy.
template <typename T>
__device__ __forceinline__ void store_state(T* p, T v, bool stream) {
  if (stream)
    __stcs(p, v);
  else
    *p = v;
}

__device__ __forceinline__ bool aligned16(const int32_t* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// Copies one row of L lanes from `src` to `dst`.  `vec`: the base pointers
// take the vector accesses of width L (16-byte aligned for L = 4, 8-byte
// for L = 6); else one element at a time.  An 8-byte aligned L = 6 row
// starts on a 16-byte boundary or 8 bytes past one, and is moved as 16 + 8
// or 8 + 16 bytes accordingly: a select, so that a warp makes the same two
// accesses whatever its rows' alignment.
template <int L>
__device__ __forceinline__ void copy_row(int32_t* dst, const int32_t* src,
                                         bool vec, bool stream) {
  if constexpr (L == 4) {
    if (vec) {
      store_state(reinterpret_cast<int4*>(dst),
                  load_once(reinterpret_cast<const int4*>(src)), stream);
      return;
    }
  } else if constexpr (L == 6) {
    if (vec) {
      const int lo = aligned16(src) ? 0 : 2;
      const int4 x = load_once(reinterpret_cast<const int4*>(src + lo));
      const int2 y =
          load_once(reinterpret_cast<const int2*>(src + 4 - 2 * lo));
      int32_t r[6];
      if (lo == 0) {
        r[0] = x.x; r[1] = x.y; r[2] = x.z; r[3] = x.w; r[4] = y.x; r[5] = y.y;
      } else {
        r[0] = y.x; r[1] = y.y; r[2] = x.x; r[3] = x.y; r[4] = x.z; r[5] = x.w;
      }
      const int d = aligned16(dst) ? 0 : 2;
      const int4 u = d == 0 ? make_int4(r[0], r[1], r[2], r[3])
                            : make_int4(r[2], r[3], r[4], r[5]);
      const int2 w = d == 0 ? make_int2(r[4], r[5]) : make_int2(r[0], r[1]);
      store_state(reinterpret_cast<int4*>(dst + d), u, stream);
      store_state(reinterpret_cast<int2*>(dst + 4 - 2 * d), w, stream);
      return;
    }
  }
#pragma unroll
  for (int c = 0; c < L; ++c) store_state(dst + c, load_once(src + c), stream);
}

// One lane a thread.  The lane is dead unless its mask is set and its slot
// lies in [0, num_rows); a dead lane's row is never loaded.  L > 0: rows of
// L lanes; L == 0: rows of `lanes` lanes, element by element.
template <int L>
__global__ void __launch_bounds__(TILE)
scatter_rows_kernel(int32_t* __restrict__ state, int64_t num_rows, int lanes,
                    const int64_t* __restrict__ slots,
                    const bool* __restrict__ mask,
                    const int32_t* __restrict__ rows, int64_t n, bool vec,
                    bool stream) {
  const int64_t j = static_cast<int64_t>(blockIdx.x) * TILE + threadIdx.x;
  if (j >= n) return;
  const int64_t slot =
      load_once(reinterpret_cast<const long long*>(slots) + j);
  if (!load_once(reinterpret_cast<const unsigned char*>(mask) + j) ||
      slot < 0 || slot >= num_rows)
    return;
  if constexpr (L > 0) {
    copy_row<L>(state + slot * L, rows + j * L, vec, stream);
  } else {
    const int32_t* src = rows + j * lanes;
    int32_t* dst = state + slot * lanes;
    for (int c = 0; c < lanes; ++c)
      store_state(dst + c, load_once(src + c), stream);
  }
}

// The L2 cache's bytes, read once a process (of the card current at the
// first launch: the port runs on H100s alone).
int64_t l2_bytes() {
  static const int64_t bytes = [] {
    int dev = 0, l2 = 50 << 20;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&l2, cudaDevAttrL2CacheSize, dev);
    return static_cast<int64_t>(l2);
  }();
  return bytes;
}

// `vec`: the base pointers take L's vector accesses.  State stores stream
// when the state cannot stay in the L2: there they measured faster, on a
// state that fits they measured slower.
template <int L>
void launch_scatter(int32_t* state, int64_t num_rows, int lanes,
                    const int64_t* slots, const bool* mask,
                    const int32_t* rows, int64_t n, bool vec,
                    cudaStream_t stream_id) {
  const bool stream = num_rows * lanes * 4 > l2_bytes();
  scatter_rows_kernel<L><<<tiles(n), TILE, 0, stream_id>>>(
      state, num_rows, lanes, slots, mask, rows, n, vec, stream);
}

}  // namespace

// Each entry returns the cudaError_t of its launch (0 on success).  The
// write-backs take a 16 B aligned state; `now` is an i64 on the device; a
// step of 0 reads one value of `win` / `curr_ws` for every lane.
extern "C" int rl_tb_writeback(int32_t* state, int64_t num_rows,
                               const int64_t* s, const int64_t* inc,
                               const int64_t* req, const int64_t* v1,
                               const int64_t* tok_old,
                               const int64_t* last_old, const int64_t* now,
                               int64_t n, cudaStream_t stream) {
  if (n <= 0) return 0;
  tb_writeback_kernel<<<tiles(n), TILE, 0, stream>>>(
      state, num_rows, s, inc, req, v1, tok_old, last_old, now, n);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int rl_sw_writeback(int32_t* state, int64_t num_rows,
                               const int64_t* s, const int64_t* inc,
                               const int64_t* curr_e, const int64_t* prev_e,
                               const int64_t* prev_dl_e,
                               const int64_t* ws_old, const int64_t* cdl_old,
                               const int64_t* win, int win_step,
                               const int64_t* curr_ws, int ws_step,
                               const int64_t* now, int64_t n,
                               cudaStream_t stream) {
  if (n <= 0) return 0;
  sw_writeback_kernel<<<tiles(n), TILE, 0, stream>>>(
      state, num_rows, s, inc, curr_e, prev_e, prev_dl_e, ws_old, cdl_old,
      win, win_step, curr_ws, ws_step, now, n);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int rl_scatter_rows(int32_t* state, int64_t num_rows, int lanes,
                               const int64_t* slots, const bool* mask,
                               const int32_t* rows, int64_t n,
                               cudaStream_t stream) {
  if (n <= 0 || lanes <= 0) return 0;
  const uintptr_t base = reinterpret_cast<uintptr_t>(state) |
                         reinterpret_cast<uintptr_t>(rows);
  if (lanes == 4)
    launch_scatter<4>(state, num_rows, lanes, slots, mask, rows, n,
                      (base & 15) == 0, stream);
  else if (lanes == 6)
    launch_scatter<6>(state, num_rows, lanes, slots, mask, rows, n,
                      (base & 7) == 0, stream);
  else
    launch_scatter<0>(state, num_rows, lanes, slots, mask, rows, n, false,
                      stream);
  return static_cast<int>(cudaGetLastError());
}
