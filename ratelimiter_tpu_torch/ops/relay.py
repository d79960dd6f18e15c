"""Relay digest step — the unit-permit stream route (counterpart of
``ratelimiter_tpu/ops/relay.py``, digest form with one limiter id).

The host slot index walks every request of a chunk in arrival order to
assign slots, and hands back the chunk's duplicate structure for free
(native/slot_index.cpp:assign_batch_uniques): one uint32 word per UNIQUE
slot, plus each request's (unique index, rank) kept on the host.  With
unit permits the requests of one slot pass iff ``rank < n_allowed``, so the
device only has to compute ``n_allowed`` per unique slot:

    decode word -> gather row -> roll/refill to now -> n_allowed
               -> write the row back -> emit the count

and the host rebuilds each request's decision as ``rank <
counts[uidx]`` (engine/native_index.py:relay_decide).

A word (``uwords``) is

    bits 1 .. rank_bits     the slot's request count, clamped at
                            2^rank_bits - 1 (a deny sentinel: the layout
                            guarantees 2^rank_bits - 2 >= every registered
                            max_permits, and n_allowed <= max_permits, so
                            the clamp never changes a decision)
    bits rank_bits+1 .. 31  slot id; the all-ones padding word decodes to
                            a slot >= num_slots, an invalid lane

Torch has little uint32 arithmetic on CUDA, so the words travel as an
``int32`` tensor holding the same bits; the plain version decodes them
through int64 (``& 0xFFFFFFFF``) and the CUDA kernel reads them as
``uint32_t``.

``tb_relay_counts`` / ``sw_relay_counts`` are the entries: a state tensor
on the CPU takes the plain version below (``_tb_counts_core`` /
``_sw_counts_core``), a CUDA tensor launches the hand-written kernel
(``ops/cuda/relay_step.cu``).  Nothing else selects between them.  Both
update the state in place.  The split digest (``*_relay_counts_split``:
singletons as a 3-byte slot plane with allow bits back, the other uniques
as words with counts back) chooses the same way: its plain version runs
the cores over both lane sets, and on the card the singles are re-encoded
as count-1 words and the relay kernel runs once over both.

Two more modes serve what the digest's one limiter id cannot carry.  The
reference ran them as composed XLA, so they are torch ops here, and their
row writes go through ``ops/scatter.py:scatter_rows`` (on the card the
``rl_scatter_rows`` kernel):

- **words mode** (``tb_relay_bits`` / ``sw_relay_bits``): one word per
  REQUEST, ``slot | clamped rank | last``, with one limiter id or a lane
  of them, and packed allow bits back.  The stream elects it for
  duplicate-poor chunks and whenever the counts fit no dtype.
- **the resident digest** (``*_relay_counts_resident``): the digest for
  per-request limiter ids.  A slot's limiter id cannot change while the
  slot is assigned, so the engine keeps a per-slot lid map on the device;
  a step folds in the (slot, lid) pairs the host has not uploaded before
  and gathers each unique's lid from the map.

The weighted relay (``*_relay_weighted``, ``*_relay_weighted_counts``)
carries a permits lane of weights in [1, 255] for one limiter.  The
reference ran it as composed XLA, so it is torch ops here; its row write
is a write of unique slots, ``ops/scatter.py:scatter_rows`` (on the card
the ``rl_scatter_rows`` kernel).
"""

from __future__ import annotations

import numpy as np
import torch

from ratelimiter_tpu_torch.core.config import TOKEN_FP_ONE
from ratelimiter_tpu_torch.engine.state import TableArrays
from ratelimiter_tpu_torch.ops.cuda import relay_step
from ratelimiter_tpu_torch.ops.flat import _policy_index, packbits
from ratelimiter_tpu_torch.ops.scatter import scatter_rows, scatter_rows_plain
from ratelimiter_tpu_torch.ops.sliding_window import (
    _rolled,
    _sw_decode,
    _sw_encode,
)
from ratelimiter_tpu_torch.ops.token_bucket import (
    _refilled,
    _tb_decode,
    _tb_encode,
    floor_div,
)
from ratelimiter_tpu_torch.ops.transfer import device_scalar


def relay_usable(rank_bits: int, max_permits_registered: int) -> bool:
    """Whether the word layout can carry the engine's traffic: the rank
    clamp ceiling (2^rank_bits - 1, a deny sentinel) must exceed every
    registered limiter's max_permits."""
    return (rank_bits >= 1
            and (1 << rank_bits) - 2 >= max_permits_registered)


def counts_dtype(max_permits_registered: int):
    """Smallest numpy dtype that carries per-unique allowed counts (None
    if none fits)."""
    if max_permits_registered <= 255:
        return np.uint8
    if max_permits_registered <= 65535:
        return np.uint16
    return None


def wire_costs(multi_lid: bool, lid_lane: bool = False):
    """(bytes per unique in digest mode, bytes per request in words mode):
    the constants the stream elects a chunk's mode by and grows its chunks
    with.  Digest: the 4 B word up and a 1-2 B count back; tenant streams
    keep their lids resident on the device, and the storage charges the
    uploaded (slot, lid) pairs apart, except where the digest ships a 4 B
    lid per unique (``lid_lane``: the sharded engine's per-shard digest).
    Words: the 4 B word up and a bit back, plus a 4 B lid per request for
    tenant streams."""
    return ((10.0 if multi_lid and lid_lane else 6.0),
            (8.125 if multi_lid else 4.125))


def decode_words(words: torch.Tensor, rank_bits: int, num_slots: int):
    """int32[B] word bits -> (slot i64[B], count i64[B], valid bool[B]);
    in words mode the count field holds the request's rank.  Padding
    lanes (0xFFFFFFFF) decode to slot >= num_slots => invalid."""
    w = words.to(torch.int64) & 0xFFFFFFFF
    slot = w >> (rank_bits + 1)
    return slot, (w >> 1) & ((1 << rank_bits) - 1), slot < num_slots


def _tb_counts_core(packed: torch.Tensor, table: TableArrays,
                    slot: torch.Tensor, count: torch.Tensor,
                    valid: torch.Tensor, lids, now,
                    write=scatter_rows_plain) -> torch.Tensor:
    """Plain version of the token-bucket relay kernel: n_allowed per lane;
    ``packed`` (i32[S, 4]) is updated in place by ``write``.  ``lids`` is
    one limiter id or an int lane of them.  Every valid lane writes its
    row (unchanged where nothing was allowed)."""
    now = device_scalar(now, packed.device)
    sc = torch.where(valid, slot, 0)
    lidc = _policy_index(lids, table.cap_fp.shape[0])
    cap = table.cap_fp[lidc]
    rate = table.rate_fp[lidc]
    maxp = table.max_permits[lidc]
    ttl2 = table.ttl2_ms[lidc]
    rows = _tb_decode(packed[sc])
    v1 = _refilled(rows, cap, rate, ttl2, now)
    # Unit permits: request r of the slot passes iff r * FP_ONE <= v1 -
    # FP_ONE, i.e. r < avail (0 when the first does not pass).
    u = torch.where(valid & (maxp >= 1), v1 - TOKEN_FP_ONE,
                    torch.full_like(v1, -1))
    avail = torch.where(u >= 0, floor_div(u, TOKEN_FP_ONE) + 1,
                        torch.zeros_like(u))
    n_alw = torch.minimum(avail, count)
    any_inc = n_alw > 0
    tokens_new = torch.where(any_inc, v1 - n_alw * TOKEN_FP_ONE,
                             rows.tokens_fp)
    last_new = torch.where(any_inc, torch.clamp(now, min=1),
                           rows.last_refill)
    write(packed, slot, valid, _tb_encode(tokens_new, last_new))
    return n_alw


def _sw_counts_core(packed: torch.Tensor, table: TableArrays,
                    slot: torch.Tensor, count: torch.Tensor,
                    valid: torch.Tensor, lids, now,
                    write=scatter_rows_plain) -> torch.Tensor:
    """Plain version of the sliding-window relay kernel: tot = min(count,
    n_pass) per lane; ``packed`` (i32[S, 6]) is updated in place by
    ``write``.  ``lids`` as in :func:`_tb_counts_core`.  Every valid lane
    writes its ROLLED row, even when it allows nothing.

    With unit permits the post-increment re-check (quirk Q2) is implied:
    n_pass = maxp - base - curr_e when positive and base >= 0, so any rank
    below n_pass also satisfies curr_e + rank + 1 <= maxp."""
    now = device_scalar(now, packed.device)
    sc = torch.where(valid, slot, 0)
    lidc = _policy_index(lids, table.max_permits.shape[0])
    maxp = table.max_permits[lidc]
    win = table.window_ms[lidc]
    rows = _sw_decode(packed[sc])
    curr_ws, curr_e, prev_e, prev_dl_e = _rolled(rows, win, now)
    rem = torch.remainder(now, win)
    base = floor_div(prev_e * (win - rem), win)
    n_pass = torch.clamp(maxp - base - curr_e, min=0)
    tot = torch.where(valid, torch.minimum(count, n_pass),
                      torch.zeros_like(count))
    any_inc = tot > 0
    curr_new = curr_e + tot
    samew = rows.win_start == curr_ws
    cdl_new = torch.where(any_inc, now + win,
                          torch.where(samew, rows.curr_dl,
                                      torch.zeros_like(curr_e)))
    new_rows = _sw_encode(torch.broadcast_to(curr_ws, sc.shape), curr_new,
                          cdl_new, prev_e, prev_dl_e)
    write(packed, slot, valid, new_rows)
    return tot


def _plain(core, packed, table, uwords, lid, now, rank_bits, out_dtype):
    slot, count, valid = decode_words(uwords, rank_bits, packed.shape[0])
    n_alw = core(packed, table, slot, count, valid, lid, now)
    lim = torch.iinfo(out_dtype).max
    return torch.clamp(n_alw, 0, lim).to(out_dtype)


def tb_relay_counts_plain(packed: torch.Tensor, table: TableArrays,
                          uwords: torch.Tensor, lid: int, now: int, *,
                          rank_bits: int,
                          out_dtype: torch.dtype = torch.uint8
                          ) -> torch.Tensor:
    """Plain PyTorch version of the token-bucket relay kernel, on any
    device."""
    return _plain(_tb_counts_core, packed, table, uwords, lid, now,
                  rank_bits, out_dtype)


def sw_relay_counts_plain(packed: torch.Tensor, table: TableArrays,
                          uwords: torch.Tensor, lid: int, now: int, *,
                          rank_bits: int,
                          out_dtype: torch.dtype = torch.uint8
                          ) -> torch.Tensor:
    """Plain PyTorch version of the sliding-window relay kernel, on any
    device."""
    return _plain(_sw_counts_core, packed, table, uwords, lid, now,
                  rank_bits, out_dtype)


def tb_relay_counts(packed: torch.Tensor, table: TableArrays,
                    uwords: torch.Tensor, lid: int, now: int, *,
                    rank_bits: int,
                    out_dtype: torch.dtype = torch.uint8) -> torch.Tensor:
    """Digest token-bucket step for one limiter id: ``uwords`` int32[U]
    (word bits, padding all ones); returns out_dtype[U] allowed counts
    (clipped to the dtype) and updates ``packed`` in place."""
    step = (tb_relay_counts_plain if packed.device.type == "cpu"
            else relay_step.tb_relay_counts)
    return step(packed, table, uwords, lid, now, rank_bits=rank_bits,
                out_dtype=out_dtype)


def sw_relay_counts(packed: torch.Tensor, table: TableArrays,
                    uwords: torch.Tensor, lid: int, now: int, *,
                    rank_bits: int,
                    out_dtype: torch.dtype = torch.uint8) -> torch.Tensor:
    """Digest sliding-window step (see :func:`tb_relay_counts`)."""
    step = (sw_relay_counts_plain if packed.device.type == "cpu"
            else relay_step.sw_relay_counts)
    return step(packed, table, uwords, lid, now, rank_bits=rank_bits,
                out_dtype=out_dtype)


# -- the split digest ------------------------------------------------------------
# Most uniques of a unit-permit chunk are singletons (one request each):
# such a unique needs no count on the way in and only an allow bit on the
# way out.  The split digest ships them as a 3-byte little-endian slot plane
# ``s3`` (uint8[S, 3], padding 0xFFFFFF) and the other uniques as digest
# words ``mwords`` (padding all ones), and returns ONE uint8 array: the
# singles' allow bits, packed MSB first, then the multis' counts as bytes
# (little-endian for uint16), as the reference returns them.  Singles and
# multis are distinct uniques, so their slots are disjoint and both decide
# in one pass over the concatenated lanes.


def _decode_s3(s3: torch.Tensor, num_slots: int):
    """uint8[S, 3] slot plane -> (slot i64[S], valid bool[S]); the
    0xFFFFFF padding decodes to a slot >= num_slots (the split is elected
    only for tables of at most 0xFFFFFF slots)."""
    w = s3.to(torch.int64)
    slot = w[:, 0] | (w[:, 1] << 8) | (w[:, 2] << 16)
    return slot, slot < num_slots


def _split_result(counts: torch.Tensor, n_s: int) -> torch.Tensor:
    """[packbits(counts[:n_s] > 0) | counts[n_s:] as bytes]."""
    return torch.cat([packbits(counts[:n_s].to(torch.int32) > 0),
                      counts[n_s:].contiguous().view(torch.uint8)])


def _relay_counts_split_plain(core, packed: torch.Tensor,
                              table: TableArrays, s3: torch.Tensor,
                              mwords: torch.Tensor, lid: int, now, *,
                              rank_bits: int,
                              out_dtype: torch.dtype) -> torch.Tensor:
    """Plain version of the split digest over ``core``
    (:func:`_tb_counts_core` / :func:`_sw_counts_core`): a singleton lane
    carries count 1."""
    num_slots = packed.shape[0]
    slot_s, valid_s = _decode_s3(s3, num_slots)
    slot_m, count_m, valid_m = decode_words(mwords, rank_bits, num_slots)
    n_alw = core(packed, table, torch.cat([slot_s, slot_m]),
                 torch.cat([torch.ones_like(slot_s), count_m]),
                 torch.cat([valid_s, valid_m]), lid, now)
    lim = torch.iinfo(out_dtype).max
    return _split_result(torch.clamp(n_alw, 0, lim).to(out_dtype),
                         s3.shape[0])


def _relay_counts_split_kernel(step, packed: torch.Tensor,
                               table: TableArrays, s3: torch.Tensor,
                               mwords: torch.Tensor, lid: int, now, *,
                               rank_bits: int,
                               out_dtype: torch.dtype) -> torch.Tensor:
    """The split digest on the card: each single becomes the count-1 word
    ``(slot << (rank_bits + 1)) | (1 << 1)`` (a slot outside the table,
    the 0xFFFFFF padding, becomes the all-ones padding word: it does not
    fit the slot field), and ``step`` (the relay kernel's wrapper) runs
    once over the singles' words followed by ``mwords``."""
    slot, valid = _decode_s3(s3, packed.shape[0])
    w = torch.where(valid, (slot << (rank_bits + 1)) | (1 << 1),
                    torch.full_like(slot, 0xFFFFFFFF))
    # The uint32 bits as int32, the kernel's word lane.
    w = torch.where(w >= 1 << 31, w - (1 << 32), w).to(torch.int32)
    counts = step(packed, table, torch.cat([w, mwords]), lid, now,
                  rank_bits=rank_bits, out_dtype=out_dtype)
    return _split_result(counts, s3.shape[0])


def tb_relay_counts_split(packed: torch.Tensor, table: TableArrays,
                          s3: torch.Tensor, mwords: torch.Tensor, lid: int,
                          now: int, *, rank_bits: int,
                          out_dtype: torch.dtype = torch.uint8
                          ) -> torch.Tensor:
    """Split-digest token-bucket step for one limiter id: ``s3`` uint8[S,
    3] singles (S a multiple of 8), ``mwords`` int32[M] multi words;
    returns uint8[S / 8 + M * itemsize] and updates ``packed`` in place.
    A CPU state takes the plain version, a CUDA state the relay kernel."""
    if packed.device.type == "cpu":
        return _relay_counts_split_plain(
            _tb_counts_core, packed, table, s3, mwords, lid, now,
            rank_bits=rank_bits, out_dtype=out_dtype)
    return _relay_counts_split_kernel(
        relay_step.tb_relay_counts, packed, table, s3, mwords, lid, now,
        rank_bits=rank_bits, out_dtype=out_dtype)


def sw_relay_counts_split(packed: torch.Tensor, table: TableArrays,
                          s3: torch.Tensor, mwords: torch.Tensor, lid: int,
                          now: int, *, rank_bits: int,
                          out_dtype: torch.dtype = torch.uint8
                          ) -> torch.Tensor:
    """Split-digest sliding-window step (see
    :func:`tb_relay_counts_split`)."""
    if packed.device.type == "cpu":
        return _relay_counts_split_plain(
            _sw_counts_core, packed, table, s3, mwords, lid, now,
            rank_bits=rank_bits, out_dtype=out_dtype)
    return _relay_counts_split_kernel(
        relay_step.sw_relay_counts, packed, table, s3, mwords, lid, now,
        rank_bits=rank_bits, out_dtype=out_dtype)


def tb_relay_counts_lanes(packed: torch.Tensor, table: TableArrays,
                          uwords: torch.Tensor, lids: torch.Tensor, now, *,
                          rank_bits: int,
                          out_dtype: torch.dtype = torch.uint8
                          ) -> torch.Tensor:
    """Digest token-bucket step with a limiter id per unique (``lids``, an
    int lane beside ``uwords``): the sharded engine's tenant digest.  The
    reference ran it as composed XLA, so it is torch ops here, its row
    write :func:`ops.scatter.scatter_rows` (on the card the
    ``rl_scatter_rows`` kernel).  Returns out_dtype[U] allowed counts and
    updates ``packed`` in place."""
    slot, count, valid = decode_words(uwords, rank_bits, packed.shape[0])
    n_alw = _tb_counts_core(packed, table, slot, count, valid, lids, now,
                            write=scatter_rows)
    return torch.clamp(n_alw, 0, torch.iinfo(out_dtype).max).to(out_dtype)


def sw_relay_counts_lanes(packed: torch.Tensor, table: TableArrays,
                          uwords: torch.Tensor, lids: torch.Tensor, now, *,
                          rank_bits: int,
                          out_dtype: torch.dtype = torch.uint8
                          ) -> torch.Tensor:
    """Sliding-window counterpart of :func:`tb_relay_counts_lanes`."""
    slot, count, valid = decode_words(uwords, rank_bits, packed.shape[0])
    n_alw = _sw_counts_core(packed, table, slot, count, valid, lids, now,
                            write=scatter_rows)
    return torch.clamp(n_alw, 0, torch.iinfo(out_dtype).max).to(out_dtype)


# -- words mode ---------------------------------------------------------------
# One word per request: bit 0 flags the request as its slot's last in the
# chunk, bits 1 .. rank_bits carry its rank among the slot's requests
# (clamped at 2^rank_bits - 1, a deny sentinel as in the digest), and the
# slot rides above them.  With unit permits a request passes iff its rank
# is below what its slot has left, and the slot's one row write happens at
# its last lane, where rank + 1 is the segment's length.


def tb_relay_bits(packed: torch.Tensor, table: TableArrays,
                  words: torch.Tensor, lids: torch.Tensor, now, *,
                  rank_bits: int) -> torch.Tensor:
    """Words-mode token-bucket step: ``words`` int32[B] (the uint32 word
    bits; padding all ones), ``lids`` a 0-d limiter id or an int lane of
    them (clipped into the table).  Each touched slot's row is written at
    its last lane; ``packed`` is updated in place.  Returns uint8[ceil(B /
    8)] arrival-order allow bits, MSB first."""
    now = device_scalar(now, packed.device)
    slot, rank, valid = decode_words(words, rank_bits, packed.shape[0])
    last = (words & 1) == 1
    sc = torch.where(valid, slot, 0)
    lidc = _policy_index(lids, table.cap_fp.shape[0])
    cap = table.cap_fp[lidc]
    rate = table.rate_fp[lidc]
    maxp = table.max_permits[lidc]
    ttl2 = table.ttl2_ms[lidc]

    rows = _tb_decode(packed[sc])
    v1 = _refilled(rows, cap, rate, ttl2, now)
    # The flat step's closed form for unit permits: rank r passes iff
    # r * FP_ONE <= v1 - FP_ONE, i.e. r < avail.
    u = torch.where(valid & (maxp >= 1), v1 - TOKEN_FP_ONE,
                    torch.full_like(v1, -1))
    avail = torch.where(u >= 0, floor_div(u, TOKEN_FP_ONE) + 1,
                        torch.zeros_like(u))
    allowed = valid & (rank < avail)
    n_alw = torch.minimum(avail, rank + 1)
    any_inc = n_alw > 0
    tokens_new = torch.where(any_inc, v1 - n_alw * TOKEN_FP_ONE,
                             rows.tokens_fp)
    last_new = torch.where(any_inc, torch.clamp(now, min=1),
                           rows.last_refill)
    scatter_rows(packed, slot, valid & last,
                 _tb_encode(tokens_new, last_new))
    return packbits(allowed)


def sw_relay_bits(packed: torch.Tensor, table: TableArrays,
                  words: torch.Tensor, lids: torch.Tensor, now, *,
                  rank_bits: int) -> torch.Tensor:
    """Words-mode sliding-window step (see :func:`tb_relay_bits`), with
    the flat step's quirks for unit permits: rank r increments iff r <
    n_pass, and passes iff it also finds room after the increments before
    it (Q2)."""
    now = device_scalar(now, packed.device)
    slot, rank, valid = decode_words(words, rank_bits, packed.shape[0])
    last = (words & 1) == 1
    sc = torch.where(valid, slot, 0)
    lidc = _policy_index(lids, table.max_permits.shape[0])
    maxp = table.max_permits[lidc]
    win = table.window_ms[lidc]

    rows = _sw_decode(packed[sc])
    curr_ws, curr_e, prev_e, prev_dl_e = _rolled(rows, win, now)
    rem = torch.remainder(now, win)
    base = floor_div(prev_e * (win - rem), win)
    n_pass = torch.where(valid, torch.clamp(maxp - base - curr_e, min=0),
                         torch.zeros_like(curr_e))
    allowed = ((rank < n_pass)
               & (curr_e + torch.minimum(rank, n_pass) + 1 <= maxp) & valid)
    _sw_write_rolled(packed, slot, valid & last, rows,
                     torch.minimum(rank + 1, n_pass), curr_ws, curr_e,
                     prev_e, prev_dl_e, win, now)
    return packbits(allowed)


# -- the resident digest --------------------------------------------------------
def _fold_lid_delta(lid_map: torch.Tensor, delta_slots: torch.Tensor,
                    delta_lids: torch.Tensor) -> None:
    """``lid_map[slot] = lid`` for each uploaded pair, in place; padding
    pairs (slot -1) and slots outside the map are dropped."""
    keep = (delta_slots >= 0) & (delta_slots < lid_map.shape[0])
    lid_map[delta_slots[keep].to(torch.int64)] = delta_lids[keep].to(
        lid_map.dtype)


def _resident(core, packed, lid_map, table, uwords, delta_slots, delta_lids,
              now, rank_bits, out_dtype):
    _fold_lid_delta(lid_map, delta_slots, delta_lids)
    slot, count, valid = decode_words(uwords, rank_bits, packed.shape[0])
    lids = lid_map[torch.where(valid, slot, 0)]
    n_alw = core(packed, table, slot, count, valid, lids, now,
                 write=scatter_rows)
    return torch.clamp(n_alw, 0, torch.iinfo(out_dtype).max).to(out_dtype)


def tb_relay_counts_resident(packed: torch.Tensor, lid_map: torch.Tensor,
                             table: TableArrays, uwords: torch.Tensor,
                             delta_slots: torch.Tensor,
                             delta_lids: torch.Tensor, now, *,
                             rank_bits: int,
                             out_dtype: torch.dtype = torch.uint8
                             ) -> torch.Tensor:
    """Digest token-bucket step with the limiter ids resident on the
    device: the (slot, lid) pairs ``delta_slots`` / ``delta_lids`` (int32,
    padding slot -1) are folded into ``lid_map`` (int32[S]), then each
    unique word decides under the lid its slot maps to, as
    :func:`tb_relay_counts` decides under one.  ``packed`` and
    ``lid_map`` are updated in place; returns out_dtype[U] allowed
    counts."""
    return _resident(_tb_counts_core, packed, lid_map, table, uwords,
                     delta_slots, delta_lids, now, rank_bits, out_dtype)


def sw_relay_counts_resident(packed: torch.Tensor, lid_map: torch.Tensor,
                             table: TableArrays, uwords: torch.Tensor,
                             delta_slots: torch.Tensor,
                             delta_lids: torch.Tensor, now, *,
                             rank_bits: int,
                             out_dtype: torch.dtype = torch.uint8
                             ) -> torch.Tensor:
    """Sliding-window counterpart of :func:`tb_relay_counts_resident`."""
    return _resident(_sw_counts_core, packed, lid_map, table, uwords,
                     delta_slots, delta_lids, now, rank_bits, out_dtype)


# -- the weighted relay ---------------------------------------------------------
# A chunk's segments arrive sorted by request count, descending, with their
# permits laid out rank-major and compacted in ``perms_rank``: every rank-0
# permit (in segment order), then every rank-1 permit, ... so the segments
# still active at rank r are a PREFIX of the lanes, and rank r's permits
# are the one slice at ``roff[r]`` (engine/native_index.py:weighted_layout).
# ``roff`` stays on the host: each rank step is one slice of the device
# lane.  Decisions come back in the same layout, packed 8 to a byte: bit
# ``roff[r] + j`` decides the r-th request of the j-th segment.


def _slice_start(roff, r: int, length: int, u_b: int) -> int:
    # The reference's dynamic_slice keeps the slice inside the array.
    return max(0, min(int(roff[r]), length - u_b))


def _weighted_step_w(perms_rank, start, r, count, u_b):
    """Permits of the r-th request of every segment (0 where r >= count)."""
    w = perms_rank[start:start + u_b].to(torch.int64)
    return torch.where(r < count, w, 0)


def tb_relay_weighted(packed: torch.Tensor, table: TableArrays,
                      uwords: torch.Tensor, perms_rank: torch.Tensor, roff,
                      lid: int, now, *, rank_bits: int,
                      r_steps: int) -> torch.Tensor:
    """Weighted token-bucket relay step, one limiter: ``uwords`` int32[U]
    word bits (slot | segment count; padding all ones) in count-descending
    segment order, ``perms_rank`` uint8[L] the rank-major permits, ``roff``
    the host's ``r_steps`` rank offsets.  ``r_steps`` rank steps run the
    flat step's recurrence (a denied request consumes nothing); ``packed``
    is updated in place.  Returns uint8[L / 8] decision bits in the
    rank-major layout."""
    now = device_scalar(now, packed.device)
    u_b = uwords.shape[0]
    slot, count, valid = decode_words(uwords, rank_bits, packed.shape[0])
    sc = torch.where(valid, slot, 0)
    cap = table.cap_fp[lid]
    rate = table.rate_fp[lid]
    maxp = table.max_permits[lid]
    ttl2 = table.ttl2_ms[lid]

    rows = _tb_decode(packed[sc])
    v1 = _refilled(rows, cap, rate, ttl2, now)
    consumed = torch.zeros_like(v1)
    buf = torch.zeros(perms_rank.shape[0], dtype=torch.uint8,
                      device=packed.device)
    for r in range(r_steps):
        # Ascending block writes: each fixes the previous one's tail.
        start = _slice_start(roff, r, perms_rank.shape[0], u_b)
        w = _weighted_step_w(perms_rank, start, r, count, u_b)
        w_fp = w * TOKEN_FP_ONE
        ok = valid & (w >= 1) & (w <= maxp) & (consumed + w_fp <= v1)
        buf[start:start + u_b] = ok.to(torch.uint8)
        consumed = consumed + torch.where(ok, w_fp, 0)
    any_inc = consumed > 0
    tokens_new = torch.where(any_inc, v1 - consumed, rows.tokens_fp)
    last_new = torch.where(any_inc, torch.clamp(now, min=1),
                           rows.last_refill)
    scatter_rows(packed, slot, valid & any_inc,
                 _tb_encode(tokens_new, last_new))
    return packbits(buf)


def sw_relay_weighted(packed: torch.Tensor, table: TableArrays,
                      uwords: torch.Tensor, perms_rank: torch.Tensor, roff,
                      lid: int, now, *, rank_bits: int,
                      r_steps: int) -> torch.Tensor:
    """Weighted sliding-window relay step (see :func:`tb_relay_weighted`).
    The recurrence carries the count of prior INCREMENTS m: a request
    checks ``count + permits`` but increments by 1 (quirk Q1), and its
    decision re-checks the count after the increment (quirk Q2).  Every
    valid lane writes its rolled row."""
    now = device_scalar(now, packed.device)
    u_b = uwords.shape[0]
    slot, count, valid = decode_words(uwords, rank_bits, packed.shape[0])
    sc = torch.where(valid, slot, 0)
    maxp = table.max_permits[lid]
    win = table.window_ms[lid]
    rem = torch.remainder(now, win)

    rows = _sw_decode(packed[sc])
    curr_ws, curr_e, prev_e, prev_dl_e = _rolled(rows, win, now)
    base = floor_div(prev_e * (win - rem), win)
    m = torch.zeros_like(curr_e)
    buf = torch.zeros(perms_rank.shape[0], dtype=torch.uint8,
                      device=packed.device)
    for r in range(r_steps):
        start = _slice_start(roff, r, perms_rank.shape[0], u_b)
        w = _weighted_step_w(perms_rank, start, r, count, u_b)
        inc = valid & (w >= 1) & (m <= maxp - base - curr_e - w)
        allowed = inc & (curr_e + m + 1 <= maxp)
        buf[start:start + u_b] = allowed.to(torch.uint8)
        m = m + inc.to(torch.int64)
    _sw_write_rolled(packed, slot, valid, rows, m, curr_ws, curr_e, prev_e,
                     prev_dl_e, win, now)
    return packbits(buf)


def _sw_write_rolled(packed, slot, valid, rows, n_inc, curr_ws, curr_e,
                     prev_e, prev_dl_e, win, now) -> None:
    """Every valid lane writes its row rolled to ``now``'s window with
    ``n_inc`` more in the current bucket."""
    any_inc = n_inc > 0
    samew = rows.win_start == curr_ws
    cdl_new = torch.where(any_inc, now + win,
                          torch.where(samew, rows.curr_dl, 0))
    new_rows = _sw_encode(torch.broadcast_to(curr_ws, slot.shape),
                          curr_e + n_inc, cdl_new, prev_e, prev_dl_e)
    scatter_rows(packed, slot, valid, new_rows)


def tb_relay_weighted_counts(packed: torch.Tensor, table: TableArrays,
                             uwords: torch.Tensor, wlane: torch.Tensor,
                             lid: int, now, *, rank_bits: int,
                             out_dtype: torch.dtype = torch.uint8
                             ) -> torch.Tensor:
    """Coalesced weighted token-bucket step, one lane per unique: when
    every repeat of a key in the chunk carries the same weight w
    (``wlane`` uint8[U]), the allowed requests are a prefix of the segment
    and ``n_allowed = min(count, v1 // (w * FP_ONE))`` (0 unless 1 <= w <=
    max_permits).  ``uwords`` as the digest route's; returns out_dtype[U]
    allowed counts (clipped to the dtype) and updates ``packed`` in
    place."""
    now = device_scalar(now, packed.device)
    slot, count, valid = decode_words(uwords, rank_bits, packed.shape[0])
    sc = torch.where(valid, slot, 0)
    cap = table.cap_fp[lid]
    rate = table.rate_fp[lid]
    maxp = table.max_permits[lid]
    ttl2 = table.ttl2_ms[lid]

    rows = _tb_decode(packed[sc])
    v1 = _refilled(rows, cap, rate, ttl2, now)
    w = wlane.to(torch.int64)
    ok = valid & (w >= 1) & (w <= maxp)
    w_fp = torch.where(ok, w, 1) * TOKEN_FP_ONE
    n_alw = torch.where(ok, torch.minimum(
        torch.clamp(floor_div(v1, w_fp), min=0), count), 0)
    consumed = n_alw * w_fp
    any_inc = n_alw > 0
    tokens_new = torch.where(any_inc, v1 - consumed, rows.tokens_fp)
    last_new = torch.where(any_inc, torch.clamp(now, min=1),
                           rows.last_refill)
    scatter_rows(packed, slot, valid & any_inc,
                 _tb_encode(tokens_new, last_new))
    return torch.clamp(n_alw, 0, torch.iinfo(out_dtype).max).to(out_dtype)


def sw_relay_weighted_counts(packed: torch.Tensor, table: TableArrays,
                             uwords: torch.Tensor, wlane: torch.Tensor,
                             lid: int, now, *, rank_bits: int,
                             out_dtype: torch.dtype = torch.uint8
                             ) -> torch.Tensor:
    """Coalesced weighted sliding-window step (see
    :func:`tb_relay_weighted_counts`): a uniform weight w admits a prefix
    of ``n_inc = clip(maxp - base - curr_e - w + 1, 0, count)`` increments
    (0 unless w >= 1; Q1), and request r is allowed iff ``r < min(n_inc,
    maxp - curr_e)`` (Q2).  The state advances by ``n_inc``; the returned
    count is the Q2-checked one."""
    now = device_scalar(now, packed.device)
    slot, count, valid = decode_words(uwords, rank_bits, packed.shape[0])
    sc = torch.where(valid, slot, 0)
    maxp = table.max_permits[lid]
    win = table.window_ms[lid]
    rem = torch.remainder(now, win)

    rows = _sw_decode(packed[sc])
    curr_ws, curr_e, prev_e, prev_dl_e = _rolled(rows, win, now)
    base = floor_div(prev_e * (win - rem), win)
    w = wlane.to(torch.int64)
    ok = valid & (w >= 1)
    t = maxp - base - curr_e - w
    n_inc = torch.where(ok, torch.minimum(torch.clamp(t + 1, min=0), count),
                        0)
    n_alw = torch.minimum(n_inc, torch.clamp(maxp - curr_e, min=0))
    _sw_write_rolled(packed, slot, valid, rows, n_inc, curr_ws, curr_e,
                     prev_e, prev_dl_e, win, now)
    return torch.clamp(n_alw, 0, torch.iinfo(out_dtype).max).to(out_dtype)
