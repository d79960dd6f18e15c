"""Replication frame wire format (counterpart of
``ratelimiter_tpu/replication/wire.py``, byte for byte: a frame either
package encodes decodes and applies in the other).

A frame is the unit the primary ships to a standby: an epoch-stamped
delta of packed state rows (the coalesced dirty-slot set of one
``SlotJournal.drain``), plus — on the epoch's last sub-frame — the
key->slot index journal and the limiter registrations that make the
rows addressable after a promotion.

Encoding reuses the checkpoint machinery's array detach/attach
(engine/checkpoint.py) so native fingerprint index dumps ship as raw
numpy arrays, not JSON:

    b"RLRP" | u16 version | u32 json_len | json meta | npz payload

Large epochs are CHUNKED (:func:`chunk_frames`) to the same per-dispatch
wire budget the reference's streaming loops use: each sub-frame's row
payload stays under ``max_bytes`` so one slow frame never parks the link, and the standby
applies sub-frames as they land (rows are idempotent writes; only the
``last`` sub-frame advances the epoch).
"""

from __future__ import annotations

import io
import json
import struct
from typing import Dict, List, Optional

import numpy as np

from ratelimiter_tpu_torch.engine.checkpoint import (
    _attach_index_arrays,
    _detach_index_arrays,
)

MAGIC = b"RLRP"
WIRE_VERSION = 1

# Per-sub-frame row-payload budget: the reference's 16 MB per-dispatch
# wire budget (large transfers amortize best in ~16 MB units).
DEFAULT_FRAME_BUDGET = 16 << 20

_HEADER = struct.Struct("<4sHI")  # magic, version, json length


def chunk_frames(
    epoch: int,
    cut_ms: int,
    num_slots: int,
    deltas: Dict[str, Dict[str, np.ndarray]],
    index_dump: Dict,
    limiters: Dict,
    full: bool = False,
    max_bytes: int = DEFAULT_FRAME_BUDGET,
) -> List[Dict]:
    """Split one epoch's deltas into sub-frames within the wire budget.

    ``deltas`` maps algo -> {"slots": i64[n], "rows": i32[n, L]}.  The
    index journal and limiter table ride only on the LAST sub-frame:
    they describe the state at the cut, so applying them before every
    row has landed would let a promotion see keys whose rows are still
    in flight.
    """
    pieces: List[Dict] = []  # (algo, slots, rows) chunks, budget-sized
    for algo, payload in deltas.items():
        slots = np.asarray(payload["slots"], dtype=np.int64)
        rows = np.asarray(payload["rows"], dtype=np.int32)
        if not len(slots):
            continue
        row_bytes = max(rows[0].nbytes + 8, 1)
        per = max(int(max_bytes // row_bytes), 1)
        for i in range(0, len(slots), per):
            pieces.append({"algo": algo,
                           "slots": slots[i:i + per],
                           "rows": rows[i:i + per]})
    frames: List[Dict] = []
    if not pieces:
        pieces = [None]  # index/limiters-only frame (still epoch-stamped)
    for seq, piece in enumerate(pieces):
        last = seq == len(pieces) - 1
        frame: Dict = {
            "epoch": int(epoch),
            "seq": seq,
            "last": last,
            "full": bool(full),
            "cut_ms": int(cut_ms),
            "num_slots": int(num_slots),
            "algos": {},
        }
        if piece is not None:
            frame["algos"][piece["algo"]] = {
                "slots": piece["slots"], "rows": piece["rows"]}
        if last:
            frame["index"] = index_dump
            frame["limiters"] = limiters
        frames.append(frame)
    return frames


def encode_frame(frame: Dict) -> bytes:
    """Serialize a frame dict (numpy arrays -> npz, the rest -> JSON)."""
    arrays: Dict[str, np.ndarray] = {}
    meta = {k: v for k, v in frame.items() if k not in ("algos", "index")}
    meta["algos"] = sorted(frame.get("algos", {}))
    for algo, payload in frame.get("algos", {}).items():
        arrays[f"delta_{algo}_slots"] = np.asarray(payload["slots"],
                                                   dtype=np.int64)
        arrays[f"delta_{algo}_rows"] = np.asarray(payload["rows"],
                                                  dtype=np.int32)
    if "index" in frame:
        meta["index"] = _detach_index_arrays(frame["index"], arrays)
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    blob = json.dumps(meta).encode()
    return _HEADER.pack(MAGIC, WIRE_VERSION, len(blob)) + blob + buf.getvalue()


def decode_frame(data: bytes) -> Dict:
    magic, version, jlen = _HEADER.unpack_from(data)
    if magic != MAGIC:
        raise ValueError("not a replication frame (bad magic)")
    if version != WIRE_VERSION:
        raise ValueError(f"unsupported replication wire version {version}")
    meta = json.loads(data[_HEADER.size:_HEADER.size + jlen])
    arrays = dict(np.load(io.BytesIO(data[_HEADER.size + jlen:]),
                          allow_pickle=False))
    frame: Dict = {k: v for k, v in meta.items() if k not in ("algos",
                                                              "index")}
    frame["algos"] = {
        algo: {"slots": arrays[f"delta_{algo}_slots"],
               "rows": arrays[f"delta_{algo}_rows"]}
        for algo in meta.get("algos", [])
    }
    if "index" in meta:
        frame["index"] = _attach_index_arrays(meta["index"], arrays)
    return frame


def frame_slots(frame: Dict) -> Dict[str, Optional[np.ndarray]]:
    """Per-algo slot ids a frame carries (re-mark set on ship failure)."""
    return {algo: payload["slots"]
            for algo, payload in frame.get("algos", {}).items()}
