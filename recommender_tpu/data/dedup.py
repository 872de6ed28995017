"""Host-side embedding-ID dedup plans (``native/libdedup.so`` + numpy fallback).

Zipf-skewed CTR traffic is highly repetitive: the DLRM batch (8192 x 26 ids
into the 1M x 16 table, ``ctr/train.py:64-65``) carries ~213k lookup rows but
only ~36k unique ids. The device backward pays per scatter ROW, so the input
pipeline precomputes a per-batch dedup plan here (producer thread, overlapped
with the device step) and ``ops.embedding_kernels.embedding_lookup_dedup``
segment-sums cotangents into unique rows before the ~6x smaller table
scatter (checked and timed on the device by chip_smoke.py).

A plan is three int32 arrays (shapes static per batch size, jit-friendly):

  perm        [N]      positions of the flattened ids, sorted by id (stable)
  slot_sorted [N]      unique-slot index per sorted position (nondecreasing)
  uniq        [U_cap]  ascending unique ids, padded with PAD_ID (2^30 —
                       out of range, so ``sorted_scatter_add`` drops them)

The C++ radix-sort plan is the fast path; the numpy fallback
(``np.unique``, a comparison sort) exists for correctness and tests, not
throughput. Neither has been timed against the current GPU's step.
"""
from __future__ import annotations

import ctypes
import dataclasses
import subprocess
from pathlib import Path

import numpy as np

PAD_ID = np.int32(2**30)  # beyond any vocab: dropped by the segment-sum

_NATIVE_DIR = Path(__file__).resolve().parents[2] / "native"
_LIB_PATH = _NATIVE_DIR / "libdedup.so"
_lib = None
_tried = False


def _load():
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    if not _LIB_PATH.exists():
        try:
            subprocess.run(
                ["make", "-C", str(_NATIVE_DIR)],
                check=True,
                capture_output=True,
                timeout=120,
            )
        except Exception:
            return None
    try:
        lib = ctypes.CDLL(str(_LIB_PATH))
    except OSError:
        return None
    i32p = ctypes.POINTER(ctypes.c_int32)
    lib.dedup_plan.argtypes = [
        i32p, ctypes.c_int64, i32p, i32p, i32p, ctypes.c_int64, ctypes.c_int32,
    ]
    lib.dedup_plan.restype = ctypes.c_int64
    _lib = lib
    return _lib


def is_available() -> bool:
    return _load() is not None


@dataclasses.dataclass(frozen=True)
class DedupPlan:
    perm: np.ndarray  # [N] int32
    slot_sorted: np.ndarray  # [N] int32
    uniq: np.ndarray  # [U_cap] int32, ascending, PAD_ID-padded
    n_unique: int


def build_plan(ids: np.ndarray, u_cap: int) -> DedupPlan | None:
    """Dedup plan for flattened ``ids`` (non-negative int), or None if the
    batch has more than ``u_cap`` unique ids (caller falls back to the
    non-dedup lookup for that batch — but keep ``u_cap`` generous: a
    fallback batch recompiles the train step for the other lookup path)."""
    flat = np.ascontiguousarray(ids.reshape(-1), dtype=np.int32)
    n = flat.size
    lib = _load()
    if lib is not None:
        perm = np.empty(n, np.int32)
        slot = np.empty(n, np.int32)
        uniq = np.empty(u_cap, np.int32)
        i32p = ctypes.POINTER(ctypes.c_int32)
        n_uniq = lib.dedup_plan(
            flat.ctypes.data_as(i32p), n,
            perm.ctypes.data_as(i32p), slot.ctypes.data_as(i32p),
            uniq.ctypes.data_as(i32p), u_cap, ctypes.c_int32(PAD_ID),
        )
        if n_uniq < 0:
            return None
        return DedupPlan(perm, slot, uniq, int(n_uniq))
    # numpy fallback (comparison sort; tests/correctness only)
    uniq_v, inv = np.unique(flat, return_inverse=True)
    if uniq_v.size > u_cap:
        return None
    perm = np.argsort(inv, kind="stable").astype(np.int32)
    slot = inv[perm].astype(np.int32)
    uniq = np.full(u_cap, PAD_ID, np.int32)
    uniq[: uniq_v.size] = uniq_v
    return DedupPlan(perm, slot, uniq, int(uniq_v.size))
