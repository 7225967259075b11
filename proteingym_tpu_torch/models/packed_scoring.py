"""Cross-assay packed masked-marginal scoring (counterpart of
proteingym_tpu/models/packed_scoring.py).

Masked-marginal rows are independent across assays: a row is fully
described by (source tokens, masked offset). This module flattens the rows
of many assays into one work queue and runs it in shared forward batches,
so the only padded rows are the last partial chunk of a whole group.

- ``packed_masked_marginal_tables`` groups rows by length bucket: short
  sequences (T <= window) are their padded token vector with one position
  masked; each position of a long sequence is scored inside its optimal
  ``window``-token slice. Opt-in ``cols_per_forward`` masks k positions of
  one source row per forward.
- ``packed_segment_tables`` packs the masked rows of every assay, as
  segments, into fixed ``row_len``-token rows with block-diagonal attention
  (one shape for the whole sweep; rows longer than 1024 tokens take the
  extent-sparse attention kernel).

Rows are built on the device from a stacked (S, T) token tensor: each
forward ships a few small int tensors, never (rows, T) tokens. Where the
JAX package maps a jitted program over a (K, chunk) grid, a Python loop
runs the K chunks of one host step. The model is an ``nn.Module`` (or any
callable) that carries its weights, so the JAX ``params`` argument has no
counterpart. The JAX package's program cache, its rule for rounding a
bucket up to a full grid and its padding of the source count
(``seqs_pad``), compile-count policies for the TPU, have none either.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from proteingym_tpu_torch.data.windows import get_optimal_window
from proteingym_tpu_torch.models.esm2 import ALPHABET, MAX_ROW_SEGMENTS, EsmAlphabet
from proteingym_tpu_torch.models.esm_scoring import (
    _device_of, _round_up, score_mutants_from_table,
)
from proteingym_tpu_torch.ops.gather_logprobs import (
    multi_log_softmax_gather, row_log_softmax_gather,
)
from proteingym_tpu_torch.pipeline.profiler import GATHER, PLAN, READBACK, ROWS, UPLOAD, span

# k>1 multi-column mode: window starts snap DOWN to this quantum so long
# assays' sliding windows coincide and k positions can share one forward
# row. Capped at window//2 so every position still fits its snapped window.
_KCOL_START_QUANT = 128


def _packed_kernel(apply_fn: Callable, row_len: int):
    """(stacked, sids, starts, offs, mask_val) -> (K*chunk, V) float32.

    stacked: (S, T_b) tokens; sids/starts/offs: (K, chunk) int64, all on
    the device. Each work item's row is stacked[sid][start : start +
    row_len] with position ``off`` set to the mask token; the output row is
    the float32 log-softmax of the model's logits at that offset."""

    def run(stacked, sids, starts, offs, mask_val):
        positions = torch.arange(row_len, device=stacked.device)
        lanes = torch.arange(sids.shape[1], device=stacked.device)
        outs = []
        for sid, st, off in zip(sids, starts, offs):
            with span(ROWS):
                rows = stacked[sid[:, None], st[:, None] + positions]
                with span(UPLOAD):  # the scalar's copy waits for the last forward
                    rows[lanes, off] = mask_val
            outs.append(row_log_softmax_gather(apply_fn(rows), off))
        return torch.cat(outs)

    return run


def _pack_k_columns(items: np.ndarray, k: int):
    """Group per-position work items (assay, sid, start, off) that share a
    source row (identical assay/sid/start) into work rows of k offsets
    with maximum stride: row r of an n_rows-row part masks offsets
    {r, r + n_rows, r + 2*n_rows, ...}. Returns (sids, starts, offs,
    scat_assay, scat_tpos, scat_valid); offs and the scat_* arrays are
    (n_rows_total, k). Padding slots repeat the row's own first offset
    (masking a position twice is a no-op) with scat_valid False."""
    uniq, inv = np.unique(items[:, :3], axis=0, return_inverse=True)
    inv = inv.reshape(-1)
    sids, starts = [], []
    offs, s_a, s_t, s_v = [], [], [], []
    for u in range(uniq.shape[0]):
        part = items[inv == u]
        n_p = part.shape[0]
        n_rows = -(-n_p // k)
        idx = np.concatenate(
            [np.arange(n_p), np.zeros(n_rows * k - n_p, np.int64)]
        ).reshape(k, n_rows).T  # (n_rows, k) max-stride
        valid = np.concatenate(
            [np.ones(n_p, bool), np.zeros(n_rows * k - n_p, bool)]
        ).reshape(k, n_rows).T
        idx = np.where(valid, idx, idx[:, :1])
        sids.append(np.full(n_rows, part[0, 1], np.int32))
        starts.append(np.full(n_rows, part[0, 2], np.int32))
        offs.append(part[idx, 3].astype(np.int32))
        s_a.append(part[idx, 0].astype(np.int32))
        s_t.append((part[idx, 2] + part[idx, 3]).astype(np.int32))
        s_v.append(valid)
    return (np.concatenate(sids), np.concatenate(starts),
            np.concatenate(offs), np.concatenate(s_a),
            np.concatenate(s_t), np.concatenate(s_v))


def _packed_kernel_multi(apply_fn: Callable, row_len: int, k_cols: int):
    """Multi-column variant of ``_packed_kernel``: offs is (K, chunk, k)
    and each work row masks all k of its offsets in one forward, reading
    each masked offset's own log-softmax row -> (K*chunk*k, V) in
    slot-major order."""

    def run(stacked, sids, starts, offs, mask_val):
        positions = torch.arange(row_len, device=stacked.device)
        lanes = torch.arange(sids.shape[1], device=stacked.device)[:, None]
        outs = []
        for sid, st, off in zip(sids, starts, offs):
            with span(ROWS):
                rows = stacked[sid[:, None], st[:, None] + positions]
                with span(UPLOAD):
                    rows[lanes, off] = mask_val
            out = multi_log_softmax_gather(apply_fn(rows), off)  # (chunk, k, V)
            outs.append(out.reshape(-1, out.shape[-1]))
        return torch.cat(outs)

    return run


def _steps(n_chunks: int, super_chunks: int):
    """The host loop's chunk slices: ``super_chunks`` chunks per step."""
    step = max(1, int(super_chunks))
    return [slice(c, c + step) for c in range(0, n_chunks, step)]


@torch.no_grad()
def packed_masked_marginal_tables(
    apply_fn: Callable,
    token_list: Sequence[np.ndarray],
    mask_idx: Optional[int] = None,
    pad_idx: Optional[int] = None,
    chunk: int = 32,
    super_chunks: int = 8,
    window: int = 1024,
    pad_to_multiple: int = 32,
    buckets: Optional[Sequence[int]] = None,
    cols_per_forward: int = 1,
    device: Optional[torch.device] = None,
) -> List[np.ndarray]:
    """Every assay's (T_i, V) float32 masked-marginal log-prob table, built
    in shared cross-assay forward batches of ``chunk`` rows.

    token_list: per-assay token vectors (cls + seq + eos, unpadded).
    Tables equal models/esm_scoring.masked_marginal_table run per assay
    (up to attention-mask float noise).

    ``buckets``: optional explicit row-length ladder; above it, and by
    default, rows are padded to a multiple of ``pad_to_multiple`` (at most
    ``window``). ``super_chunks``: how many chunks go through one step of
    the host loop (one upload of their work indices). ``device``: where
    the forwards run (default: the module's).

    ``cols_per_forward`` (k): opt-in k-column masking: each forward masks
    k positions of one source row (max-stride assignment) and reads each
    masked position's own logits, ~1/k of the forwards. k=1, the default,
    is the reference's one-column-per-forward protocol. k>1 also snaps
    long assays' optimal-window starts down to _KCOL_START_QUANT so
    sliding windows coincide."""
    mask_idx = ALPHABET.mask_idx if mask_idx is None else mask_idx
    pad_idx = ALPHABET.padding_idx if pad_idx is None else pad_idx
    device = _device_of(apply_fn) if device is None else torch.device(device)
    k_cols = max(1, int(cols_per_forward))
    start_quant = max(1, min(_KCOL_START_QUANT, window // 2))
    lengths = [int(np.asarray(t).shape[0]) for t in token_list]

    # --- group work by row-length bucket ---------------------------------
    groups: Dict[int, dict] = defaultdict(
        lambda: {"seqs": [], "items": []}  # items: (assay, sid, start, off)
    )

    def bucket_of(total: int) -> int:
        if buckets:
            for b in sorted(buckets):
                if b >= total:
                    return min(b, window)
        return min(_round_up(total, pad_to_multiple), window)

    with span(PLAN):
        for a, toks in enumerate(token_list):
            toks = np.asarray(toks)
            total = lengths[a]
            if total <= window:
                row_len = bucket_of(total)
                g = groups[row_len]
                sid = len(g["seqs"])
                g["seqs"].append(np.concatenate(
                    [toks, np.full(row_len - total, pad_idx, toks.dtype)]))
                g["items"].extend((a, sid, 0, off) for off in range(total))
            else:
                g = groups[window]
                sid = len(g["seqs"])
                t_pad = _round_up(total, pad_to_multiple)
                g["seqs"].append(np.concatenate(
                    [toks, np.full(t_pad - total, pad_idx, toks.dtype)]))
                for i in range(total):
                    start, _end = get_optimal_window(i, total, window)
                    if k_cols > 1:
                        # snap the window start down to the quantum, but never
                        # past the point where position i leaves the window
                        snapped = start - start % start_quant
                        if i - snapped < window:
                            start = snapped
                    g["items"].append((a, sid, start, i - start))

    tables: List[Optional[np.ndarray]] = [None] * len(token_list)
    for row_len, g in sorted(groups.items()):
        with span(PLAN):
            t_max = max(max(s.shape[0] for s in g["seqs"]), row_len)
            stacked = np.full((len(g["seqs"]), t_max), pad_idx, np.int64)
            for i, s in enumerate(g["seqs"]):
                stacked[i, : s.shape[0]] = s

            items = np.asarray(g["items"], dtype=np.int64)  # (N, 4)
            if k_cols > 1:
                w_sids, w_starts, w_offs, sc_a, sc_t, sc_v = _pack_k_columns(items, k_cols)
                kernel = _packed_kernel_multi(apply_fn, row_len, k_cols)
            else:
                w_sids, w_starts, w_offs = items[:, 1], items[:, 2], items[:, 3]
                kernel = _packed_kernel(apply_fn, row_len)
            n = w_sids.shape[0]
            # pad the work queue to a chunk multiple only: a group never pays
            # for more than chunk - 1 padded rows
            n_chunks = -(-n // chunk)
            pad = n_chunks * chunk - n

            def grid(arr):
                arr = np.concatenate([arr, np.zeros((pad,) + arr.shape[1:], arr.dtype)])
                return arr.reshape((n_chunks, chunk) + arr.shape[1:])

            sids, starts, offs = grid(w_sids), grid(w_starts), grid(w_offs)
            stacked_d = torch.as_tensor(stacked, device=device)
        outs = [
            kernel(stacked_d, *(torch.as_tensor(x[sl], dtype=torch.long, device=device)
                                for x in (sids, starts, offs)), mask_idx)
            for sl in _steps(n_chunks, super_chunks)
        ]
        with span(READBACK):
            out = torch.cat(outs).cpu().numpy()
        with span(GATHER):
            vocab = out.shape[-1]
            if k_cols > 1:
                # (n_pad * k, V) slot-major; padding slots never scatter
                flat_a = sc_a.reshape(-1)
                flat_t = sc_t.reshape(-1)
                flat_v = sc_v.reshape(-1)
                out = out[: flat_a.shape[0]]
            else:
                flat_a, flat_t = items[:, 0], items[:, 2] + items[:, 3]
                flat_v = np.ones(n, bool)
                out = out[:n]
            for a in np.unique(flat_a[flat_v]):
                sel = flat_v & (flat_a == a)
                tab = np.zeros((lengths[a], vocab), np.float32)
                tab[flat_t[sel]] = out[sel]
                tables[a] = tab
    return tables


def _segment_rows(stacked, sids, starts, begins, lens, offs, row_len,
                  mask_val, pad_val):
    """Build packed rows on the device. sids/starts/begins/lens/offs:
    (chunk, slots) int64: slot s of a row holds stacked[sid][start : start +
    len] placed at row position ``begin``, with segment-relative position
    ``off`` masked; len == 0 marks an empty slot. Returns the rows
    (chunk, row_len), their segment ids (slot + 1, 0 = padding) and each
    slot's masked row position (row_len for an empty slot)."""
    t = torch.arange(row_len, device=stacked.device)
    in_slot = (t >= begins[..., None]) & (t < (begins + lens)[..., None])  # (chunk, slots, T)
    slot = in_slot.to(torch.uint8).argmax(dim=1)  # (chunk, T): first slot holding t
    valid = in_slot.any(dim=1)
    src_pos = (t - begins.gather(1, slot) + starts.gather(1, slot)).clamp(
        0, stacked.shape[1] - 1)
    rows = torch.where(valid, stacked[sids.gather(1, slot), src_pos], pad_val)
    gms = torch.where(lens > 0, begins + offs, row_len)
    # set the masked positions; an empty slot's row_len lands in a spare
    # column that is cut off again
    rows = torch.cat([rows, torch.full_like(rows[:, :1], pad_val)], dim=1)
    rows.scatter_(1, gms, mask_val)
    segs = torch.where(valid, slot + 1, 0).to(torch.int32)
    return rows[:, :row_len], segs, gms


def _segment_kernel(apply_fn: Callable, row_len: int, slots: int):
    """(stacked, sids, starts, begins, lens, offs, mask_val, pad_val) ->
    (K*chunk*slots, V) float32. The five index tensors are (K, chunk,
    slots) int64 on the device (see ``_segment_rows``); each row's forward
    runs with block-diagonal segment attention, so every packed segment
    scores as if it were alone (ref esm/compute_fitness.py:489-504 per
    segment)."""

    def run(stacked, sids, starts, begins, lens, offs, mask_val, pad_val):
        outs = []
        for args in zip(sids, starts, begins, lens, offs):
            with span(ROWS):
                rows, segs, gms = _segment_rows(stacked, *args, row_len, mask_val, pad_val)
            out = multi_log_softmax_gather(apply_fn(rows, segs), gms)  # (chunk, S, V)
            outs.append(out.reshape(-1, out.shape[-1]))
        return torch.cat(outs)

    return run


def _plan_rows(
    counts: Dict[int, int], row_len: int, max_slots: int
) -> List[List[int]]:
    """Greedy bin packing of segment lengths into rows.

    counts: {segment_length: how_many}. Returns one list of segment
    lengths per row. Repeatedly fills a row with the largest remaining
    length that fits (first-fit-decreasing over a handful of distinct
    lengths, one per assay)."""
    remaining = dict(counts)
    rows: List[List[int]] = []
    lengths = sorted(remaining, reverse=True)
    if lengths and lengths[0] > row_len:
        raise ValueError(
            f"segment length {lengths[0]} exceeds row_len {row_len}"
        )
    while any(remaining.values()):
        free, used = row_len, []
        while len(used) < max_slots:
            pick = next(
                (L for L in lengths if remaining.get(L, 0) and L <= free),
                None,
            )
            if pick is None:
                break
            used.append(pick)
            remaining[pick] -= 1
            free -= pick
        rows.append(used)
    return rows


@torch.no_grad()
def packed_segment_tables(
    seg_apply_fn: Callable,
    token_list: Sequence[np.ndarray],
    mask_idx: Optional[int] = None,
    pad_idx: Optional[int] = None,
    row_len: int = 1024,
    chunk: int = 8,
    super_chunks: int = 8,
    window: int = 1024,
    max_slots: Optional[int] = None,
    device: Optional[torch.device] = None,
) -> List[np.ndarray]:
    """Segment-packed cross-assay masked-marginal tables.

    Packs the masked rows of every assay, any length mix, into fixed
    ``row_len``-token rows with block-diagonal segment attention, ``chunk``
    rows per forward; per assay the tables equal
    ``packed_masked_marginal_tables``'s (each segment scores as if alone).
    Sequences longer than ``window`` score through optimal windows, which
    pack like any other segment.

    seg_apply_fn: (tokens, segment_ids) -> logits, e.g.
    ``esm2.make_segmented_apply_fn(model)``. ``super_chunks``: how many
    chunks go through one step of the host loop. ``device``: where the
    forwards run (default: the module's)."""
    mask_idx = ALPHABET.mask_idx if mask_idx is None else mask_idx
    pad_idx = ALPHABET.padding_idx if pad_idx is None else pad_idx
    device = _device_of(seg_apply_fn) if device is None else torch.device(device)
    max_slots = min(MAX_ROW_SEGMENTS if max_slots is None else max_slots,
                    MAX_ROW_SEGMENTS)
    window = min(window, row_len)
    lengths = [int(np.asarray(tk).shape[0]) for tk in token_list]

    with span(PLAN):
        # --- flatten every assay into (assay, sid, start, off, seg_len) ------
        seqs: List[np.ndarray] = []
        items: List[Tuple[int, int, int, int, int]] = []
        for a, toks in enumerate(token_list):
            total = lengths[a]
            sid = len(seqs)
            seqs.append(np.asarray(toks))
            if total <= window:
                items.extend((a, sid, 0, off, total) for off in range(total))
            else:
                for i in range(total):
                    start, _end = get_optimal_window(i, total, window)
                    items.append((a, sid, start, i - start, window))

        # --- plan rows, assign items to slots --------------------------------
        counts: Dict[int, int] = defaultdict(int)
        for it in items:
            counts[it[4]] += 1
        plan = _plan_rows(counts, row_len, max_slots)
        slots = max((len(r) for r in plan), default=1)
        slots = min(_round_up(max(slots, 1), 4), max_slots)

        by_len: Dict[int, List[Tuple[int, int, int, int, int]]] = defaultdict(list)
        for it in items:
            by_len[it[4]].append(it)

        n_chunks = -(-len(plan) // chunk)
        n_rows_pad = n_chunks * chunk
        # sids, starts, begins, lens, offs per (row, slot)
        work = np.zeros((5, n_rows_pad, slots), np.int64)
        # (assay, table_pos) per (row, slot); -1 = empty
        meta = np.full((n_rows_pad, slots, 2), -1, np.int64)
        for r, row_plan in enumerate(plan):
            begin = 0
            for s, seg_len in enumerate(row_plan):
                a, sid, start, off, _ = by_len[seg_len].pop()
                work[:, r, s] = (sid, start, begin, seg_len, off)
                meta[r, s] = (a, start + off)
                begin += seg_len

        # --- stack sources ---------------------------------------------------
        stacked = np.full((len(seqs), _round_up(max(s.shape[0] for s in seqs), 32)),
                          pad_idx, np.int64)
        for i, s in enumerate(seqs):
            stacked[i, : s.shape[0]] = s
        kernel = _segment_kernel(seg_apply_fn, row_len, slots)
        stacked_d = torch.as_tensor(stacked, device=device)
        grid = work.reshape(5, n_chunks, chunk, slots)
    outs = [
        kernel(stacked_d, *torch.as_tensor(grid[:, sl], device=device), mask_idx, pad_idx)
        for sl in _steps(n_chunks, super_chunks)
    ]
    with span(READBACK):
        out = torch.cat(outs).cpu().numpy()  # (rows_pad * slots, V)
    with span(GATHER):
        vocab = out.shape[-1]
        flat_meta = meta.reshape(-1, 2)
        tables = [np.zeros((n, vocab), np.float32) for n in lengths]
        live = flat_meta[:, 0] >= 0
        for a in range(len(token_list)):
            sel = live & (flat_meta[:, 0] == a)
            tables[a][flat_meta[sel, 1]] = out[sel]
    return tables


def score_assays_packed(
    apply_fn: Optional[Callable],
    assays: Sequence[Tuple[str, Sequence[str]]],
    alphabet: EsmAlphabet = ALPHABET,
    offset_idx: int = 1,
    chunk: int = 32,
    super_chunks: int = 8,
    window: int = 1024,
    pad_to_multiple: int = 32,
    buckets: Optional[Sequence[int]] = None,
    seg_apply_fn: Optional[Callable] = None,
    row_len: int = 1024,
    seg_chunk: int = 8,
    cols_per_forward: int = 1,
    device: Optional[torch.device] = None,
) -> List[np.ndarray]:
    """Masked-marginal scores of many (sequence, mutants) assays with
    cross-assay row packing; per assay they match
    models/esm_scoring.score_assay(strategy='masked-marginals').

    With ``seg_apply_fn`` (e.g. ``esm2.make_segmented_apply_fn(model)``)
    rows also pack segments of different assays into fixed ``row_len`` rows
    (block-diagonal attention), ``seg_chunk`` rows per forward; otherwise
    ``apply_fn`` runs the bucketed path. ``cols_per_forward`` > 1 enables
    the opt-in k-column table approximation of the bucketed path and does
    not combine with ``seg_apply_fn``."""
    if cols_per_forward > 1 and seg_apply_fn is not None:
        raise ValueError(
            "cols_per_forward > 1 does not combine with segment packing"
        )
    with span(PLAN):
        token_list = [alphabet.tokenize(seq) for seq, _ in assays]
    if seg_apply_fn is not None:
        tables = packed_segment_tables(
            seg_apply_fn, token_list,
            mask_idx=alphabet.mask_idx, pad_idx=alphabet.padding_idx,
            row_len=row_len, chunk=seg_chunk, super_chunks=super_chunks,
            window=window, device=device,
        )
    else:
        tables = packed_masked_marginal_tables(
            apply_fn, token_list,
            mask_idx=alphabet.mask_idx, pad_idx=alphabet.padding_idx,
            chunk=chunk, super_chunks=super_chunks, window=window,
            pad_to_multiple=pad_to_multiple, buckets=buckets,
            cols_per_forward=cols_per_forward, device=device,
        )
    return [
        score_mutants_from_table(tables[i], mutants, seq,
                                 offset_idx=offset_idx, alphabet=alphabet)
        for i, (seq, mutants) in enumerate(assays)
    ]
