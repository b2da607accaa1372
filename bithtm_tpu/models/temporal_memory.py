"""Functional TemporalMemory: one recurrent timestep as a pure function.

Re-implements the semantics of `TemporalMemory.process`
(`networks.py:91-128`) + `PredictiveProjection.process/update`
(`projections.py:245-293`) over a static **per-column** padded synapse
pool, in the order the reference executes them:

  1. bursting from previous prediction            (`networks.py:96-97`)
  2. winner-cell selection (best-matching / least-used, jittered
     tie-breaks)                                   (`networks.py:100-104`)
  3. learning: permanence +/-, synapse death, punishment, segment
     allocation (recycle-before-grow), synapse growth toward previous
     winners                                       (`networks.py:106-113`)
  4. activation (predicted | bursting)             (`networks.py:115-119`)
  5. distal forward pass -> next prediction        (`networks.py:121-127`)

Design (why this looks nothing like the reference):
  * The active/winner cell sets ride as exactly-A compact column lists
    + cell bitmasks, so "is this synapse's target active?" is an A-wide
    vectorized compare (`ops/active_set.synapse_activation_xla`), and
    all per-cell segment reductions are one-hot over the D axis.
  * Full-table arrays stay **flat (C, G*K)**. Per-segment counts on the
    full table go through a constant block matrix as one exact dot
    (`ops/active_set.seg_counts_packed`); per-segment *broadcasts* ride
    as packed per-column bitmask words expanded in the table pass.
  * All learning mutation is compacted to the A active-column rows
    (winner cells and learning segments only exist there), where 3D
    shapes are tiny; the only full-table learning op is the punishment
    decrement, a pure elementwise pass.
  * Minimal sorting: active columns are sorted once per step (A-wide),
    growth sampling is one `lax.sort` of random priorities over the
    narrow candidate axis (sortfill), and segment allocation is
    deterministic rank-pairing.

Capacity overflows (per-column pool or synapse rows full) are dropped
and surfaced as metrics instead of reallocating (the reference grows
arrays, `utils.py:113-135`).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..config import TMConfig
from ..ops.active_set import (
    argmax_onehot,
    column_mask_from_cols,
    compact_first_k,
    pack_bits,
    percell_max,
    percell_sum,
    prediction_dense,
    prediction_words,
    rank_ascending,
    seg_counts_packed,
    seg_counts_packed_rows,
    synapse_activation_conn,
    synapse_activation_frozen,
    table_update_xla,
    take_percell,
    take_small_table,
    unpack_bits,
)
from ..state import TMState


class TMOutput(NamedTuple):
    """Per-step observables, mirroring `TemporalMemory.State`
    (`networks.py:39-46`) as dense masks plus bookkeeping metrics."""

    active_mask: jnp.ndarray      # (N,) bool
    winner_mask: jnp.ndarray      # (N,) bool
    prediction: jnp.ndarray       # (N,) bool (for the *next* step;
                                  #   unpacked from the packed carry —
                                  #   XLA fuses/DCEs it when unused)
    prev_prediction: jnp.ndarray  # (N,) bool (this step's input prediction)
    prev_col_prediction: jnp.ndarray  # (C,) bool any-cell-predicted, read
                                  #   straight off the packed carry (the
                                  #   driver metrics' hot consumer — the
                                  #   dense (N,) forms relayout-transpose
                                  #   when materialized in the scan)
    bursting_columns: jnp.ndarray # (C,) bool
    metrics: dict


class TMDebug(NamedTuple):
    """Decision trace for oracle parity testing (see
    `bithtm_tpu/oracle`): every RNG-dependent choice the step made."""

    winner_mask: jnp.ndarray       # (N,) bool
    learning_segments: jnp.ndarray # (C, G) bool (incl. newly allocated)
    punished_segments: jnp.ndarray # (C, G) bool
    new_segments: jnp.ndarray      # (C, G) bool newly allocated this step
    grown_mask: jnp.ndarray        # (C, G, K) bool slots grown this step
    synapse_cell: jnp.ndarray      # (C, G, K) int32 post-step targets
    seg_cell: jnp.ndarray          # (C, G) int32 post-step owners


def _winner_selection(cfg: TMConfig, state: TMState, key: jax.Array,
                      active_cols: jnp.ndarray, pred_rows: jnp.ndarray):
    """Steps 1-2 in active-column space.

    Returns (col_burst, winner_rows, cell_max_j, seg_j):
      col_burst  (A,)    bursting active columns (`networks.py:96-97`)
      winner_rows (A, D) winner cells             (`networks.py:100-104`)
      cell_max_j (A, D)  per-cell max jittered matching potential
                         (`projections.py:229-243`)
      seg_j      (A, G)  per-segment jittered potential (shared with the
                         learning phase, `projections.py:241-243`)
    """
    A, D, G = cfg.active_columns, cfg.cell_dim, cfg.segments_per_column
    K = cfg.synapse_capacity
    k_seg, k_least = jax.random.split(key)

    col_burst = ~pred_rows.any(axis=-1)                       # (A,)

    # Per-segment potential / matching at the active rows, re-derived
    # from the cached forward activity (the table is unchanged since
    # the previous step's forward pass, so these equal the values that
    # step computed — `utils.checks` audits exactly this invariant).
    # Re-deriving from the (A, G, K) row gather replaces carrying
    # (C, G) arrays; the packed-count decode is one reduce (shared with
    # `_learn` by jit CSE).
    pot_rows, _ = seg_counts_packed_rows(
        state.synapse_act[active_cols].reshape(A, G, K), K
    )                                                         # (A, G)
    match_rows = pot_rows >= cfg.segment_matching_threshold
    segcell_rows = state.seg_cell[active_cols]                # (A, G)

    # Jittered max matching potential per cell (networks.py:73-82).
    seg_j = jnp.where(
        match_rows,
        pot_rows.astype(jnp.float32)
        + jax.random.uniform(k_seg, (A, G), jnp.float32),
        0.0,
    )
    cell_max_j = percell_max(segcell_rows, seg_j, D, 0.0)     # (A, D)
    col_max = cell_max_j.max(axis=-1)                         # (A,)
    col_matching = col_max >= cfg.segment_matching_threshold

    # Jittered least-used segment count per cell (networks.py:84-89).
    seg_count = percell_sum(
        segcell_rows, jnp.ones((A, G), jnp.int32), D
    ).astype(jnp.float32)
    least_j = seg_count + jax.random.uniform(k_least, (A, D), jnp.float32)

    # Bursting columns pick exactly one winner: the (jittered) argmax is
    # a.s. a member of the reference's epsilon-tied candidate set
    # (best-matching if the column has a matching segment, else
    # least-used; networks.py:102-104).
    burst_score = jnp.where(col_matching[:, None], cell_max_j, -least_j)
    burst_sel = argmax_onehot(burst_score)                    # (A, D)
    winner_rows = pred_rows | (col_burst[:, None] & burst_sel)
    return col_burst, winner_rows, cell_max_j, seg_j


def _allocate(cfg: TMConfig, segcell_rows, syn_rows, match_rows, unacc):
    """Per-column segment allocation for unaccounted winner cells
    (`projections.py:271-281` + `add_output` recycling,
    `projections.py:79-95`), deterministic rank pairing:

    Eligible slots (live synapses < matching threshold — `add_output`'s
    `edges_threshold`, `projections.py:80`) are ordered allocated-
    recyclable-first then unallocated, ascending slot index; unaccounted
    cells ascending cell index; the i-th cell takes the i-th slot.
    Overflow (more cells than eligible slots in a column) is dropped —
    unless ``cfg.allocation_policy == "evict"``, in which case mature
    non-matching slots become a third eligibility tier ordered by
    (ascending live-synapse count, ascending slot), so overflow evicts
    the weakest stale context instead (see TMConfig.allocation_policy).

    Returns (new_seg (A,G) bool, new_owner (A,G) cell, n_dropped,
    n_evicted).
    """
    A, D, G = cfg.active_columns, cfg.cell_dim, cfg.segments_per_column
    syn_count = (syn_rows >= 0).sum(axis=-1, dtype=jnp.int32)   # (A, G)
    recyclable = syn_count < cfg.segment_matching_threshold
    unallocated = segcell_rows >= D
    g = jnp.arange(G, dtype=jnp.int32)
    key = g + G * unallocated.astype(jnp.int32)                  # (A, G)
    if cfg.allocation_policy == "evict":
        evictable = ~match_rows & ~recyclable
        key = jnp.where(recyclable, key, 2 * G + syn_count * G + g)
        eligible = recyclable | evictable
    elif cfg.allocation_policy == "reference":
        evictable = jnp.zeros_like(recyclable)
        eligible = recyclable
    else:
        raise ValueError(
            f"unknown allocation_policy {cfg.allocation_policy!r}"
        )
    # rank among eligible slots by ascending key (keys are distinct)
    elig_rank = jnp.where(
        eligible,
        jnp.sum(
            (key[:, :, None] > key[:, None, :]) & eligible[:, None, :],
            axis=-1, dtype=jnp.int32,
        ),
        -1,
    )
    un_rank = jnp.where(unacc, rank_ascending(unacc), -2)        # (A, D)
    assign = eligible[:, :, None] & unacc[:, None, :] & (
        elig_rank[:, :, None] == un_rank[:, None, :]
    )                                                            # (A, G, D)
    new_seg = assign.any(axis=-1)
    new_owner = jnp.sum(
        assign * jnp.arange(D, dtype=jnp.int32), axis=-1, dtype=jnp.int32
    )
    n_dropped = unacc.sum(dtype=jnp.int32) - assign.sum(dtype=jnp.int32)
    n_evicted = (new_seg & evictable).sum(dtype=jnp.int32)
    return new_seg, new_owner, n_dropped, n_evicted


def _select_and_fill(pri, n_grow, cand_cell, free, samp, method,
                     idx_bits: int | None = None):
    """Growth-candidate selection + free-slot fill, shared core of
    `_grow` (replace_free semantics, `utils.py:44-76`): per row, choose
    the ``n_grow[i]`` smallest finite priorities and write them into the
    first free slots.

    Four methods choosing the **identical candidate set** (away from
    measure-zero priority ties) but placing it differently — placement
    within a segment is semantically free (a segment is a *set* of
    synapses; the oracle adopts grown sets per slot, not positions):
      * ``sortfill_packed_cell`` (default when the cell id fits, see
        `_grow`) — ``pri`` is a uint32 key with the candidate's cell id
        in the low ``idx_bits`` bits and i.i.d. random bits above
        (invalid = 0xFFFFFFFF, which no valid key reaches: valid keys
        keep bit 31 clear); ONE payload-free `lax.sort` both ranks and
        carries the candidates, halving the sorted bytes of
        ``sortfill`` with no decode step.
      * ``sortfill_packed_idx`` (default for large cell spaces) —
        ``pri`` is an int32 key with the candidate's **list index** in
        the low ``idx_bits`` bits and i.i.d. random bits in bits
        [idx_bits, 29] (invalid = 0x7FFFFFFF, unreachable: valid keys
        keep bits 30-31 clear); the payload-free s32 sort moves half
        the bytes of the f32+s32 pair sort, and one gather maps the
        chosen indices back to cells from the shared candidate list
        (`take_small_table`).
      * ``sortfill`` — one `lax.sort` of (priority f32, candidate s32)
        pairs; the r-th smallest priority fills the r-th free slot
        (no O(Wc^2) rank tensor, no (K, Wc) match tensor).
      * ``pairwise`` — O(Wc^2) rank-count compares mapping the r-th
        chosen candidate in **ascending candidate order** to the r-th
        free slot (the reference's `replace_free` placement,
        `utils.py:44-76`); kept as the readable cross-check.

    Returns (gathered (L,K) int32 candidate per slot — garbage where
    not written, wrote_l (L,K) bool, n_chosen (L,) int32)."""
    L, Wc = pri.shape
    K = free.shape[-1]
    free_rank = rank_ascending(free)                             # (L, K)
    if method in ("sortfill_packed_cell", "sortfill_packed_idx"):
        if method == "sortfill_packed_cell":
            sent = jnp.uint32(0xFFFFFFFF)
        else:
            sent = jnp.int32(0x7FFFFFFF)
        n_valid = (pri != sent).sum(axis=-1, dtype=jnp.int32)
        n_chosen = jnp.minimum(n_grow, n_valid)                  # (L,)
        kk = min(samp, Wc)                                       # n_grow <= samp
        # Only the kk smallest keys are consumed, so wide candidate
        # lists use an exact split selection instead of one full-width
        # sort: sort 192-wide blocks, keep each block's kk smallest,
        # sort the n*kk survivors (any global top-kk key is within the
        # top kk of its block). The split dispatches only for wide
        # lists, small kk and a merge width <= 256; the 192 block width
        # is a tuning constant that has not been re-swept on the GPU.
        _SPLIT_W = 192
        n_blk = -(-Wc // _SPLIT_W)
        if Wc >= 2 * _SPLIT_W and kk <= _SPLIT_W // 2 \
                and n_blk * kk <= 256:
            pad = n_blk * _SPLIT_W - Wc
            keys = pri if pad == 0 else jnp.concatenate(
                [pri, jnp.full((L, pad), sent, pri.dtype)], axis=-1
            )
            blocks = jax.lax.sort(
                keys.reshape(L, n_blk, _SPLIT_W),
                dimension=-1, is_stable=False,
            )
            survivors = blocks[:, :, :kk].reshape(L, n_blk * kk)
            sorted_key = jax.lax.sort(
                survivors, dimension=-1, is_stable=False
            )
        else:
            sorted_key = jax.lax.sort(pri, dimension=-1, is_stable=False)
        low = pri.dtype.type((1 << idx_bits) - 1)
        if method == "sortfill_packed_cell":
            chosen_cell = (sorted_key[:, :kk] & low).astype(jnp.int32)
        else:
            chosen_idx = (sorted_key[:, :kk] & low).astype(jnp.int32)
            # index -> cell against the shared candidate list (one
            # gather); sentinel rows decode to an out-of-range or
            # arbitrary index, but land only in slots with
            # free_rank >= n_chosen, which wrote_l never writes.
            chosen_cell = take_small_table(cand_cell, chosen_idx)
        r = jnp.arange(kk, dtype=jnp.int32)
        sel = free_rank[:, None, :] == r[:, None]                # (L, kk, K)
        gathered = jnp.sum(
            sel * chosen_cell[:, :, None], axis=1, dtype=jnp.int32
        )                                                        # (L, K)
    elif method == "sortfill":
        n_valid = (pri < jnp.inf).sum(axis=-1, dtype=jnp.int32)
        n_chosen = jnp.minimum(n_grow, n_valid)                  # (L,)
        _, cand_by_pri = jax.lax.sort(
            (pri, jnp.broadcast_to(cand_cell, pri.shape)),
            dimension=-1, num_keys=1, is_stable=False,
        )                                                        # (L, Wc)
        # is_stable=False drops the iota tie-break operand: priorities are i.i.d. uniform floats, so ties
        # among *selected* (finite) entries are measure-zero, and the
        # +inf-masked invalid entries sort behind every finite priority
        # regardless of their relative order.
        kk = min(samp, Wc)                                       # n_grow <= samp
        r = jnp.arange(kk, dtype=jnp.int32)
        sel = free_rank[:, None, :] == r[:, None]                # (L, kk, K)
        gathered = jnp.sum(
            sel * cand_by_pri[:, :kk, None], axis=1, dtype=jnp.int32
        )                                                        # (L, K)
    elif method == "pairwise":
        rank = jnp.sum(
            pri[:, None, :] < pri[:, :, None], axis=-1, dtype=jnp.int32
        )                                                        # (L, Wc)
        chosen = (pri < jnp.inf) & (rank < n_grow[:, None])
        chosen_rank = rank_ascending(chosen)                     # (L, Wc)
        n_chosen = chosen.sum(axis=-1, dtype=jnp.int32)          # (L,)
        match = chosen[:, None, :] & (
            chosen_rank[:, None, :] == free_rank[:, :, None]
        )                                                        # (L, K, Wc)
        gathered = jnp.sum(match * cand_cell, axis=-1, dtype=jnp.int32)
    else:
        raise ValueError(f"unknown selection method {method!r}")
    wrote_l = free & (free_rank < n_chosen[:, None])
    return gathered, wrote_l, n_chosen


def _grow(cfg: TMConfig, key, syn_rows, perm_rows, learn_rows,
          act_prev_rows, prev_cols, prev_winner_bits):
    """Synapse growth toward previous winner cells
    (`projections.py:111-161,190-192`): per learning segment, grow
    n = clip(sampling - active_potential, 0, min(sampling, n_winners))
    random candidates (i.i.d. uniform priorities, smallest-n selected by
    `_select_and_fill`), never duplicating existing targets, written
    into free slots in ascending candidate/slot order (`utils.py:44-76`).

    The growing segments (typically ~1 per active column out of the
    A*G active-column slots) are first compacted to an L-wide list so
    the O(Wc)-and-O(Wc^2) selection math runs on ~128 rows, not ~656.

    Returns (syn_rows, perm_rows, wrote (A,G,K) bool, n_grown, overflow,
    n_winners_dropped, n_growth_dropped).
    """
    A, D, G, K = (cfg.active_columns, cfg.cell_dim, cfg.segments_per_column,
                  cfg.synapse_capacity)
    Wc = cfg.resolved_winner_capacity
    L = cfg.resolved_growth_capacity
    samp = cfg.segment_sampling_synapses

    n_winners = jax.lax.population_count(prev_winner_bits).sum().astype(
        jnp.int32
    )

    # Candidate list: previous winner cells, compacted (ascending cell
    # id — prev_cols is sorted) to the Wc lowest. Typical winner count is
    # ~1 per active column, far below Wc; truncation is counted. The
    # narrow candidate axis keeps the selection/fill ops cheap.
    grid_cell = (
        prev_cols[:, None] * D + jnp.arange(D, dtype=jnp.int32)
    ).reshape(A * D)
    grid_valid = unpack_bits(prev_winner_bits, D).reshape(A * D)
    cand_cell, cand_valid = compact_first_k(grid_valid, grid_cell, Wc)
    n_winners_eff = jnp.minimum(n_winners, Wc)

    # --- compact the growing segments to L rows (ascending slot id) ---
    # (compact_first_k's rank/one-hot form, in place of
    # `jnp.nonzero(size=L)`)
    learn_flat = learn_rows.reshape(A * G)
    lidx_c, lvalid = compact_first_k(
        learn_flat, jnp.arange(A * G, dtype=jnp.int32), L
    )                                                            # (L,)
    lidx = jnp.where(lvalid, lidx_c, A * G)
    syn_l = jnp.take(syn_rows.reshape(A * G, K), lidx, axis=0,
                     mode="clip")                                # (L, K)
    act_l = jnp.take(act_prev_rows.reshape(A * G, K), lidx, axis=0,
                     mode="clip")
    live_l = syn_l >= 0
    row_potential = (act_l & live_l).sum(axis=-1, dtype=jnp.int32)
    n_grow = jnp.where(
        lvalid,
        jnp.clip(samp - row_potential, 0, jnp.minimum(samp, n_winners_eff)),
        0,
    )                                                            # (L,)

    # Random priorities; existing targets and non-winner slots are
    # excluded (projections.py:120-121's put_along_axis(..., inf)
    # trick). The priority key is a single packed integer sorted
    # payload-free; what identifies the candidate in the low bits
    # depends on the cell-space size:
    #   * cell id fits with >= 15 spare random bits (the default
    #     2048 x 32 = 16-bit cell space): embed the cell id — no
    #     decode step at all (``sortfill_packed_cell``).
    #   * larger cell spaces (16K x 64 = 2^20 cells): embed the
    #     candidate **list index** (<= 10 bits for Wc <= 1024), which
    #     leaves >= 30 - idx_bits >= 20 random bits, and decode
    #     index -> cell with one gather (``sortfill_packed_idx``),
    #     sorting half the bytes of an f32+s32 pair sort.
    # Either way valid keys never tie exactly (distinct ids/indices),
    # and random-bit collisions (falling back to order-by-low-bits
    # among the collided pair) are a <= 0.1%-of-selected event — the
    # grown set stays a uniform random sample to that tolerance.
    # The existing-target test only needs the ACTIVE live synapses:
    # candidates are previous winner cells, winners are a subset of
    # active cells, and act_prev was computed by the forward pass AFTER
    # the previous step's growth — so every live synapse targeting a
    # candidate has its act_prev bit set. A row only grows when
    # potential < samp, i.e. it has fewer than samp active-live slots,
    # so compacting those targets to the first `samp` positions is
    # lossless exactly where the mask matters (rows at or past samp
    # have n_grow == 0 and select nothing). Halves the (L, K, Wc)
    # compare when samp < K (the shipped configs: 32 < 48/64).
    if samp < K:
        act_valid = act_l & live_l
        r_act = jnp.where(act_valid, rank_ascending(act_valid), -1)
        sel_act = (
            r_act[:, :, None] == jnp.arange(samp, dtype=jnp.int32)
        )                                                        # (L, K, samp)
        syn_cmp = jnp.sum(
            sel_act * syn_l[:, :, None], axis=1, dtype=jnp.int32
        )                                                        # (L, samp)
        syn_cmp = jnp.where(
            jnp.arange(samp, dtype=jnp.int32) < row_potential[:, None],
            syn_cmp, -1,
        )
    else:
        syn_cmp = syn_l
    existing = (syn_cmp[:, :, None] == cand_cell).any(axis=1)    # (L, Wc)
    valid = cand_valid & ~existing
    n_cells = cfg.column_dim * D
    cell_bits = max(1, (n_cells - 1).bit_length())
    free = ~live_l
    rnd = jax.random.bits(key, (L, Wc), jnp.uint32)
    if 31 - cell_bits >= 15:
        pkey = (
            ((rnd >> jnp.uint32(cell_bits + 1)) << jnp.uint32(cell_bits))
            | cand_cell.astype(jnp.uint32)
        )
        pkey = jnp.where(valid, pkey, jnp.uint32(0xFFFFFFFF))
        gathered, wrote_l, n_chosen = _select_and_fill(
            pkey, n_grow, cand_cell, free, samp, "sortfill_packed_cell",
            idx_bits=cell_bits,
        )
    else:
        idx_bits = max(1, (Wc - 1).bit_length())
        pkey = (
            ((rnd >> jnp.uint32(idx_bits + 2)) << jnp.uint32(idx_bits))
            | jnp.arange(Wc, dtype=jnp.uint32)
        ).astype(jnp.int32)
        pkey = jnp.where(valid, pkey, jnp.int32(0x7FFFFFFF))
        gathered, wrote_l, n_chosen = _select_and_fill(
            pkey, n_grow, cand_cell, free, samp, "sortfill_packed_idx",
            idx_bits=idx_bits,
        )
    new_syn_l = jnp.where(wrote_l, gathered, syn_l)

    # --- scatter the L rows back into the (A, G, K) active-column rows
    syn_rows = (
        syn_rows.reshape(A * G, K).at[lidx].set(new_syn_l, mode="drop")
        .reshape(A, G, K)
    )
    wrote = (
        jnp.zeros((A * G, K), jnp.bool_).at[lidx].set(wrote_l, mode="drop")
        .reshape(A, G, K)
    )
    perm_rows = jnp.where(wrote, cfg.permanence_initial, perm_rows)

    n_free = free.sum(axis=-1, dtype=jnp.int32)
    overflow = (
        jnp.maximum(n_chosen - n_free, 0) * lvalid
    ).sum(dtype=jnp.int32)
    n_growth_dropped = (
        learn_flat.sum(dtype=jnp.int32) - lvalid.sum(dtype=jnp.int32)
    )
    return (syn_rows, perm_rows, wrote, wrote_l.sum(dtype=jnp.int32),
            overflow, n_winners - n_winners_eff, n_growth_dropped)


def _learn(cfg: TMConfig, state: TMState, key: jax.Array,
           active_cols, pred_rows, winner_rows, cell_max_j, seg_j):
    """Step 3 minus punishment: row-space graph mutation
    (`PredictiveProjection.update`, `projections.py:257-293`). Learns
    against the *previous* step's activation/winners; a no-op on step 0
    (prev distal state is None, `projections.py:258-259`).

    Everything happens on the gathered (A, ...) active-column rows,
    written back into the flat tables at the end; the full-table
    punishment pass is fused into the forward table pass by the
    caller (punished segments live only in non-active columns, so the
    two mutations are disjoint).
    """
    C, D, G, K = (cfg.column_dim, cfg.cell_dim, cfg.segments_per_column,
                  cfg.synapse_capacity)
    J = G * K
    has_prev = state.step > 0

    syn_flat = state.synapse_cell                               # (C, J)
    perm_flat = state.synapse_perm                              # (C, J)

    # Synapse activity wrt the previous step's active cells: cached by
    # the previous forward pass (the table is unchanged since), so the
    # learning phase needs no activation pass of its own. Packed
    # (`ops.active_set.act_scale`); nonzero == active.
    act_prev = state.synapse_act                                # (C, J)

    # --- learning-segment set in active-column row space
    # (projections.py:264-268)
    segcell_rows = state.seg_cell[active_cols]
    syn_rows = syn_flat[active_cols].reshape(-1, G, K)          # (A, G, K)
    perm_rows = perm_flat[active_cols].reshape(-1, G, K)
    # Punishment death is implicit (the table pass does not rewrite the
    # syn table; dead = perm < 0). Clean the stale slots here, in row
    # space — this writes the (-1, -1.0) of an explicit death, for
    # every row learning touches, and the write-back
    # persists it. Free slots are already (-1, -1.0), so this is
    # idempotent on them.
    stale = perm_rows < 0.0
    syn_rows = jnp.where(stale, -1, syn_rows)
    perm_rows = jnp.where(stale, -1.0, perm_rows)
    act_prev_raw = act_prev[active_cols].reshape(-1, G, K)      # packed
    act_prev_rows = act_prev_raw != 0
    # matching / active flags re-derived at the rows from the cached
    # packed activity (bit-equal to what the previous step's forward
    # pass computed: the conn bit IS that pass's perm >= threshold,
    # and active-column rows are untouched by the table pass's punishment,
    # which lives in non-active columns; jit CSE shares the row gathers
    # and the count decode with `_winner_selection`)
    pot_rows, conn_rows = seg_counts_packed_rows(act_prev_raw, K)
    match_rows = pot_rows >= cfg.segment_matching_threshold
    active_seg_rows = match_rows & (
        conn_rows >= cfg.segment_activation_threshold
    )

    owner_pred = take_percell(pred_rows, segcell_rows, D, False)
    owner_winner = take_percell(winner_rows, segcell_rows, D, False)
    owner_max = take_percell(cell_max_j, segcell_rows, D, 0.0)
    seg_best = match_rows & (jnp.abs(seg_j - owner_max) < cfg.epsilon)
    learn_rows = (
        match_rows
        & owner_winner
        & (active_seg_rows | (~owner_pred & seg_best))
        & has_prev
    )                                                           # (A, G)

    # --- segment allocation for unaccounted winners (recycle-first)
    unacc = winner_rows & (cell_max_j < cfg.epsilon) & has_prev  # (A, D)
    new_seg, new_owner, n_dropped, n_evicted = _allocate(
        cfg, segcell_rows, syn_rows, match_rows, unacc
    )
    segcell_rows = jnp.where(new_seg, new_owner, segcell_rows)
    syn_rows = jnp.where(new_seg[:, :, None], -1, syn_rows)
    perm_rows = jnp.where(new_seg[:, :, None], -1.0, perm_rows)
    learn_rows = learn_rows | new_seg

    # --- permanence update + death on learning rows
    # (projections.py:97-109,283-289)
    live_rows = syn_rows >= 0
    delta = jnp.where(
        act_prev_rows,
        jnp.float32(cfg.permanence_increment),
        jnp.float32(-cfg.permanence_decrement),
    )
    perm_rows = perm_rows + (learn_rows[:, :, None] & live_rows) * delta
    dead_rows = live_rows & (perm_rows < 0.0)
    syn_rows = jnp.where(dead_rows, -1, syn_rows)
    perm_rows = jnp.where(dead_rows, -1.0, perm_rows)

    # --- synapse growth toward previous winners
    (syn_rows, perm_rows, wrote, n_grown, overflow, winners_dropped,
     growth_dropped) = _grow(
        cfg, key, syn_rows, perm_rows, learn_rows, act_prev_rows,
        state.active_cols, state.winner_bits,
    )

    # --- write the active-column rows back into the full tables (the
    # punishment pass runs after this, touching only non-active columns;
    # active_cols are distinct, so each row scatter is exact)
    syn_full = syn_flat.at[active_cols].set(syn_rows.reshape(-1, J))
    perm_full = perm_flat.at[active_cols].set(perm_rows.reshape(-1, J))
    seg_cell = state.seg_cell.at[active_cols].set(segcell_rows)

    learning_full = (
        jnp.zeros((C, G), jnp.bool_).at[active_cols].set(learn_rows)
    )
    new_seg_full = (
        jnp.zeros((C, G), jnp.bool_).at[active_cols].set(new_seg)
    )
    wrote_full = (
        jnp.zeros((C, G, K), jnp.bool_).at[active_cols].set(wrote)
    )

    metrics = {
        "tm_new_segments": new_seg.sum(dtype=jnp.int32),
        "tm_grown_synapses": n_grown,
        "tm_learning_segments": learn_rows.sum(dtype=jnp.int32),
        # capacity-overflow counters (reference reallocates instead):
        "tm_dropped_new_segments": n_dropped,
        "tm_evicted_segments": n_evicted,
        "tm_dropped_synapses": overflow,
        "tm_dropped_winner_candidates": winners_dropped,
        "tm_dropped_growth_segments": growth_dropped,
    }
    debug = dict(
        learning_segments=learning_full,
        new_segments=new_seg_full,
        grown_mask=wrote_full,
    )
    return syn_full, perm_full, seg_cell, metrics, debug


def tm_segment_observables(cfg: TMConfig, state: TMState) -> dict:
    """Per-segment forward observables off a post-step state.

    The reference returns the distal state's `segment_potential` /
    `matching_segment` / `matching_segment_activation` to callers
    (`projections.py:195-203`); the rebuild's step outputs carry
    cell-level masks only (no (C, G) per-segment arrays are carried
    through the scan). This decodes them on demand
    from the packed activity the forward pass cached: for each segment,
    the potential (active) and connected-active synapse counts wrt the
    PREVIOUS step's active cells — exactly the values the last forward
    pass computed — plus the derived matching / active masks
    (`projections.py:245-251` thresholds). Works on single-stream and
    batched (leading-axis) states; cheap (one packed-count decode), not
    part of the hot path.

    Returns ``{"potential", "connected_active", "matching", "active"}``
    as (..., C, G) arrays.
    """
    G, K = cfg.segments_per_column, cfg.synapse_capacity

    def one(act):
        return seg_counts_packed(act, G, K)

    if state.synapse_act.ndim == 3:
        potential, connected = jax.vmap(one)(state.synapse_act)
    else:
        potential, connected = one(state.synapse_act)
    matching = potential >= cfg.segment_matching_threshold
    active = matching & (connected >= cfg.segment_activation_threshold)
    return {
        "potential": potential,
        "connected_active": connected,
        "matching": matching,
        "active": active,
    }


def tm_resume(cfg: TMConfig, state: TMState) -> TMState:
    """Re-derive the carries a compact-serving scan leaves stale.

    `tm_step(serving_table=...)` passes ``synapse_act`` through
    unchanged and stores connected-only matching flags in
    ``matching_word`` (see its docstring); both are re-derived here from
    the frozen tables and the state's own previous active set — exactly
    what the unpacked inference forward pass would have produced at the
    last served step. No input is consumed and no step is taken, so
    serve -> resume -> learn is bit-equal to unpacked-inference -> learn
    (`tests/test_serving.py`). Mirrors the reference's inference-mode
    contract where any step may be followed by a learning step
    (`networks.py:91,99`).
    """
    G, K, D = cfg.segments_per_column, cfg.synapse_capacity, cfg.cell_dim
    act_now = synapse_activation_conn(
        state.synapse_cell, state.synapse_perm, state.active_cols,
        state.active_bits, D, cfg.permanence_threshold, K,
    )
    potential, _ = seg_counts_packed(act_now, G, K)
    matching = potential >= cfg.segment_matching_threshold
    matching_word = jnp.sum(
        matching.astype(jnp.int32)
        << jnp.arange(G, dtype=jnp.int32)[None, :],
        axis=-1, dtype=jnp.int32,
    )
    return state.replace(synapse_act=act_now, matching_word=matching_word)


def tm_step(
    cfg: TMConfig,
    state: TMState,
    key: jax.Array,
    active_cols: jnp.ndarray,
    learning: bool = True,
    compute_winner: bool = True,
    return_debug: bool = False,
    epsilon: float | None = None,
    detailed_metrics: bool = True,
    col_active: jnp.ndarray | None = None,
    frozen_word: jnp.ndarray | None = None,
    serving_table=None,
    distal_forward=None,
):
    """One TM timestep for a single stream.

    `active_cols` is the SP's exactly-A top-k column index list (any
    order; sorted internally so downstream compaction is by ascending
    id). `col_active` optionally passes the matching (C,) bool mask
    when the caller already has one (the SP's `active_mask`), which
    saves rebuilding it from the index list.
    `learning`, `compute_winner`, `return_debug` are jit-static,
    mirroring the `learning` / `return_winner_cell` flags of
    `networks.py:91`. `epsilon` overrides `cfg.epsilon` for this call
    (the reference exposes it per `process` call, `networks.py:91`);
    it becomes part of the jit-static config, so every distinct value
    compiles a fresh step — don't sweep it per call.

    `frozen_word` (inference only): a `pack_frozen_table` word table
    for this state's synapse tables — the forward pass then reads
    4 B/slot instead of syn+perm's 8 (the serving fast path,
    `htm_serve_scan`). Results are bit-identical to the unpacked path.

    `serving_table` (serving only: requires ``learning=False`` and
    ``compute_winner=False``): a `ops.serving.make_serving_table`
    compact table for this state — connected synapses only, per-column
    packed (typically ~1/4 the forward-pass traffic and ~1/2 the
    elements). Predictions and all always-on metrics are bit-identical
    to the unpacked path; the carried ``synapse_act`` passes through
    unchanged (stale — nothing in the serving loop reads it) and the
    carried ``matching_word`` holds connected-matching flags (a subset
    of true matching; re-derive with one unpacked inference step before
    resuming learning from a served state). ``detailed_metrics`` is
    rejected (``tm_matching_segments`` would undercount).
    """
    if serving_table is not None:
        if learning or compute_winner:
            raise ValueError(
                "serving_table is a serving-only fast path: it needs "
                "learning=False and compute_winner=False (winner "
                "selection reads the full activity table the compact "
                "form drops)")
        if frozen_word is not None:
            raise ValueError("pass either serving_table or frozen_word, "
                             "not both")
        if detailed_metrics:
            raise ValueError(
                "serving_table computes connected-only counts; "
                "tm_matching_segments would undercount — pass "
                "detailed_metrics=False")
    if frozen_word is not None and learning:
        raise ValueError("frozen_word is an inference-only fast path; "
                         "learning mutates the tables it snapshots")
    if distal_forward is not None and (
            learning or frozen_word is not None or serving_table is not None):
        raise ValueError(
            "distal_forward substitutes the inference forward pass only "
            "(the learning path fuses its forward into the punish/death "
            "table pass — substitute the whole step via the "
            "temporal_memory= hook to change learning-mode semantics); "
            "it also cannot combine with frozen_word/serving_table")
    if epsilon is not None and epsilon != cfg.epsilon:
        import dataclasses

        cfg = dataclasses.replace(cfg, epsilon=float(epsilon))
    C, D, G, K = (cfg.column_dim, cfg.cell_dim, cfg.segments_per_column,
                  cfg.synapse_capacity)
    A, J = cfg.active_columns, G * K
    active_cols = jnp.sort(active_cols.astype(jnp.int32))
    k_select, k_grow = jax.random.split(key)

    prev_prediction = state.prediction                         # (W, C) packed
    pred_rows = unpack_bits(
        jnp.swapaxes(jnp.take(prev_prediction, active_cols, axis=-1),
                     -1, -2), D
    )                                                          # (A, D)
    if col_active is None:
        col_active = column_mask_from_cols(active_cols, C)     # (C,)

    if learning or compute_winner:
        with jax.named_scope("tm_winner"):
            col_burst, winner_rows, cell_max_j, seg_j = _winner_selection(
                cfg, state, k_select, active_cols, pred_rows
            )
    else:
        col_burst = ~pred_rows.any(axis=-1)
        winner_rows = jnp.zeros((A, D), jnp.bool_)

    # --- activation: predicted cells + full bursting columns
    # (networks.py:115-119)
    act_rows = pred_rows | col_burst[:, None]                  # (A, D)
    act_bits = pack_bits(act_rows)                             # (A, W)

    debug = None
    if learning:
        with jax.named_scope("tm_learn"):
            syn_mid, perm_mid, seg_cell, learn_metrics, debug = _learn(
                cfg, state, k_grow, active_cols, pred_rows,
                winner_rows, cell_max_j, seg_j,
            )
        # punishment: matching segments of non-active columns
        # (projections.py:269,290-293), fused with the forward
        # activation pass into one full-table pass (disjoint from the
        # active-column rows _learn just wrote).
        # (C,) i32 bitmask word, bit g = punished[c, g]: the previous
        # step's matching flags arrive already packed in the carried
        # matching_word; masking out active columns (and step 0) is a
        # (C,)-wide select. The table pass extracts the per-slot bit.
        pun_word = jnp.where(
            col_active | (state.step <= 0),
            0,
            state.matching_word,
        )
        # the fused full-table pass: punish + implicit death +
        # activation + per-segment counts + prediction
        # (networks.py:121-122, projections.py:245-255,269,290-293).
        # The syn table is read-only in it (dead = perm < 0); syn_mid
        # already carries the learning phase's row writes.
        (perm_full, act_now, potential, connected, matching, seg_active,
         prediction) = table_update_xla(
            syn_mid, perm_mid, state.synapse_act, pun_word,
            active_cols, act_bits, seg_cell, D,
            cfg.permanence_punishment, cfg.permanence_threshold,
            cfg.segment_matching_threshold,
            cfg.segment_activation_threshold,
        )
        syn_full = syn_mid
        if detailed_metrics:
            learn_metrics["tm_punished_segments"] = jnp.sum(
                jax.lax.population_count(pun_word), dtype=jnp.int32
            )
            learn_metrics["tm_punished_columns"] = jnp.sum(
                (pun_word != 0).astype(jnp.int32), dtype=jnp.int32
            )
        debug["punished_segments"] = (
            (pun_word[:, None] >> jnp.arange(G, dtype=jnp.int32)[None, :])
            & 1
        ) != 0
    elif serving_table is not None:
        # compact-serving forward: connected-only counts straight off
        # the packed table (see ops/serving.py). seg_active is EXACT
        # (conn-active >= theta_a implies potential >= theta_a >=
        # theta_m, the pack-time precondition); the matching flags are
        # connected-matching (subset of true matching, carried for
        # shape-compatibility only).
        from ..ops.serving import serving_counts

        syn_full = state.synapse_cell
        perm_full = state.synapse_perm
        seg_cell = state.seg_cell
        learn_metrics = {}
        conn_cnt = serving_counts(serving_table, active_cols, act_bits,
                                  C, D, G)                    # (C, G)
        matching = conn_cnt >= cfg.segment_matching_threshold
        seg_active = conn_cnt >= cfg.segment_activation_threshold
        prediction = prediction_words(seg_cell, seg_active, D)
        act_now = state.synapse_act          # pass-through (stale)
    else:
        # inference: tables are frozen, only the forward pass runs
        # (networks.py:121-122, projections.py:245-255)
        syn_full = state.synapse_cell
        perm_full = state.synapse_perm
        seg_cell = state.seg_cell
        learn_metrics = {}
        if distal_forward is not None:
            # hook point for a custom distal forward rule (the
            # reference's `distal_projection=` substitution,
            # `networks.py:50-55`): returns the packed activity plus
            # per-segment potential/connected counts; thresholding and
            # prediction stay built-in.
            act_now, potential, connected = distal_forward(
                cfg, state, active_cols, act_bits
            )
        elif frozen_word is not None:
            act_now = synapse_activation_frozen(
                frozen_word, active_cols, act_bits, D, K,
            )
            potential, connected = seg_counts_packed(act_now, G, K)
        else:
            act_now = synapse_activation_conn(
                syn_full, perm_full, active_cols, act_bits, D,
                cfg.permanence_threshold, K,
            )
            potential, connected = seg_counts_packed(act_now, G, K)
        matching = potential >= cfg.segment_matching_threshold
        seg_active = matching & (
            connected >= cfg.segment_activation_threshold
        )
        prediction = prediction_words(seg_cell, seg_active, D)

    new_state = TMState(
        synapse_cell=syn_full,
        synapse_perm=perm_full,
        seg_cell=seg_cell,
        active_cols=active_cols,
        active_bits=act_bits,
        winner_bits=pack_bits(winner_rows),
        synapse_act=act_now,
        prediction=prediction,
        matching_word=jnp.sum(
            matching.astype(jnp.int32)
            << jnp.arange(G, dtype=jnp.int32)[None, :],
            axis=-1, dtype=jnp.int32,
        ),
        step=state.step + 1,
    )

    N = C * D
    active_mask = (
        jnp.zeros((C, D), jnp.bool_).at[active_cols].set(act_rows)
    ).reshape(N)
    winner_mask = (
        jnp.zeros((C, D), jnp.bool_).at[active_cols].set(winner_rows)
    ).reshape(N)
    bursting_full = (
        jnp.zeros((C,), jnp.bool_).at[active_cols].set(col_burst)
    )
    # Always-on: the driver-loop observables and the capacity-drop
    # safety counters (all A-sized, cheap). Opt-out (`detailed_metrics`,
    # jit-static): the full-table (C, G)/(C, D) occupancy reductions,
    # which the serving loop need not pay for.
    metrics = {
        "tm_bursting_columns": col_burst.sum(dtype=jnp.int32),
        "tm_active_cells": act_rows.sum(dtype=jnp.int32),
        # Wc-usage observable: next step's growth-candidate count is
        # this step's winner count (truncated at resolved_winner_capacity
        # and counted in tm_dropped_winner_candidates).
        "tm_winner_cells": winner_rows.sum(dtype=jnp.int32),
        **learn_metrics,
    }
    if detailed_metrics:
        metrics.update(
            tm_predicted_cells=jnp.sum(
                jax.lax.population_count(prediction), dtype=jnp.int32
            ),
            tm_matching_segments=matching.sum(dtype=jnp.int32),
            tm_pool_occupancy=(seg_cell < D).sum(dtype=jnp.int32),
        )
    out = TMOutput(
        active_mask=active_mask,
        winner_mask=winner_mask,
        prediction=prediction_dense(prediction, D).reshape(N),
        prev_prediction=prediction_dense(prev_prediction, D).reshape(N),
        prev_col_prediction=(prev_prediction != 0).any(axis=-2),
        bursting_columns=bursting_full,
        metrics=metrics,
    )
    if return_debug:
        dbg = TMDebug(
            winner_mask=winner_mask,
            learning_segments=(
                debug["learning_segments"] if debug is not None
                else jnp.zeros((C, G), jnp.bool_)
            ),
            punished_segments=(
                debug["punished_segments"] if debug is not None
                else jnp.zeros((C, G), jnp.bool_)
            ),
            new_segments=(
                debug["new_segments"] if debug is not None
                else jnp.zeros((C, G), jnp.bool_)
            ),
            grown_mask=(
                debug["grown_mask"] if debug is not None
                else jnp.zeros((C, G, K), jnp.bool_)
            ),
            synapse_cell=syn_full.reshape(C, G, K),
            seg_cell=seg_cell,
        )
        return new_state, out, dbg
    return new_state, out
