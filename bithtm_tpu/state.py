"""Model state pytrees.

Everything the reference keeps as live mutable NumPy arrays
(`projections.py:16,40-44,226-227`; `networks.py:57`) becomes one
immutable pytree threaded through a functional step, so the whole model
scans under `lax.scan`, vmaps over independent streams, checkpoints as a
pytree, and shards with `jax.sharding`.

Layout notes:
  * The synapse pool is **per-column**: column ``c`` owns slots
    ``(c, 0..G)``; flat tables are ``(C, G*K)`` so per-column rows are
    contiguous (cheap row gather/scatter of the A active columns).
  * Segment owners are stored as cell-within-column (`seg_cell`,
    sentinel = cell_dim), making every per-cell reduction a one-hot
    over the small D axis instead of a 65k-wide scatter (the reference
    scatters over a global `segment_bundle`, `projections.py:226`).
  * The recurrent active/winner sets are stored compactly as
    ``(A,) cols + (A, W) uint32 bitmasks`` (see `ops/active_set.py`) —
    the losslessly exact encoding of HTM's fixed top-k sparsity.
  * Sentinels: ``synapse_cell == -1`` marks a free synapse slot
    (reference: packed `invalid_output_edge`, `projections.py:36`);
    ``synapse_perm < 0`` marks a dead one (implicit punishment death
    may leave a stale target id behind — see the TMState docstring).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from .config import HTMConfig, SPConfig, TMConfig


def _pytree_dataclass(cls):
    """A frozen dataclass registered as a pytree whose fields are all
    children, with ``.replace(**changes)`` for functional updates."""
    cls = dataclasses.dataclass(frozen=True)(cls)
    cls.replace = lambda self, **changes: dataclasses.replace(self, **changes)
    return jax.tree_util.register_dataclass(cls)


@_pytree_dataclass
class SPState:
    """Spatial pooler parameters + homeostasis.

    ``permanence`` is the learnable proximal matrix (`projections.py:16`);
    ``connected`` caches ``permanence >= threshold`` bit-packed so the
    hot forward overlap is an AND+popcount over 1/8th the bytes of an
    int8 matrix, without re-reading the full-width permanences;
    ``duty_cycle`` is the boosting EMA (`regularizations.py:13`).
    """

    permanence: jax.Array   # (C, I_pad) float32 (or int16 quantized
                            # units); I_pad = overlap.padded_input_dim —
                            # lanes >= input_dim are pinned at the
                            # negative rail and never update
    connected: jax.Array    # (C, overlap.input_words) uint8 packed
    duty_cycle: jax.Array   # (C,) float32


@_pytree_dataclass
class TMState:
    """Temporal memory synapse pool + recurrent state.

    Pool (replaces `SparseProjection`'s dual-index DynamicArray2D graph,
    `projections.py:27-44`):
      synapse_cell: (C, G*K) int32  global presynaptic cell, -1 free
      synapse_perm: (C, G*K) float32  permanence; a slot is dead iff
        perm < 0 (free slots sit at the -1.0 sentinel). Punishment death
        leaves the stale target id in synapse_cell (the table pass does
        not rewrite the syn table — that would be a full-table write per
        step);
        the perm < 0 mask keeps stale targets out of every activation,
        and the learning phase rewrites stale slots to (-1, -1.0) when
        it next gathers their column.
      seg_cell:     (C, G) int32  owner cell within column, D = unallocated

    Recurrent state (mirrors `TemporalMemory.State`, `networks.py:39-46`,
    and the distal `PredictiveProjection.State`, `projections.py:195-203`):
      active_cols: (A,) int32     previous step's active columns
      active_bits: (A, W) uint32  previous active cells (compact bitmask)
      winner_bits: (A, W) uint32  previous winner cells (subset of active)
      synapse_act: (C, G*K) packed per-synapse-slot activity wrt the
        previous step's active set, computed by the forward pass on the
        post-step table: v = act + scale*conn (`ops.active_set.act_scale`;
        nonzero = active, v > 1 = also connected; dtype from
        `ops.active_set.act_dtype`). The table does not change between
        one step's forward pass and the next step's learning phase, so
        this is exactly the `act_prev` the learning phase needs —
        caching it halves the
        number of full-table activation passes per step; packing conn
        into the same value halves the forward pass's mask-output
        traffic and its count-dot operand reads (one dot + exact decode,
        `ops.active_set.seg_counts_packed`).
      prediction:  (W, C) uint32  packed cell predictive state for the
        next step (bit d of word [w, c] = cell w*32+d of column c
        predictive; see `ops.active_set.prediction_words`). Word-major,
        so C is the minor axis.
      matching_word: (C,) int32  bit g = segment g matching (potential
        >= matching_threshold) — the only cross-step full-C flag the
        next step needs (the punishment set). Per-segment potential /
        matching / active values are NOT carried: the next step
        re-derives them at its A active rows from `synapse_act` and
        `synapse_perm` (both unchanged between a step's forward pass
        and the next step's learning phase), which drops three
        (C, G)-shaped carries.
      step: () int32  timestep counter; step 0 has no previous distal
        state, so learning is skipped exactly like the reference's
        `update(prev_state=None)` early-return (`projections.py:258-259`).
    """

    synapse_cell: jax.Array
    synapse_perm: jax.Array
    seg_cell: jax.Array

    active_cols: jax.Array
    active_bits: jax.Array
    winner_bits: jax.Array
    synapse_act: jax.Array
    prediction: jax.Array
    matching_word: jax.Array
    step: jax.Array


@_pytree_dataclass
class HTMState:
    """Full model state: one independent HTM stream (vmap for a batch)."""

    sp: SPState
    tm: TMState
    key: jax.Array  # PRNG key consumed by jittered tie-breaks and sampling


def sp_init(key: jax.Array, cfg: SPConfig) -> SPState:
    """Gaussian proximal permanences, N(mean, std^2) (`projections.py:16`).
    With `permanence_dtype="int16"` the init is quantized to integer
    multiples of `permanence_quantum` (see SPConfig)."""
    perm = (
        jax.random.normal(key, (cfg.column_dim, cfg.input_dim), jnp.float32)
        * cfg.permanence_std
        + cfg.permanence_mean
    )
    from .ops.overlap import pack_input, padded_input_dim

    # physical table is lane-padded (padded_input_dim); padding lanes sit
    # at the negative rail, get a zero Hebbian delta, and never connect
    pad = padded_input_dim(cfg.input_dim) - cfg.input_dim
    if cfg.quantized:
        perm = jnp.round(perm / cfg.permanence_quantum).astype(jnp.int16)
        thr = cfg.to_units(cfg.permanence_threshold)
        if pad:
            perm = jnp.concatenate(
                [perm, jnp.full((cfg.column_dim, pad), -32000, jnp.int16)],
                axis=-1,
            )
        connected = pack_input(perm >= thr)
    else:
        if pad:
            perm = jnp.concatenate(
                [perm, jnp.full((cfg.column_dim, pad), -1e9, jnp.float32)],
                axis=-1,
            )
        connected = pack_input(perm >= cfg.permanence_threshold)
    return SPState(
        permanence=perm,
        connected=connected,
        duty_cycle=jnp.zeros((cfg.column_dim,), jnp.float32),
    )


def tm_init(cfg: TMConfig) -> TMState:
    """Empty pool: zero segments, zero synapses (`projections.py:28-44`
    starts with zero output rows; `networks.py:59-65` empty state)."""
    from .ops.active_set import act_dtype

    C, D, G, K = (cfg.column_dim, cfg.cell_dim, cfg.segments_per_column,
                  cfg.synapse_capacity)
    A, W = cfg.active_columns, cfg.cell_words
    return TMState(
        synapse_cell=jnp.full((C, G * K), -1, jnp.int32),
        synapse_perm=jnp.full((C, G * K), -1.0, jnp.float32),
        seg_cell=jnp.full((C, G), D, jnp.int32),
        active_cols=jnp.zeros((A,), jnp.int32),
        active_bits=jnp.zeros((A, W), jnp.uint32),
        winner_bits=jnp.zeros((A, W), jnp.uint32),
        synapse_act=jnp.zeros((C, G * K), act_dtype(K)),
        prediction=jnp.zeros((W, C), jnp.uint32),
        matching_word=jnp.zeros((C,), jnp.int32),
        step=jnp.zeros((), jnp.int32),
    )


def htm_init(key: jax.Array, cfg: HTMConfig) -> HTMState:
    sp_key, state_key = jax.random.split(key)
    return HTMState(sp=sp_init(sp_key, cfg.sp), tm=tm_init(cfg.tm), key=state_key)


def htm_init_batch(key: jax.Array, cfg: HTMConfig, batch: int) -> HTMState:
    """A batch of independent streams: vmap of htm_init over split keys."""
    keys = jax.random.split(key, batch)
    return jax.vmap(lambda k: htm_init(k, cfg))(keys)
