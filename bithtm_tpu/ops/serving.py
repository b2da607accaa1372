"""Compact serving tables: the frozen-graph forward at a fraction of
the table.

The learning-table forward reads 8 B per synapse SLOT (syn id s32 +
permanence f32) over the full (C, G*K) pool — but a frozen serving
graph needs none of that generality:

* only **connected** synapses (perm >= threshold) can contribute to a
  prediction, and whenever ``segment_matching_threshold <=
  segment_activation_threshold`` (the reference defaults: 15/15) the
  matching test is *implied* by the activation test — potential >=
  connected-active >= threshold — so non-connected synapses can be
  pruned entirely at freeze time with bit-identical predictions
  (`/root/reference/bithtm/projections.py:245-251` semantics);
* pool slots are ~57% occupied and segments hold ~32 of their K=64
  slots at steady state (counted on the 2048 x 32 reference workload,
  docs/QUALITY.md), so per-COLUMN compaction — all of a column's
  connected synapses packed into one 128-wide row — roughly halves the
  element count on top of halving the bytes.

Layout: ONE i32 word per connected synapse,

    word = (presynaptic cell id << 5) | segment slot g     (-1 = empty)

packed into `rows` ((C*M + E), 128): columns own M = width/128
consecutive rows each; the E **extension rows** at the bottom absorb
the rare columns whose connected count exceeds the main width
(measured p99.9 ~ 98 of 128 at the default config, with ~1e-4 of
columns spilling), `ext_col[e]` naming the owning column (C = unused).
A column may own several extension rows.

The forward pass emits one byte per slot — ``g+1`` where the synapse's
presynaptic cell is active, else 0 — so the per-(column, segment)
connected-active counts decode from a 1 B/elem read
(`serving_counts`).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from .active_set import synapse_activation_xla

SERVING_G_BITS = 5          # segment field of the packed word (G <= 32)
_SERVING_CELL_MAX = 1 << 26  # cell id must fit bits 5..30


class ServingTable(NamedTuple):
    """Frozen compact serving table (see module docstring).

    rows:    (..., C*M + E, 128) int32 packed words (-1 = empty)
    ext_col: (..., E) int32 owning column of each extension row (C = unused)

    M (main rows per column) is derived from the shapes; build with
    `make_serving_table`.
    """

    rows: jax.Array
    ext_col: jax.Array


def pack_serving_rows(syn_cell, syn_perm, perm_threshold: float,
                      synapses: int, column_dim: int, cell_dim: int,
                      width: int, ext_rows: int):
    """Jittable core of `make_serving_table` for ONE stream.

    ``width`` (a multiple of 128) and ``ext_rows`` are static; every
    column's connected count must fit width + 128*ext_rows (the host
    wrapper sizes them from the actual state). Returns (rows, ext_col).
    """
    C, J = syn_cell.shape
    assert C == column_dim and width % 128 == 0 and width >= 128
    M = width // 128
    if column_dim * cell_dim > _SERVING_CELL_MAX:
        raise ValueError(
            f"serving word packs the cell id into 26 bits; "
            f"{column_dim} x {cell_dim} cells exceed {_SERVING_CELL_MAX}"
        )
    g_lane = (jnp.arange(J, dtype=jnp.int32) // synapses)
    conn = (syn_cell >= 0) & (syn_perm >= perm_threshold)
    word = jnp.where(
        conn, (syn_cell << SERVING_G_BITS) | g_lane[None, :], -1
    ).astype(jnp.int32)
    # per-column compaction in slot order: one pair sort per row — the
    # sort key keeps connected slots (key = slot index) ahead of empties
    # (key = MAX), and the word rides as payload
    key = jnp.where(conn, jnp.arange(J, dtype=jnp.int32)[None, :],
                    jnp.int32(0x7FFFFFFF))
    _, sorted_word = jax.lax.sort((key, word), dimension=-1, num_keys=1)
    pad = width + 128 * ext_rows
    if pad > J:
        sorted_word = jnp.concatenate(
            [sorted_word, jnp.full((C, pad - J), -1, jnp.int32)], axis=-1
        )
    main = sorted_word[:, :width].reshape(C * M, 128)

    if ext_rows == 0:
        return main, jnp.full((0,), column_dim, jnp.int32)

    # extension rows: column c's overflow chunk o (128 wide, starting at
    # width + 128*o) lands in extension row sum(chunks of columns < c) + o
    n_conn = conn.sum(axis=-1, dtype=jnp.int32)                 # (C,)
    n_chunks = jnp.maximum(
        -((-jnp.maximum(n_conn - width, 0)) // 128), 0
    )                                                            # (C,)
    start = jnp.cumsum(n_chunks) - n_chunks                      # (C,)
    e_idx = jnp.arange(ext_rows, dtype=jnp.int32)
    # (C, ext_rows): does column c own extension row e, and which chunk
    owns = (e_idx[None, :] >= start[:, None]) & (
        e_idx[None, :] < (start + n_chunks)[:, None]
    )
    chunk = jnp.where(owns, e_idx[None, :] - start[:, None], 0)
    # gather chunk o of column c for each ext row: one-hot contraction
    # over C (ext_rows is tiny; C x ext_rows x 128 work)
    chunks_all = sorted_word[:, width:width + 128 * ext_rows].reshape(
        C, ext_rows, 128
    )
    take = owns[:, :, None] & (
        chunk[:, :, None] == jnp.arange(ext_rows, dtype=jnp.int32)[
            None, None, :]
    )
    # take[c, e, o] = ext row e holds chunk o of column c
    ext = jnp.sum(
        jnp.where(take[:, :, :, None], chunks_all[:, None, :, :], 0),
        axis=(0, 2), dtype=jnp.int32,
    )                                                            # (E, 128)
    ext = jnp.where(owns.any(axis=0)[:, None], ext, -1)
    ext_col = jnp.sum(
        owns * jnp.arange(C, dtype=jnp.int32)[:, None], axis=0,
        dtype=jnp.int32,
    )
    ext_col = jnp.where(owns.any(axis=0), ext_col, column_dim)
    return jnp.concatenate([main, ext], axis=0), ext_col


def make_serving_table(cfg, state_tm) -> ServingTable:
    """Freeze a TM state into a compact serving table (host wrapper).

    ``cfg`` is a TMConfig; ``state_tm`` a TMState (single-stream or
    batched — leading axes are vmapped). Reads two scalars from the
    state (max/total connected per column) to size the static width and
    extension region, then runs the jitted pack.

    Requires ``segment_matching_threshold <=
    segment_activation_threshold`` (otherwise the matching test is not
    implied by activation and pruning non-connected synapses would
    change predictions — use the unpacked serving path)."""
    if cfg.segment_matching_threshold > cfg.segment_activation_threshold:
        raise ValueError(
            "compact serving tables prune non-connected synapses, which "
            "is prediction-exact only when segment_matching_threshold "
            "<= segment_activation_threshold; got "
            f"{cfg.segment_matching_threshold} > "
            f"{cfg.segment_activation_threshold}"
        )
    syn, perm = state_tm.synapse_cell, state_tm.synapse_perm
    conn = (syn >= 0) & (perm >= cfg.permanence_threshold)
    n_conn = conn.sum(axis=-1)                     # (..., C)
    mx = int(jax.device_get(jnp.max(n_conn)))
    # width: one main row unless the typical column exceeds it (p99
    # guides the main width; the tail rides extension rows)
    p99 = int(jax.device_get(
        jnp.percentile(n_conn.astype(jnp.float32), 99.0)))
    width = 128 * max(1, -(-p99 // 128))
    if mx <= width:
        ext = 0
    else:
        spill = jnp.maximum(n_conn - width, 0)
        chunks = -(-spill // 128)
        ext = int(jax.device_get(
            jnp.max(chunks.sum(axis=-1)) if chunks.ndim > 1
            else chunks.sum()))
        ext = max(8, -(-ext // 8) * 8)
    fn = pack_serving_rows
    for _ in range(syn.ndim - 2):
        fn = jax.vmap(fn, in_axes=(0, 0, None, None, None, None, None,
                                   None))
    rows, ext_col = jax.jit(fn, static_argnums=(2, 3, 4, 5, 6, 7))(
        syn, perm, float(cfg.permanence_threshold), cfg.synapse_capacity,
        cfg.column_dim, cfg.cell_dim, width, ext,
    )
    return ServingTable(rows=rows, ext_col=ext_col)


def serving_activation_xla(rows, cols, bits, cell_dim: int):
    """(R, 128) packed words -> (R, 128) uint8: g+1 where the slot's
    presynaptic cell is in the active set, else 0."""
    live = rows >= 0
    cell = jnp.where(live, rows >> SERVING_G_BITS, -1)
    act = synapse_activation_xla(cell, cols, bits, cell_dim) & live
    g = rows & ((1 << SERVING_G_BITS) - 1)
    return jnp.where(act, g + 1, 0).astype(jnp.uint8)


def serving_counts(table: ServingTable, cols, bits, column_dim: int,
                   cell_dim: int, num_segments: int) -> jnp.ndarray:
    """Per-(column, segment) connected-active counts of ONE stream:
    the whole frozen forward pass. Returns (C, G) int32.

    The activation is decoded into counts from the 1-byte form:
    count[c, g] = |{slots of column c with value g+1}|, extension rows
    added onto their owning columns by an integer scatter-add."""
    rows, ext_col = table.rows, table.ext_col
    R = rows.shape[0]
    E = ext_col.shape[0]
    C, G = column_dim, num_segments
    M = (R - E) // C
    assert C * M + E == R, (rows.shape, ext_col.shape, C)
    act = serving_activation_xla(rows, cols, bits, cell_dim)
    gi = jnp.arange(1, G + 1, dtype=jnp.int32)
    cnt = jnp.sum(
        act[:, None, :].astype(jnp.int32) == gi[None, :, None],
        axis=-1, dtype=jnp.int32,
    )                                                      # (R, G)
    main = cnt[: C * M].reshape(C, M, G).sum(axis=1)
    if E == 0:
        return main
    # unused extension rows carry ext_col == C and are dropped
    return main.at[ext_col].add(cnt[C * M:], mode="drop")
