"""Compact active-set encoding: the core of this framework.

HTM's whole sparsity structure is "exactly A = active_columns columns per
step, each with a D-bit cell activation pattern" (inhibition picks a
fixed top-k, `regularizations.py:28-29` in the reference; D = cells per
column). So the active/winner cell sets are *losslessly* described by

    cols: (A,) int32     the active column ids (SP top-k output)
    bits: (A, W) uint32  per-column cell bitmask, W = ceil(D / 32)

With that encoding, the reference's hot gather — "for every synapse, is
its presynaptic cell active?" (`projections.py:167-178` push/pull over a
65 536-entry table) — becomes a **compare-broadcast against the A-entry
list plus a bit-extract** (`synapse_activation_xla`), plain elementwise
XLA that fuses into the surrounding table pass.

Per-cell segment reductions (the reference's `np.maximum.at` /
`bincount` over segment bundles, `projections.py:229-255`) become
one-hot compares over the D axis.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def cell_words(cell_dim: int) -> int:
    return (cell_dim + 31) // 32


def act_scale(synapses: int) -> int:
    """Scale of the packed activity encoding: the forward passes emit
    ONE value per synapse slot, v = act + scale*conn (conn implies act,
    so v in {0, 1, 1+scale}), with scale > synapses so the per-segment
    count sum r = potential + scale*connected decodes exactly (both
    counts <= synapses < scale). Emitting one packed mask instead of
    separate act/conn masks saves a full table-sized write plus one
    count-dot operand pass.

    The scale is the smallest power of two > synapses — EXCEPT when
    that would push 1+scale past the int8 range while synapses+1 keeps
    it inside: then scale = synapses+1, so the packed table stays u8
    (see `act_dtype`; the non-power-of-two decode is one constant
    integer division, strength-reduced by XLA). K=64 — the fast-stack
    width — is exactly this case: pow2 scale 128 gives v=129 > 127,
    scale 65 gives v=66."""
    s = 1 << synapses.bit_length()
    if s + 1 > 127 and synapses <= 125:
        return synapses + 1
    return s


def act_dtype(synapses: int):
    """Dtype of the packed activity mask: uint8 whenever v = 1+scale
    fits int8 (<= 127 — the count dot then runs as an exact s8 x s8 ->
    s32 dot and the table costs 1 B/elem of write + count read instead
    of bf16's 2); bf16 when 1+scale is bf16-exact (scale <= 128); f32
    above (v and the HIGHEST-precision dot stay exact to 2^24)."""
    scale = act_scale(synapses)
    if 1 + scale <= 127:
        return jnp.uint8
    return jnp.bfloat16 if scale <= 128 else jnp.float32


def pack_act_conn(act: jnp.ndarray, conn: jnp.ndarray,
                  synapses: int) -> jnp.ndarray:
    """(bool act, bool conn) -> packed activity value (see act_scale)."""
    scale = act_scale(synapses)
    dtype = act_dtype(synapses)
    if dtype == jnp.uint8:
        one = jnp.int32(1)
        return jnp.where(
            act, jnp.where(conn, one + scale, one), jnp.int32(0)
        ).astype(jnp.uint8)
    one = jnp.float32(1.0)
    return jnp.where(
        act, jnp.where(conn, one + scale, one), jnp.float32(0.0)
    ).astype(dtype)


def pack_bits(mask: jnp.ndarray) -> jnp.ndarray:
    """(..., D) bool -> (..., W) uint32 bitmask (bit d of word d//32)."""
    D = mask.shape[-1]
    W = cell_words(D)
    pad = W * 32 - D
    if pad:
        mask = jnp.concatenate(
            [mask, jnp.zeros((*mask.shape[:-1], pad), mask.dtype)], axis=-1
        )
    m = mask.reshape(*mask.shape[:-1], W, 32).astype(jnp.uint32)
    weights = (jnp.uint32(1) << jnp.arange(32, dtype=jnp.uint32))
    return (m * weights).sum(axis=-1, dtype=jnp.uint32)


def unpack_bits(bits: jnp.ndarray, cell_dim: int) -> jnp.ndarray:
    """(..., W) uint32 -> (..., D) bool."""
    W = bits.shape[-1]
    shifts = jnp.arange(32, dtype=jnp.uint32)
    expanded = (bits[..., None] >> shifts) & jnp.uint32(1)  # (..., W, 32)
    flat = expanded.reshape(*bits.shape[:-1], W * 32)
    return flat[..., :cell_dim].astype(jnp.bool_)


def prediction_words(seg_cell: jnp.ndarray, seg_active: jnp.ndarray,
                     cell_dim: int) -> jnp.ndarray:
    """(..., C, G) owner cells + active flags -> (..., W, C) uint32
    packed per-cell prediction: bit d of word [..., w, c] set iff some
    active segment of column c is owned by cell w*32 + d.

    This is the producer of the `TMState.prediction` carry. Packing
    directly from the G axis skips the (..., G, D) one-hot intermediate
    of `percell_max`, and the word-major (W, C) layout keeps C as the
    minor axis. The sentinel owner (seg_cell == cell_dim, unallocated)
    never lands in a word range.

    The G-axis OR is a single `lax.reduce` (not a per-g slice chain),
    so the bit computation fuses into the reduction and only the
    (..., C) words are written."""
    W = cell_words(cell_dim)
    words = []
    for w in range(W):
        upper = min(32 * (w + 1), cell_dim)
        in_w = seg_active & (seg_cell >= 32 * w) & (seg_cell < upper)
        sft = jnp.clip(seg_cell - 32 * w, 0, 31).astype(jnp.uint32)
        bit = jnp.where(in_w, jnp.uint32(1) << sft, jnp.uint32(0))
        words.append(jax.lax.reduce(
            bit, jnp.uint32(0), jax.lax.bitwise_or, (bit.ndim - 1,)
        ))
    return jnp.stack(words, axis=-2)


def prediction_dense(pred_words: jnp.ndarray, cell_dim: int) -> jnp.ndarray:
    """(..., W, C) packed prediction -> (..., C, D) dense bool."""
    return unpack_bits(jnp.swapaxes(pred_words, -1, -2), cell_dim)


def prediction_dense_host(pred_words, cell_dim: int):
    """NumPy form of `prediction_dense` for host-side readers (the
    oracle bridge and the state validator)."""
    import numpy as np

    words = np.asarray(pred_words)                     # (..., W, C)
    d = np.arange(cell_dim)
    sel = np.take(words, d // 32, axis=-2)             # (..., D, C)
    dense = (sel >> (d % 32)[..., :, None]) & 1
    return np.swapaxes(dense, -1, -2).astype(bool)     # (..., C, D)


def matching_dense_host(matching_word, segments_per_column: int):
    """NumPy form: (..., C) packed matching word -> (..., C, G) dense
    bool (bit g = segment g matching). The one canonical host-side
    decoder of the carried `matching_word` (used by the oracle bridge
    and the state validator — keep them on this helper so the packed
    layout has a single reader)."""
    import numpy as np

    word = np.asarray(matching_word)
    g = np.arange(segments_per_column)
    return ((word[..., :, None] >> g) & 1) != 0


def dense_from_compact(cols: jnp.ndarray, bits: jnp.ndarray,
                       column_dim: int, cell_dim: int) -> jnp.ndarray:
    """Compact (cols, bits) -> dense (C, D) bool mask (for outputs/tests)."""
    rows = unpack_bits(bits, cell_dim)  # (A, D)
    out = jnp.zeros((column_dim, cell_dim), jnp.bool_)
    return out.at[cols].set(rows)


def column_mask_from_cols(cols: jnp.ndarray, column_dim: int) -> jnp.ndarray:
    """(A,) column ids -> (C,) bool mask.

    Small shapes use the (C x A) compare-any (elementwise, fuses into
    its consumer — e.g. the SP duty-cycle update); past ~1e6 compare
    elements the A-index scatter (A writes instead of C x A compares)
    is used."""
    A = cols.shape[-1]
    if column_dim * A >= 1_000_000:
        return jnp.zeros((column_dim,), jnp.bool_).at[cols].set(
            True, mode="drop"
        )
    c = jnp.arange(column_dim, dtype=jnp.int32)
    return (c[:, None] == cols[None, :]).any(axis=1)


def synapse_activation_conn(
    syn_cell: jnp.ndarray,
    syn_perm: jnp.ndarray,
    cols: jnp.ndarray,
    bits: jnp.ndarray,
    cell_dim: int,
    perm_threshold: float,
    synapses: int,
):
    """Activation + connected-activity over a frozen table in one pass
    (the inference forward; learning gets these from `table_update_xla`).
    Returns ONE packed activity mask (see `act_scale`; decode counts
    with `seg_counts_packed`). Dead slots are implicit — `perm < 0`
    masks the activation, so stale targets left by punishment death
    (which does not rewrite the syn table) never match."""
    act_b = synapse_activation_xla(syn_cell, cols, bits, cell_dim) & (
        syn_perm >= 0.0
    )
    return pack_act_conn(act_b, syn_perm >= perm_threshold, synapses)


FROZEN_CELL_BITS = 24  # cell id field of the frozen serving word


def frozen_word_supported(column_dim: int, cell_dim: int) -> bool:
    """The frozen serving word packs the cell id into 24 bits —
    plenty (2^24 = 16.7M cells = 8x the 16K x 64 scaled config)."""
    return column_dim * cell_dim <= (1 << FROZEN_CELL_BITS)


def pack_frozen_table(syn_cell: jnp.ndarray, syn_perm: jnp.ndarray,
                      perm_threshold: float,
                      num_cells: int | None = None) -> jnp.ndarray:
    """Pack a frozen (read-only) distal table for serving: ONE i32 per
    slot — cell id (bits 0-23) | connected (bit 24; perm >= threshold),
    -1 when the slot is dead or free (syn < 0 or perm < 0, the implicit
    death encoding). While the graph is frozen the permanence compare
    is invariant, so the serving forward reads 4 B/slot instead of
    syn (4 B) + perm f32 (4 B). Elementwise — batched tables pack
    without vmap.

    Cell ids must fit the 24-bit field (`frozen_word_supported`): a
    larger id would collide with the connected bit and silently corrupt
    serving results. Pass ``num_cells`` (= column_dim * cell_dim) for a
    static geometry check; without it, concrete (non-traced) tables are
    checked against their actual max id."""
    if num_cells is not None:
        if num_cells > (1 << FROZEN_CELL_BITS):
            raise ValueError(
                f"pack_frozen_table: num_cells={num_cells} exceeds the "
                f"frozen word's {FROZEN_CELL_BITS}-bit cell-id field "
                f"(max {1 << FROZEN_CELL_BITS}); the packed table would "
                f"corrupt the connected bit — use the unpacked serving "
                f"path for this geometry"
            )
    elif not isinstance(syn_cell, jax.core.Tracer):
        max_id = int(jnp.max(syn_cell)) if syn_cell.size else -1
        if max_id >= (1 << FROZEN_CELL_BITS):
            raise ValueError(
                f"pack_frozen_table: cell id {max_id} exceeds the "
                f"{FROZEN_CELL_BITS}-bit field (max "
                f"{(1 << FROZEN_CELL_BITS) - 1}); the packed table "
                f"would corrupt the connected bit — use the unpacked "
                f"serving path for this geometry"
            )
    live = (syn_cell >= 0) & (syn_perm >= 0.0)
    conn = (syn_perm >= perm_threshold).astype(jnp.int32)
    return jnp.where(
        live, syn_cell | (conn << FROZEN_CELL_BITS), jnp.int32(-1)
    )


def synapse_activation_frozen(
    frozen_word: jnp.ndarray,
    cols: jnp.ndarray,
    bits: jnp.ndarray,
    cell_dim: int,
    synapses: int,
):
    """`synapse_activation_conn` over a `pack_frozen_table` word table
    (4 B/slot of table traffic instead of 8). Bit-identical to
    `synapse_activation_conn` on the unpacked table."""
    live = frozen_word >= 0
    cell = jnp.where(live, frozen_word & ((1 << FROZEN_CELL_BITS) - 1),
                     jnp.int32(-1))
    act_b = synapse_activation_xla(cell, cols, bits, cell_dim) & live
    conn_b = (frozen_word >> FROZEN_CELL_BITS) == 1
    return pack_act_conn(act_b, conn_b, synapses)


def synapse_activation_xla(
    syn_cell: jnp.ndarray,
    cols: jnp.ndarray,
    bits: jnp.ndarray,
    cell_dim: int,
) -> jnp.ndarray:
    """For every synapse slot: is its presynaptic cell in the active set?

    act[r, j] = any_a( col(syn[r,j]) == cols[a] AND bit(bits[a], lo(syn)) )

    Free slots (-1) never match (floor-div keeps them at column -1).
    Cost: R * J * A compares — the stand-in for the reference's
    push-mode bincount / pull-mode gather (`projections.py:163-178`).
    The A axis sits second-to-last so the slot axis J stays minor.

    Since column ids are distinct, at most one a matches, so the
    matched column's bitmask word (the one holding bit lo) is recovered
    with ONE masked sum over A and the bit extract happens once per
    element. The word choice is a select inside the summand, so the
    (R, A, J) compare feeds a single reduction and is never stored.
    """
    W = bits.shape[-1]
    col = syn_cell // cell_dim                       # (R, J), -1 for free
    lo = syn_cell - col * cell_dim                   # in [0, D)
    eq = col[:, None, :] == cols[None, :, None]      # (R, A, J)
    word_bits = bits[None, :, 0, None]               # (1, A, 1)
    if W > 1:
        word = (lo // 32)[:, None, :]                # (R, 1, J)
        for w in range(1, W):
            word_bits = jnp.where(word == w, bits[None, :, w, None],
                                  word_bits)
    matched = jnp.sum(jnp.where(eq, word_bits, jnp.uint32(0)), axis=1,
                      dtype=jnp.uint32)              # (R, J)
    bitpos = (lo % 32).astype(jnp.uint32)
    return ((matched >> bitpos) & jnp.uint32(1)).astype(jnp.bool_)


def table_update_xla(syn_cell, syn_perm, act_prev, pun_word, cols, bits,
                     seg_cell, cell_dim: int, punishment: float,
                     perm_threshold: float, matching_threshold: int,
                     activation_threshold: int):
    """The full-table portion of a TM step: punishment decrement +
    synapse death + active-set compare + per-segment counts +
    matching/active flags + per-cell prediction, one fused XLA pass.

    ``pun_word`` is ONE i32 per column with bit g = segment g punished
    (the per-slot bit is extracted in the pass, so no table-sized mask
    is materialized).

    Synapse death is **implicit**: a slot is dead iff ``perm < 0``. The
    syn table is never rewritten here (that would be a full-table write
    to set ``-1`` on the handful of punish-killed slots); the stale
    target ids are masked out of the activation by the ``perm >= 0``
    compare and cleaned up in row space the next time their column is
    gathered for learning (`temporal_memory._learn`).

    ``act_prev`` and the returned activity are **packed** masks
    (v = act + scale*conn, see `act_scale`): one table-sized output and
    one count-dot operand instead of two of each; counts decode exactly
    (`seg_counts_packed`).

    Returns (perm', act_now packed, potential, connected, matching,
    seg_active, prediction packed (W, C) uint32 — see
    `prediction_words`)."""
    G = seg_cell.shape[1]
    K = syn_cell.shape[1] // G
    # No explicit live mask: free slots have act_prev == 0 (never
    # punished) and dead/free slots sit at perm < 0, which the
    # activation mask excludes.
    g_lane = jnp.arange(syn_cell.shape[1], dtype=jnp.int32) // K
    pen_bit = (pun_word[:, None].astype(jnp.int32) >> g_lane) & 1
    pen = (pen_bit == 1) & (act_prev != 0)
    perm = syn_perm - jnp.where(pen, jnp.float32(punishment),
                                jnp.float32(0.0))
    act_b = synapse_activation_xla(syn_cell, cols, bits, cell_dim) & (
        perm >= 0.0
    )
    act = pack_act_conn(act_b, perm >= perm_threshold, K)
    potential, connected = seg_counts_packed(act, G, K)
    matching = potential >= matching_threshold
    seg_active = matching & (connected >= activation_threshold)
    prediction = prediction_words(seg_cell, seg_active, cell_dim)
    return perm, act, potential, connected, matching, seg_active, prediction


# ---- segment-axis reduction on flat (C, G*K) tables --------------------
# Full-table arrays stay flat 2D (C, G*K); per-segment sums over K go
# through a constant 0/1 block matrix as one dot. Every dot here is
# exact: integer or bf16 operands whose products and f32 sums are
# integers far below 2^24, and the f32-operand form asks for HIGHEST
# precision so no reduced-precision (TF32) path can round it.


def _seg_matrix(num_segments: int, synapses: int) -> jnp.ndarray:
    """(G*K, G) constant 0/1 matrix, M[j, g] = (j // K == g)."""
    j = jnp.arange(num_segments * synapses, dtype=jnp.int32)
    g = jnp.arange(num_segments, dtype=jnp.int32)
    return ((j[:, None] // synapses) == g).astype(jnp.int8)


def seg_reduce_counts(flat_mask: jnp.ndarray, num_segments: int,
                      synapses: int,
                      out_dtype=jnp.int32) -> jnp.ndarray:
    """(C, G*K) 0/1 mask (bool or bf16) -> (C, G) per-segment counts
    via a dot against a constant block matrix. bf16 inputs take a
    bf16 x bf16 -> f32 dot — exact, since counts <= K < 256 and
    accumulation is f32 — with no table-sized convert pass; other
    dtypes take the int8 path.

    ``out_dtype=jnp.bfloat16`` halves the bytes of the (C, G) output.
    The threshold compares downstream are exact on integer-valued
    bf16; counts above 256 are not bf16-exact, so K > 256 silently
    widens to f32 (still exact)."""
    if out_dtype == jnp.bfloat16 and synapses > 256:
        out_dtype = jnp.float32
    m = _seg_matrix(num_segments, synapses)
    if flat_mask.dtype == jnp.bfloat16:
        out = jax.lax.dot_general(
            flat_mask, m.astype(jnp.bfloat16),
            dimension_numbers=(((1,), (0,)), ((), ())),
            preferred_element_type=jnp.float32,
        )
        return out.astype(out_dtype)
    return jax.lax.dot_general(
        flat_mask.astype(jnp.int8), m,
        dimension_numbers=(((1,), (0,)), ((), ())),
        preferred_element_type=jnp.int32,
    ).astype(out_dtype)


def seg_counts_packed(packed: jnp.ndarray, num_segments: int,
                      synapses: int) -> tuple[jnp.ndarray, jnp.ndarray]:
    """(C, G*K) packed activity (v = act + scale*conn, `act_scale`) ->
    (potential, connected) per-segment counts via ONE dot + an exact
    decode: r = pot + scale*connc with both counts <= synapses < scale,
    so connc = floor(r/scale) and pot = r - scale*connc are exact
    (r <= synapses*(1+scale) << 2^24).

    Counts are emitted bf16 when exact there (synapses <= 256), as in
    `seg_reduce_counts`."""
    scale = act_scale(synapses)
    m = _seg_matrix(num_segments, synapses)
    out_dtype = jnp.bfloat16 if synapses <= 256 else jnp.float32
    if packed.dtype == jnp.uint8:
        # v <= 1+scale <= 127 by act_dtype's contract: exact s8 dot +
        # integer decode (the constant division strength-reduces; the
        # scale may be non-power-of-two here, see act_scale)
        r = jax.lax.dot_general(
            packed.astype(jnp.int8), m,
            dimension_numbers=(((1,), (0,)), ((), ())),
            preferred_element_type=jnp.int32,
        )
        connected = r // scale
        potential = r - scale * connected
        return potential.astype(out_dtype), connected.astype(out_dtype)
    # bf16 operands are exact at any precision; f32 operands (K > 127,
    # v up to 1+scale > 256) would lose bits under TF32
    precision = (jax.lax.Precision.HIGHEST if packed.dtype == jnp.float32
                 else None)
    r = jax.lax.dot_general(
        packed, m.astype(packed.dtype),
        dimension_numbers=(((1,), (0,)), ((), ())),
        precision=precision,
        preferred_element_type=jnp.float32,
    )
    connected = jnp.floor(r * (1.0 / scale))
    potential = r - scale * connected
    return potential.astype(out_dtype), connected.astype(out_dtype)


def seg_counts_packed_rows(act_rows: jnp.ndarray,
                           synapses: int) -> tuple[jnp.ndarray, jnp.ndarray]:
    """(..., K) packed activity rows -> (potential, connected) int32
    counts, the gathered-row sibling of `seg_counts_packed`: same exact
    decode, but via a plain accumulated sum over the slot axis (the
    active-column rows are small). The connected count comes off the
    packed conn bit the forward pass already computed — no permanence
    re-compare."""
    scale = act_scale(synapses)
    if act_rows.dtype == jnp.uint8:
        r = jnp.sum(act_rows.astype(jnp.int32), axis=-1)
        connected = r // scale
        return (r - scale * connected), connected
    r = jnp.sum(act_rows.astype(jnp.float32), axis=-1)
    connected = jnp.floor(r * (1.0 / scale))
    potential = r - scale * connected
    return potential.astype(jnp.int32), connected.astype(jnp.int32)


def take_small_table(table: jnp.ndarray, idx: jnp.ndarray) -> jnp.ndarray:
    """out[l, k] = table[idx[l, k]] for a small shared lookup table
    (table (Wc,) int32, idx (L, kk) int32): one gather. Out-of-range
    indices are clamped to the table's ends — callers mask them. This
    is the packed-index growth-key decode (index -> candidate cell)."""
    return jnp.take(table, idx, mode="clip")


def compact_first_k(valid: jnp.ndarray, values: jnp.ndarray,
                    k: int) -> tuple[jnp.ndarray, jnp.ndarray]:
    """First k `values[valid]` in index order, one-hot matched (no sort,
    no scatter). Returns (out (k,), out_valid (k,)); out is 0-filled past
    the valid count."""
    rank = jnp.cumsum(valid.astype(jnp.int32)) - 1      # (n,)
    rank = jnp.where(valid, rank, -1)
    sel = rank[None, :] == jnp.arange(k, dtype=jnp.int32)[:, None]  # (k, n)
    out = jnp.sum(sel * values[None, :], axis=1, dtype=values.dtype)
    out_valid = jnp.arange(k, dtype=jnp.int32) < valid.sum(dtype=jnp.int32)
    return out, out_valid


# ---- one-hot per-cell reductions over the segment axis -----------------
# seg_cell holds the owner cell *within its column* (sentinel = cell_dim
# for unallocated slots, which the [0, D) one-hot range excludes).


def percell_max(seg_cell: jnp.ndarray, values: jnp.ndarray, cell_dim: int,
                init) -> jnp.ndarray:
    """(..., G) idx + (..., G) values -> (..., D) per-cell max."""
    d = jnp.arange(cell_dim, dtype=seg_cell.dtype)
    onehot = seg_cell[..., None] == d                # (..., G, D)
    return jnp.max(jnp.where(onehot, values[..., None], init), axis=-2)


def percell_sum(seg_cell: jnp.ndarray, values: jnp.ndarray,
                cell_dim: int) -> jnp.ndarray:
    """(..., G) idx + (..., G) values -> (..., D) per-cell sum."""
    d = jnp.arange(cell_dim, dtype=seg_cell.dtype)
    onehot = seg_cell[..., None] == d
    return jnp.sum(jnp.where(onehot, values[..., None], 0), axis=-2)


def take_percell(values: jnp.ndarray, seg_cell: jnp.ndarray,
                 cell_dim: int, fill) -> jnp.ndarray:
    """values (..., D) indexed by seg_cell (..., G) -> (..., G), one-hot
    (gather-free); sentinel cell_dim yields `fill`."""
    d = jnp.arange(cell_dim, dtype=seg_cell.dtype)
    onehot = seg_cell[..., None] == d                # (..., G, D)
    picked = jnp.sum(
        jnp.where(onehot, values[..., None, :], 0), axis=-1
    )
    valid = seg_cell < cell_dim
    return jnp.where(valid, picked.astype(values.dtype), fill)


def rank_ascending(mask: jnp.ndarray) -> jnp.ndarray:
    """0-based rank of each True among Trues along the last axis."""
    return jnp.cumsum(mask.astype(jnp.int32), axis=-1) - 1


def argmax_onehot(values: jnp.ndarray) -> jnp.ndarray:
    """One-hot of the argmax along the last axis (exactly one True)."""
    idx = jnp.argmax(values, axis=-1)
    d = jnp.arange(values.shape[-1], dtype=idx.dtype)
    return d == idx[..., None]
