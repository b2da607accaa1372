"""Proximal overlap: the SpatialPooler's hot forward op.

Reference semantics (`projections.py:18-21`): per column, count input
bits that land on connected synapses (permanence >= threshold).

Form: the connection matrix is binary, so it is cached **bit-packed as
uint8** (`SPState.connected`, (C, S)) and the overlap is a popcount of
the AND with the packed input — 1/8th the memory traffic of an int8
matrix (an int8 matvec would be bandwidth-bound: each stream has its
own connection matrix, so there is no operand reuse).

The bit mapping is **strided**: bit j of word w holds input
``i = j*S + w`` (NOT the row-major ``i = 8*w + j``), so the pack is 8
OR-shifted slice reads that XLA fuses into the permanence-update pass
with no boolean intermediate, no reshape, no relayout. The mapping is
private to this module — always go through `pack_input` /
`unpack_connected`.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def input_words(input_dim: int) -> int:
    """uint8 words per packed input row.

    Rounded up to a multiple of 128 words, so the 8 OR-shifted slice
    reads of the strided pack start at aligned offsets. The padding
    bits are always zero.
    """
    return max(128, ((input_dim + 7) // 8 + 127) // 128 * 128)


def padded_input_dim(input_dim: int) -> int:
    """Physical width of the SP permanence table: 8 * input_words.

    Lanes >= input_dim are pinned at a large negative permanence and
    receive a zero Hebbian delta, so they never connect and never move.
    """
    return 8 * input_words(input_dim)


def pack_input(bits: jnp.ndarray) -> jnp.ndarray:
    """(..., I) bool -> (..., S = ceil(I/8)) uint8, **strided mapping**:
    bit j of word w holds input ``i = j*S + w``.

    The strided layout keeps the word axis minor, and the pack is written as 8 OR-shifted *slice* reads of the
    source so XLA fuses it into one (…, S)-shaped loop fusion reading 8
    windows of the producer — no boolean intermediate, no reshape, no
    relayout. Which input lands in which bit is private to this
    module (pack/unpack/overlap agree; the overlap's AND+popcount is
    mapping-agnostic).
    """
    I = bits.shape[-1]
    S = input_words(I)
    out = jnp.zeros((*bits.shape[:-1], S), jnp.uint8)
    for j in range((I + S - 1) // S):
        sl = bits[..., j * S:min((j + 1) * S, I)]
        if sl.shape[-1] < S:  # ragged tail when I % S != 0
            sl = jnp.concatenate(
                [sl, jnp.zeros((*sl.shape[:-1], S - sl.shape[-1]),
                               sl.dtype)], axis=-1,
            )
        out = out | (sl.astype(jnp.uint8) << j)
    return out


def unpack_connected(words: jnp.ndarray, input_dim: int) -> jnp.ndarray:
    """(..., S) uint8 -> (..., I) bool (inverse of `pack_input`)."""
    shifts = jnp.arange(8, dtype=jnp.uint8)
    expanded = (words[..., None, :] >> shifts[:, None]) & jnp.uint8(1)
    flat = expanded.reshape(*words.shape[:-1], words.shape[-1] * 8)
    return flat[..., :input_dim].astype(jnp.bool_)


def overlaps(connected_bits: jnp.ndarray,
             input_bits: jnp.ndarray) -> jnp.ndarray:
    """(C, Iw) uint8 packed connection matrix x (I,) bool input ->
    (C,) int32 overlap counts.

    Equivalent to `(weight & input).sum(axis=1)` (`projections.py:20`).
    """
    x = pack_input(input_bits)                      # (Iw,)
    anded = connected_bits & x
    return jax.lax.population_count(anded).astype(jnp.int32).sum(
        axis=-1, dtype=jnp.int32
    )
