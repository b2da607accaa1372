"""Functional SpatialPooler.

Pipeline mirrors `SpatialPooler.process` (`networks.py:26-35`):
overlaps -> boosting -> global inhibition -> (if learning) Hebbian
proximal update; the boosting duty-cycle EMA updates even when
learning=False (`networks.py:33`).

Notes: the overlap is a popcount over the bit-packed connection matrix
(`ops/overlap.py`). The Hebbian update gathers the k active rows,
updates them, and scatters them back with their re-packed connected
words.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from ..config import SPConfig
from ..ops.overlap import overlaps as _overlaps, pack_input
from ..ops.regularization import boost, duty_cycle_update, k_winners
from ..state import SPState


class SPOutput(NamedTuple):
    """Mirrors `SpatialPooler.State` (`networks.py:8-12`), with the
    active-column set carried both as indices and as a dense mask."""

    active_columns: jnp.ndarray   # (k,) int32 top-k column indices
    active_mask: jnp.ndarray      # (C,) bool
    overlaps: jnp.ndarray         # (C,) int32
    boosted_overlaps: jnp.ndarray # (C,) float32


def sp_step(cfg: SPConfig, state: SPState, input_bits: jnp.ndarray,
            learning: bool, boosting=None, inhibition=None,
            overlap=None, proximal_update=None) -> tuple[SPState, SPOutput]:
    """One SP timestep for a single stream. `learning` is jit-static.

    `boosting` / `inhibition` are optional component hooks mirroring the
    reference's constructor injection (`networks.py:14-24`, where the
    example swaps implementations in, `example.py:7-12`):

      boosting(cfg, overlaps (C,) i32, duty_cycle (C,) f32) -> (C,) f32
      inhibition(cfg, boosted (C,) f32) -> ((A,) i32 cols, (C,) bool mask)

    `overlap` / `proximal_update` together substitute the proximal
    projection (the reference's `proximal_projection=`,
    `networks.py:16,22` — its `DenseProjection.process/update`,
    `projections.py:18-24`):

      overlap(cfg, state, input_bits (I,) bool) -> (C,) overlaps
      proximal_update(cfg, state, input_bits, active_columns (A,) i32)
          -> (permanence, connected)  # replacement SPState tables

    None selects the built-in popcount overlap / sparse-row Hebbian
    update. Hooks must be jit-traceable (static callables)."""
    if overlap is None:
        ov = _overlaps(state.connected, input_bits)
    else:
        ov = overlap(cfg, state, input_bits)
    if boosting is None:
        boosted = boost(ov, state.duty_cycle, cfg.boosting_intensity,
                        cfg.density)
    else:
        boosted = boosting(cfg, ov, state.duty_cycle)
    if inhibition is None:
        active_columns, active_mask = k_winners(boosted, cfg.active_columns)
    else:
        active_columns, active_mask = inhibition(cfg, boosted)

    permanence = state.permanence
    connected = state.connected
    if learning and proximal_update is not None:
        permanence, connected = proximal_update(cfg, state, input_bits,
                                                active_columns)
    elif learning:
        # Hebbian update on the k active rows only (`projections.py:23-24`):
        # delta = input * (inc + dec) - dec. Sparse row form: gather the
        # A active rows, update them, scatter rows + their re-packed
        # connected words back. Touches A/C of the table instead of a
        # masked full-table read+write pass.
        # Padding lanes get delta 0 so they stay pinned at the rail.
        I = cfg.input_dim
        I_pad = permanence.shape[-1]
        lane = jnp.arange(I_pad, dtype=jnp.int32)
        rows = permanence[active_columns]            # (A, I_pad)
        if cfg.quantized:
            # int16 permanences in units of permanence_quantum: exact
            # integer arithmetic, half the table traffic of f32
            inc = cfg.to_units(cfg.permanence_increment)
            dec = cfg.to_units(cfg.permanence_decrement)
            thr = cfg.to_units(cfg.permanence_threshold)
            x_pad = jnp.zeros(I_pad, jnp.int32).at[:I].set(
                input_bits.astype(jnp.int32)
            )
            delta = jnp.where(lane < I, x_pad * (inc + dec) - dec, 0)
            # saturating accumulate (int32 intermediate + clip): a
            # chronically-reinforced synapse must pin at the rail, not
            # wrap int16 and silently disconnect
            rows = jnp.clip(
                rows.astype(jnp.int32) + delta[None, :], -32000, 32000
            ).astype(jnp.int16)
        else:
            thr = cfg.permanence_threshold
            x_pad = jnp.zeros(I_pad, jnp.float32).at[:I].set(
                input_bits.astype(jnp.float32)
            )
            delta = jnp.where(
                lane < I,
                x_pad * (cfg.permanence_increment + cfg.permanence_decrement)
                - cfg.permanence_decrement,
                0.0,
            )
            rows = rows + delta[None, :]
        permanence = permanence.at[active_columns].set(rows)
        connected = connected.at[active_columns].set(
            pack_input(rows >= thr)
        )

    duty = duty_cycle_update(state.duty_cycle, active_mask,
                             cfg.duty_cycle_momentum)
    new_state = SPState(permanence=permanence, connected=connected,
                        duty_cycle=duty)
    return new_state, SPOutput(active_columns, active_mask, ov, boosted)
