"""Host-side (non-jittable) component substitution.

The reference's composition root takes an arbitrary Python object for
its temporal-memory slot (`networks.py:134,144`) — its example swaps in
a pure-Python TM (`example.py:7-12`). The jit-traceable hooks of
`htm_step` cannot host such code directly, so this adapter routes the
TM step through `jax.experimental.io_callback`: the host implementation
(NumPy, a C extension, anything) keeps its own mutable state and runs
at its natural pace while the SP, metrics, and driver loop stay on the
compiled device path.

    def my_tm(active_columns, learning):      # plain NumPy, stateful
        ...
        return active_cells, winner_cells, prediction   # (N,) bools

    htm = HierarchicalTemporalMemory(
        1000, 2048, 32, temporal_memory=HostTemporalMemory(my_tm))

Ordered callbacks serialize with the device stream, so this is a
correctness/integration tool (the reference's use-case: differential
testing, prototyping a new TM rule in NumPy), not a throughput path.
Single-stream only — host state cannot vmap, exactly like the
reference's stateful classes.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import io_callback

from .models.temporal_memory import TMOutput


class HostTemporalMemory:
    """Adapter: a host Python TM as an `htm_step` `temporal_memory=` hook.

    ``step_fn(active_columns, learning) -> (active, winner, prediction)``
    runs on the host with NumPy inputs: ``active_columns`` is the SP's
    (A,) int32 top-k column list; the three returns are (N,)-shaped
    0/1-coercible cell masks (N = column_dim * cell_dim), matching the
    reference `TemporalMemory.State` triple (`networks.py:39-46`).
    State belongs to ``step_fn`` (closure or bound object), mirroring
    the reference's mutable classes.

    The adapter supplies the wrapper contract on top: it remembers the
    previous prediction host-side (the driver metrics' correct/incorrect
    inputs, `example.py:55-57`), derives bursting columns (active
    columns with no previously-predicted cell, `networks.py:96-97`),
    and leaves the carried TMState untouched.
    """

    def __init__(self, step_fn):
        self._fn = step_fn
        self._prev_prediction = None

    def reset(self):
        self._prev_prediction = None

    def __call__(self, cfg, state, key, active_cols, learning,
                 compute_winner):
        C, D = cfg.column_dim, cfg.cell_dim
        N = C * D

        def host(ac):
            ac = np.asarray(ac)
            prev = self._prev_prediction
            if prev is None:
                prev = np.zeros((N,), bool)
            active, winner, pred = self._fn(ac, learning)
            active = np.asarray(active, bool).reshape(N)
            winner = np.asarray(winner, bool).reshape(N)
            pred = np.asarray(pred, bool).reshape(N)
            self._prev_prediction = pred
            burst = np.zeros((C,), bool)
            prev_cd = prev.reshape(C, D)
            burst[ac] = ~prev_cd[ac].any(axis=-1)
            return active, winner, pred, prev, burst

        b = jax.ShapeDtypeStruct((N,), jnp.bool_)
        active, winner, pred, prev, burst = io_callback(
            host,
            (b, b, b, b, jax.ShapeDtypeStruct((C,), jnp.bool_)),
            active_cols,
            ordered=True,  # the host TM is stateful
        )
        out = TMOutput(
            active_mask=active,
            winner_mask=winner,
            prediction=pred,
            prev_prediction=prev,
            prev_col_prediction=prev.reshape(C, D).any(axis=-1),
            bursting_columns=burst,
            metrics={
                "tm_bursting_columns": burst.sum(dtype=jnp.int32),
                "tm_active_cells": active.sum(dtype=jnp.int32),
                "tm_winner_cells": winner.sum(dtype=jnp.int32),
            },
        )
        return state, out
