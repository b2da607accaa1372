"""HierarchicalTemporalMemory: composition + batched/scanned drivers.

`htm_step` mirrors `HierarchicalTemporalMemory.process`
(`networks.py:146-149`): SP then TM, single stream. Throughput
comes from `htm_step_batch` (vmap over independent streams — the
reference processes exactly one stream) and `htm_scan` (lax.scan over the
sequential timestep recurrence, `networks.py:57,127`).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..config import HTMConfig
from ..state import HTMState
from .spatial_pooler import SPOutput, sp_step
from .temporal_memory import TMOutput, tm_resume, tm_step


class HTMOutput(NamedTuple):
    sp: SPOutput
    tm: TMOutput
    metrics: dict


def _step_metrics(cfg: HTMConfig, sp_out: SPOutput, tm_out: TMOutput) -> dict:
    """The driver-loop metrics of `example.py:50-57`: correct columns =
    previously-predicted columns that became active; incorrect = the rest
    of the previously-predicted; plus the standard HTM anomaly score."""
    prev_col_pred = tm_out.prev_col_prediction          # (C,) packed-native
    corrects = (prev_col_pred & sp_out.active_mask).sum(dtype=jnp.int32)
    incorrects = prev_col_pred.sum(dtype=jnp.int32) - corrects
    burstings = tm_out.bursting_columns.sum(dtype=jnp.int32)
    anomaly = burstings.astype(jnp.float32) / cfg.sp.active_columns
    return {
        "bursting": burstings,
        "correct": corrects,
        "incorrect": incorrects,
        "anomaly": anomaly,
        **tm_out.metrics,
    }


def htm_step(
    cfg: HTMConfig,
    state: HTMState,
    input_bits: jnp.ndarray,
    learning: bool = True,
    compute_winner: bool = True,
    boosting=None,
    inhibition=None,
    temporal_memory=None,
    detailed_metrics: bool = True,
    frozen_word: jnp.ndarray | None = None,
    serving_table=None,
    overlap=None,
    proximal_update=None,
    distal_forward=None,
) -> tuple[HTMState, HTMOutput]:
    """One full timestep for a single stream. `learning` and
    `compute_winner` (the reference's `return_winner_cell`,
    `networks.py:91` — False skips the winner-selection jitters on
    inference-only steps) are jit-static.

    `boosting` / `inhibition` forward to `sp_step`'s component hooks;
    `overlap` / `proximal_update` substitute the proximal projection
    (the reference's `proximal_projection=`, `networks.py:16,22` — see
    `sp_step` for signatures); `distal_forward` substitutes the distal
    forward rule on inference steps (the forward half of the
    reference's `distal_projection=`, `networks.py:50-55` — see
    `tm_step`; learning-mode substitution goes through
    `temporal_memory=`); `temporal_memory` substitutes the TM step
    itself (the reference's
    `temporal_memory=` constructor injection, `networks.py:134,144`,
    which is how its example swaps in the oracle, `example.py:7-12`):

      temporal_memory(tm_cfg, tm_state, key, active_cols,
                      learning, compute_winner) -> (tm_state, TMOutput)

    The hook must trace under jit; to substitute *non-jittable* host
    code (the reference's pure-Python swap), wrap it in
    `host_hooks.HostTemporalMemory`, which routes through an ordered
    `io_callback`.
    """
    if input_bits.shape != (cfg.input_dim,):
        raise ValueError(
            f"htm_step expects a single ({cfg.input_dim},) input SDR, got "
            f"{input_bits.shape}; use htm_step_batch for a (B, I) batch"
        )
    if (frozen_word is not None or serving_table is not None
            or distal_forward is not None) and temporal_memory is not None:
        raise ValueError(
            "frozen_word/serving_table/distal_forward configure the "
            "built-in tm_step; a temporal_memory hook would silently "
            "ignore them — pass them to the hook yourself instead"
        )
    key, sub = jax.random.split(state.key)
    with jax.named_scope("sp"):
        sp_state, sp_out = sp_step(cfg.sp, state.sp, input_bits, learning,
                                   boosting=boosting, inhibition=inhibition,
                                   overlap=overlap,
                                   proximal_update=proximal_update)
    with jax.named_scope("tm"):
        if temporal_memory is None:
            tm_state, tm_out = tm_step(
                cfg.tm, state.tm, sub, sp_out.active_columns,
                learning, compute_winner,
                detailed_metrics=detailed_metrics,
                # reuse the SP's mask only when it is the stock
                # k_winners output (exactly consistent with the index
                # list by construction); a custom inhibition hook's
                # mask only ever feeds the SP duty cycle — TM state
                # integrity must not depend on hook self-consistency
                col_active=(sp_out.active_mask
                            if inhibition is None else None),
                frozen_word=frozen_word,
                serving_table=serving_table,
                distal_forward=distal_forward,
            )
        else:
            tm_state, tm_out = temporal_memory(
                cfg.tm, state.tm, sub, sp_out.active_columns,
                learning, compute_winner,
            )
    new_state = HTMState(sp=sp_state, tm=tm_state, key=key)
    return new_state, HTMOutput(sp_out, tm_out, _step_metrics(cfg, sp_out, tm_out))


def htm_step_batch(cfg, state, input_bits, learning=True,
                   compute_winner=True, detailed_metrics=True,
                   frozen_word=None, serving_table=None):
    """Batched step: state pytree and inputs carry a leading stream axis.
    Streams are fully independent (pure data parallelism)."""
    if serving_table is not None:
        return jax.vmap(
            lambda s, x, st: htm_step(cfg, s, x, learning, compute_winner,
                                      detailed_metrics=detailed_metrics,
                                      serving_table=st)
        )(state, input_bits, serving_table)
    if frozen_word is None:
        return jax.vmap(
            lambda s, x: htm_step(cfg, s, x, learning, compute_winner,
                                  detailed_metrics=detailed_metrics)
        )(state, input_bits)
    return jax.vmap(
        lambda s, x, fw: htm_step(cfg, s, x, learning, compute_winner,
                                  detailed_metrics=detailed_metrics,
                                  frozen_word=fw)
    )(state, input_bits, frozen_word)


def _scan_impl(cfg: HTMConfig, state: HTMState, inputs: jnp.ndarray,
               learning: bool, unroll: int, compute_winner: bool,
               detailed_metrics: bool, frozen_word=None,
               serving_table=None):
    """Shared validation + scan body for `htm_scan` and
    `htm_serve_scan` — ONE implementation, so the serve path's
    bit-equality contract cannot drift from the standard scan."""
    if inputs.ndim not in (2, 3) or inputs.shape[-1] != cfg.input_dim:
        raise ValueError(
            f"htm_scan expects [T, {cfg.input_dim}] or "
            f"[T, B, {cfg.input_dim}] inputs, got {inputs.shape}"
        )
    batched = inputs.ndim == 3
    if batched and state.tm.prediction.ndim != 3:
        raise ValueError(
            "batched [T, B, I] inputs need a batched state "
            "(htm_init_batch), got a single-stream state"
        )
    if not batched and state.tm.prediction.ndim == 3:
        raise ValueError(
            "unbatched [T, I] inputs need a single-stream state "
            "(htm_init), got a batched state — add a stream axis to "
            "the inputs or use htm_init"
        )
    if unroll == 0:
        unroll = 1

    def body(carry, x):
        if batched:
            new_state, out = htm_step_batch(cfg, carry, x, learning,
                                            compute_winner,
                                            detailed_metrics,
                                            frozen_word=frozen_word,
                                            serving_table=serving_table)
        else:
            new_state, out = htm_step(cfg, carry, x, learning,
                                      compute_winner,
                                      detailed_metrics=detailed_metrics,
                                      frozen_word=frozen_word,
                                      serving_table=serving_table)
        return new_state, out.metrics

    return jax.lax.scan(body, state, inputs, unroll=unroll)


@functools.partial(jax.jit, static_argnums=(0, 3, 4, 5, 6),
                   donate_argnums=(1,))
def htm_scan(cfg: HTMConfig, state: HTMState, inputs: jnp.ndarray,
             learning: bool = True, unroll: int = 0,
             compute_winner: bool = True, detailed_metrics: bool = True):
    """Scan a [T, ...] (or [T, B, ...] batched) input sequence through the
    recurrence. Carry is donated: the synapse pool updates in place.

    `unroll=0` (the default) means 1 on every platform: one scan
    iteration per loop trip. A larger value unrolls the scan body that
    many times, trading compile time for less per-iteration overhead.
    `compute_winner=False` (inference only) skips the winner-selection
    jitters — the pure anomaly-serving fast path.

    Returns (final_state, per-step metrics dict of [T]-leading arrays).
    """
    return _scan_impl(cfg, state, inputs, learning, unroll,
                      compute_winner, detailed_metrics)


CAP_DROP_METRICS = ("tm_dropped_winner_candidates",
                    "tm_dropped_growth_segments")


def htm_scan_autocap(cfg: HTMConfig, state: HTMState, inputs,
                     *, tuned: dict, safe: dict | None = None,
                     chunk: int = 256, learning: bool = True,
                     unroll: int = 0, compute_winner: bool = True,
                     detailed_metrics: bool = False, on_chunk=None):
    """Chunked `htm_scan` under TUNED capacity caps, auto-widening on
    the first counted cap drop — the "bank the tuned-cap speed safely"
    mode.

    The winner/growth list widths (`winner_capacity` /
    `growth_capacity`) are per-step scratch, not state: a config with
    different caps resumes from the SAME state pytree
    (`tests/test_pool_pressure.py::test_growth_cap_drop_mitigation`).
    This runs the scan in ``chunk``-step dispatches with the ``tuned``
    overrides (narrower caps shrink the growth sort at large A),
    snapshotting the carry before each chunk; if a
    chunk counts ANY winner/growth cap drop (`CAP_DROP_METRICS`), the
    snapshot is restored, the config escalates to the ``safe``
    overrides (default: the config's own auto caps), and the SAME chunk
    re-runs — so the produced trajectory is guaranteed drop-free on
    those counters, while fast-as-tuned up to the escalation point.

    Returns ``(state, metrics, info)``: metrics are host np arrays
    concatenated over chunks ([T]-leading, like `htm_scan`); ``info``
    has ``escalated_at_step`` (None if the tuned caps held),
    ``tuned_drops`` (the counted drops that triggered escalation —
    observed on the discarded chunk, absent from the trajectory), and
    ``chunks``. While tuned, the per-chunk drop check reads ONE scalar
    (the summed cap counters) to the host; the full metrics transfer
    once at the end.
    ``on_chunk(start_step, seconds, escalated, drops)`` is called
    after each produced chunk (soak timing hook).
    """
    import dataclasses
    import time

    import numpy as np

    def with_caps(overrides):
        return dataclasses.replace(
            cfg, tm=dataclasses.replace(cfg.tm, **overrides))

    cfg_tuned = with_caps(tuned)
    cfg_safe = with_caps(safe or {})
    T = inputs.shape[0]
    out_metrics: dict[str, list] = {}
    active_cfg = cfg_tuned
    escalated_at = None
    tuned_drops = 0
    n_chunks = 0
    t0 = 0
    while t0 < T:
        xs = inputs[t0:t0 + chunk]
        wall0 = time.perf_counter()
        saved = (jax.tree.map(jnp.copy, state)
                 if active_cfg is cfg_tuned else None)
        new_state, m = htm_scan(active_cfg, state, xs, learning, unroll,
                                compute_winner, detailed_metrics)
        escalated_now = False
        if active_cfg is cfg_tuned:
            drops = int(jax.device_get(sum(
                m[k].sum() for k in CAP_DROP_METRICS if k in m)))
            if drops:
                # discard the dropping chunk, re-run it under safe caps
                tuned_drops = drops
                escalated_at = t0
                escalated_now = True
                active_cfg = cfg_safe
                state = saved
                new_state, m = htm_scan(active_cfg, state, xs, learning,
                                        unroll, compute_winner,
                                        detailed_metrics)
        else:
            drops = 0
        state = new_state
        for k, v in m.items():
            out_metrics.setdefault(k, []).append(v)
        n_chunks += 1
        if on_chunk is not None:
            jax.block_until_ready(state)
            on_chunk(t0, time.perf_counter() - wall0, escalated_now,
                     drops)
        t0 += chunk
    metrics = {k: np.concatenate([np.asarray(x) for x in v])
               for k, v in out_metrics.items()}
    info = {"escalated_at_step": escalated_at,
            "tuned_drops": tuned_drops, "chunks": n_chunks}
    return state, metrics, info


@functools.partial(jax.jit, static_argnums=(0,), donate_argnums=(1,))
def resume_learning(cfg: HTMConfig, state: HTMState) -> HTMState:
    """Make a compact-serving state safe to learn from again.

    After `htm_serve_scan(..., serving_table=...)` the carried
    ``synapse_act`` and ``matching_word`` are stale (the compact table
    skips the full-table forward pass that produces them); the next
    learning step would reinforce/punish against the wrong activity.
    This re-derives both from the frozen tables and the state's own
    previous active set — no input consumed, no timestep taken — so
    serve -> resume -> learn is bit-equal to having served unpacked.
    Handles single-stream and batched states; a no-op (bit-exact
    recompute of current values) on states that never served packed.
    """
    if state.tm.prediction.ndim == 3:
        tm = jax.vmap(lambda t: tm_resume(cfg.tm, t))(state.tm)
    else:
        tm = tm_resume(cfg.tm, state.tm)
    return HTMState(sp=state.sp, tm=tm, key=state.key)


@functools.partial(jax.jit, static_argnums=(0, 3, 4, 5),
                   donate_argnums=(1,))
def htm_serve_scan(cfg: HTMConfig, state: HTMState, inputs: jnp.ndarray,
                   unroll: int = 0, compute_winner: bool = False,
                   detailed_metrics: bool | None = None,
                   serving_table=None):
    """The serving scan: ``htm_scan`` with learning off and
    `compute_winner` defaulting False — the anomaly-serving path has no
    use for winner cells (the reference's `return_winner_cell=False`,
    `networks.py:91`), and skipping the winner pass (jittered
    best-matching, per-cell maxes, RNG use) saves work on every
    served step. Results are bit-identical to
    ``htm_scan(..., learning=False, compute_winner=False)``.

    A frozen-word table variant (pack cell|conn into one i32/slot to
    halve the forward pass's table reads — `pack_frozen_table` +
    `synapse_activation_frozen`, both kept and parity-tested) is not
    the default; pass ``frozen_word`` to `htm_step_batch` to use it.

    ``serving_table`` (a `ops.serving.make_serving_table` compact
    table for this state, batched like it): the forward pass then runs
    over connected synapses only — per-column packed, ~1/4 the traffic
    and ~1/2 the elements of the full pool. Predictions and the
    returned metrics are bit-identical; the final state's
    ``synapse_act`` / ``matching_word`` carry stale values — call
    `resume_learning(cfg, state)` before the next learning step.
    Requires ``compute_winner=False``; ``detailed_metrics`` defaults
    to False when a table is passed (the compact counts would make
    ``tm_matching_segments`` undercount) and True otherwise.

    Same returns as `htm_scan`: (final state, [T]-leading metrics).
    """
    if detailed_metrics is None:
        detailed_metrics = serving_table is None
    return _scan_impl(cfg, state, inputs, False, unroll,
                      compute_winner, detailed_metrics,
                      serving_table=serving_table)
