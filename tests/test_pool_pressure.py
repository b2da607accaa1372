"""Column-pool pressure study.

This build replaces the reference's unbounded global segment store
(`DynamicArray2D` growth + table-wide recycling, `projections.py:79-95`
+ `utils.py:79-135`) with a static per-column pool of G slots. The
failure mode this creates: once a column's G slots are all *mature*
(live synapses >= matching threshold, so not recyclable under the
reference's `add_output` rule, `projections.py:80`), the column can
never host a NEW context — where the reference would simply grow its
table.

Worst-case workload driving it: one shared pattern S presented after
each of N context patterns in rotation. S's cells predict all N
contexts at once, so N-1 context predictions are punished per cycle;
eventually one context's segments die and must re-bootstrap — which
requires a fresh allocation in the now-mature pool.

Measured behavior (this file asserts it):
  * `allocation_policy="reference"` (default): permanent lockout — the
    dropped-allocation counter fires every epoch and the broken context
    never recovers. The failure is *surfaced*, not silent.
  * `allocation_policy="evict"`: the weakest non-matching mature slot
    is evicted instead; the broken context re-bootstraps and the run
    keeps returning to full prediction with zero drops.
  * `segments_per_column` headroom is the static-envelope knob: sized
    above the context count, the default policy converges outright.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np

from bithtm_tpu import TMConfig, tm_init
from bithtm_tpu.models.temporal_memory import tm_step
from bithtm_tpu.ops.active_set import prediction_dense_host


def _run_contexts(n_ctx: int, G: int, epochs: int = 40,
                  policy: str = "reference"):
    """Rotating (context_i, S) pairs; per-epoch stats for the shared
    pattern S: bursting, allocation drops/evictions (both step kinds),
    and the fraction of (context -> S) transitions predicted."""
    C, D, A = 96, 8, 6
    cfg = TMConfig(
        column_dim=C, cell_dim=D, active_columns=A,
        segments_per_column=G, synapse_capacity=16,
        segment_activation_threshold=3, segment_matching_threshold=3,
        segment_sampling_synapses=6,
        allocation_policy=policy,
    )
    rng = np.random.RandomState(0)
    # contexts use disjoint column ranges; S is a fixed disjoint set
    shared = np.arange(C - A, C, dtype=np.int32)
    ctxs = [np.sort(rng.choice(C - A, size=A, replace=False)).astype(np.int32)
            for _ in range(n_ctx)]

    step = jax.jit(functools.partial(tm_step, cfg),
                   static_argnames=("learning",))
    state = tm_init(cfg)
    key = jax.random.key(42)
    stats = []
    for epoch in range(epochs):
        burst_s = drops = evicted = 0
        predicted_cols = 0
        for i in range(n_ctx):
            key, k1, k2 = jax.random.split(key, 3)
            state, o1 = step(state, k1, jnp.asarray(ctxs[i]), learning=True)
            pred_before = prediction_dense_host(state.prediction,
                                                cfg.cell_dim)  # (C, D)
            state, o2 = step(state, k2, jnp.asarray(shared),
                             learning=True)
            m1, m2 = jax.device_get((o1.metrics, o2.metrics))
            burst_s += int(m2["tm_bursting_columns"])
            drops += int(m1["tm_dropped_new_segments"]) + int(
                m2["tm_dropped_new_segments"])
            evicted += int(m1["tm_evicted_segments"]) + int(
                m2["tm_evicted_segments"])
            predicted_cols += int(pred_before[shared].any(-1).sum())
        stats.append(dict(
            bursting=burst_s, drops=drops, evicted=evicted,
            predicted_frac=predicted_cols / (n_ctx * A),
        ))
    return cfg, stats


def test_reference_policy_lockout_is_surfaced():
    """Default policy: after the punishment cycle first breaks a
    context (~epoch 16 here), its column pools are fully mature, the
    re-bootstrap allocation drops EVERY epoch, and prediction never
    returns to full — a permanent lockout, but a loudly counted one."""
    _, stats = _run_contexts(n_ctx=3, G=4, policy="reference")
    late = stats[-15:]
    assert all(s["drops"] > 0 for s in late), late
    assert all(s["evicted"] == 0 for s in late)
    assert max(s["predicted_frac"] for s in late) < 1.0, late


def test_evict_policy_recovers():
    """Evict policy on the identical workload: allocations never drop
    (the weakest mature slot is recycled instead, counted), and the
    broken context periodically re-bootstraps back to full
    prediction."""
    _, stats = _run_contexts(n_ctx=3, G=4, policy="evict")
    assert all(s["drops"] == 0 for s in stats), stats[-5:]
    late = stats[-20:]
    assert any(s["evicted"] > 0 for s in late), late
    assert max(s["predicted_frac"] for s in late) == 1.0, late


def test_headroom_knob_keeps_pool_out_of_the_picture():
    """segments_per_column sized above the context count: allocations
    never drop, so the pool is out of the dynamics entirely and every
    punishment-induced context break re-bootstraps (the run keeps
    returning to full prediction). At 8 contexts the punishment cycle
    itself (7 punishments per reinforcement) keeps churning contexts —
    that is workload dynamics shared with the reference algorithm, not
    pool pressure."""
    _, stats = _run_contexts(n_ctx=8, G=16, epochs=30)
    assert all(s["drops"] == 0 for s in stats)
    assert all(s["evicted"] == 0 for s in stats)
    late = stats[-10:]
    assert max(s["predicted_frac"] for s in late) == 1.0, late


def test_growth_cap_drop_mitigation():
    """The growth list L (`resolved_growth_capacity`) is per-step
    SCRATCH width, not state: a run that counts
    `tm_dropped_growth_segments` overflows can re-jit with a wider
    (explicit) `growth_capacity` and resume from the SAME state pytree
    — zero migration. This pins the mitigation path the 16K soak's
    655-of-656 peak relies on."""
    C, D, A, G = 96, 8, 24, 4
    base = dict(
        column_dim=C, cell_dim=D, active_columns=A,
        segments_per_column=G, synapse_capacity=16,
        segment_activation_threshold=3, segment_matching_threshold=3,
        segment_sampling_synapses=6,
    )
    tight = TMConfig(**base, growth_capacity=8)
    wide = TMConfig(**base, growth_capacity=64)

    rng = np.random.RandomState(3)
    cols = [np.sort(rng.choice(C, size=A, replace=False)).astype(np.int32)
            for _ in range(4)]
    step_tight = jax.jit(functools.partial(tm_step, tight),
                         static_argnames=("learning",))
    step_wide = jax.jit(functools.partial(tm_step, wide),
                        static_argnames=("learning",))

    state = tm_init(tight)
    key = jax.random.key(9)
    dropped = 0
    for t in range(8):
        key, k = jax.random.split(key)
        state, out = step_tight(state, k, jnp.asarray(cols[t % 4]),
                                learning=True)
        dropped += int(out.metrics["tm_dropped_growth_segments"])
    # bootstrap allocates ~A=24 growing segments/step; L=8 drops them
    assert dropped > 0, "workload failed to overflow the tight L"

    # same state pytree, wider L: shapes unchanged, drops stop
    jax.tree_util.tree_map(lambda x: x, state)  # still a valid pytree
    dropped_after = 0
    for t in range(12):
        key, k = jax.random.split(key)
        state, out = step_wide(state, k, jnp.asarray(cols[t % 4]),
                               learning=True)
        dropped_after += int(out.metrics["tm_dropped_growth_segments"])
    assert dropped_after == 0, dropped_after
    # and learning actually proceeds: the repeating patterns predict
    pred = prediction_dense_host(state.prediction, D)
    assert pred.any(), "no predictions formed after widening L"


def test_htm_scan_autocap_escalates_and_stays_dropfree():
    """`htm_scan_autocap`: starts under tight
    tuned caps, counts the first winner/growth cap drop, re-runs that
    chunk under the safe caps — so the produced trajectory is
    drop-free on the cap counters and bit-equal to manually switching
    configs at the escalation point."""
    from bithtm_tpu import htm_init, htm_scan, make_htm_config
    from bithtm_tpu.models.htm import htm_scan_autocap

    import dataclasses

    cfg = make_htm_config(
        input_dim=128, column_dim=96, cell_dim=8, active_columns=24,
        segments_per_column=4, synapse_capacity=16,
        segment_activation_threshold=3, segment_matching_threshold=3,
        segment_sampling_synapses=6,
    )
    tuned = dict(growth_capacity=8)   # bootstrap allocates ~A=24 -> drops
    rng = np.random.RandomState(5)
    pats = rng.rand(4, 128) < 0.2
    seq = jnp.asarray(pats[np.arange(24) % 4])

    state, metrics, info = htm_scan_autocap(
        cfg, htm_init(jax.random.key(0), cfg), seq,
        tuned=tuned, chunk=4, unroll=1)

    assert info["escalated_at_step"] is not None
    assert info["tuned_drops"] > 0
    # the produced trajectory never dropped on the tuned counters
    assert metrics["tm_dropped_growth_segments"].sum() == 0
    assert metrics["tm_dropped_winner_candidates"].sum() == 0

    # bit-equal to manually switching configs at the escalation point
    esc = info["escalated_at_step"]
    cfg_tuned = dataclasses.replace(
        cfg, tm=dataclasses.replace(cfg.tm, **tuned))
    ctrl = htm_init(jax.random.key(0), cfg)
    if esc > 0:
        ctrl, _ = htm_scan(cfg_tuned, ctrl, seq[:esc], True, 1)
    ctrl, _ = htm_scan(cfg, ctrl, seq[esc:], True, 1)
    for name in ("synapse_cell", "synapse_perm", "seg_cell",
                 "prediction", "matching_word", "step"):
        np.testing.assert_array_equal(
            np.asarray(getattr(state.tm, name)),
            np.asarray(getattr(ctrl.tm, name)), err_msg=name)


def test_htm_scan_autocap_no_escalation_when_caps_hold():
    """Wide tuned caps that never drop: no escalation, trajectory
    bit-equal to a plain tuned-caps scan."""
    from bithtm_tpu import htm_init, htm_scan, make_htm_config
    from bithtm_tpu.models.htm import htm_scan_autocap

    import dataclasses

    cfg = make_htm_config(
        input_dim=128, column_dim=96, cell_dim=8, active_columns=24,
        segments_per_column=4, synapse_capacity=16,
        segment_activation_threshold=3, segment_matching_threshold=3,
        segment_sampling_synapses=6,
    )
    tuned = dict(growth_capacity=96)
    rng = np.random.RandomState(6)
    pats = rng.rand(4, 128) < 0.2
    seq = jnp.asarray(pats[np.arange(12) % 4])
    state, metrics, info = htm_scan_autocap(
        cfg, htm_init(jax.random.key(1), cfg), seq,
        tuned=tuned, chunk=5, unroll=1)
    assert info["escalated_at_step"] is None and info["chunks"] == 3

    cfg_tuned = dataclasses.replace(
        cfg, tm=dataclasses.replace(cfg.tm, **tuned))
    ctrl, _ = htm_scan(cfg_tuned, htm_init(jax.random.key(1), cfg),
                       seq, True, 1)
    np.testing.assert_array_equal(np.asarray(state.tm.synapse_perm),
                                  np.asarray(ctrl.tm.synapse_perm))
