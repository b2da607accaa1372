"""Component dependency injection through the public wrapper API
(reference constructor injection, `networks.py:14-24,134,144`), the
per-call epsilon override (`networks.py:91`), and operability warnings.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from bithtm_tpu import HierarchicalTemporalMemory, SpatialPooler
from bithtm_tpu.models.temporal_memory import tm_step
from bithtm_tpu.ops.regularization import k_winners


def identity_boosting(cfg, overlaps, duty_cycle):
    return overlaps.astype(jnp.float32)


def halfwise_inhibition(cfg, boosted):
    """Local inhibition: top-k/2 within each half of the column range."""
    C = cfg.column_dim
    k = cfg.active_columns // 2
    lo_cols, _ = k_winners(boosted[: C // 2], k)
    hi_cols, _ = k_winners(boosted[C // 2:], k)
    cols = jnp.concatenate([lo_cols, hi_cols + C // 2])
    mask = jnp.zeros((C,), jnp.bool_).at[cols].set(True)
    return cols, mask


def tagged_tm(cfg, state, key, active_cols, learning, compute_winner):
    new_state, out = tm_step(cfg, state, key, active_cols,
                             learning=learning,
                             compute_winner=compute_winner)
    return new_state, out._replace(
        metrics={**out.metrics, "custom_tm_called": jnp.int32(1)}
    )


def _input(seed=0, dim=64):
    return np.random.RandomState(seed).rand(dim) < 0.2


def test_custom_inhibition_through_sp_wrapper():
    sp = SpatialPooler(64, 64, 8, inhibition=halfwise_inhibition)
    out = sp.process(_input())
    cols = np.asarray(out.active_columns)
    assert (cols < 32).sum() == 4 and (cols >= 32).sum() == 4


def test_custom_boosting_through_sp_wrapper():
    sp = SpatialPooler(64, 64, 8, boosting=identity_boosting)
    out = sp.process(_input())
    np.testing.assert_array_equal(
        np.asarray(out.boosted_overlaps), np.asarray(out.overlaps)
    )


def test_custom_inhibition_through_htm_wrapper():
    htm = HierarchicalTemporalMemory(
        64, 64, 4, active_columns=8, inhibition=halfwise_inhibition,
        segment_activation_threshold=2, segment_matching_threshold=2,
        segment_sampling_synapses=8,
    )
    for t in range(4):
        sp_out, tm_out = htm.process(_input(t))
        cols = np.asarray(sp_out.active_columns)
        assert (cols < 32).sum() == 4 and (cols >= 32).sum() == 4


def test_custom_temporal_memory_through_htm_wrapper():
    htm = HierarchicalTemporalMemory(
        64, 64, 4, active_columns=4, temporal_memory=tagged_tm,
        segment_activation_threshold=2, segment_matching_threshold=2,
        segment_sampling_synapses=8,
    )
    htm.process(_input())
    assert int(htm.last_metrics["custom_tm_called"]) == 1


def halved_overlap(cfg, state, input_bits):
    """A custom proximal rule: the built-in popcount overlap, halved —
    distinguishable from the default in `out.overlaps`."""
    from bithtm_tpu.ops.overlap import overlaps

    return overlaps(state.connected, input_bits) // 2


def frozen_proximal_update(cfg, state, input_bits, active_columns):
    """A proximal update that refuses to learn (tables pass through)."""
    return state.permanence, state.connected


def passthrough_distal_forward(cfg, state, active_cols, act_bits):
    """Re-derives exactly what the built-in inference forward computes —
    substituted output must be bit-identical to the default path."""
    from bithtm_tpu.ops.active_set import (seg_counts_packed,
                                           synapse_activation_conn)

    act = synapse_activation_conn(
        state.synapse_cell, state.synapse_perm, active_cols, act_bits,
        cfg.cell_dim, cfg.permanence_threshold, cfg.synapse_capacity,
    )
    pot, conn = seg_counts_packed(act, cfg.segments_per_column,
                                  cfg.synapse_capacity)
    return act, pot, conn


def test_custom_overlap_through_sp_wrapper():
    ref = SpatialPooler(64, 64, 8)
    sp = SpatialPooler(64, 64, 8, overlap=halved_overlap)
    x = _input()
    want = np.asarray(ref.process(x).overlaps) // 2
    np.testing.assert_array_equal(np.asarray(sp.process(x).overlaps), want)


def test_custom_overlap_end_to_end_htm():
    """The done-bar: a custom overlap rule swapped in
    end-to-end — the full HTM pipeline (SP -> TM, learning on) runs on
    top of it and the custom overlaps reach the driver observables."""
    htm = HierarchicalTemporalMemory(
        64, 64, 4, active_columns=4, overlap=halved_overlap,
        segment_activation_threshold=2, segment_matching_threshold=2,
        segment_sampling_synapses=8,
    )
    ref = HierarchicalTemporalMemory(
        64, 64, 4, active_columns=4,
        segment_activation_threshold=2, segment_matching_threshold=2,
        segment_sampling_synapses=8,
    )
    pats = np.random.RandomState(0).rand(5, 64) < 0.2
    # step 1 (identical init states): the hook's halved overlaps show up
    sp_out, _ = htm.process(pats[0])
    ref_out, _ = ref.process(pats[0])
    np.testing.assert_array_equal(np.asarray(sp_out.overlaps),
                                  np.asarray(ref_out.overlaps) // 2)
    # and the full pipeline keeps learning on top of the custom rule
    for _ in range(5):
        for p in pats:
            htm.process(p)
    assert int(htm.last_metrics["bursting"]) <= 1
    assert int(htm.last_metrics["correct"]) >= 3


def test_custom_proximal_update_freezes_tables():
    sp = SpatialPooler(64, 64, 8, proximal_update=frozen_proximal_update)
    before = np.asarray(sp.state.permanence).copy()
    sp.process(_input(), learning=True)
    np.testing.assert_array_equal(np.asarray(sp.state.permanence), before)
    # default DOES learn under the same step
    ref = SpatialPooler(64, 64, 8)
    ref_before = np.asarray(ref.state.permanence).copy()
    ref.process(_input(), learning=True)
    assert (np.asarray(ref.state.permanence) != ref_before).any()


def test_custom_distal_forward_inference_parity_and_guard():
    """A pass-through distal_forward is bit-identical to the built-in
    inference path; combining it with learning raises."""
    kw = dict(active_columns=4, segment_activation_threshold=2,
              segment_matching_threshold=2, segment_sampling_synapses=8)
    htm = HierarchicalTemporalMemory(64, 64, 4, **kw)
    pats = np.random.RandomState(1).rand(5, 64) < 0.2
    for _ in range(4):
        for p in pats:
            htm.process(p)
    hooked = HierarchicalTemporalMemory(
        64, 64, 4, distal_forward=passthrough_distal_forward, **kw)
    hooked.state = jax.tree.map(jnp.copy, htm.state)
    for p in pats:
        _, ref_tm = htm.process(p, learning=False, return_winner_cell=False)
        _, got_tm = hooked.process(p, learning=False,
                                   return_winner_cell=False)
        np.testing.assert_array_equal(np.asarray(ref_tm.prediction),
                                      np.asarray(got_tm.prediction))
    with pytest.raises(ValueError, match="inference forward pass only"):
        hooked.process(pats[0], learning=True)


def test_epsilon_per_call():
    from bithtm_tpu import TemporalMemory

    tm = TemporalMemory(32, 4, active_columns=4,
                        segment_activation_threshold=2,
                        segment_matching_threshold=2,
                        segment_sampling_synapses=4)
    sp = SpatialPooler(64, 32, 4)
    sp_out = sp.process(_input())
    tm.process(sp_out)                      # cfg default epsilon
    tm.process(sp_out, epsilon=1e-6)        # per-call override retraces
    tm.process(sp_out, epsilon=tm.config.epsilon)  # no-op override


def test_htm_scan_rejects_unbatched_inputs_with_batched_state():
    from bithtm_tpu import htm_init_batch, htm_scan, make_htm_config

    cfg = make_htm_config(32, 32, 4, active_columns=4,
                          segment_activation_threshold=2,
                          segment_matching_threshold=2,
                          segment_sampling_synapses=4)
    state = htm_init_batch(jax.random.key(0), cfg, 2)
    seq = jnp.zeros((3, cfg.input_dim), jnp.bool_)
    with pytest.raises(ValueError, match="single-stream state"):
        htm_scan(cfg, state, seq, True)


def test_host_temporal_memory_substitution():
    """A pure-NumPy, non-jittable TM rides the jitted composition root —
    the reference's `temporal_memory=` swap of a host Python class
    (`/root/reference/example.py:7-12` via `networks.py:134,144`). The
    host TM keeps its own mutable state (a transition dict); SP,
    driver metrics, and jit stay on the compiled path."""
    import numpy as np

    from bithtm_tpu import HierarchicalTemporalMemory, HostTemporalMemory

    C, D = 64, 4
    N = C * D
    transitions = {}
    last_cols = [None]

    def numpy_tm(active_cols, learning):
        # first-order sequence memory: remember column-set transitions,
        # activate/win cell 0 of each active column, predict the learned
        # successor set
        cols = tuple(sorted(int(c) for c in active_cols))
        active = np.zeros(N, bool)
        winner = np.zeros(N, bool)
        for c in cols:
            active[c * D] = True
            winner[c * D] = True
        if learning and last_cols[0] is not None:
            transitions[last_cols[0]] = cols
        pred = np.zeros(N, bool)
        for c in transitions.get(cols, ()):
            pred[c * D] = True
        last_cols[0] = cols
        return active, winner, pred

    htm = HierarchicalTemporalMemory(
        128, C, D, active_columns=4,
        temporal_memory=HostTemporalMemory(numpy_tm),
    )
    rng = np.random.RandomState(0)
    pats = rng.rand(4, 128) < 0.15
    per_epoch = []
    for _ in range(4):
        corrects = burstings = 0
        for p in pats:
            htm.process(p)
            corrects += int(htm.last_metrics["correct"])
            burstings += int(htm.last_metrics["bursting"])
        per_epoch.append((corrects, burstings))
    # the host dict learns the cycle: corrects rise toward 4 cols x 4
    # steps, bursting falls (epoch 1 is all-bursting: empty dict)
    assert per_epoch[0][1] == 16
    assert per_epoch[-1][0] > per_epoch[0][0]
    assert per_epoch[-1][1] < per_epoch[0][1]
    assert transitions  # the host-side state really mutated under jit
