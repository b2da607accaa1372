"""End-to-end HTM behavior: learning convergence, scan/loop equivalence,
stream independence under vmap — the semantics of the reference driver
loop (`example.py:48-67`)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np

from bithtm_tpu import (
    htm_init,
    htm_init_batch,
    htm_scan,
    htm_step,
    htm_step_batch,
    make_htm_config,
)


def small_cfg(**kw):
    base = dict(
        input_dim=64,
        column_dim=64,
        cell_dim=4,
        active_columns=4,
        segment_activation_threshold=2,
        segment_matching_threshold=2,
        segment_sampling_synapses=8,
    )
    base.update(kw)
    return make_htm_config(**base)


def test_learning_converges():
    """Bursting falls and correct predictions rise on a repeated
    sequence (the reference's convergence eyeball, example.py:55-65)."""
    cfg = small_cfg()
    state = htm_init(jax.random.key(0), cfg)
    rng = np.random.RandomState(0)
    pats = rng.rand(6, cfg.input_dim) < 0.2
    step = jax.jit(functools.partial(htm_step, cfg), static_argnums=(2,))
    first_epoch, last_epoch = None, None
    for epoch in range(10):
        tot_burst, tot_correct = 0, 0
        for p in pats:
            state, out = step(state, jnp.asarray(p), True)
            tot_burst += int(out.metrics["bursting"])
            tot_correct += int(out.metrics["correct"])
        if epoch == 0:
            first_epoch = (tot_burst, tot_correct)
        last_epoch = (tot_burst, tot_correct)
    assert last_epoch[0] < first_epoch[0], "bursting should fall"
    assert last_epoch[1] > first_epoch[1], "corrects should rise"
    assert last_epoch[1] >= 3 * len(pats)  # most columns predicted


def test_scan_equals_python_loop():
    cfg = small_cfg()
    rng = np.random.RandomState(1)
    seq = jnp.asarray(rng.rand(12, cfg.input_dim) < 0.2)

    state_a = htm_init(jax.random.key(7), cfg)
    step = jax.jit(functools.partial(htm_step, cfg), static_argnums=(2,))
    metrics_loop = []
    for x in seq:
        state_a, out = step(state_a, x, True)
        metrics_loop.append(int(out.metrics["bursting"]))

    state_b = htm_init(jax.random.key(7), cfg)
    state_b, metrics = htm_scan(cfg, state_b, seq, True)

    np.testing.assert_array_equal(
        np.asarray(metrics["bursting"]), metrics_loop
    )
    jax.tree_util.tree_map(
        lambda a, b: np.testing.assert_array_equal(
            np.asarray(a), np.asarray(b)
        ),
        jax.device_get(state_a.tm),
        jax.device_get(state_b.tm),
    )


def test_batched_streams_are_independent():
    """Stream i of a batched run must equal a solo run with the same key."""
    cfg = small_cfg()
    B = 3
    batch_state = htm_init_batch(jax.random.key(42), cfg, B)
    solo_state = jax.tree_util.tree_map(lambda x: x[1], batch_state)
    rng = np.random.RandomState(2)
    seq = jnp.asarray(rng.rand(8, B, cfg.input_dim) < 0.2)
    final_batch, _ = htm_scan(cfg, batch_state, seq, True)
    final_solo, _ = htm_scan(cfg, solo_state, seq[:, 1], True)

    jax.tree_util.tree_map(
        lambda a, b: np.testing.assert_array_equal(
            np.asarray(a)[1], np.asarray(b)
        ),
        jax.device_get(final_batch.tm),
        jax.device_get(final_solo.tm),
    )


def test_inference_mode_frozen_graph():
    cfg = small_cfg()
    state = htm_init(jax.random.key(3), cfg)
    rng = np.random.RandomState(3)
    seq = jnp.asarray(rng.rand(10, cfg.input_dim) < 0.2)
    state, _ = htm_scan(cfg, state, seq, True)
    before = jax.device_get(state)
    state2, _ = htm_scan(cfg, state, seq, False)
    after = jax.device_get(state2)
    np.testing.assert_array_equal(before.tm.synapse_perm,
                                  after.tm.synapse_perm)
    np.testing.assert_array_equal(before.tm.seg_cell, after.tm.seg_cell)
    np.testing.assert_array_equal(before.sp.permanence, after.sp.permanence)


def test_multiword_cell_dim_end_to_end():
    """cell_dim > 32 (multi-word bitmasks) through the full HTM."""
    cfg = small_cfg(cell_dim=40)
    state = htm_init(jax.random.key(0), cfg)
    rng = np.random.RandomState(5)
    pats = rng.rand(4, cfg.input_dim) < 0.2
    step = jax.jit(functools.partial(htm_step, cfg), static_argnums=(2,))
    first = last = None
    for epoch in range(12):
        burst = 0
        for p in pats:
            state, out = step(state, jnp.asarray(p), True)
            burst += int(out.metrics["bursting"])
        if epoch == 0:
            first = burst
        last = burst
    # boosting (0.3) keeps remapping a column or two forever (faithful
    # to the reference's convergence behavior) - require a 4x drop
    assert last <= first // 4, (first, last)
    assert int(out.metrics["tm_predicted_cells"]) > 0


def test_inference_serving_keeps_predicting():
    """Train, then serve with learning=False: predictions persist and
    anomaly stays low on in-distribution inputs, spikes on novel ones."""
    # low boosting: the default 0.3 keeps remapping columns, which reads
    # as anomaly even on learned inputs (faithful reference behavior)
    cfg = small_cfg(sp_overrides={"boosting_intensity": 0.02})
    state = htm_init(jax.random.key(1), cfg)
    rng = np.random.RandomState(6)
    pats = rng.rand(5, cfg.input_dim) < 0.2
    seq = jnp.asarray(np.tile(pats, (12, 1)))
    state, _ = htm_scan(cfg, state, seq, True)

    state, m = htm_scan(cfg, state, jnp.asarray(np.tile(pats, (3, 1))),
                        False)
    assert np.asarray(m["anomaly"]).mean() < 0.3

    novel = jnp.asarray(rng.rand(5, cfg.input_dim) < 0.2)
    state, m2 = htm_scan(cfg, state, novel, False)
    assert np.asarray(m2["anomaly"]).mean() > 0.7


def test_shape_errors_are_friendly():
    import pytest

    cfg = small_cfg()
    state = htm_init(jax.random.key(0), cfg)
    with pytest.raises(ValueError, match="htm_step expects"):
        htm_step(cfg, state, jnp.zeros((3, cfg.input_dim), bool))
    with pytest.raises(ValueError, match="htm_scan expects"):
        htm_scan(cfg, state, jnp.zeros((5, cfg.input_dim + 1), bool), True)
    with pytest.raises(ValueError, match="batched"):
        htm_scan(cfg, state, jnp.zeros((5, 2, cfg.input_dim), bool), True)


def test_serve_scan_bit_equals_inference_scan():
    """`htm_serve_scan` (the packed frozen-word serving path) produces
    the exact state trajectory and metrics of
    `htm_scan(learning=False)`, batched and unbatched, including the
    carried packed activity (`synapse_act`) a later learning step would
    consume."""
    from bithtm_tpu import htm_serve_scan

    def clone(t):
        return jax.tree.map(lambda x: x.copy(), t)

    def assert_tree_equal(a, b):
        for (p, x), (_, y) in zip(jax.tree_util.tree_leaves_with_path(a),
                                  jax.tree_util.tree_leaves_with_path(b)):
            if hasattr(x, "dtype") and jnp.issubdtype(
                    x.dtype, jax.dtypes.prng_key):
                x, y = jax.random.key_data(x), jax.random.key_data(y)
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y),
                                          err_msg=str(p))

    cfg = small_cfg()
    rng = np.random.RandomState(11)
    for batched in (False, True):
        if batched:
            state = htm_init_batch(jax.random.key(4), cfg, 3)
            train = jnp.asarray(rng.rand(30, 3, cfg.input_dim) < 0.2)
            serve = jnp.asarray(rng.rand(8, 3, cfg.input_dim) < 0.2)
        else:
            state = htm_init(jax.random.key(4), cfg)
            train = jnp.asarray(rng.rand(30, cfg.input_dim) < 0.2)
            serve = jnp.asarray(rng.rand(8, cfg.input_dim) < 0.2)
        state, _ = htm_scan(cfg, state, train, True)
        s1, m1 = htm_scan(cfg, clone(state), serve, False, 0, False)
        s2, m2 = htm_serve_scan(cfg, clone(state), serve)
        assert_tree_equal(s1, s2)
        assert sorted(m1) == sorted(m2)
        for k in m1:
            np.testing.assert_array_equal(np.asarray(m1[k]),
                                          np.asarray(m2[k]), err_msg=k)
        # a learning step resumed from the served state is also
        # bit-identical (synapse_act carry correctness)
        l1, _ = htm_scan(cfg, s1, train[:2], True)
        l2, _ = htm_scan(cfg, s2, train[:2], True)
        assert_tree_equal(l1, l2)


def test_frozen_word_step_bit_equals_unpacked():
    """The kept (not-dispatched-by-default) frozen-word forward:
    `htm_step_batch(..., frozen_word=...)` over a `pack_frozen_table`
    snapshot is bit-equal to the unpacked inference step — the contract
    for enabling it where the activation pass is bandwidth-bound."""
    from bithtm_tpu.ops.active_set import pack_frozen_table

    cfg = small_cfg()
    B = 3
    rng = np.random.RandomState(13)
    state = htm_init_batch(jax.random.key(9), cfg, B)
    train = jnp.asarray(rng.rand(25, B, cfg.input_dim) < 0.2)
    state, _ = htm_scan(cfg, state, train, True)
    state = jax.device_get(state)

    frozen = pack_frozen_table(jnp.asarray(state.tm.synapse_cell),
                               jnp.asarray(state.tm.synapse_perm),
                               cfg.tm.permanence_threshold)
    s1 = jax.tree.map(jnp.asarray, state)
    s2 = jax.tree.map(jnp.asarray, state)
    for t in range(4):
        x = jnp.asarray(rng.rand(B, cfg.input_dim) < 0.2)
        s1, o1 = htm_step_batch(cfg, s1, x, learning=False,
                                compute_winner=False)
        s2, o2 = htm_step_batch(cfg, s2, x, learning=False,
                                compute_winner=False, frozen_word=frozen)
        np.testing.assert_array_equal(np.asarray(o1.tm.prediction),
                                      np.asarray(o2.tm.prediction))
        for k in o1.metrics:
            np.testing.assert_array_equal(np.asarray(o1.metrics[k]),
                                          np.asarray(o2.metrics[k]),
                                          err_msg=k)
    np.testing.assert_array_equal(np.asarray(s1.tm.synapse_act),
                                  np.asarray(s2.tm.synapse_act))


def test_tm_segment_observables_match_naive_and_carry():
    """`tm_segment_observables` (the reference's per-segment forward
    observables, `projections.py:195-203`) decodes the packed activity
    into exact per-segment counts: validated against a naive NumPy
    count over the previous active set, and its matching mask must
    equal the carried matching_word bit for bit."""
    from bithtm_tpu import (htm_init, htm_scan, make_htm_config,
                            tm_segment_observables)

    cfg = make_htm_config(
        input_dim=64, column_dim=64, cell_dim=4, active_columns=4,
        segment_activation_threshold=2, segment_matching_threshold=2,
        segment_sampling_synapses=8,
    )
    rng = np.random.RandomState(11)
    pats = rng.rand(5, 64) < 0.2
    state = htm_init(jax.random.key(2), cfg)
    state, _ = htm_scan(cfg, state, jnp.asarray(pats[np.arange(30) % 5]),
                        True, 1)

    obs = tm_segment_observables(cfg.tm, state.tm)
    C, D = cfg.tm.column_dim, cfg.tm.cell_dim
    G, K = cfg.tm.segments_per_column, cfg.tm.synapse_capacity
    thr = cfg.tm.permanence_threshold

    # previous step's active cells from the compact carry
    cols = np.asarray(state.tm.active_cols)
    bits = np.asarray(state.tm.active_bits)
    active_cells = {
        int(cols[a]) * D + d
        for a in range(len(cols)) for d in range(D)
        if bits[a, d // 32] >> (d % 32) & 1
    }
    syn = np.asarray(state.tm.synapse_cell)
    perm = np.asarray(state.tm.synapse_perm)
    pot = np.zeros((C, G), np.int32)
    conn = np.zeros((C, G), np.int32)
    for c in range(C):
        for j in range(G * K):
            if perm[c, j] >= 0 and int(syn[c, j]) in active_cells:
                pot[c, j // K] += 1
                if perm[c, j] >= thr:
                    conn[c, j // K] += 1
    np.testing.assert_array_equal(np.asarray(obs["potential"]), pot)
    np.testing.assert_array_equal(np.asarray(obs["connected_active"]),
                                  conn)
    assert np.asarray(obs["matching"]).any()  # non-degenerate state
    # matching mask == the carried packed matching_word
    mw = np.asarray(state.tm.matching_word)
    want = ((mw[:, None] >> np.arange(G)[None, :]) & 1) != 0
    np.testing.assert_array_equal(np.asarray(obs["matching"]), want)

    # batched states decode too (leading axis)
    from bithtm_tpu import htm_init_batch
    bstate = htm_init_batch(jax.random.key(0), cfg, 3)
    bobs = tm_segment_observables(cfg.tm, bstate.tm)
    assert bobs["potential"].shape == (3, C, G)
