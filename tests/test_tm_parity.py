"""Bit-exact TemporalMemory parity: JAX step vs clean-room NumPy oracle.

The oracle (`bithtm_tpu/oracle/bami.py`) re-derives every deterministic
consequence of the step independently, adopting only the JAX step's
RNG tie-break decisions after validating them against the legal
candidate sets (SURVEY.md §4's recommended transplant direction).
Comparison covers active/winner/predicted cell sets, the matching /
active segment sets, per-segment potentials, and the entire synapse
table (targets + float32-exact permanences) — every step.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np

from bithtm_tpu import TMConfig, tm_init
from bithtm_tpu.models.temporal_memory import tm_step
from bithtm_tpu.oracle.bami import OracleDecisions, OracleTM
from bithtm_tpu.oracle.transplant import extract_decisions, oracle_from_state


def make_cfg(k_active=5, **kw):
    base = dict(
        column_dim=32,
        cell_dim=4,
        active_columns=k_active,
        segments_per_column=4,
        synapse_capacity=12,
        segment_activation_threshold=2,
        segment_matching_threshold=2,
        segment_sampling_synapses=4,
        # incommensurate constants so no permanence ever lands exactly on
        # the 0.0 death threshold (would make f32-vs-f64 comparison moot)
        permanence_initial=0.2137,
        permanence_increment=0.1003,
        permanence_decrement=0.0997,
        permanence_punishment=0.0251,
    )
    base.update(kw)
    return TMConfig(**base)


def run_parity(cfg, steps, seed, learn_schedule=None, cols_fn=None):
    step_fn = jax.jit(
        functools.partial(tm_step, cfg),
        static_argnames=("learning", "compute_winner", "return_debug"),
    )
    state = tm_init(cfg)
    oracle = OracleTM(cfg)
    rng = np.random.RandomState(seed)
    key = jax.random.key(seed)
    for t in range(steps):
        if cols_fn is not None:
            cols = cols_fn(t, rng)
        else:
            cols = np.sort(
                rng.choice(cfg.column_dim, size=cfg.active_columns,
                           replace=False)
            ).astype(np.int32)
        learning = True if learn_schedule is None else learn_schedule(t)
        key, sub = jax.random.split(key)
        if learning:
            state, out, debug = step_fn(
                state, sub, jnp.asarray(cols),
                learning=True, return_debug=True,
            )
            decisions = extract_decisions(jax.device_get(debug))
        else:
            state, out = step_fn(state, sub, jnp.asarray(cols),
                                 learning=False)
            decisions = OracleDecisions(
                winner_cells=set(
                    np.nonzero(np.asarray(out.winner_mask))[0].tolist()
                ),
                learning_segments=set(), new_segments=[], grown={},
            )
        oracle.step(cols, decisions, learning=learning)
        host = jax.device_get(state)
        oracle.compare(host)
    return state, oracle


def test_parity_full_learning_200_steps():
    run_parity(make_cfg(), steps=200, seed=0)


def test_parity_small_cells_heavy_reuse():
    # 2 cells/column, few columns -> heavy segment reuse and punishment
    cfg = make_cfg(k_active=4, column_dim=16, cell_dim=2)
    run_parity(cfg, steps=200, seed=1)


def test_parity_tight_pool_recycling():
    # One slot per column forces recycle-before-grow continuously
    cfg = make_cfg(segments_per_column=1)
    run_parity(cfg, steps=150, seed=2)


def test_parity_evict_allocation_policy():
    # allocation_policy="evict" (the default): mature non-matching slots
    # become a third (weakest-first) eligibility tier; the oracle
    # re-derives the same eviction choices. Tight pools force evictions
    # constantly.
    cfg = make_cfg(segments_per_column=2, allocation_policy="evict")
    run_parity(cfg, steps=150, seed=12)
    cfg2 = make_cfg(allocation_policy="evict", synapse_capacity=8,
                    segment_sampling_synapses=4)
    run_parity(cfg2, steps=120, seed=13)


def test_parity_reference_allocation_policy_under_pressure():
    # The opt-in drop-mode policy stays parity-pinned: same tight-pool
    # pressure configs as the evict test, explicit policy.
    cfg = make_cfg(segments_per_column=2, allocation_policy="reference")
    run_parity(cfg, steps=150, seed=12)


def test_evict_equals_reference_until_first_drop():
    """The default-flip contract: `evict` is
    bit-identical to `reference` up to and including the step where
    `reference` first drops an allocation — recyclable slots always
    outrank evictable ones in `_allocate`'s tier-key order, so the two
    policies choose identical slots while recyclable supply suffices."""
    import dataclasses

    cfg_e = make_cfg(segments_per_column=2, allocation_policy="evict")
    cfg_r = dataclasses.replace(cfg_e, allocation_policy="reference")
    fns = {
        name: jax.jit(
            functools.partial(tm_step, c),
            static_argnames=("learning", "compute_winner", "return_debug"),
        )
        for name, c in (("evict", cfg_e), ("reference", cfg_r))
    }
    states = {"evict": tm_init(cfg_e), "reference": tm_init(cfg_r)}
    rng = np.random.RandomState(21)
    key = jax.random.key(21)
    saw_drop = False
    for t in range(120):
        cols = np.sort(
            rng.choice(cfg_e.column_dim, size=cfg_e.active_columns,
                       replace=False)
        ).astype(np.int32)
        key, sub = jax.random.split(key)
        outs = {}
        for name, fn in fns.items():
            states[name], outs[name] = fn(
                states[name], sub, jnp.asarray(cols), learning=True
            )
        dropped = int(outs["reference"].metrics["tm_dropped_new_segments"])
        evicted = int(outs["evict"].metrics["tm_evicted_segments"])
        he = jax.device_get(states["evict"])
        hr = jax.device_get(states["reference"])
        if dropped == 0:
            # no pressure this step: full state pytrees bit-equal
            assert evicted == 0
            for fe, fr in zip(jax.tree.leaves(he), jax.tree.leaves(hr)):
                np.testing.assert_array_equal(np.asarray(fe),
                                              np.asarray(fr))
        else:
            # the divergence step: evict served what reference dropped
            assert evicted == dropped
            saw_drop = True
            break
    assert saw_drop, "workload never pressured the pool; test is vacuous"


def test_parity_mixed_inference():
    # alternate learning and inference; inference must not mutate
    cfg = make_cfg()
    run_parity(cfg, steps=120, seed=3,
               learn_schedule=lambda t: t % 3 != 1)


def test_parity_tiny_synapse_capacity_overflow():
    # K too small: growth hits the free-slot cap; oracle models the cap
    cfg = make_cfg(synapse_capacity=5, segment_sampling_synapses=4)
    run_parity(cfg, steps=150, seed=4)


def test_parity_tiny_growth_capacity():
    # growth list narrower than the learning-segment count: segments
    # past the cap (ascending global slot id) skip growth; the oracle
    # mirrors the truncation (this forces it constantly)
    cfg = make_cfg(growth_capacity=2)
    run_parity(cfg, steps=150, seed=14)


def test_parity_tiny_winner_capacity():
    # candidate list narrower than the winner count: truncation by
    # ascending cell id must match between oracle and JAX step
    cfg = make_cfg(winner_capacity=3)
    run_parity(cfg, steps=150, seed=7)


def test_parity_midscale_real_thresholds():
    """Mid-scale parity at the regime the defaults actually run in:
    C=512, D=32, the reference's real thresholds
    (activation/matching 15, sampling 32, `projections.py:205-223`),
    G=8/K=48 pools, ~80 steps over a repeating 6-pattern cycle so
    matching segments, predictions, reinforcement, and punishment all
    actually fire. Bit-exact every step (the oracle is O(synapses) per
    step, so the step count is budgeted, not maximal)."""
    cfg = make_cfg(
        k_active=41, column_dim=512, cell_dim=32,
        segments_per_column=8, synapse_capacity=48,
        segment_activation_threshold=15, segment_matching_threshold=15,
        segment_sampling_synapses=32,
    )
    patterns = [
        np.sort(np.random.RandomState(100 + i).choice(
            cfg.column_dim, size=cfg.active_columns, replace=False
        )).astype(np.int32)
        for i in range(6)
    ]

    def cols_fn(t, rng):
        base = patterns[t % len(patterns)]
        if rng.rand() < 0.2:  # occasional noise: swap one column out
            base = base.copy()
            repl = rng.randint(cfg.column_dim)
            while repl in base:
                repl = rng.randint(cfg.column_dim)
            base[rng.randint(len(base))] = repl
            base = np.sort(base)
        return base

    state, oracle = run_parity(cfg, steps=80, seed=11, cols_fn=cols_fn)
    # sanity: the run must actually reach the predictive regime
    assert len(oracle.predicted_cells) > 0
    assert len(oracle.active_segments) > 0


def test_parity_multiword_bitmask():
    # cell_dim > 32 exercises the multi-word uint32 bitmask path
    cfg = make_cfg(k_active=4, column_dim=16, cell_dim=40,
                   segments_per_column=2)
    run_parity(cfg, steps=100, seed=6)


def test_oracle_from_state_midstream():
    cfg = make_cfg()
    state, _ = run_parity(cfg, steps=50, seed=5)
    o = oracle_from_state(cfg, jax.device_get(state))
    o.compare(jax.device_get(state))


def test_parity_single_cell_columns():
    # cell_dim=1: every active column has exactly one (always-winning)
    # cell; bursting == unpredicted; degenerate one-hot paths
    cfg = make_cfg(k_active=4, column_dim=24, cell_dim=1,
                   segments_per_column=3)
    run_parity(cfg, steps=120, seed=8)


def test_parity_single_active_column():
    # A=1: compact active-set arrays have a singleton leading axis
    cfg = make_cfg(k_active=1, column_dim=16, cell_dim=4,
                   segment_activation_threshold=1,
                   segment_matching_threshold=1,
                   segment_sampling_synapses=2)
    run_parity(cfg, steps=100, seed=9)


def test_parity_exact_cell_word_boundary():
    # cell_dim=32 exactly fills one uint32 word (bit 31 sign handling)
    cfg = make_cfg(k_active=3, column_dim=8, cell_dim=32,
                   segments_per_column=2)
    run_parity(cfg, steps=100, seed=10)


def test_parity_all_columns_active():
    # A == C: no punishment can ever occur (every column active)
    cfg = make_cfg(k_active=8, column_dim=8, cell_dim=4,
                   segments_per_column=4)
    run_parity(cfg, steps=80, seed=11)


def test_parity_fuzz_random_configs():
    """Randomized configs (dims, capacities, thresholds) x 40 learning
    steps, each step compared bit-exactly against the oracle."""
    rng = np.random.RandomState(1234)
    for trial in range(6):
        D = int(rng.choice([1, 2, 3, 4, 8, 33]))
        C = int(rng.choice([8, 16, 24, 40]))
        A = int(rng.randint(1, min(C, 6) + 1))
        G = int(rng.choice([1, 2, 4, 5]))
        K = int(rng.randint(3, 14))
        samp = int(rng.randint(1, min(K, 6) + 1))
        thr = int(rng.randint(1, samp + 1))
        cfg = make_cfg(
            k_active=A, column_dim=C, cell_dim=D,
            segments_per_column=G, synapse_capacity=K,
            segment_sampling_synapses=samp,
            segment_matching_threshold=thr,
            segment_activation_threshold=int(rng.randint(1, thr + 1)),
        )
        run_parity(cfg, steps=40, seed=1000 + trial)


def test_select_and_fill_methods_agree():
    """The sortfill and pairwise growth-selection paths choose the
    identical candidate set into the identical free slots (placement
    order within the slots differs by design — a segment is a set)."""
    from bithtm_tpu.models.temporal_memory import _select_and_fill

    rng = np.random.RandomState(42)
    for trial in range(8):  # each distinct shape costs 2 jit compiles
        L = int(rng.randint(1, 12))
        Wc = int(rng.choice([4, 16, 130, 260]))
        K = int(rng.randint(3, 20))
        samp = int(rng.randint(1, 34))
        pri = rng.rand(L, Wc).astype(np.float32)
        # random invalid candidates (existing targets / past list end)
        pri[rng.rand(L, Wc) < 0.3] = np.inf
        n_grow = rng.randint(0, min(samp, Wc) + 1, size=L).astype(np.int32)
        cand_cell = rng.randint(0, 1000, size=Wc).astype(np.int32)
        free = rng.rand(L, K) < 0.5
        outs = {}
        for method in ("pairwise", "sortfill"):
            gathered, wrote, n_chosen = jax.device_get(
                _select_and_fill(
                    jnp.asarray(pri), jnp.asarray(n_grow),
                    jnp.asarray(cand_cell), jnp.asarray(free),
                    samp, method,
                )
            )
            outs[method] = (gathered, wrote, n_chosen)
        (g1, w1, n1), (g2, w2, n2) = outs["pairwise"], outs["sortfill"]
        np.testing.assert_array_equal(w1, w2)
        np.testing.assert_array_equal(n1, n2)
        for l in range(L):
            # the exact chosen set: the n smallest finite priorities
            order = np.argsort(pri[l], kind="stable")
            n = min(int(n_grow[l]), int(np.isfinite(pri[l]).sum()))
            chosen = cand_cell[order[:n]]
            got1, got2 = np.sort(g1[l][w1[l]]), np.sort(g2[l][w2[l]])
            if n <= int(free[l].sum()):  # no overflow: full set written
                np.testing.assert_array_equal(got1, np.sort(chosen))
                np.testing.assert_array_equal(got2, np.sort(chosen))
            else:  # overflow: each writes SOME subset of the chosen set
                from collections import Counter

                for got in (got1, got2):
                    assert not Counter(got.tolist()) - Counter(
                        chosen.tolist()
                    )


def test_select_and_fill_packed_idx():
    """The packed-index path (candidate list index in the low key bits,
    random bits above, sentinel 0x7FFFFFFF) selects exactly the cells
    of the n smallest keys into the first free slots, matching the
    f32-priority sortfill run on the key order."""
    from bithtm_tpu.models.temporal_memory import _select_and_fill

    rng = np.random.RandomState(7)
    for trial in range(8):
        L = int(rng.randint(1, 12))
        # 384/700 trigger the split selection (192-wide blocks, with
        # and without sentinel padding); the rest the full sort
        Wc = int(rng.choice([4, 16, 130, 384, 700]))
        K = int(rng.randint(3, 20))
        samp = int(rng.randint(1, 34))
        idx_bits = max(1, (Wc - 1).bit_length())
        # distinct indices by construction; random bits in
        # [idx_bits, 29]; ~30% invalid (sentinel)
        hi = rng.randint(0, 1 << (30 - idx_bits), size=(L, Wc))
        key = ((hi << idx_bits) | np.arange(Wc)).astype(np.int32)
        key[rng.rand(L, Wc) < 0.3] = np.int32(0x7FFFFFFF)
        cells = rng.randint(0, 1 << 20, size=Wc).astype(np.int32)
        n_grow = rng.randint(0, min(samp, Wc) + 1, size=L).astype(np.int32)
        free = rng.rand(L, K) < 0.5
        gathered, wrote, n_chosen = jax.device_get(
            _select_and_fill(
                jnp.asarray(key), jnp.asarray(n_grow),
                jnp.asarray(cells), jnp.asarray(free),
                samp, "sortfill_packed_idx", idx_bits=idx_bits,
            )
        )
        for l in range(L):
            valid = key[l] != np.int32(0x7FFFFFFF)
            n = min(int(n_grow[l]), int(valid.sum()))
            order = np.argsort(key[l], kind="stable")
            chosen = cells[key[l][order[:n]] & ((1 << idx_bits) - 1)]
            assert int(n_chosen[l]) == n
            got = np.sort(gathered[l][wrote[l]])
            if n <= int(free[l].sum()):
                np.testing.assert_array_equal(got, np.sort(chosen))
            else:
                from collections import Counter

                assert not Counter(got.tolist()) - Counter(
                    chosen.tolist()
                )


def test_select_and_fill_packed_cell():
    """The packed-cell path (cell id in the low key bits, random bits
    above, sentinel 0xFFFFFFFF) selects exactly the cells of the n
    smallest keys into the first free slots."""
    from bithtm_tpu.models.temporal_memory import _select_and_fill

    rng = np.random.RandomState(17)
    cell_bits = 16
    for trial in range(8):
        L = int(rng.randint(1, 12))
        Wc = int(rng.choice([4, 16, 130, 384, 700]))
        K = int(rng.randint(3, 20))
        samp = int(rng.randint(1, 34))
        # distinct cells (the real candidate list is distinct by
        # construction), random high bits (bit 31 clear), ~30% invalid
        cells = rng.choice(1 << cell_bits, size=Wc, replace=False)
        hi = rng.randint(0, 1 << (31 - cell_bits), size=(L, Wc))
        key = ((hi << cell_bits) | cells[None, :]).astype(np.uint32)
        key[rng.rand(L, Wc) < 0.3] = np.uint32(0xFFFFFFFF)
        n_grow = rng.randint(0, min(samp, Wc) + 1, size=L).astype(np.int32)
        free = rng.rand(L, K) < 0.5
        gathered, wrote, n_chosen = jax.device_get(
            _select_and_fill(
                jnp.asarray(key), jnp.asarray(n_grow),
                jnp.asarray(cells.astype(np.int32)), jnp.asarray(free),
                samp, "sortfill_packed_cell", idx_bits=cell_bits,
            )
        )
        for l in range(L):
            valid = key[l] != np.uint32(0xFFFFFFFF)
            n = min(int(n_grow[l]), int(valid.sum()))
            order = np.argsort(key[l], kind="stable")
            chosen = (key[l][order[:n]] & 0xFFFF).astype(np.int32)
            assert int(n_chosen[l]) == n
            got = np.sort(gathered[l][wrote[l]])
            if n <= int(free[l].sum()):
                np.testing.assert_array_equal(got, np.sort(chosen))
            else:
                from collections import Counter

                assert not Counter(got.tolist()) - Counter(
                    chosen.tolist()
                )


def test_parity_wide_active_set_no_truncation():
    """A=160 > the old 128 cap: bit-exact parity with
    auto-scaled winner/growth capacities, zero drop counters, and
    synapse growth reaching high column ids (no low-id bias)."""
    cfg = make_cfg(
        k_active=160, column_dim=800, cell_dim=4,
        segments_per_column=8, synapse_capacity=12,
        segment_sampling_synapses=4,
    )
    assert cfg.resolved_winner_capacity >= 2 * cfg.active_columns
    assert cfg.resolved_growth_capacity >= 2 * cfg.active_columns

    step_fn = jax.jit(
        functools.partial(tm_step, cfg),
        static_argnames=("learning", "compute_winner", "return_debug"),
    )
    state = tm_init(cfg)
    oracle = OracleTM(cfg)
    rng = np.random.RandomState(99)
    key = jax.random.key(99)
    grown_cols = set()
    for t in range(25):
        cols = np.sort(rng.choice(cfg.column_dim, size=cfg.active_columns,
                                  replace=False)).astype(np.int32)
        key, sub = jax.random.split(key)
        state, out, debug = step_fn(
            state, sub, jnp.asarray(cols), learning=True, return_debug=True
        )
        metrics = jax.device_get(out.metrics)
        for name in ("tm_dropped_winner_candidates",
                     "tm_dropped_growth_segments",
                     "tm_dropped_new_segments",
                     "tm_dropped_synapses"):
            assert int(metrics[name]) == 0, (t, name, metrics[name])
        host_debug = jax.device_get(debug)
        decisions = extract_decisions(host_debug)
        oracle.step(cols, decisions, learning=True)
        oracle.compare(jax.device_get(state))
        grown_cols |= set(
            np.nonzero(np.asarray(host_debug.grown_mask).any(axis=(1, 2)))[0]
            .tolist()
        )
    # growth must reach the upper half of the column range: with the old
    # fixed 128-wide candidate list only the lowest winner cell ids ever
    # received synapses
    assert max(grown_cols) > cfg.column_dim // 2, sorted(grown_cols)[-5:]
    assert len(grown_cols) > cfg.active_columns
