"""The plain XLA forms of the step's hot-path ops against naive NumPy
membership / count references, plus the step-level guarantees they
rest on: exact arithmetic (no float32 dot at default precision, which
a GPU may run in TF32), exact write-backs at large cell ids, and an
import that needs nothing beyond JAX and NumPy."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from bithtm_tpu.ops.active_set import (
    act_scale,
    pack_act_conn,
    pack_bits,
    prediction_dense_host,
    synapse_activation_xla,
    table_update_xla,
    take_small_table,
)
from bithtm_tpu.ops.serving import SERVING_G_BITS, serving_activation_xla

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (A, D): the active-set sizes of the shipped geometries (5: tiny tests,
# 41: 2048 columns, 82: 4096, 328: 16K) with one- and two-word (W=1, 2)
# cell bitmasks
ACTIVE_SETS = [(a, d) for d in (32, 64) for a in (5, 41, 82, 328)]
C = 512


def _active_set(rng, A, D):
    cols = np.sort(rng.choice(C, A, replace=False)).astype(np.int32)
    rows = rng.rand(A, D) < 0.4
    dense = np.zeros((C, D), bool)
    dense[cols] = rows
    return cols, rows, dense.reshape(-1)


def _random_table(rng, D, J, free=0.3, dead=0.1):
    """syn (C, J) targets with free (-1, -1.0) slots and implicitly dead
    (target kept, perm < 0) slots, as the step's tables hold them."""
    N = C * D
    syn = rng.randint(0, N, size=(C, J)).astype(np.int32)
    perm = rng.rand(C, J).astype(np.float32)
    is_free = rng.rand(C, J) < free
    syn[is_free] = -1
    perm[is_free] = -1.0
    perm[~is_free & (rng.rand(C, J) < dead)] = -0.25
    return syn, perm


@pytest.mark.parametrize("A,D", ACTIVE_SETS)
def test_synapse_activation_xla_matches_membership(A, D):
    rng = np.random.RandomState(A * 100 + D)
    cols, rows, dense = _active_set(rng, A, D)
    syn, _ = _random_table(rng, D, 64)
    got = np.asarray(synapse_activation_xla(
        jnp.asarray(syn), jnp.asarray(cols), pack_bits(jnp.asarray(rows)), D))
    expect = (syn >= 0) & dense[np.clip(syn, 0, None)]
    np.testing.assert_array_equal(got, expect)


def _naive_table_update(syn, perm, act_prev, pun_word, dense, seg_cell, D,
                        punishment, thr, m_thr, a_thr):
    G = seg_cell.shape[1]
    J = syn.shape[1]
    K = J // G
    g_of_j = np.arange(J) // K
    pen = (((pun_word[:, None] >> g_of_j) & 1) == 1) & (act_prev != 0)
    perm2 = np.where(pen, perm - np.float32(punishment), perm)
    act = (syn >= 0) & dense[np.clip(syn, 0, None)] & (perm2 >= 0)
    conn = act & (perm2 >= np.float32(thr))
    pot = act.reshape(C, G, K).sum(-1)
    con = conn.reshape(C, G, K).sum(-1)
    matching = pot >= m_thr
    seg_active = matching & (con >= a_thr)
    pred = np.zeros((C, D), bool)
    for c, g in zip(*np.nonzero(seg_active)):
        if seg_cell[c, g] < D:
            pred[c, seg_cell[c, g]] = True
    return perm2, act, conn, pot, con, matching, seg_active, pred


@pytest.mark.parametrize(
    "A,D,K",
    [(a, d, 16) for a, d in ACTIVE_SETS]
    # the packed activity in bf16 (K=126) and float32 (K=128)
    + [(41, 64, 126), (41, 64, 128)],
)
def test_table_update_xla_matches_naive(A, D, K):
    rng = np.random.RandomState(A * 1000 + D * 10 + K)
    G = 4
    J = G * K
    cols, rows, dense = _active_set(rng, A, D)
    syn, perm = _random_table(rng, D, J)
    # low activation / matching thresholds so segments match and fire
    m_thr, a_thr = max(1, K // 64), max(1, K // 48)
    scale = act_scale(K)
    prev = rng.choice([0.0, 1.0, 1.0 + scale], size=(C, J))
    prev[syn < 0] = 0.0
    act_prev = pack_act_conn(jnp.asarray(prev != 0), jnp.asarray(prev > 1),
                             K)
    pun_word = rng.randint(0, 1 << G, size=C).astype(np.int32)
    seg_cell = rng.randint(0, D + 1, size=(C, G)).astype(np.int32)
    out = table_update_xla(
        jnp.asarray(syn), jnp.asarray(perm), act_prev, jnp.asarray(pun_word),
        jnp.asarray(cols), pack_bits(jnp.asarray(rows)),
        jnp.asarray(seg_cell), D, 0.01, 0.5, m_thr, a_thr)
    perm_g, act_g, pot_g, con_g, match_g, segact_g, pred_g = (
        np.asarray(x) for x in out)
    perm_e, act_e, conn_e, pot_e, con_e, match_e, segact_e, pred_e = (
        _naive_table_update(syn, perm, np.asarray(prev), pun_word, dense,
                            seg_cell, D, 0.01, 0.5, m_thr, a_thr))
    assert act_e.any() and segact_e.any(), "reference exercised nothing"
    np.testing.assert_array_equal(perm_g, perm_e)
    v = act_g.astype(np.float32)
    np.testing.assert_array_equal(v != 0, act_e)
    np.testing.assert_array_equal(v > 1, conn_e)
    np.testing.assert_array_equal(pot_g.astype(np.int32), pot_e)
    np.testing.assert_array_equal(con_g.astype(np.int32), con_e)
    np.testing.assert_array_equal(match_g, match_e)
    np.testing.assert_array_equal(segact_g, segact_e)
    np.testing.assert_array_equal(prediction_dense_host(pred_g, D), pred_e)


@pytest.mark.parametrize("A,D", ACTIVE_SETS)
def test_serving_activation_xla_matches_naive(A, D):
    rng = np.random.RandomState(A * 7 + D)
    cols, rows, dense = _active_set(rng, A, D)
    R = 64
    cell = rng.randint(0, C * D, size=(R, 128)).astype(np.int32)
    g = rng.randint(0, 1 << SERVING_G_BITS, size=(R, 128)).astype(np.int32)
    # about a third of the slots active, the rest inactive or empty
    hit = rng.rand(R, 128) < 0.3
    act_cells = np.nonzero(dense)[0]
    cell[hit] = rng.choice(act_cells, size=int(hit.sum()))
    words = (cell << SERVING_G_BITS) | g
    words[rng.rand(R, 128) < 0.2] = -1
    got = np.asarray(serving_activation_xla(
        jnp.asarray(words), jnp.asarray(cols), pack_bits(jnp.asarray(rows)),
        D))
    live = words >= 0
    expect = np.where(live & dense[np.where(live, cell, 0)], g + 1, 0)
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, expect)


def test_take_small_table_is_a_gather():
    rng = np.random.RandomState(0)
    table = rng.randint(0, 1 << 20, size=768).astype(np.int32)
    idx = rng.randint(0, 768, size=(82, 32)).astype(np.int32)
    got = np.asarray(take_small_table(jnp.asarray(table), jnp.asarray(idx)))
    np.testing.assert_array_equal(got, table[idx])
    # out-of-range indices (the sentinel rows) clamp; callers mask them
    idx[0, :3] = [768, 1023, -1]
    got = np.asarray(take_small_table(jnp.asarray(table), jnp.asarray(idx)))
    np.testing.assert_array_equal(got[0, :3], table[[767, 767, 0]])
    jaxpr = jax.make_jaxpr(take_small_table)(jnp.asarray(table),
                                             jnp.asarray(idx))
    prims = _primitives(jaxpr.jaxpr, set())
    assert "gather" in prims and "reduce_sum" not in prims, prims


def _primitives(jaxpr, out):
    for eqn in jaxpr.eqns:
        out.add(eqn.primitive.name)
        for sub in jax.core.jaxprs_in_params(eqn.params):
            _primitives(sub, out)
    return out


def _dot_precisions(jaxpr, out):
    """(operand dtypes, precision) of every dot_general, sub-jaxprs
    (scan bodies, pjit, cond branches) included."""
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            out.append(([v.aval.dtype for v in eqn.invars],
                        eqn.params.get("precision")))
        for sub in jax.core.jaxprs_in_params(eqn.params):
            _dot_precisions(sub, out)
    return out


def _tiny_cfg(K):
    from bithtm_tpu import make_htm_config

    return make_htm_config(64, 64, 4, active_columns=4,
                           segments_per_column=4, synapse_capacity=K,
                           segment_activation_threshold=2,
                           segment_matching_threshold=2,
                           segment_sampling_synapses=8)


@pytest.mark.parametrize("mode", ["learning", "inference", "serving"])
def test_no_float32_dot_at_default_precision_on_the_step(mode):
    """Every float32 dot_general the step traces states HIGHEST
    precision; K=128 makes the packed activity float32, so the count
    dot is a float32 dot and the check is not vacuous."""
    from bithtm_tpu import htm_init, htm_step
    from bithtm_tpu.ops.serving import make_serving_table

    found = []
    for K in (16, 126, 128):
        cfg = _tiny_cfg(K)
        state = htm_init(jax.random.key(0), cfg)
        x = jnp.zeros((cfg.input_dim,), jnp.bool_)
        if mode == "serving":
            tab = make_serving_table(cfg.tm, state.tm)
            fn = lambda s, x, t: htm_step(  # noqa: E731
                cfg, s, x, False, False, detailed_metrics=False,
                serving_table=t)
            jaxpr = jax.make_jaxpr(fn)(state, x, tab)
        else:
            learning = mode == "learning"
            jaxpr = jax.make_jaxpr(
                lambda s, x: htm_step(cfg, s, x, learning))(state, x)
        found += _dot_precisions(jaxpr.jaxpr, [])
    f32 = [(d, p) for d, p in found if jnp.float32 in d]
    for dtypes, precision in f32:
        assert precision is not None and all(
            q == jax.lax.Precision.HIGHEST for q in precision
        ), (dtypes, precision)
    if mode != "serving":
        assert f32, "the float32 packed-count dot was not traced"


def test_readout_dot_is_exact_precision():
    from bithtm_tpu.readout import classifier_init, classifier_predict

    st = classifier_init(16, 4)
    jaxpr = jax.make_jaxpr(classifier_predict)(st, jnp.ones(16, bool))
    dots = _dot_precisions(jaxpr.jaxpr, [])
    assert dots and all(p is not None and all(
        q == jax.lax.Precision.HIGHEST for q in p) for _, p in dots)


def test_seg_cell_write_back_exact_at_high_cell_ids():
    """At 16384 columns x 64 cells, global cell ids reach 2^20. Learning
    steps confined to the top columns write segment owners and synapse
    targets at ids >= 2^20 - 64*8; every step matches the oracle
    bit-exactly and the owners decode to ids past 2^20 - 512."""
    from bithtm_tpu import TMConfig, tm_init
    from bithtm_tpu.models.temporal_memory import tm_step
    from bithtm_tpu.oracle.bami import OracleTM
    from bithtm_tpu.oracle.transplant import extract_decisions

    cfg = TMConfig(column_dim=16384, cell_dim=64, active_columns=4,
                   segments_per_column=2, synapse_capacity=8,
                   segment_activation_threshold=2,
                   segment_matching_threshold=2,
                   segment_sampling_synapses=4)
    step = jax.jit(lambda s, k, c: tm_step(cfg, s, k, c, learning=True,
                                           return_debug=True))
    state = tm_init(cfg)
    oracle = OracleTM(cfg)
    rng = np.random.RandomState(0)
    top = np.arange(16384 - 8, 16384)
    key = jax.random.key(0)
    for _ in range(8):
        cols = np.sort(rng.choice(top, 4, replace=False)).astype(np.int32)
        key, sub = jax.random.split(key)
        state, _, dbg = step(state, sub, jnp.asarray(cols))
        oracle.step(cols, extract_decisions(jax.device_get(dbg)))
        oracle.compare(jax.device_get(state))
    seg = np.asarray(state.seg_cell)
    c, g = np.nonzero(seg < cfg.cell_dim)
    owners = c * cfg.cell_dim + seg[c, g]
    assert len(owners) and owners.min() >= (16384 - 8) * 64
    assert np.asarray(state.synapse_cell).max() >= (1 << 20) - 512


def test_import_and_step_without_flax():
    """The package needs nothing beyond JAX and NumPy: with flax made
    unimportable, it imports and takes a learning step."""
    code = f"""
import sys
sys.path.insert(0, {REPO!r})

class _Block:
    def find_spec(self, name, path=None, target=None):
        if name == "flax" or name.startswith("flax."):
            raise ImportError("flax is blocked")

sys.meta_path.insert(0, _Block())
import jax, jax.numpy as jnp
import bithtm_tpu
from bithtm_tpu import htm_init, htm_step, make_htm_config
cfg = make_htm_config(64, 64, 4, active_columns=4,
                      segment_activation_threshold=2,
                      segment_matching_threshold=2,
                      segment_sampling_synapses=8)
s = htm_init(jax.random.key(0), cfg)
s, out = htm_step(cfg, s, jnp.ones((64,), bool))
s = s.replace(key=s.key)
assert "flax" not in sys.modules
print(int(out.metrics["bursting"]), int(s.tm.step))
"""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.split() == ["4", "1"], r.stdout
