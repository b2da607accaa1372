"""Unit tests for the compact active-set ops (`bithtm_tpu/ops/active_set`)
— the scatter/gather-free primitives that replace the reference's
ragged-index kernels (`utils.py:13-76`) and push/pull projection modes
(`projections.py:163-178`) — against direct NumPy models."""

import jax.numpy as jnp
import numpy as np

from bithtm_tpu.ops.active_set import (
    argmax_onehot,
    column_mask_from_cols,
    dense_from_compact,
    pack_bits,
    percell_max,
    percell_sum,
    rank_ascending,
    synapse_activation_xla,
    take_percell,
    unpack_bits,
)


def test_pack_unpack_roundtrip():
    rng = np.random.RandomState(0)
    for D in (4, 32, 40, 64):
        mask = rng.rand(5, D) < 0.4
        bits = pack_bits(jnp.asarray(mask))
        assert bits.shape == (5, (D + 31) // 32)
        back = np.asarray(unpack_bits(bits, D))
        np.testing.assert_array_equal(back, mask)


def test_dense_from_compact():
    cols = jnp.asarray([3, 0], jnp.int32)
    rows = jnp.asarray([[1, 0, 1, 0], [0, 1, 0, 0]], bool)
    dense = np.asarray(
        dense_from_compact(cols, pack_bits(rows), 6, 4)
    )
    expect = np.zeros((6, 4), bool)
    expect[3] = [1, 0, 1, 0]
    expect[0] = [0, 1, 0, 0]
    np.testing.assert_array_equal(dense, expect)


def test_column_mask_from_cols():
    m = np.asarray(column_mask_from_cols(jnp.asarray([1, 4], jnp.int32), 6))
    np.testing.assert_array_equal(m, [0, 1, 0, 0, 1, 0])


def test_synapse_activation_matches_dense_gather():
    rng = np.random.RandomState(1)
    C, D, A = 16, 4, 3
    for D in (4, 40):  # single- and multi-word bitmask paths
        N = C * D
        # random active set over A columns
        cols = np.sort(rng.choice(C, A, replace=False)).astype(np.int32)
        rows = rng.rand(A, D) < 0.5
        dense = np.zeros((C, D), bool)
        dense[cols] = rows
        syn = rng.randint(-1, N, size=(7, 11)).astype(np.int32)
        got = np.asarray(
            synapse_activation_xla(
                jnp.asarray(syn), jnp.asarray(cols),
                pack_bits(jnp.asarray(rows)), D,
            )
        )
        flat = dense.reshape(-1)
        expect = np.where(syn >= 0, flat[np.clip(syn, 0, N - 1)], False)
        np.testing.assert_array_equal(got, expect)


def test_percell_reductions():
    # 2 columns, G=4 slots, D=3 cells
    seg_cell = jnp.asarray([[0, 2, 0, 3], [1, 3, 3, 3]], jnp.int32)  # 3=unalloc
    vals = jnp.asarray([[1.0, 5.0, 2.0, 9.0], [4.0, 9.0, 9.0, 9.0]])
    mx = np.asarray(percell_max(seg_cell, vals, 3, 0.0))
    np.testing.assert_array_equal(mx, [[2.0, 0.0, 5.0], [0.0, 4.0, 0.0]])
    sm = np.asarray(percell_sum(seg_cell, jnp.ones_like(vals), 3))
    np.testing.assert_array_equal(sm, [[2, 0, 1], [0, 1, 0]])


def test_take_percell():
    values = jnp.asarray([[1.0, 2.0, 3.0]])
    seg_cell = jnp.asarray([[2, 0, 3, 1]], jnp.int32)  # 3 = sentinel
    got = np.asarray(take_percell(values, seg_cell, 3, -7.0))
    np.testing.assert_array_equal(got, [[3.0, 1.0, -7.0, 2.0]])


def test_rank_ascending():
    m = jnp.asarray([[1, 0, 1, 1], [0, 0, 0, 1]], bool)
    r = np.asarray(rank_ascending(m))
    assert r[0, 0] == 0 and r[0, 2] == 1 and r[0, 3] == 2
    assert r[1, 3] == 0


def test_argmax_onehot_exactly_one():
    v = jnp.asarray([[3.0, 7.0, 7.0], [1.0, 0.0, -2.0]])
    oh = np.asarray(argmax_onehot(v))
    assert oh.sum(axis=1).tolist() == [1, 1]
    assert oh[0, 1] and oh[1, 0]  # ties -> lowest index (jnp.argmax)


def test_seg_reduce_counts_dtypes():
    """bf16-output counts must stay exact (counts are integers <= K) and
    auto-widen to f32 when K > 256 would break bf16 integer exactness."""
    from bithtm_tpu.ops.active_set import seg_reduce_counts

    rng = np.random.RandomState(3)
    C, G, K = 8, 4, 48
    mask = (rng.rand(C, G * K) < 0.5)
    expect = mask.reshape(C, G, K).sum(-1).astype(np.int32)
    for in_dtype in (jnp.bool_, jnp.bfloat16):
        x = jnp.asarray(mask).astype(in_dtype)
        got_i32 = seg_reduce_counts(x, G, K)
        assert got_i32.dtype == jnp.int32
        np.testing.assert_array_equal(np.asarray(got_i32), expect)
        got_bf16 = seg_reduce_counts(x, G, K, out_dtype=jnp.bfloat16)
        assert got_bf16.dtype == jnp.bfloat16
        np.testing.assert_array_equal(
            np.asarray(got_bf16, dtype=np.int32), expect
        )

    # K > 256: the bf16 request silently widens to f32 (still exact)
    K2 = 300
    mask2 = np.ones((4, 2 * K2), bool)  # counts = 300 > bf16 integer range
    got = seg_reduce_counts(jnp.asarray(mask2), 2, K2,
                            out_dtype=jnp.bfloat16)
    assert got.dtype == jnp.float32
    np.testing.assert_array_equal(
        np.asarray(got, dtype=np.int32), np.full((4, 2), K2, np.int32)
    )


def test_packed_activity_counts_exact():
    """The packed activity encoding (v = act + scale*conn,
    `act_scale`) must decode to exact per-segment (potential, connected)
    counts via `seg_counts_packed`, across the dtype boundaries: u8
    while 1+scale fits int8 (K <= 125 — incl. K=64's non-power-of-two
    scale 65), bf16 for K <= 127, f32 above. Worst case exercised:
    every slot active AND connected (counts == K, r == K*(1+scale))."""
    from bithtm_tpu.ops.active_set import (
        act_dtype,
        act_scale,
        pack_act_conn,
        seg_counts_packed,
    )

    rng = np.random.RandomState(7)
    for K, want_dtype in ((48, jnp.uint8), (64, jnp.uint8),
                          (125, jnp.uint8),
                          (126, jnp.bfloat16), (127, jnp.bfloat16),
                          (128, jnp.float32)):
        scale = act_scale(K)
        assert scale > K
        if want_dtype == jnp.uint8:
            assert 1 + scale <= 127
        else:
            assert (scale & (scale - 1)) == 0
        assert act_dtype(K) == want_dtype
        C, G = 8, 4
        act = rng.rand(C, G * K) < 0.5
        conn = act & (rng.rand(C, G * K) < 0.5)
        # include the all-on worst case on one row
        act[0], conn[0] = True, True
        v = pack_act_conn(jnp.asarray(act), jnp.asarray(conn), K)
        assert v.dtype == want_dtype
        # the packed value is exactly decodable entry-wise
        vf = np.asarray(v, np.float32)
        np.testing.assert_array_equal(vf != 0, act)
        np.testing.assert_array_equal(vf > 1, conn)
        pot, connc = seg_counts_packed(v, G, K)
        np.testing.assert_array_equal(
            np.asarray(pot, np.int32),
            act.reshape(C, G, K).sum(-1).astype(np.int32),
        )
        np.testing.assert_array_equal(
            np.asarray(connc, np.int32),
            conn.reshape(C, G, K).sum(-1).astype(np.int32),
        )


def test_prediction_words_matches_or_chain():
    """The lax.reduce OR over the G axis must equal the per-g OR chain."""
    from bithtm_tpu.ops.active_set import prediction_words

    rng = np.random.RandomState(4)
    for D in (4, 32, 40, 64):
        C, G = 12, 5
        seg_cell = rng.randint(0, D + 1, size=(C, G)).astype(np.int32)
        seg_active = (rng.rand(C, G) < 0.5) & (seg_cell < D)
        words = np.asarray(
            prediction_words(jnp.asarray(seg_cell),
                             jnp.asarray(seg_active), D)
        )
        W = (D + 31) // 32
        expect = np.zeros((W, C), np.uint32)
        for c in range(C):
            for g in range(G):
                if seg_active[c, g]:
                    cell = seg_cell[c, g]
                    expect[cell // 32, c] |= np.uint32(1) << (cell % 32)
        np.testing.assert_array_equal(words, expect)
