"""Time what XLA makes of each hot-path form of the TM step, on the GPU.

    python scripts/xla_forms.py            # GPU required
    python scripts/xla_forms.py --cpu --tiny   # rehearsal at a tiny size

Forms, each vmapped over the stream batch as the step runs it, on a
state trained for ``--train`` learning steps of the reference workload:

  table pass     `table_update_xla` (the learning step's full-table pass)
  conn forward   `synapse_activation_conn` + `seg_counts_packed` (inference)
  serving        `serving_counts` over a `make_serving_table` table
  growth decode  `take_small_table` (one gather) beside the
                 compare-select-reduce form it replaced
  whole step     `htm_scan`, learning on, per step (for scale)

Configurations: 2048 x 32 fast stack (G=4/K=64, int16 SP) at B=256 and
16384 x 64 fast stack at B=64. Each form is one jitted dispatch, timed
with `jax.block_until_ready` after a warm-up call; the median and the
minimum over ``--repeats`` calls are printed in ms per call, beside the
time of an empty dispatch (the fixed cost every call pays).
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def _time(fn, args, repeats):
    import jax

    jax.block_until_ready(fn(*args))
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return float(np.median(times)) * 1e3, float(np.min(times)) * 1e3


def compare_select_take(table, idx):
    """The growth decode as a compare-select-reduce over the table."""
    import jax.numpy as jnp

    return jnp.sum(
        (idx[:, :, None] == jnp.arange(table.shape[0], dtype=jnp.int32))
        * table, axis=-1, dtype=jnp.int32)


def run_config(name, cfg, batch, train, repeats, label):
    import jax
    import jax.numpy as jnp

    from bithtm_tpu import htm_init_batch, htm_scan
    from bithtm_tpu.ops.active_set import (seg_counts_packed,
                                           synapse_activation_conn,
                                           table_update_xla,
                                           take_small_table)
    from bithtm_tpu.ops.serving import make_serving_table, serving_counts
    from chip_smoke import device_inputs

    tm = cfg.tm
    C, D, G, K = (tm.column_dim, tm.cell_dim, tm.segments_per_column,
                  tm.synapse_capacity)
    state = htm_init_batch(jax.random.key(0), cfg, batch)
    seq = device_inputs(0, train + 32, batch, cfg.input_dim)
    t0 = time.perf_counter()
    state, _ = htm_scan(cfg, state, seq[:train], True)
    jax.block_until_ready(state)
    print(f"[{name}] trained {train} steps x {batch} streams in "
          f"{time.perf_counter() - t0:.1f} s (incl. compile)", flush=True)
    s = state.tm
    rows = []

    def report(form, ms):
        med, mn = ms
        rows.append((form, med, mn))
        print(f"[{name}] {form}: median {med:.4f} ms, min {mn:.4f} ms per "
              f"call of {batch} streams on {label}", flush=True)

    report("empty dispatch", _time(jax.jit(lambda x: x + 1),
                                   (jnp.zeros((batch,), jnp.int32),),
                                   repeats))

    def table_pass(syn, perm, act, pun_word, cols, bits, seg_cell):
        return table_update_xla(
            syn, perm, act, pun_word, cols, bits, seg_cell, D,
            tm.permanence_punishment, tm.permanence_threshold,
            tm.segment_matching_threshold, tm.segment_activation_threshold)

    report("table pass (table_update_xla)", _time(
        jax.jit(jax.vmap(table_pass)),
        (s.synapse_cell, s.synapse_perm, s.synapse_act, s.matching_word,
         s.active_cols, s.active_bits, s.seg_cell), repeats))

    def conn_forward(syn, perm, cols, bits):
        act = synapse_activation_conn(syn, perm, cols, bits, D,
                                      tm.permanence_threshold, K)
        return seg_counts_packed(act, G, K)

    report("conn forward (synapse_activation_conn + counts)", _time(
        jax.jit(jax.vmap(conn_forward)),
        (s.synapse_cell, s.synapse_perm, s.active_cols, s.active_bits),
        repeats))

    table = make_serving_table(tm, s)
    serve = jax.jit(jax.vmap(
        lambda t, cols, bits: serving_counts(t, cols, bits, C, D, G)))
    report(f"serving (serving_counts, rows {tuple(table.rows.shape)})",
           _time(serve, (table, s.active_cols, s.active_bits), repeats))

    Wc, L = tm.resolved_winner_capacity, tm.resolved_growth_capacity
    kk = min(tm.segment_sampling_synapses, Wc)
    rng = np.random.RandomState(1)
    cand = jnp.asarray(rng.randint(0, C * D, size=(batch, Wc)), jnp.int32)
    idx = jnp.asarray(rng.randint(0, Wc, size=(batch, L, kk)), jnp.int32)
    report(f"growth decode, gather ({L}x{kk} from {Wc})", _time(
        jax.jit(jax.vmap(take_small_table)), (cand, idx), repeats))
    report(f"growth decode, compare-select-reduce ({L}x{kk} from {Wc})",
           _time(jax.jit(jax.vmap(compare_select_take)), (cand, idx),
                 repeats))

    T = 32
    xs = seq[train:train + T]
    state, _ = htm_scan(cfg, state, xs, True)       # compile for T
    jax.block_until_ready(state)
    times = []
    for _ in range(max(3, repeats // 4)):
        t0 = time.perf_counter()
        state, m = htm_scan(cfg, state, xs, True)
        jax.block_until_ready((state, m))
        times.append(time.perf_counter() - t0)
    med = float(np.median(times)) / T * 1e3
    report(f"whole learning step (htm_scan, T={T})",
           (med, float(np.min(times)) / T * 1e3))
    return rows


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU backend (rehearsal only)")
    p.add_argument("--tiny", action="store_true",
                   help="tiny configurations (rehearsal only)")
    p.add_argument("--repeats", type=int, default=20)
    p.add_argument("--train", type=int, default=64)
    args = p.parse_args(argv)

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    from bithtm_tpu.utils.compile_cache import enable_compilation_cache
    from bithtm_tpu.utils.profiling import require_gpu

    dev = require_gpu(args.cpu)
    from chip_smoke import card_info, fast_config

    enable_compilation_cache()
    label = f"{dev.device_kind} ({card_info()})"
    print(f"device: {label}", flush=True)
    if args.tiny:
        small = dict(active_columns=4, segment_activation_threshold=2,
                     segment_matching_threshold=2,
                     segment_sampling_synapses=8)
        configs = [("tiny 64x4", fast_config(64, 64, 4, **small), 2),
                   ("tiny 128x64", fast_config(128, 128, 64, **small), 2)]
    else:
        configs = [("2048x32 B=256", fast_config(1000, 2048, 32), 256),
                   ("16384x64 B=64", fast_config(1000, 16384, 64), 64)]
    for name, cfg, batch in configs:
        run_config(name, cfg, batch, args.train, args.repeats, label)
    return 0


if __name__ == "__main__":
    sys.exit(main())
