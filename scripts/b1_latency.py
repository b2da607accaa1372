"""Single-stream (B=1) step-latency study.

The reference runs exactly one stream (`example.py:48-53` in the
reference); at B=1 the per-step fixed costs (loop bookkeeping, launches,
metric stacking) can dominate the device compute. This script measures,
on the current backend:

  * learning htm_scan at B=1 (unbatched state, [T, I] inputs) across
    scan-unroll factors, detailed_metrics on/off;
  * a no-ys ablation (scan body returns None instead of the per-step
    metrics dict) to price the [T]-stacking of the ~15 metric scalars;
  * serving (htm_serve_scan, winner pass off) unpacked and with the
    compact serving table, same sweeps.

Timing: per-step = best-of-``--repeats`` wall time of one T-step
dispatch / T, each dispatch ended by `jax.block_until_ready`.

Run: python scripts/b1_latency.py [--steps 2048 --repeats 5]
"""

import argparse
import functools
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--steps", type=int, default=2048)
    p.add_argument("--repeats", type=int, default=5)
    p.add_argument("--input_dim", type=int, default=1000)
    p.add_argument("--column_dim", type=int, default=2048)
    p.add_argument("--cell_dim", type=int, default=32)
    p.add_argument("--unrolls", type=str, default="4,8,16")
    p.add_argument("--serve_warmup", type=int, default=256)
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU backend")
    args = p.parse_args()

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from bithtm_tpu.utils.profiling import require_gpu

    require_gpu(args.cpu)

    from bithtm_tpu import (htm_init, htm_scan, htm_serve_scan,
                            make_htm_config)
    from bithtm_tpu.models.htm import htm_step

    cfg = make_htm_config(
        input_dim=args.input_dim, column_dim=args.column_dim,
        cell_dim=args.cell_dim, segments_per_column=4, synapse_capacity=64,
        sp_overrides={"permanence_dtype": "int16"},
    )
    print(f"# backend: {jax.default_backend()} devices={jax.devices()}",
          file=sys.stderr)

    T = args.steps
    rng = np.random.RandomState(0)
    patterns = rng.rand(100, args.input_dim) < 0.2
    idx = np.arange(T) % 100
    seq = jnp.asarray(patterns[idx]
                      ^ (rng.rand(T, args.input_dim) < 0.05))

    def timed(run, st, label):
        t0 = time.perf_counter()
        st2, metrics = run(st)
        jax.block_until_ready((st2, metrics))
        compile_s = time.perf_counter() - t0
        times = []
        for _r in range(args.repeats):
            t0 = time.perf_counter()
            st2, metrics = run(st2)
            jax.block_until_ready((st2, metrics))
            times.append(time.perf_counter() - t0)
        best = min(times)
        med = sorted(times)[len(times) // 2]
        print(f"{label}: best {best / T * 1e3:.3f} ms/step (median "
              f"{med / T * 1e3:.3f}, {T / best:,.0f} steps/s; "
              f"compile+first {compile_s:.1f}s) on "
              f"{jax.devices()[0].device_kind}")
        return st2

    unrolls = [int(u) for u in args.unrolls.split(",") if u]

    # -- learning sweeps ---------------------------------------------
    for unroll in unrolls:
        for dm in (False, True):
            run = lambda st: htm_scan(cfg, st, seq, True, unroll, True, dm)
            timed(run, htm_init(jax.random.key(0), cfg),
                  f"learning B=1 unroll={unroll} detailed_metrics={dm}")

    # -- no-ys ablation: what the metric stacking costs --------------
    @functools.partial(jax.jit, static_argnums=(2,), donate_argnums=(0,))
    def scan_noys(st, xs, unroll):
        def body(c, x):
            s, _o = htm_step(cfg, c, x, True, True,
                             detailed_metrics=False)
            return s, None
        final, _ = jax.lax.scan(body, st, xs, unroll=unroll)
        return final, None

    for unroll in unrolls:
        run = lambda st: scan_noys(st, seq, unroll)
        timed(run, htm_init(jax.random.key(0), cfg),
              f"learning B=1 unroll={unroll} NO-YS (no metric stacking)")

    # -- serving -----------------------------------------------------
    warm_seq = jnp.asarray(
        patterns[np.arange(args.serve_warmup) % 100]
        ^ (rng.rand(args.serve_warmup, args.input_dim) < 0.05)
    )
    state0, _ = htm_scan(cfg, htm_init(jax.random.key(0), cfg),
                         warm_seq, True)
    from bithtm_tpu.ops.serving import make_serving_table
    table = make_serving_table(cfg.tm, state0.tm)

    for unroll in unrolls:
        run = lambda st: htm_serve_scan(cfg, st, seq, unroll, False, False)
        state0 = timed(run, state0,
                       f"serving B=1 unpacked unroll={unroll}")
        run = lambda st: htm_serve_scan(cfg, st, seq, unroll, False, False,
                                        serving_table=table)
        state0 = timed(run, state0,
                       f"serving B=1 packed unroll={unroll}")


if __name__ == "__main__":
    main()
