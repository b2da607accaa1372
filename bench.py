"""Throughput benchmark: aggregate HTM timesteps/sec, batched streams.

Reproduces the reference driver's measurement semantics (`example.py:46-67`:
wall-clock over the full learning loop at the default 2048-column x
32-cell config) but batched over independent streams (SURVEY.md §6
north star).

Runs on the GPU; with no GPU it exits nonzero unless ``--cpu`` asks for
the CPU backend. Each timed repeat ends in `jax.block_until_ready`.

Baseline: the reference's vectorized NumPy implementation sustains
~48 timesteps/s warm on the survey container CPU (BASELINE.md).

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline",
"device"}.
"""

import argparse
import json
import os
import sys
import time

import numpy as np


BASELINE_STEPS_PER_SEC = 48.0  # reference NumPy, warm, single stream


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--batch", type=int, default=int(os.environ.get("BENCH_BATCH", 256)))
    p.add_argument("--steps", type=int,
                   default=int(os.environ.get("BENCH_STEPS", 384)),
                   help="scan length per timed dispatch")
    p.add_argument("--repeats", type=int, default=5)
    p.add_argument("--input_dim", type=int, default=1000)
    p.add_argument("--column_dim", type=int, default=2048)
    p.add_argument("--cell_dim", type=int, default=32)
    p.add_argument("--input_patterns", type=int, default=100)
    p.add_argument("--input_density", type=float, default=0.2)
    p.add_argument("--mode", choices=("htm", "sp", "tm"), default="htm",
                   help="htm: full pipeline (the headline metric); "
                        "sp: SpatialPooler only (BASELINE configs[1]); "
                        "tm: TemporalMemory learning only (configs[2])")
    p.add_argument("--stack", choices=("fast", "reference"), default="fast",
                   help="fast (default): the validated throughput stack — "
                        "G=4 segment slots/column, K=64 synapse slots, "
                        "int16 SP permanences. Bit-exact against the BAMI "
                        "oracle (example.py --oracle, chip_smoke.py); "
                        "2000-step soak on the reference workload converges "
                        "to 0.16 bursting / 40.8 of 41 correct with ~1% "
                        "benign segment-cap drops (scripts/soak_fast_stack"
                        ".py, docs/QUALITY.md). reference: the "
                        "reference's G=8/K=48 head-room pool with f32 SP "
                        "permanences.")
    p.add_argument("--inference", action="store_true",
                   help="learning=False (frozen graph), winner selection "
                        "still on (the reference's return_winner_cell "
                        "default)")
    p.add_argument("--serve", action="store_true",
                   help="the production serving path: htm_serve_scan over a "
                        "compact serving table (connected synapses only, "
                        "per-column packed — ops/serving.py) built from a "
                        "graph trained for --serve_warmup steps (packing an "
                        "EMPTY graph would flatter the number). Predictions "
                        "bit-identical to the unpacked inference scan.")
    p.add_argument("--serve_unpacked", action="store_true",
                   help="with --serve: skip the compact table and serve the "
                        "full pool (the pre-round-4 serving path; the "
                        "ablation baseline for the packed win)")
    p.add_argument("--serve_warmup", type=int, default=256,
                   help="learning steps used to populate the graph before "
                        "--serve freezes and packs it (untimed)")
    p.add_argument("--detailed_metrics", action="store_true",
                   help="include the full-table occupancy metrics "
                        "(tm_pool_occupancy etc.) in every step; off by "
                        "default — the serving loop keeps the driver "
                        "observables and drop counters only")
    p.add_argument("--winner_capacity", type=int, default=0,
                   help="growth-candidate list width Wc (0 = auto); "
                        "tuned caps belong in htm_scan_autocap in "
                        "production, which widens drop-free")
    p.add_argument("--growth_capacity", type=int, default=0,
                   help="growing-segment list width L (0 = auto)")
    p.add_argument("--allocation_policy", default="evict",
                   choices=("reference", "evict"),
                   help="segment-pool allocation under pressure: "
                        "'reference' (recycle-or-drop, surfaced by "
                        "counters) or 'evict' (also evict the weakest "
                        "mature slot — the analogue of the reference's "
                        "unbounded growth; see docs/QUALITY.md)")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU backend (otherwise a GPU is "
                        "required)")
    args = p.parse_args()

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from bithtm_tpu.utils.profiling import require_gpu

    dev = require_gpu(args.cpu)
    device = {"platform": dev.platform, "kind": dev.device_kind,
              "count": len(jax.devices())}

    from bithtm_tpu.utils.compile_cache import enable_compilation_cache

    print(f"# compilation cache: {enable_compilation_cache()}",
          file=sys.stderr)

    from bithtm_tpu import htm_init_batch, htm_scan, make_htm_config

    print(f"# devices: {jax.devices()}", file=sys.stderr)
    stack_overrides = (
        dict(segments_per_column=4, synapse_capacity=64,
             sp_overrides={"permanence_dtype": "int16"})
        if args.stack == "fast" else {}
    )
    cfg = make_htm_config(
        input_dim=args.input_dim,
        column_dim=args.column_dim,
        cell_dim=args.cell_dim,
        allocation_policy=args.allocation_policy,
        winner_capacity=args.winner_capacity,
        growth_capacity=args.growth_capacity,
        **stack_overrides,
    )
    print(f"# stack: {args.stack}", file=sys.stderr)
    B, T = args.batch, args.steps

    rng = np.random.RandomState(0)
    patterns = rng.rand(args.input_patterns, B, args.input_dim) < args.input_density
    # per-step noisy inputs from a repeating pattern sequence (example.py:34,52)
    idx = np.arange(T) % args.input_patterns
    noise = rng.rand(T, B, args.input_dim) < 0.05
    seq = jnp.asarray(patterns[idx] ^ noise)

    state = htm_init_batch(jax.random.key(0), cfg, B)

    if args.serve and args.mode != "htm":
        p.error("--serve is the full-pipeline serving path; it has no "
                "--mode sp/tm form (use --inference for those)")
    learn = not (args.inference or args.serve)
    suffix = ("serving" if args.serve
              else "learning" if learn else "inference")
    shape = f"{args.column_dim}x{args.cell_dim}"
    if args.mode == "htm":
        if args.serve:
            from bithtm_tpu import htm_scan as _train_scan, htm_serve_scan

            # populate the graph before freezing: serving an empty pool
            # measures nothing real. Untimed (compile + warmup both
            # excluded by the warmup run below).
            warm = jnp.asarray(
                patterns[np.arange(args.serve_warmup) % args.input_patterns]
                ^ (rng.rand(args.serve_warmup, B, args.input_dim) < 0.05)
            )
            state, _ = _train_scan(cfg, state, warm, True)
            table = None
            if not args.serve_unpacked:
                from bithtm_tpu.ops.serving import make_serving_table

                table = make_serving_table(cfg.tm, state.tm)
                rshape = tuple(table.rows.shape)
                print(f"# serving table: rows {rshape}, ext "
                      f"{tuple(table.ext_col.shape)} (full pool: "
                      f"{(B, args.column_dim, cfg.tm.segments_per_column * cfg.tm.synapse_capacity)})",
                      file=sys.stderr)

            run = lambda st: htm_serve_scan(
                cfg, st, seq, detailed_metrics=args.detailed_metrics,
                serving_table=table)
        else:
            run = lambda st: htm_scan(
                cfg, st, seq, learn,
                detailed_metrics=args.detailed_metrics)
        metric = f"aggregate_timesteps_per_sec_{shape}_{suffix}"
    elif args.mode == "sp":
        # SpatialPooler only: overlap matmul + boosting + top-k + Hebbian
        # update, scanned over the sequence (BASELINE configs[1]).
        import functools

        from bithtm_tpu.models.spatial_pooler import sp_step

        @functools.partial(jax.jit, donate_argnums=(0,))
        def run(st):
            def body(carry, x):
                new, out = jax.vmap(
                    lambda s, xx: sp_step(cfg.sp, s, xx, learn)
                )(carry, x)
                return new, out.boosted_overlaps.sum(-1)
            sp_final, boosted = jax.lax.scan(body, st.sp, seq)
            return st.replace(sp=sp_final), {"anomaly": boosted}
        metric = f"sp_only_timesteps_per_sec_{shape}_{suffix}"
    else:
        # TemporalMemory full learning driven by fixed column sequences
        # (BASELINE configs[2]); SP is bypassed with random top-k sets.
        import functools

        from bithtm_tpu.models.temporal_memory import tm_step

        A = cfg.sp.active_columns
        col_seq = jnp.asarray(np.stack([
            np.stack([np.sort(rng.choice(args.column_dim, A, replace=False))
                      for _ in range(B)])
            for _ in range(T)
        ]).astype(np.int32))

        @functools.partial(jax.jit, donate_argnums=(0,))
        def run(st):
            def body(carry, cols):
                tm, key = carry  # key: (B,) per-stream keys
                split = jax.vmap(lambda k: jax.random.split(k, 2))(key)
                key, subs = split[:, 0], split[:, 1]
                new_tm, out = jax.vmap(
                    lambda t, k, c: tm_step(cfg.tm, t, k, c, learning=learn)
                )(tm, subs, cols)
                return (new_tm, key), out.metrics["tm_bursting_columns"]
            (tm_final, key), burst = jax.lax.scan(
                body, (st.tm, st.key), col_seq
            )
            return st.replace(tm=tm_final, key=key), {
                "anomaly": burst.astype(jnp.float32)
            }
        metric = f"tm_only_timesteps_per_sec_{shape}_{suffix}"

    def one_run(st):
        new_st, mets = run(st)
        jax.block_until_ready((new_st, mets))
        return new_st, mets

    t0 = time.perf_counter()
    state, metrics = one_run(state)
    warm_s = time.perf_counter() - t0
    print(f"# warmup (compile + {T} steps): {warm_s:.1f}s",
          file=sys.stderr, flush=True)

    times = []
    for _ in range(args.repeats):
        t0 = time.perf_counter()
        state, metrics = one_run(state)
        times.append(time.perf_counter() - t0)
    best = min(times)
    agg = B * T / best
    print(
        f"# best of {len(times)}: {best:.3f}s for {T} steps x {B} streams"
        f" = {agg:,.0f} steps/s ({best / T * 1e3:.2f} ms/step) on "
        f"{device['kind']}",
        file=sys.stderr, flush=True,
    )
    if args.mode == "htm":
        print(
            f"# bursting[last-step] mean: "
            f"{np.asarray(metrics['bursting'][-1]).mean():.1f}",
            file=sys.stderr,
        )
    print(json.dumps({
        "metric": metric,
        "value": round(agg, 1),
        "unit": "timesteps/s",
        "vs_baseline": round(agg / BASELINE_STEPS_PER_SEC, 1),
        "device": device,
    }), flush=True)


if __name__ == "__main__":
    main()
