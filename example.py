"""CLI driver mirroring the reference benchmark loop (`example.py:15-67`):
random bool patterns, per-step XOR noise, per-step bursting / correct /
incorrect column metrics, total wall-clock. Adds extras the reference
lacks: --batch (vmapped independent streams), --scan (whole epochs as
one lax.scan), --oracle (NumPy oracle TM for comparison), --checkpoint
(save/resume).

Runs on the GPU; with no GPU it exits nonzero unless --cpu asks for the
CPU backend. The persistent compilation cache is on
(`bithtm_tpu.utils.compile_cache`).
"""

import argparse
import time

import numpy as np


def run_oracle_checked(args, cfg, inputs):
    """Single-stream run with the BAMI oracle in lockstep: every step,
    the oracle adopts the JAX step's RNG decisions, validates them
    against the legal candidate sets, re-derives the consequences, and
    the whole TM state (cell sets, segment sets, synapse tables incl.
    permanences) is compared bit-exactly."""
    import functools

    import jax
    import jax.numpy as jnp

    from bithtm_tpu import htm_init
    from bithtm_tpu.models.spatial_pooler import sp_step
    from bithtm_tpu.models.temporal_memory import tm_step
    from bithtm_tpu.oracle.bami import OracleTM
    from bithtm_tpu.oracle.transplant import extract_decisions

    sp_fn = jax.jit(functools.partial(sp_step, cfg.sp), static_argnums=(2,))
    tm_fn = jax.jit(
        functools.partial(tm_step, cfg.tm),
        static_argnames=("learning", "return_debug"),
    )
    state = htm_init(jax.random.key(args.seed), cfg)
    sp_state, tm_state, key = state.sp, state.tm, state.key
    oracle = OracleTM(cfg.tm)
    rng = np.random.RandomState(args.seed)
    start = time.time()
    steps = 0
    for epoch in range(args.epochs):
        for i, pattern in enumerate(inputs):
            noisy = pattern ^ (
                rng.rand(args.input_dim) < args.input_noise_probability
            )
            key, sub = jax.random.split(key)
            sp_state, sp_out = sp_fn(sp_state, jnp.asarray(noisy), True)
            tm_state, tm_out, debug = tm_fn(
                tm_state, sub, sp_out.active_columns,
                learning=True, return_debug=True,
            )
            oracle.step(
                np.asarray(jax.device_get(sp_out.active_columns)),
                extract_decisions(jax.device_get(debug)),
                learning=True,
            )
            oracle.compare(jax.device_get(tm_state))
            steps += 1
            if not args.quiet:
                m = tm_out.metrics
                print(
                    f"epoch {epoch}, pattern {i}: parity OK — bursting "
                    f"{int(m['tm_bursting_columns'])}, predicted cells "
                    f"{int(m['tm_predicted_cells'])}"
                )
    print(
        f"{time.time() - start:.1f} seconds: {steps} steps, every step "
        f"verified bit-exact against the BAMI oracle."
    )


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("--input_patterns", type=int, default=100)
    p.add_argument("--input_dim", type=int, default=1000)
    p.add_argument("--input_density", type=float, default=0.2)
    p.add_argument("--input_noise_probability", type=float, default=0.05)
    p.add_argument("--column_dim", type=int, default=2048)
    p.add_argument("--cell_dim", type=int, default=32)
    p.add_argument("--active_columns", type=int, default=None,
                   help="default: round(0.02 * column_dim)")
    p.add_argument("--activation_threshold", type=int, default=15)
    p.add_argument("--matching_threshold", type=int, default=15)
    p.add_argument("--sampling_synapses", type=int, default=32)
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--scan", action="store_true",
                   help="run each epoch as one lax.scan")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU backend (otherwise a GPU is "
                        "required)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--checkpoint", type=str, default=None,
                   help="directory to save final state / resume from")
    p.add_argument("--oracle", action="store_true",
                   help="run the NumPy BAMI oracle TM in lockstep and "
                        "verify the full state bit-exactly every step "
                        "(the reference's --use_reference_implementation, "
                        "upgraded to a continuous differential check; "
                        "single stream, no --scan)")
    p.add_argument("--allocation_policy", default="evict",
                   choices=("reference", "evict"),
                   help="segment-pool overflow behavior (see README "
                        "'Pool capacity semantics')")
    p.add_argument("--log", type=str, default=None,
                   help="append per-step metrics to this JSONL file")
    p.add_argument("--quiet", action="store_true")
    args = p.parse_args()

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    from bithtm_tpu.utils.compile_cache import enable_compilation_cache
    from bithtm_tpu.utils.profiling import require_gpu

    require_gpu(args.cpu)

    enable_compilation_cache()
    import functools

    import jax.numpy as jnp

    from bithtm_tpu import (
        htm_init,
        htm_init_batch,
        htm_scan,
        htm_step,
        htm_step_batch,
        make_htm_config,
    )

    cfg = make_htm_config(
        args.input_dim, args.column_dim, args.cell_dim,
        args.active_columns,
        segment_activation_threshold=args.activation_threshold,
        segment_matching_threshold=args.matching_threshold,
        segment_sampling_synapses=args.sampling_synapses,
        allocation_policy=args.allocation_policy,
    )
    rng = np.random.RandomState(args.seed)
    inputs = rng.rand(args.input_patterns, args.input_dim) < args.input_density

    if args.oracle:
        run_oracle_checked(args, cfg, inputs)
        return

    batched = args.batch > 1
    if batched:
        state = htm_init_batch(jax.random.key(args.seed), cfg, args.batch)
        step = jax.jit(
            functools.partial(htm_step_batch, cfg), static_argnums=(2,)
        )
    else:
        state = htm_init(jax.random.key(args.seed), cfg)
        step = jax.jit(functools.partial(htm_step, cfg), static_argnums=(2,))

    if args.checkpoint:
        from bithtm_tpu.utils.checkpoint import restore, save
        import os

        if os.path.exists(args.checkpoint):
            state = restore(args.checkpoint, state)
            print(f"resumed from {args.checkpoint}")

    logger = None
    if args.log:
        from bithtm_tpu.config import config_to_dict
        from bithtm_tpu.utils.metrics_log import JsonlLogger

        logger = JsonlLogger(args.log, config=config_to_dict(cfg))

    start = time.time()
    for epoch in range(args.epochs):
        if args.scan:
            idx = np.arange(args.input_patterns)
            noise = rng.rand(args.input_patterns, args.input_dim) \
                < args.input_noise_probability
            seq = inputs[idx] ^ noise
            if batched:
                seq = np.broadcast_to(
                    seq[:, None], (len(seq), args.batch, args.input_dim)
                )
            state, metrics = htm_scan(cfg, state, jnp.asarray(seq), True)
            if logger is not None:
                host_m = jax.device_get(metrics)
                logger.write(host_m, epoch=epoch)
                logger.write_capacity(host_m, scan=True, epoch=epoch,
                                      pool_slots=cfg.tm.segment_capacity)
            if not args.quiet:
                m = {k: np.asarray(v).sum(axis=-1) if batched else
                     np.asarray(v) for k, v in metrics.items()}
                print(
                    f"epoch {epoch}: bursting {np.sum(m['bursting'])}, "
                    f"correct {np.sum(m['correct'])}, "
                    f"incorrect {np.sum(m['incorrect'])}"
                )
        else:
            epoch_metrics = []  # per-step host metrics for capacity agg
            for i, pattern in enumerate(inputs):
                noisy = pattern ^ (
                    rng.rand(args.input_dim) < args.input_noise_probability
                )
                x = jnp.asarray(
                    np.broadcast_to(noisy, (args.batch, args.input_dim))
                    if batched else noisy
                )
                state, out = step(state, x, True)
                if logger is not None:
                    host_m = jax.device_get(out.metrics)
                    logger.write(host_m, epoch=epoch)
                    epoch_metrics.append(host_m)
                if not args.quiet:
                    m = {k: int(np.asarray(v).sum()) for k, v in
                         out.metrics.items()
                         if k in ("bursting", "correct", "incorrect")}
                    print(
                        f"epoch {epoch}, pattern {i}: "
                        f"bursting columns: {m['bursting']}, "
                        f"correct columns: {m['correct']}, "
                        f"incorrect columns: {m['incorrect']}"
                    )
            if logger is not None and epoch_metrics:
                # stack [T]-wise so capacity_health owns the counter
                # classification (sums drops, takes latest occupancy)
                stacked = {
                    k: np.stack([np.asarray(m[k]) for m in epoch_metrics])
                    for k in epoch_metrics[0]
                }
                logger.write_capacity(stacked, scan=True, epoch=epoch,
                                      pool_slots=cfg.tm.segment_capacity)

    jax.block_until_ready(state)
    elapsed = time.time() - start
    total_steps = args.epochs * args.input_patterns * args.batch
    print(f"{elapsed} seconds. "
          f"({total_steps / elapsed:,.0f} aggregate timesteps/s)")

    if args.checkpoint:
        save(args.checkpoint, state)
        print(f"saved checkpoint to {args.checkpoint}")


if __name__ == "__main__":
    main()
