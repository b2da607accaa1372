"""Smoke run of the HTM main path on one NVIDIA GPU, at full width.

    python chip_smoke.py           # phases (a)-(e) on one GPU
    python chip_smoke.py --mesh4   # only the four-GPU sharded path

Phases, in order (any failure exits nonzero):

  (a) the platform is a GPU; print the card's name and power limit
      (nvidia-smi), the JAX/jaxlib versions and XLA_FLAGS;
  (b) the main path: `htm_init_batch` + `htm_scan` at 2048 x 32, input
      1000, the fast stack (G=4/K=64, int16 SP), B=256, T=128, learning
      on — metrics finite, `validate_state` on two streams; prints the
      first-call (compile) seconds, steady steps/s and peak device
      memory;
  (c) compact serving at the same config: train 64 steps, then
      `make_serving_table` + `htm_serve_scan`, bit-identical to
      `htm_scan(learning=False, compute_winner=False)` from a copied
      state, and `resume_learning` restores the full unpacked state;
  (d) oracle parity on the card: the compiled TM step against the
      NumPy BAMI oracle at 2048 x 32 (A=41, 40 mixed learning /
      inference steps) and 16384 x 64 (A=328, 20 steps), bit-exact; the
      compiled SP step against a NumPy SP model at 2048 x 1000 over 30
      steps (int16 bit-exact, float32 within 1e-5: the SP has no matrix
      product, the tolerance covers f32 rounding of the Hebbian adds);
  (e) five steps of `HierarchicalTemporalMemory(1000, 2048, 32).process`.

`--mesh4` runs only a data-parallel 2048 x 32 step on a (4, 1) mesh and
a model-parallel 16384 x 64 step on a (1, 4) mesh, each bit-equal to the
same steps unsharded on one card.

The last line of standard output is one JSON object,
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``;
it is printed only when every phase passed. With no GPU the script
exits nonzero and prints no result.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

FAST_STACK = dict(segments_per_column=4, synapse_capacity=64,
                  sp_overrides={"permanence_dtype": "int16"})
THRESHOLDS = dict(segment_activation_threshold=15,
                  segment_matching_threshold=15,
                  segment_sampling_synapses=32)


def log(msg: str) -> None:
    print(msg, flush=True)


def card_info() -> str:
    """The card's name and power limit as nvidia-smi reports them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True,
        ).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({type(e).__name__})"
    return out or "nvidia-smi printed nothing"


def peak_bytes(device) -> str:
    stats = device.memory_stats()
    if not stats or "peak_bytes_in_use" not in stats:
        return "peak_bytes_in_use not reported"
    return f"peak_bytes_in_use {stats['peak_bytes_in_use']:,} B"


def fast_config(input_dim: int, column_dim: int, cell_dim: int, **kw):
    from bithtm_tpu import make_htm_config

    return make_htm_config(input_dim, column_dim, cell_dim,
                           **{**FAST_STACK, **kw})


def device_inputs(seed: int, steps: int, batch: int, input_dim: int,
                  patterns: int = 100, density: float = 0.2,
                  noise: float = 0.05):
    """[T, B, I] bool inputs made on the device from ``seed``: a
    repeating cycle of random patterns with per-step XOR noise (the
    reference example's workload, `example.py:34,52`)."""
    import jax
    import jax.numpy as jnp

    kp, kn = jax.random.split(jax.random.key(seed))
    pats = jax.random.bernoulli(kp, density, (patterns, batch, input_dim))
    flip = jax.random.bernoulli(kn, noise, (steps, batch, input_dim))
    return pats[jnp.arange(steps) % patterns] ^ flip


def _copy(tree):
    import jax
    import jax.numpy as jnp

    return jax.tree.map(jnp.copy, tree)


def _stream(tree, i: int):
    import jax

    return jax.device_get(jax.tree.map(lambda x: x[i], tree))


# ---- (b) the main path -------------------------------------------------

def phase_main(cfg, batch: int, steps: int, seed: int, label: str) -> dict:
    import jax

    from bithtm_tpu import htm_init_batch, htm_scan
    from bithtm_tpu.utils.checks import validate_state

    state = htm_init_batch(jax.random.key(seed), cfg, batch)
    seq = device_inputs(seed, 2 * steps, batch, cfg.input_dim)
    jax.block_until_ready((state, seq))
    t0 = time.perf_counter()
    state, m = htm_scan(cfg, state, seq[:steps], True)
    jax.block_until_ready((state, m))
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    state, m = htm_scan(cfg, state, seq[steps:], True)
    jax.block_until_ready((state, m))
    steady = time.perf_counter() - t0

    m = jax.device_get(m)
    for k, v in m.items():
        v = np.asarray(v)
        if v.shape != (steps, batch):
            raise AssertionError(f"metric {k} has shape {v.shape}")
        if not np.isfinite(v.astype(np.float64)).all():
            raise AssertionError(f"metric {k} is not finite")
    A = cfg.sp.active_columns
    if not ((m["bursting"] >= 0) & (m["bursting"] <= A)).all():
        raise AssertionError("bursting outside [0, A]")
    for i in (0, batch - 1):
        validate_state(cfg, _stream(state, i))
    rate = batch * steps / steady
    log(f"(b) main path on {label}: first call (trace + compile + "
        f"{steps} steps) {first:.2f} s, so compile ~{first - steady:.2f} s; "
        f"steady {steps} steps x {batch} streams in {steady:.4f} s = "
        f"{rate:,.0f} steps/s ({steady / steps * 1e3:.3f} ms/step); "
        f"{peak_bytes(jax.devices()[0])}; last-step bursting mean "
        f"{np.asarray(m['bursting'][-1]).mean():.2f}; metrics finite, "
        f"validate_state ok on streams 0 and {batch - 1}")
    return {"first_s": first, "steady_s": steady, "steps_per_s": rate}


# ---- (c) compact serving -------------------------------------------------

def phase_serving(cfg, batch: int, train_steps: int, serve_steps: int,
                  seed: int, label: str) -> None:
    import jax

    from bithtm_tpu import (htm_init_batch, htm_scan, htm_serve_scan,
                            resume_learning)
    from bithtm_tpu.ops.serving import make_serving_table
    from bithtm_tpu.utils.checks import assert_trees_bit_equal

    state = htm_init_batch(jax.random.key(seed), cfg, batch)
    seq = device_inputs(seed, train_steps + serve_steps, batch,
                        cfg.input_dim)
    state, _ = htm_scan(cfg, state, seq[:train_steps], True)
    serve_seq = seq[train_steps:]
    table = make_serving_table(cfg.tm, state.tm)

    ref, ref_m = htm_scan(cfg, _copy(state), serve_seq, False, 0, False,
                          False)
    t0 = time.perf_counter()
    got, got_m = htm_serve_scan(cfg, _copy(state), serve_seq,
                                serving_table=table)
    jax.block_until_ready((got, got_m))
    first = time.perf_counter() - t0

    if set(ref_m) != set(got_m):
        raise AssertionError(f"metric keys {set(ref_m)} != {set(got_m)}")
    for k in ref_m:
        np.testing.assert_array_equal(np.asarray(ref_m[k]),
                                      np.asarray(got_m[k]), err_msg=k)
    np.testing.assert_array_equal(np.asarray(ref.tm.prediction),
                                  np.asarray(got.tm.prediction))
    resumed = resume_learning(cfg, got)
    assert_trees_bit_equal(resumed, ref)
    log(f"(c) compact serving on {label}: trained {train_steps} steps x "
        f"{batch} streams, table rows {tuple(table.rows.shape)} (full pool "
        f"{tuple(state.tm.synapse_cell.shape)}); {serve_steps} served "
        f"steps bit-identical to htm_scan(learning=False, "
        f"compute_winner=False) (first serve call {first:.2f} s incl. "
        f"compile); resume_learning restores every state leaf bit-equal")


# ---- (d) oracle parity ---------------------------------------------------

def parity_tm_config(column_dim: int, cell_dim: int, active_columns: int,
                     **kw):
    from bithtm_tpu import TMConfig

    return TMConfig(column_dim=column_dim, cell_dim=cell_dim,
                    active_columns=active_columns, segments_per_column=4,
                    synapse_capacity=64, **{**THRESHOLDS, **kw})


def _column_schedule(cfg, seed: int, cycle: int):
    """A repeating ``cycle``-pattern sequence of active-column sets with
    occasional one-column noise swaps, so matching and active segments,
    reinforcement and punishment all fire at the real thresholds. A
    grown synapse (permanence 0.21) connects (0.5) after three
    reinforcements, one per pass of the cycle, so the first predictions
    come after about 4 * cycle steps."""
    rng = np.random.RandomState(seed)
    patterns = [
        np.sort(np.random.RandomState(seed + 100 + i).choice(
            cfg.column_dim, size=cfg.active_columns, replace=False
        )).astype(np.int32)
        for i in range(cycle)
    ]

    def cols(t):
        base = patterns[t % len(patterns)]
        if rng.rand() < 0.2:
            repl = rng.randint(cfg.column_dim)
            if repl not in base:
                base = base.copy()
                base[rng.randint(len(base))] = repl
                base = np.sort(base)
        return base

    return cols


def phase_tm_parity(cfg, steps: int, cycle: int, seed: int,
                    label: str) -> None:
    import jax
    import jax.numpy as jnp

    from bithtm_tpu import tm_init
    from bithtm_tpu.models.temporal_memory import tm_step
    from bithtm_tpu.oracle.bami import OracleDecisions, OracleTM
    from bithtm_tpu.oracle.transplant import extract_decisions

    step_fn = jax.jit(
        functools.partial(tm_step, cfg),
        static_argnames=("learning", "compute_winner", "return_debug"),
    )
    state = tm_init(cfg)
    oracle = OracleTM(cfg)
    key = jax.random.key(seed)
    cols_fn = _column_schedule(cfg, seed, cycle)
    t0 = time.perf_counter()
    n_learn = n_pred = 0
    for t in range(steps):
        cols = cols_fn(t)
        key, sub = jax.random.split(key)
        learning = t % 5 != 3
        if learning:
            state, out, debug = step_fn(state, sub, jnp.asarray(cols),
                                        learning=True, return_debug=True)
            dec = extract_decisions(jax.device_get(debug))
            n_learn += 1
        else:
            state, out = step_fn(state, sub, jnp.asarray(cols),
                                 learning=False)
            dec = OracleDecisions(
                winner_cells=set(
                    np.nonzero(np.asarray(out.winner_mask))[0].tolist()),
                learning_segments=set(), new_segments=[], grown={},
            )
        oracle.step(cols, dec, learning=learning)
        oracle.compare(jax.device_get(state))
        n_pred += len(oracle.predicted_cells)
    occ = int((np.asarray(state.seg_cell) < cfg.cell_dim).sum())
    log(f"(d) TM oracle parity on {label}: C={cfg.column_dim} "
        f"D={cfg.cell_dim} A={cfg.active_columns} "
        f"G={cfg.segments_per_column}/K={cfg.synapse_capacity} thresholds "
        f"{cfg.segment_activation_threshold}/"
        f"{cfg.segment_matching_threshold}/"
        f"{cfg.segment_sampling_synapses}, {cycle}-pattern cycle: {steps} "
        f"steps ({n_learn} "
        f"learning) bit-exact vs the oracle; {occ} segments allocated, "
        f"{n_pred} predicted cells summed over steps "
        f"({time.perf_counter() - t0:.1f} s)")
    if n_pred == 0:
        raise AssertionError("no cell was ever predicted: the parity run "
                             "did not exercise active segments")


def phase_sp_parity(input_dim: int, column_dim: int, active_columns: int,
                    steps: int, seed: int, label: str) -> None:
    """The compiled SP step against a NumPy model of the same rule:
    overlap, boosting, top-k with lowest-index tie-break, Hebbian update,
    duty cycle."""
    import jax
    import jax.numpy as jnp

    from bithtm_tpu import SPConfig, sp_init
    from bithtm_tpu.models.spatial_pooler import sp_step

    for dtype in ("int16", "float32"):
        cfg = SPConfig(input_dim=input_dim, column_dim=column_dim,
                       active_columns=active_columns,
                       permanence_dtype=dtype)
        I = cfg.input_dim
        state = sp_init(jax.random.key(seed), cfg)
        step_fn = jax.jit(functools.partial(sp_step, cfg),
                          static_argnames=("learning",))
        if cfg.quantized:
            perm = np.asarray(state.permanence)[:, :I].astype(np.int64)
            inc = cfg.to_units(cfg.permanence_increment)
            dec = cfg.to_units(cfg.permanence_decrement)
            thr = cfg.to_units(cfg.permanence_threshold)
        else:
            perm = np.asarray(state.permanence)[:, :I].astype(np.float64)
            inc, dec = cfg.permanence_increment, cfg.permanence_decrement
            thr = cfg.permanence_threshold
        duty = np.zeros(cfg.column_dim, np.float32)
        rng = np.random.RandomState(seed)
        for _ in range(steps):
            x = rng.rand(I) < 0.2
            state, out = step_fn(state, jnp.asarray(x), learning=True)
            overlaps = ((perm >= thr) & x).sum(axis=1)
            factor = np.exp(-(cfg.boosting_intensity / cfg.density) * duty)
            boosted = factor.astype(np.float32) * overlaps.astype(np.float32)
            order = np.lexsort((np.arange(len(boosted)), -boosted))
            active = np.sort(order[: cfg.active_columns])
            perm[active] += x * (inc + dec) - dec
            if cfg.quantized:
                perm = np.clip(perm, -32000, 32000)
            duty = duty * cfg.duty_cycle_momentum
            duty[active] += 1.0 - cfg.duty_cycle_momentum
            np.testing.assert_array_equal(np.asarray(out.overlaps), overlaps)
            np.testing.assert_array_equal(
                np.sort(np.asarray(out.active_columns)), active)
            got = np.asarray(state.permanence)[:, :I]
            if cfg.quantized:
                np.testing.assert_array_equal(got.astype(np.int64), perm)
            else:
                np.testing.assert_allclose(got, perm, rtol=0, atol=1e-5)
        log(f"(d) SP parity on {label}: {dtype} {column_dim}x{input_dim}, "
            f"{steps} learning steps "
            + ("bit-exact" if cfg.quantized else "within atol 1e-5")
            + " vs the NumPy SP model")


# ---- (e) the README's first example ---------------------------------------

def phase_wrapper(input_dim: int, column_dim: int, cell_dim: int,
                  steps: int, seed: int, label: str, **kw) -> None:
    from bithtm_tpu import HierarchicalTemporalMemory

    htm = HierarchicalTemporalMemory(input_dim, column_dim, cell_dim, **kw)
    rng = np.random.RandomState(seed)
    for _ in range(steps):
        sp_out, tm_out = htm.process(rng.rand(input_dim) < 0.2)
    A = htm.active_columns
    cols = np.asarray(sp_out.active_columns)
    if cols.shape != (A,) or len(np.unique(cols)) != A:
        raise AssertionError(f"SP active columns {cols.shape}")
    active = np.asarray(tm_out.active_mask)
    if active.shape != (column_dim * cell_dim,) or not active.any():
        raise AssertionError("TM active cells missing")
    for k, v in htm.last_metrics.items():
        if not np.isfinite(np.asarray(v, np.float64)).all():
            raise AssertionError(f"metric {k} is not finite")
    log(f"(e) HierarchicalTemporalMemory({input_dim}, {column_dim}, "
        f"{cell_dim}).process x{steps} on {label}: {A} active columns, "
        f"{int(active.sum())} active cells, bursting "
        f"{int(htm.last_metrics['bursting'])}")


# ---- --mesh4: the sharded steps --------------------------------------------

def phase_mesh(cfg, n_data: int, n_model: int, batch: int, steps: int,
               seed: int, devices, label: str) -> None:
    """``steps`` training steps sharded over a (n_data, n_model) mesh of
    ``devices``, bit-equal (state + last metrics) to the same steps
    unsharded on the default device."""
    import jax

    from bithtm_tpu import htm_init_batch
    from bithtm_tpu.models.htm import htm_step_batch
    from bithtm_tpu.parallel.mesh import (make_mesh, shard_batched_state,
                                          sharded_step)
    from bithtm_tpu.utils.checks import assert_trees_bit_equal

    mesh = make_mesh(n_data=n_data, n_model=n_model, devices=devices)
    rng = np.random.RandomState(seed)
    xs = [rng.rand(batch, cfg.input_dim) < 0.2 for _ in range(steps)]

    init = htm_init_batch(jax.random.key(seed), cfg, batch)
    ctrl = _copy(init)
    state = shard_batched_state(init, mesh)
    step = sharded_step(cfg, mesh, learning=True)
    t0 = time.perf_counter()
    for x in xs:
        state, metrics = step(state, x)
    jax.block_until_ready(state)
    sharded_s = time.perf_counter() - t0

    ctrl_step = jax.jit(functools.partial(htm_step_batch, cfg))
    for x in xs:
        ctrl, out = ctrl_step(ctrl, x)
    jax.block_until_ready(ctrl)
    assert_trees_bit_equal(state, ctrl, got_metrics=metrics,
                           want_metrics=out.metrics)
    log(f"(mesh) {label}: {cfg.column_dim}x{cfg.cell_dim}, B={batch}, "
        f"{steps} learning steps on a (data={n_data}, model={n_model}) "
        f"mesh bit-equal (state + metrics) to the unsharded steps on one "
        f"card (sharded run {sharded_s:.2f} s incl. compile); bursting "
        f"{np.asarray(metrics['bursting']).tolist()[:8]}")


# ---- entry point -------------------------------------------------------------

def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--mesh4", action="store_true",
                   help="run only the four-GPU sharded path")
    args = p.parse_args(argv)

    import jax
    import jaxlib

    devices = jax.devices()
    dev = devices[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: no GPU found (JAX platform {dev.platform!r})",
              file=sys.stderr)
        return 2
    want = 4 if args.mesh4 else 1
    if len(devices) < want:
        print(f"chip_smoke: --mesh4 needs 4 GPUs, found {len(devices)}",
              file=sys.stderr)
        return 2
    devices = devices[:want]

    from bithtm_tpu.utils.compile_cache import enable_compilation_cache

    card = card_info()
    label = f"{dev.device_kind} ({card.splitlines()[0]})"
    log(f"(a) platform gpu: {len(devices)} x {dev.device_kind}; "
        f"nvidia-smi: {'; '.join(card.splitlines())}")
    log(f"(a) jax {jax.__version__}, jaxlib {jaxlib.__version__}, "
        f"XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}, compilation "
        f"cache {enable_compilation_cache()}")

    t0 = time.perf_counter()
    if args.mesh4:
        phase_mesh(fast_config(1000, 2048, 32), 4, 1, batch=64, steps=3,
                   seed=0, devices=devices, label=f"data-parallel on {label}")
        phase_mesh(fast_config(1000, 16384, 64), 1, 4, batch=2, steps=3,
                   seed=1, devices=devices,
                   label=f"model-parallel on {label}")
    else:
        cfg = fast_config(1000, 2048, 32)
        phase_main(cfg, batch=256, steps=128, seed=0, label=label)
        log(f"    [{time.perf_counter() - t0:.1f} s]")
        phase_serving(cfg, batch=256, train_steps=64, serve_steps=32,
                      seed=1, label=label)
        log(f"    [{time.perf_counter() - t0:.1f} s]")
        phase_tm_parity(parity_tm_config(2048, 32, 41), steps=40, cycle=6,
                        seed=2, label=label)
        log(f"    [{time.perf_counter() - t0:.1f} s]")
        phase_tm_parity(parity_tm_config(16384, 64, 328), steps=20,
                        cycle=3, seed=3, label=label)
        log(f"    [{time.perf_counter() - t0:.1f} s]")
        phase_sp_parity(1000, 2048, 41, steps=30, seed=4, label=label)
        log(f"    [{time.perf_counter() - t0:.1f} s]")
        phase_wrapper(1000, 2048, 32, steps=5, seed=5, label=label)
    log(f"all phases passed in {time.perf_counter() - t0:.1f} s on {label}")
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
