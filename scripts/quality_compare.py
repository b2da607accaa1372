"""Multi-seed learning-quality comparison vs the reference implementation.

Runs the reference workload (`/root/reference/example.py:20-32` defaults,
scaled to 10 patterns x 60 epochs like the README comparison) for N seeds
on BOTH implementations:

  - the reference's vectorized NumPy HTM (imported from /root/reference,
    driven exactly like its own driver loop, metric semantics
    `/root/reference/example.py:50,55-57`), and
  - this framework (CPU backend by default; the algorithms are
    backend-identical and bit-exact vs the BAMI oracle either way).

Reported per implementation, mean +- sd over seeds:

  - steps_with_correct: steps (of epochs*patterns) with >= 1 correct
    column (a previously-predicted column that became active)
  - total_corrects: sum of per-step correct-column counts
  - last10_correct: mean correct columns over the final epoch
    (41 = every active column was predicted)
  - last10_bursting: mean bursting columns over the final epoch
    (0 = fully predicted)
  - first_correct_epoch: first epoch with any correct prediction

Run: python scripts/quality_compare.py [--seeds 5] [--epochs 60]
Output: one table + a JSON line for machine capture.
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def run_reference(seed, epochs, patterns, input_dim, column_dim, cell_dim,
                  density, noise):
    """One seed of the reference's own vectorized implementation, driven
    with its driver-loop metric semantics (example.py:48-57)."""
    sys.path.insert(0, "/root/reference")
    from bithtm import HierarchicalTemporalMemory as RefHTM

    np.random.seed(seed)
    inputs = np.random.rand(patterns, input_dim) < density
    htm = RefHTM(input_dim, column_dim, cell_dim)
    correct, bursting = [], []
    for _ in range(epochs):
        for cur in inputs:
            prev_pred = htm.temporal_memory.last_state.cell_prediction.max(
                axis=1
            )
            noisy = cur ^ (np.random.rand(input_dim) < noise)
            sp_state, tm_state = htm.process(noisy)
            correct.append(int(prev_pred[sp_state.active_column].sum()))
            bursting.append(int(tm_state.active_column_bursting.sum()))
    return np.array(correct), np.array(bursting)


def run_ours(seed, epochs, patterns, input_dim, column_dim, cell_dim,
             density, noise):
    """One seed of this framework through the reference-compatible
    wrapper; `last_metrics['correct'/'bursting']` implement the same
    driver-loop semantics in-step (models/htm.py `_step_metrics`)."""
    from bithtm_tpu import HierarchicalTemporalMemory

    rng = np.random.RandomState(seed)
    inputs = rng.rand(patterns, input_dim) < density
    htm = HierarchicalTemporalMemory(input_dim, column_dim, cell_dim,
                                     seed=seed)
    correct, bursting = [], []
    for _ in range(epochs):
        for cur in inputs:
            noisy = cur ^ (rng.rand(input_dim) < noise)
            htm.process(noisy)
            correct.append(int(htm.last_metrics["correct"]))
            bursting.append(int(htm.last_metrics["bursting"]))
    return np.array(correct), np.array(bursting)


def summarize(correct, bursting, patterns):
    last = patterns  # final epoch = last `patterns` steps
    ep = np.nonzero(correct)[0]
    return {
        "steps_with_correct": int((correct > 0).sum()),
        "total_corrects": int(correct.sum()),
        "last10_correct": float(correct[-last:].mean()),
        "last10_bursting": float(bursting[-last:].mean()),
        "first_correct_epoch": int(ep[0] // patterns) if len(ep) else -1,
    }


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--seeds", type=int, default=5)
    p.add_argument("--epochs", type=int, default=60)
    p.add_argument("--input_patterns", type=int, default=10)
    p.add_argument("--input_dim", type=int, default=1000)
    p.add_argument("--column_dim", type=int, default=2048)
    p.add_argument("--cell_dim", type=int, default=32)
    p.add_argument("--input_density", type=float, default=0.2)
    p.add_argument("--input_noise_probability", type=float, default=0.05)
    p.add_argument("--skip_reference", action="store_true")
    p.add_argument("--gpu", action="store_true",
                   help="run our side on the default (GPU) backend "
                        "instead of the CPU")
    args = p.parse_args()

    if not args.gpu:
        # quality, not speed: the CPU backend gives the same results
        import jax
        jax.config.update("jax_platforms", "cpu")

    dims = (args.epochs, args.input_patterns, args.input_dim,
            args.column_dim, args.cell_dim, args.input_density,
            args.input_noise_probability)
    results = {"ours": [], "reference": []}
    for seed in range(args.seeds):
        c, b = run_ours(seed, *dims)
        results["ours"].append(summarize(c, b, args.input_patterns))
        print(f"# ours seed {seed}: {results['ours'][-1]}", flush=True)
        if not args.skip_reference:
            c, b = run_reference(seed, *dims)
            results["reference"].append(
                summarize(c, b, args.input_patterns))
            print(f"# ref  seed {seed}: {results['reference'][-1]}",
                  flush=True)

    keys = ["steps_with_correct", "total_corrects", "last10_correct",
            "last10_bursting", "first_correct_epoch"]
    print(f"\n# {args.seeds} seeds, {args.epochs} epochs x "
          f"{args.input_patterns} patterns, "
          f"{args.column_dim}x{args.cell_dim}")
    print(f"{'metric':24s} {'ours (mean+-sd)':>22s} "
          f"{'reference (mean+-sd)':>22s}")
    summary = {}
    for k in keys:
        row = [k]
        for impl in ("ours", "reference"):
            if results[impl]:
                v = np.array([r[k] for r in results[impl]], float)
                row.append(f"{v.mean():.1f} +- {v.std():.1f}")
                summary[f"{impl}_{k}"] = [round(v.mean(), 2),
                                          round(v.std(), 2)]
            else:
                row.append("-")
        print(f"{row[0]:24s} {row[1]:>22s} {row[2]:>22s}")
    print(json.dumps({"seeds": args.seeds, **summary}))


if __name__ == "__main__":
    main()
