"""16K x 64 learning soak under `htm_scan_autocap`.

Tuned caps (Wc=448/L=384) drop winner candidates at the convergence
horizon; the auto caps (Wc=768/L=656) stay drop-free. This soak runs
the production banking mode: START tuned, auto-widen to the safe caps
on the first counted drop, re-running the offending chunk — trajectory
guaranteed drop-free — and reports per-chunk throughput, the
escalation point, and the end-to-end average. Run on the GPU:

    python scripts/soak_16k_autocap.py [--steps 2048] [--chunk 256]
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

p = argparse.ArgumentParser()
p.add_argument("--column_dim", type=int, default=16384)
p.add_argument("--cell_dim", type=int, default=64)
p.add_argument("--batch", type=int, default=64)
p.add_argument("--input_dim", type=int, default=1000)
p.add_argument("--steps", type=int, default=2048)
p.add_argument("--chunk", type=int, default=256)
p.add_argument("--tuned", type=str, default="448:384",
               help="Wc:L tuned starting caps")
p.add_argument("--patterns", type=int, default=100)
p.add_argument("--cpu", action="store_true",
               help="CPU backend (smoke-testing the harness at tiny dims)")
args = p.parse_args()

import jax

if args.cpu:
    jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp

from bithtm_tpu import htm_init_batch, htm_scan_autocap, make_htm_config
from bithtm_tpu.utils.profiling import require_gpu

require_gpu(args.cpu)

print(f"# devices: {jax.devices()}", file=sys.stderr, flush=True)

B, T = args.batch, args.steps
wc, gl = (int(x) for x in args.tuned.split(":"))
cfg = make_htm_config(
    input_dim=args.input_dim,
    column_dim=args.column_dim,
    cell_dim=args.cell_dim,
    segments_per_column=4,
    synapse_capacity=64,
    sp_overrides={"permanence_dtype": "int16"},
)
print(f"# tuned Wc={wc} L={gl}; safe (auto) "
      f"Wc={cfg.tm.resolved_winner_capacity} "
      f"L={cfg.tm.resolved_growth_capacity}", flush=True)

rng = np.random.RandomState(0)
patterns = rng.rand(args.patterns, B, args.input_dim) < 0.2
idx = np.arange(T) % args.patterns
noise = rng.rand(T, B, args.input_dim) < 0.05
seq = jnp.asarray(patterns[idx] ^ noise)

state = htm_init_batch(jax.random.key(0), cfg, B)

chunk_log = []


def on_chunk(t0, secs, escalated, drops):
    sps = B * args.chunk / secs
    chunk_log.append((t0, secs, sps, escalated))
    print(f"  chunk @{t0:5d}: {secs:6.2f}s = {sps:7,.0f} steps/s"
          + (f"  << ESCALATED (drops={drops}, chunk re-run under safe "
             f"caps; time includes both runs)" if escalated else ""),
          flush=True)


wall0 = time.perf_counter()
state, metrics, info = htm_scan_autocap(
    cfg, state, seq,
    tuned=dict(winner_capacity=wc, growth_capacity=gl),
    chunk=args.chunk, on_chunk=on_chunk,
)
wall = time.perf_counter() - wall0

total_drops = {
    k: int(metrics[k].sum())
    for k in ("tm_dropped_winner_candidates", "tm_dropped_growth_segments",
              "tm_dropped_new_segments")
}
# steady-state rates: exclude each phase's first (compile) chunk
tuned_chunks = [c for c in chunk_log
                if not c[3] and (info["escalated_at_step"] is None
                                 or c[0] < info["escalated_at_step"])][1:]
safe_chunks = [c for c in chunk_log
               if info["escalated_at_step"] is not None
               and c[0] > info["escalated_at_step"]][1:]
print(f"\n# escalated_at_step={info['escalated_at_step']} "
      f"tuned_drops_observed={info['tuned_drops']} (discarded chunk)")
print(f"# trajectory drops: {total_drops}")
print(f"# end-to-end: {B * T / wall:,.0f} steps/s over {T} steps "
      f"({wall:.1f}s incl. compiles)")
if tuned_chunks:
    print(f"# tuned steady-state: "
          f"{np.mean([c[2] for c in tuned_chunks]):,.0f} steps/s "
          f"over {len(tuned_chunks)} chunks")
if safe_chunks:
    print(f"# safe steady-state: "
          f"{np.mean([c[2] for c in safe_chunks]):,.0f} steps/s "
          f"over {len(safe_chunks)} chunks")
print(f"# bursting[last] mean: "
      f"{np.asarray(metrics['bursting'][-1]).mean():.1f}")
