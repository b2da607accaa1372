"""Per-op profile of the jitted HTM step on the current backend.

Traces ``--trace_steps`` scan iterations of the batched learning step
with `jax.profiler`, parses the resulting ``*.trace.json.gz`` and prints
per-op device durations divided by the step count.

Run: python scripts/profile_step.py [--fast] [--batch 256]
"""

import argparse
import glob
import gzip
import json
import os
import sys
import tempfile
from collections import defaultdict

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--batch", type=int, default=256)
    p.add_argument("--trace_steps", type=int, default=8)
    p.add_argument("--input_dim", type=int, default=1000)
    p.add_argument("--column_dim", type=int, default=2048)
    p.add_argument("--cell_dim", type=int, default=32)
    p.add_argument("--fast", action="store_true",
                   help="throughput preset (G=4/K=64 + int16 SP)")
    p.add_argument("--inference", action="store_true")
    p.add_argument("--serve", action="store_true",
                   help="profile htm_serve_scan (frozen-word table, "
                        "winner pass off)")
    p.add_argument("--detailed_metrics", action="store_true",
                   help="include the full-table occupancy metrics (bench.py "
                        "serves with them off)")
    p.add_argument("--top", type=int, default=28)
    p.add_argument("--dump", type=str, default="",
                   help="write ALL per-instance rows (tsv) to this path")
    args = p.parse_args()

    import jax
    import jax.numpy as jnp

    from bithtm_tpu import (htm_init_batch, htm_scan, htm_serve_scan,
                            make_htm_config)
    from bithtm_tpu.utils.profiling import require_gpu

    require_gpu()

    overrides = {}
    if args.fast:
        overrides = dict(
            segments_per_column=4, synapse_capacity=64,
            sp_overrides={"permanence_dtype": "int16"},
        )
    cfg = make_htm_config(
        input_dim=args.input_dim, column_dim=args.column_dim,
        cell_dim=args.cell_dim, **overrides,
    )
    B, T = args.batch, args.trace_steps
    rng = np.random.RandomState(0)
    seq = jnp.asarray(rng.rand(T, B, args.input_dim) < 0.2)
    state = htm_init_batch(jax.random.key(0), cfg, B)
    learn = not (args.inference or args.serve)

    if args.serve:
        run = lambda st: htm_serve_scan(
            cfg, st, seq, detailed_metrics=args.detailed_metrics)
    else:
        run = lambda st: htm_scan(cfg, st, seq, learn,
                                  detailed_metrics=args.detailed_metrics)
    state, m = run(state)  # compile + warm
    jax.block_until_ready((state, m))

    tmp = tempfile.mkdtemp(prefix="htm_trace_")
    jax.profiler.start_trace(tmp)
    state, m = run(state)
    jax.block_until_ready((state, m))
    jax.profiler.stop_trace()

    traces = glob.glob(os.path.join(tmp, "**", "*.trace.json.gz"),
                       recursive=True)
    assert traces, f"no trace under {tmp}"
    with gzip.open(traces[0], "rt") as f:
        data = json.load(f)

    # device-lane complete events only (pid names contain "device")
    pid_name = {}
    for ev in data["traceEvents"]:
        if ev.get("ph") == "M" and ev.get("name") == "process_name":
            pid_name[ev["pid"]] = ev["args"].get("name", "")
    import re

    dur_by_op = defaultdict(float)
    total = 0.0
    for ev in data["traceEvents"]:
        if ev.get("ph") != "X":
            continue
        pname = pid_name.get(ev.get("pid"), "")
        if not ("/device" in pname or "Device" in pname):
            continue
        name = ev.get("name", "?")
        # skip the whole-program wrapper events (they contain the rest)
        if name.startswith("jit_") or name.startswith("while"):
            continue
        # merge per-instance op names: fusion.123 -> fusion, vmap_tm_.17
        # -> vmap_tm_ (the scan-unroll clones of each op)
        name = re.sub(r"[.\d]+$", "", name)
        d = ev.get("dur", 0) / 1e3  # us -> ms
        dur_by_op[name] += d
        total += d

    mode = "serve" if args.serve else ("learning" if learn else "inference")
    print(f"# config: fast={args.fast} B={B} steps={T} "
          f"{args.column_dim}x{args.cell_dim} mode={mode}")
    print(f"# total device time: {total:.1f} ms "
          f"({total / T:.2f} ms/step)")
    rows = sorted(dur_by_op.items(), key=lambda kv: -kv[1])
    for name, d in rows[: args.top]:
        print(f"{d / T:8.3f} ms/step  {name[:110]}")

    # second view: per-instance, with HLO source metadata where present
    inst = defaultdict(float)
    meta = {}
    for ev in data["traceEvents"]:
        if ev.get("ph") != "X":
            continue
        pname = pid_name.get(ev.get("pid"), "")
        if not ("/device" in pname or "Device" in pname):
            continue
        name = ev.get("name", "?")
        if name.startswith("jit_") or name.startswith("while"):
            continue
        inst[name] += ev.get("dur", 0) / 1e3
        a = ev.get("args") or {}
        m = a.get("long_name") or a.get("tf_op") or a.get("source") or ""
        if m:
            meta[name] = str(m)
    print("\n# top instances (with HLO metadata):")
    for name, d in sorted(inst.items(), key=lambda kv: -kv[1])[: args.top]:
        print(f"{d / T:8.3f} ms/step  {name[:40]:40s} {meta.get(name, '')[:140]}")
    if args.dump:
        with open(args.dump, "w") as f:
            for name, d in sorted(inst.items(), key=lambda kv: -kv[1]):
                f.write(f"{d / T:.4f}\t{name}\t{meta.get(name, '')[:400]}\n")
        print(f"# dumped {len(inst)} instances to {args.dump}")


if __name__ == "__main__":
    main()
