"""True multi-process execution (jax.distributed): two processes, each
with two virtual CPU devices, form one 4-way data-parallel mesh and run
sharded HTM steps with per-process input feeding — the multi-host story
of `parallel/distributed.py` + `parallel/mesh.py` end to end.

Includes the elastic-recovery drill (SURVEY.md §5 failure-recovery row):
run -> checkpoint -> SIGKILL both workers mid-step-loop -> fresh
processes restore into a new mesh and continue, bit-identical to an
uninterrupted single-process run of the same stream.
"""

import hashlib
import os
import socket
import subprocess
import sys
import textwrap
import threading
import time

import numpy as np

_PREAMBLE = textwrap.dedent("""
    import hashlib, os, sys
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    port, rank, repo = sys.argv[1], int(sys.argv[2]), sys.argv[3]
    nprocs = int(os.environ.get("BITHTM_TEST_NPROCS", "2"))
    import jax
    jax.config.update("jax_platforms", "cpu")
    sys.path.insert(0, repo)
    from bithtm_tpu.parallel.distributed import (
        initialize, local_batch_slice, local_data_slice,
        make_global_array)
    initialize(f"localhost:{port}", num_processes=nprocs, process_id=rank)
    import numpy as np, jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    from bithtm_tpu import htm_init_batch, make_htm_config
    from bithtm_tpu.parallel.mesh import (
        make_mesh, shard_batched_state, sharded_serve_step, sharded_step)
    from bithtm_tpu.utils.checkpoint import _rekey, _unkey
    assert jax.device_count() == 2 * nprocs
    assert jax.local_device_count() == 2
    cfg = make_htm_config(64, 64, 4, 4, segments_per_column=4,
        segment_activation_threshold=2, segment_matching_threshold=2,
        segment_sampling_synapses=8)
    B = 2 * jax.device_count()
    mesh = make_mesh(n_data=jax.device_count(), n_model=1)
    step = sharded_step(cfg, mesh, learning=True)

    def feed(t):
        rng = np.random.RandomState(1000 + t)
        full = rng.rand(B, cfg.input_dim) < 0.2
        return make_global_array(full[local_batch_slice(B)], mesh,
                                 P("data", None))

    def local_leaves(state):
        # this process's shard of every (batch-sharded) leaf, row
        # order; typed PRNG keys ride as their raw uint32 key data
        out = []
        for leaf in jax.tree_util.tree_leaves(_unkey(state)):
            shards = sorted(leaf.addressable_shards,
                            key=lambda s: s.index[0].start or 0)
            out.append(np.concatenate(
                [np.asarray(jax.device_get(s.data)) for s in shards]))
        return out

    def digest(state):
        h = hashlib.sha256()
        for arr in local_leaves(state):
            h.update(np.ascontiguousarray(arr).tobytes())
        return h.hexdigest()
""")

WORKER_DP = _PREAMBLE + textwrap.dedent("""
    state = shard_batched_state(htm_init_batch(jax.random.key(0), cfg, B),
                                mesh)
    for t in range(3):
        state, metrics = step(state, feed(t))
    shard = np.asarray(jax.device_get(
        metrics["bursting"].addressable_shards[0].data))
    print(f"MULTIHOST_OK rank={rank} burst={shard.tolist()}", flush=True)

    # also cross-host MODEL parallelism: a 2x2 (data x model) mesh puts
    # each model shard-pair on different processes, so the prediction
    # reduce crosses the host boundary
    mesh2 = make_mesh(n_data=2, n_model=2)
    step2 = sharded_step(cfg, mesh2, learning=True)
    state2 = shard_batched_state(
        htm_init_batch(jax.random.key(1), cfg, 4), mesh2)
    rng2 = np.random.RandomState(5)
    for t in range(2):
        full = rng2.rand(4, cfg.input_dim) < 0.2
        x2 = make_global_array(full[local_batch_slice(4)], mesh2,
                               P("data", None))
        state2, m2 = step2(state2, x2)
    jax.block_until_ready(state2)
    print(f"MODELPAR_OK rank={rank}", flush=True)
""")

# Phase A: 3 steps -> checkpoint local shard -> keep stepping until
# killed (the parent SIGKILLs us mid-loop: a real worker failure).
WORKER_CKPT = _PREAMBLE + textwrap.dedent("""
    from bithtm_tpu.utils import checkpoint as ckpt
    ckpt_dir = sys.argv[4]
    state = shard_batched_state(htm_init_batch(jax.random.key(0), cfg, B),
                                mesh)
    for t in range(3):
        state, metrics = step(state, feed(t))
    jax.block_until_ready(state)
    # each process persists ITS OWN shard (4 streams) of the pytree,
    # in key-data space (all plain arrays)
    local = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(_unkey(state)), local_leaves(state))
    ckpt.save(os.path.join(ckpt_dir, f"shard{rank}"), local,
              backend="npz")  # per-process shard: no orbax multihost sync
    print("CKPT_SAVED", flush=True)
    t = 3
    while True:  # keep working until the parent kills us
        state, metrics = step(state, feed(t))
        jax.block_until_ready(metrics["bursting"])
        t += 1
""")

# Phase B: fresh processes, new mesh, restore from the shard files,
# continue steps 3 and 4, print the final state digest.
WORKER_RESUME = _PREAMBLE + textwrap.dedent("""
    from bithtm_tpu.utils import checkpoint as ckpt
    ckpt_dir = sys.argv[4]
    like = htm_init_batch(jax.random.key(0), cfg, B // nprocs)  # local
    like_raw = _unkey(jax.device_get(like))
    raw_local = ckpt.restore(os.path.join(ckpt_dir, f"shard{rank}"),
                             like_raw)  # plain arrays (keys as u32 data)
    raw_global = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(like_raw),
        [make_global_array(np.asarray(x), mesh,
                           P("data", *([None] * (np.ndim(x) - 1))))
         for x in jax.tree_util.tree_leaves(raw_local)])
    state = _rekey(raw_global, like)  # wrap key leaves back to typed
    for t in range(3, 5):
        state, metrics = step(state, feed(t))
    jax.block_until_ready(state)
    print(f"RESUME_DIGEST rank={rank} {digest(state)}", flush=True)
""")


# Wide-drill phase B (run with nprocs=4): restore the 8-way
# data-parallel state from the per-process shards, continue stepping,
# then exercise a cross-host (2 data x 4 model) mesh — each data
# replica's model shards span two processes — with learning AND serving
# steps (`sharded_serve_step`).
WORKER_WIDE_RESUME = _PREAMBLE + textwrap.dedent("""
    from bithtm_tpu.utils import checkpoint as ckpt
    ckpt_dir = sys.argv[4]
    like = htm_init_batch(jax.random.key(0), cfg, B // nprocs)
    like_raw = _unkey(jax.device_get(like))
    raw_local = ckpt.restore(os.path.join(ckpt_dir, f"shard{rank}"),
                             like_raw)
    raw_global = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(like_raw),
        [make_global_array(np.asarray(x), mesh,
                           P("data", *([None] * (np.ndim(x) - 1))))
         for x in jax.tree_util.tree_leaves(raw_local)])
    state = _rekey(raw_global, like)
    for t in range(3, 5):
        state, metrics = step(state, feed(t))
    jax.block_until_ready(state)
    print(f"RESUME_DIGEST rank={rank} {digest(state)}", flush=True)

    # cross-host model parallelism + serving: 2 data x 4 model (the
    # model axis of each data replica spans TWO processes, so two
    # processes feed the SAME batch rows — local_data_slice, not
    # local_batch_slice)
    mesh2 = make_mesh(n_data=2, n_model=4)
    step2 = sharded_step(cfg, mesh2, learning=True)
    serve2 = sharded_serve_step(cfg, mesh2)
    state2 = shard_batched_state(
        htm_init_batch(jax.random.key(7), cfg, 4), mesh2)
    rng2 = np.random.RandomState(9)
    for t in range(2):
        full = rng2.rand(4, cfg.input_dim) < 0.2
        x2 = make_global_array(full[local_data_slice(4, mesh2)], mesh2,
                               P("data", None))
        state2, m2 = step2(state2, x2)
    for t in range(2):
        full = rng2.rand(4, cfg.input_dim) < 0.2
        x2 = make_global_array(full[local_data_slice(4, mesh2)], mesh2,
                               P("data", None))
        state2, m2 = serve2(state2, x2)
    jax.block_until_ready(state2)
    burst = int(np.asarray(jax.device_get(
        m2["bursting"].addressable_shards[0].data)).sum())
    print(f"WIDE_OK rank={rank} serve_burst_shard={burst}", flush=True)
""")


def _spawn(script_text, extra_args, tmp_path, tag, until, timeout=240,
           nprocs=2):
    """Start `nprocs` workers on a fresh port; wait until
    `until(outputs)` is true (outputs grow live) or timeout. Returns
    (procs, outputs). Caller must kill/reap the procs."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    script = tmp_path / f"worker_{tag}.py"
    script.write_text(script_text)
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    env["BITHTM_TEST_NPROCS"] = str(nprocs)
    procs, outputs, threads = [], [[] for _ in range(nprocs)], []
    for rank in range(nprocs):
        p = subprocess.Popen(
            [sys.executable, str(script), str(port), str(rank), repo,
             *extra_args],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=env, bufsize=1,
        )
        procs.append(p)

        def pump(p=p, buf=outputs[rank]):
            for line in p.stdout:
                buf.append(line)
        th = threading.Thread(target=pump, daemon=True)
        th.start()
        threads.append(th)
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if until(outputs):
            return procs, outputs
        if all(p.poll() is not None for p in procs):
            break  # both exited; let the caller inspect outputs
        time.sleep(0.2)
    for p in procs:
        p.kill()
    raise AssertionError(
        "workers did not reach the expected state; outputs:\n"
        + "\n---\n".join("".join(buf)[-2000:] for buf in outputs)
    )


def _kill_all(procs):
    for p in procs:
        p.kill()
    for p in procs:
        p.wait(timeout=30)


def _run_to_completion(script_text, tmp_path, tag, want, extra_args=(),
                       nprocs=2, timeout=240):
    """Spawn, wait for `want` in every output, reap, return outputs."""
    last_err = None
    for attempt in range(2):  # one retry for port races
        try:
            procs, outputs = _spawn(
                script_text, list(extra_args), tmp_path,
                f"{tag}{attempt}",
                lambda o: all(any(want in ln for ln in buf) for buf in o),
                nprocs=nprocs, timeout=timeout,
            )
            _kill_all(procs)
            return ["".join(buf) for buf in outputs]
        except AssertionError as e:
            last_err = e
    raise last_err


def test_two_process_data_parallel(tmp_path):
    outs = _run_to_completion(WORKER_DP, tmp_path, "dp", "MODELPAR_OK")
    for rank, out in enumerate(outs):
        assert f"MULTIHOST_OK rank={rank}" in out, out[-2000:]
        assert f"MODELPAR_OK rank={rank}" in out, out[-2000:]


def test_elastic_recovery_restart_resumes_bitexact(tmp_path):
    """Worker failure drill: checkpoint at step 3, SIGKILL both workers
    while they are still stepping, restore into fresh processes + a
    fresh mesh, continue to step 5 — and the resumed distributed state
    equals an uninterrupted single-process run bit-for-bit."""
    ckpt_dir = tmp_path / "ckpt"
    ckpt_dir.mkdir()

    # Phase A: run + checkpoint, then die mid-work.
    procs, outputs = _spawn(
        WORKER_CKPT, [str(ckpt_dir)], tmp_path, "ckpt",
        lambda o: all(any("CKPT_SAVED" in ln for ln in buf) for buf in o),
    )
    time.sleep(1.0)  # let them get back into the step loop
    _kill_all(procs)  # SIGKILL: a real, uncoordinated failure

    # Phase B: fresh processes restore and continue.
    outs = _run_to_completion(WORKER_RESUME, tmp_path, "resume",
                              "RESUME_DIGEST", [str(ckpt_dir)])
    digests = {}
    for rank, out in enumerate(outs):
        line = [ln for ln in out.splitlines()
                if ln.startswith("RESUME_DIGEST")][0]
        assert f"rank={rank}" in line
        digests[rank] = line.split()[-1]

    # Control: the same 5 steps, single process, no interruption.
    import jax

    from bithtm_tpu import htm_init_batch, htm_step_batch, make_htm_config

    cfg = make_htm_config(64, 64, 4, 4, segments_per_column=4,
                          segment_activation_threshold=2,
                          segment_matching_threshold=2,
                          segment_sampling_synapses=8)
    B = 8
    state = htm_init_batch(jax.random.key(0), cfg, B)
    for t in range(5):
        rng = np.random.RandomState(1000 + t)
        x = rng.rand(B, cfg.input_dim) < 0.2
        state, _ = htm_step_batch(cfg, state, x, learning=True)
    from bithtm_tpu.utils.checkpoint import _unkey

    host = jax.device_get(_unkey(state))
    for rank in range(2):
        h = hashlib.sha256()
        for leaf in jax.tree_util.tree_leaves(host):
            arr = np.asarray(leaf)[rank * 4:(rank + 1) * 4]
            h.update(np.ascontiguousarray(arr).tobytes())
        assert h.hexdigest() == digests[rank], (
            f"rank {rank}: resumed distributed state differs from the "
            f"uninterrupted single-process control"
        )


def test_four_process_wide_drill(tmp_path):
    """4 processes x 2 virtual devices. 8-way
    data-parallel learning with per-process feeding, per-process npz
    checkpoint shards, SIGKILL of all four workers mid-loop, restore
    into fresh processes continuing bit-identically to an uninterrupted
    single-process control — then a cross-host (2 data x 4 model) mesh
    runs learning AND serving steps."""
    ckpt_dir = tmp_path / "ckpt4"
    ckpt_dir.mkdir()

    # Phase A: 4 workers run + checkpoint their shards, then die.
    procs, outputs = _spawn(
        WORKER_CKPT, [str(ckpt_dir)], tmp_path, "wide_ckpt",
        lambda o: all(any("CKPT_SAVED" in ln for ln in buf) for buf in o),
        nprocs=4, timeout=360,
    )
    time.sleep(1.0)
    _kill_all(procs)

    # Phase B: fresh 4-process cluster restores + continues + runs the
    # cross-host model mesh and the serving phase.
    outs = _run_to_completion(WORKER_WIDE_RESUME, tmp_path, "wide_resume",
                              "WIDE_OK", [str(ckpt_dir)], nprocs=4,
                              timeout=360)
    digests = {}
    for rank, out in enumerate(outs):
        line = [ln for ln in out.splitlines()
                if ln.startswith("RESUME_DIGEST")][0]
        assert f"rank={rank}" in line
        digests[rank] = line.split()[-1]
        assert f"WIDE_OK rank={rank}" in out, out[-2000:]

    # Control: same 5 steps, single process, B=16.
    import jax

    from bithtm_tpu import htm_init_batch, htm_step_batch, make_htm_config
    from bithtm_tpu.utils.checkpoint import _unkey

    cfg = make_htm_config(64, 64, 4, 4, segments_per_column=4,
                          segment_activation_threshold=2,
                          segment_matching_threshold=2,
                          segment_sampling_synapses=8)
    B = 16
    state = htm_init_batch(jax.random.key(0), cfg, B)
    for t in range(5):
        rng = np.random.RandomState(1000 + t)
        x = rng.rand(B, cfg.input_dim) < 0.2
        state, _ = htm_step_batch(cfg, state, x, learning=True)
    host = jax.device_get(_unkey(state))
    share = B // 4
    for rank in range(4):
        h = hashlib.sha256()
        for leaf in jax.tree_util.tree_leaves(host):
            arr = np.asarray(leaf)[rank * share:(rank + 1) * share]
            h.update(np.ascontiguousarray(arr).tobytes())
        assert h.hexdigest() == digests[rank], (
            f"rank {rank}: resumed 4-process state differs from the "
            f"uninterrupted single-process control"
        )
