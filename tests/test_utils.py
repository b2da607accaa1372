"""Aux-subsystem tests: state invariants, metrics logging, profiling."""

import json

import jax
import jax.numpy as jnp
import numpy as np

from bithtm_tpu import htm_init, htm_scan, make_htm_config
from bithtm_tpu.utils.checks import validate_state
from bithtm_tpu.utils.metrics_log import JsonlLogger, summarize
from bithtm_tpu.utils.profiling import PhaseTimer


def small_cfg():
    return make_htm_config(
        input_dim=64, column_dim=64, cell_dim=4, active_columns=4,
        segment_activation_threshold=2, segment_matching_threshold=2,
        segment_sampling_synapses=8,
    )


def test_invariants_hold_through_training():
    cfg = small_cfg()
    state = htm_init(jax.random.key(0), cfg)
    validate_state(cfg, jax.device_get(state))
    rng = np.random.RandomState(0)
    for _ in range(4):
        seq = jnp.asarray(rng.rand(8, cfg.input_dim) < 0.2)
        state, _ = htm_scan(cfg, state, seq, True)
        validate_state(cfg, jax.device_get(state))


def test_jsonl_logger(tmp_path):
    cfg = small_cfg()
    state = htm_init(jax.random.key(0), cfg)
    rng = np.random.RandomState(0)
    seq = jnp.asarray(rng.rand(5, cfg.input_dim) < 0.2)
    state, metrics = htm_scan(cfg, state, seq, True)

    path = str(tmp_path / "m.jsonl")
    log = JsonlLogger(path, config={"column_dim": cfg.column_dim})
    per_step = jax.device_get(metrics)
    for t in range(5):
        log.write({k: v[t] for k, v in per_step.items()})
    log.close()

    lines = [json.loads(l) for l in open(path)]
    assert lines[0]["event"] == "config"
    assert len(lines) == 6
    assert "bursting" in lines[1] and lines[1]["step"] == 0


def test_capacity_health_events(tmp_path):
    """The JSONL logger's per-epoch capacity record:
    drop/eviction totals, latest pool occupancy (+fraction), and an
    ok/pressure status an operator can alert on."""
    from bithtm_tpu.utils.metrics_log import capacity_health

    cfg = small_cfg()
    state = htm_init(jax.random.key(0), cfg)
    rng = np.random.RandomState(0)
    seq = jnp.asarray(rng.rand(6, cfg.input_dim) < 0.2)
    state, metrics = htm_scan(cfg, state, seq, True)

    path = str(tmp_path / "m.jsonl")
    log = JsonlLogger(path)
    log.write_capacity(jax.device_get(metrics), scan=True,
                       pool_slots=cfg.tm.segment_capacity, epoch=0)
    log.close()
    rec = [json.loads(l) for l in open(path)][-1]
    assert rec["event"] == "capacity" and rec["epoch"] == 0
    assert rec["status"] == "ok"  # tiny run: nothing drops
    assert 0.0 <= rec["pool_occupancy_frac"] <= 1.0
    assert rec["tm_dropped_new_segments"] == 0
    assert "tm_evicted_segments" in rec

    # pressure path: synthesize counters
    h = capacity_health(
        {"tm_dropped_new_segments": np.asarray([3, 1]),
         "tm_evicted_segments": np.asarray(0),
         "tm_pool_occupancy": np.asarray([[5, 7], [6, 8]])},
        pool_slots=16, scan=True,
    )
    assert h["status"] == "pressure"
    assert h["tm_dropped_new_segments"] == 4
    assert h["pool_occupancy"] == 7.0  # latest step, mean over streams
    assert h["pool_occupancy_frac"] == round(7.0 / 16, 4)


def test_summarize_shapes():
    m = {"a": jnp.asarray(3), "b": jnp.asarray([1, 2]),
         "c": jnp.asarray([0.5, 1.5])}
    s = summarize(m)
    assert s == {"a": 3, "b": 3, "c": 1.0}


def test_phase_timer_and_drain():
    t = PhaseTimer()
    with t.phase("x"):
        y = jnp.ones((8, 8)) * 2
        jax.block_until_ready(y)
    assert "x" in t.report()


def test_require_gpu_refuses_the_cpu_unless_asked():
    import pytest

    from bithtm_tpu.utils.profiling import require_gpu

    with pytest.raises(SystemExit, match="no GPU found"):
        require_gpu()
    assert require_gpu(allow_cpu=True).platform == "cpu"


def test_invariant_checker_catches_corruption():
    import jax.numpy as jnp
    import pytest

    from bithtm_tpu.utils.checks import StateInvariantError

    cfg = small_cfg()
    state = htm_init(jax.random.key(0), cfg)
    rng = np.random.RandomState(0)
    seq = jnp.asarray(rng.rand(8, cfg.input_dim) < 0.2)
    state, _ = htm_scan(cfg, state, seq, True)
    host = jax.device_get(state)

    # out-of-range synapse target
    bad_syn = np.array(host.tm.synapse_cell)
    bad_syn[0, 0] = cfg.tm.num_cells + 5
    with pytest.raises(StateInvariantError):
        validate_state(cfg, host.replace(
            tm=host.tm.replace(synapse_cell=bad_syn)))

    # non-sentinel permanence on a free (syn == -1) slot
    free = np.array(host.tm.synapse_cell) < 0
    assert free.any()
    c, j = np.argwhere(free)[0]
    bad_perm = np.array(host.tm.synapse_perm)
    bad_perm[c, j] = 0.4
    with pytest.raises(StateInvariantError):
        validate_state(cfg, host.replace(
            tm=host.tm.replace(synapse_perm=bad_perm)))

    # stale cached activity: flip one entry's active bit (the packed
    # encoding is nonzero iff active — see ops.active_set.act_scale)
    live = (np.array(host.tm.synapse_cell) >= 0) & (
        np.array(host.tm.synapse_perm) >= 0
    )
    assert live.any()
    c, j = np.argwhere(live)[0]
    bad_act = np.array(host.tm.synapse_act)
    bad_act[c, j] = 1.0 if bad_act[c, j] == 0 else 0.0
    with pytest.raises(StateInvariantError):
        validate_state(cfg, host.replace(
            tm=host.tm.replace(synapse_act=bad_act)))

    # corrupted conn bit in the packed activity carry (active entry
    # reporting the wrong connectedness — v = 1 vs 1 + scale)
    from bithtm_tpu.ops.active_set import act_scale

    scale = float(act_scale(cfg.tm.synapse_capacity))
    v = np.array(host.tm.synapse_act, np.float32)
    on = np.argwhere(v != 0)
    assert len(on), "soaked state should have active synapses"
    c, j = on[0]
    bad_act = np.array(host.tm.synapse_act)
    bad_act[c, j] = np.asarray(
        1.0 + scale if v[c, j] == 1.0 else 1.0, bad_act.dtype
    )
    with pytest.raises(StateInvariantError):
        validate_state(cfg, host.replace(
            tm=host.tm.replace(synapse_act=bad_act)))

    # corrupted packed prediction carry (single flipped cell bit)
    bad_pred = np.array(host.tm.prediction)
    bad_pred[0, 3] ^= np.uint32(1 << 2)
    with pytest.raises(StateInvariantError):
        validate_state(cfg, host.replace(
            tm=host.tm.replace(prediction=bad_pred)))


def test_prefetch_pipeline_feeds_scan():
    import jax.numpy as jnp

    from bithtm_tpu.utils.data import noisy_pattern_chunks, prefetch_to_device

    cfg = small_cfg()
    rng = np.random.RandomState(0)
    pats = rng.rand(5, cfg.input_dim) < 0.2
    chunks = noisy_pattern_chunks(np.random.RandomState(1), pats,
                                  chunk_steps=10, num_chunks=4)
    state = htm_init(jax.random.key(0), cfg)
    n = 0
    for chunk in prefetch_to_device(chunks):
        assert chunk.shape == (10, cfg.input_dim)
        state, metrics = htm_scan(cfg, state, chunk, True)
        n += 1
    assert n == 4
    assert int(np.asarray(state.tm.step)) == 40


def test_prefetch_propagates_producer_errors():
    import pytest

    from bithtm_tpu.utils.data import prefetch_to_device

    def bad():
        yield np.zeros(3)
        raise ValueError("boom")

    it = prefetch_to_device(bad())
    next(it)
    with pytest.raises(ValueError):
        list(it)


def test_prefetch_early_exit_releases_producer():
    import time

    from bithtm_tpu.utils.data import prefetch_to_device

    produced = []

    def gen():
        for i in range(100):
            produced.append(i)
            yield np.full(4, i)

    it = prefetch_to_device(gen(), buffer_size=2)
    next(it)
    it.close()  # consumer abandons early
    time.sleep(0.5)
    n = len(produced)
    time.sleep(0.3)
    assert len(produced) == n  # producer stopped, not blocked-and-leaked
    assert n < 100


def test_config_validation_errors():
    from bithtm_tpu import SPConfig, TMConfig

    import pytest as _pytest

    with _pytest.raises(ValueError, match="active_columns"):
        SPConfig(input_dim=10, column_dim=8, active_columns=9)
    with _pytest.raises(ValueError, match="permanence_dtype"):
        SPConfig(input_dim=10, column_dim=8, active_columns=2,
                 permanence_dtype="fp8")
    with _pytest.raises(ValueError, match="allocation_policy"):
        TMConfig(column_dim=8, cell_dim=4, active_columns=2,
                 allocation_policy="lru")
    with _pytest.warns(UserWarning, match="synapse_capacity"):
        TMConfig(column_dim=8, cell_dim=4, active_columns=2,
                 synapse_capacity=8, segment_sampling_synapses=16)


def test_compile_cache_populates_and_hits(tmp_path):
    """With JAX_COMPILATION_CACHE_DIR set, enable_compilation_cache
    leaves the directory to JAX, executables land there, and a second
    process reuses them (cross-process warm start)."""
    import subprocess
    import sys as _sys

    prog = """
import sys
sys.path.insert(0, {repo!r})
import jax
jax.config.update("jax_platforms", "cpu")
from bithtm_tpu.utils.compile_cache import enable_compilation_cache
d = enable_compilation_cache()
assert d == {cache!r}, d
assert jax.config.jax_compilation_cache_dir == {cache!r}
import jax.numpy as jnp
print(float(jax.jit(lambda x: (x * 3 + 1).sum())(jnp.arange(7.0))))
"""
    import os as _os

    repo = _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__)))
    cache = str(tmp_path / "xla")
    code = prog.format(repo=repo, cache=cache)
    env = dict(_os.environ, JAX_PLATFORMS="cpu",
               JAX_COMPILATION_CACHE_DIR=cache)
    out1 = subprocess.run([_sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert out1.returncode == 0, out1.stderr
    entries = [f for f in _os.listdir(cache)]
    assert entries, "cache dir is empty after a compile"
    mtimes = {f: _os.path.getmtime(_os.path.join(cache, f))
              for f in entries}
    out2 = subprocess.run([_sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert out2.returncode == 0, out2.stderr
    assert out1.stdout == out2.stdout
    # the second run served from the cache: same entries, none rewritten
    assert set(_os.listdir(cache)) == set(entries)
    for f, m in mtimes.items():
        assert _os.path.getmtime(_os.path.join(cache, f)) == m


def test_compile_cache_dir_follows_env_var():
    """The variable, when set, names the cache; unset or empty, the
    cache is the fixed in-checkout path, which git ignores."""
    import os as _os
    import subprocess

    from bithtm_tpu.utils.compile_cache import DEFAULT_DIR, cache_dir

    assert cache_dir({"JAX_COMPILATION_CACHE_DIR": "/x/y"}) == "/x/y"
    assert cache_dir({}) == DEFAULT_DIR
    assert cache_dir({"JAX_COMPILATION_CACHE_DIR": ""}) == DEFAULT_DIR
    repo = _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__)))
    assert DEFAULT_DIR == _os.path.join(repo, ".jax_cache")
    ignored = subprocess.run(
        ["git", "check-ignore", "-q", _os.path.join(DEFAULT_DIR, "f")],
        cwd=repo, capture_output=True)
    if ignored.returncode == 128:      # not a git checkout: read the file
        with open(_os.path.join(repo, ".gitignore")) as f:
            assert ".jax_cache/" in f.read().split()
    else:
        assert ignored.returncode == 0
    # unset: enable_compilation_cache points JAX at the fixed path
    import sys as _sys

    env = {k: v for k, v in _os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env["JAX_PLATFORMS"] = "cpu"
    code = (f"import sys; sys.path.insert(0, {repo!r}); import jax; "
            "from bithtm_tpu.utils.compile_cache import "
            "enable_compilation_cache as e; d = e(); "
            "print(d == jax.config.jax_compilation_cache_dir, d)")
    out = subprocess.run([_sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["True", DEFAULT_DIR]
