"""`chip_smoke.py`: each phase at a tiny size on the CPU, the refusal to
run without a GPU, and (marked ``chip``) the full script on the card.

The chip tests run the script in a subprocess, so the test process
itself stays on the CPU and the script is the only process on the card;
whether a card exists is decided inside the fixture."""

import json
import os
import shutil
import subprocess
import sys

import jax
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402

TINY = dict(active_columns=4, segment_activation_threshold=2,
            segment_matching_threshold=2, segment_sampling_synapses=8)


def test_phase_main_tiny(capsys):
    cfg = chip_smoke.fast_config(64, 64, 4, **TINY)
    out = chip_smoke.phase_main(cfg, batch=2, steps=6, seed=0, label="cpu")
    assert out["steps_per_s"] > 0
    assert "validate_state ok" in capsys.readouterr().out


def test_phase_serving_tiny(capsys):
    cfg = chip_smoke.fast_config(64, 64, 4, **TINY)
    chip_smoke.phase_serving(cfg, batch=2, train_steps=16, serve_steps=6,
                             seed=1, label="cpu")
    assert "bit-identical" in capsys.readouterr().out


def test_phase_tm_parity_tiny(capsys):
    cfg = chip_smoke.parity_tm_config(
        64, 4, 4, segment_activation_threshold=2,
        segment_matching_threshold=2, segment_sampling_synapses=4)
    chip_smoke.phase_tm_parity(cfg, steps=20, cycle=3, seed=2, label="cpu")
    assert "bit-exact vs the oracle" in capsys.readouterr().out


def test_phase_sp_parity_tiny(capsys):
    chip_smoke.phase_sp_parity(64, 128, 4, steps=5, seed=4, label="cpu")
    out = capsys.readouterr().out
    assert "int16" in out and "float32" in out


def test_phase_wrapper_tiny(capsys):
    chip_smoke.phase_wrapper(64, 64, 4, steps=3, seed=5, label="cpu",
                             **TINY)
    assert "active columns" in capsys.readouterr().out


@pytest.mark.parametrize("n_data,n_model", [(4, 1), (1, 4)])
def test_phase_mesh_tiny_on_four_devices(n_data, n_model, capsys):
    if n_model == 1:
        cfg = chip_smoke.fast_config(64, 64, 4, **TINY)
        batch = 8
    else:
        cfg = chip_smoke.fast_config(128, 64, 64, **{**TINY,
                                                     "active_columns": 8})
        batch = 1
    chip_smoke.phase_mesh(cfg, n_data, n_model, batch=batch, steps=2,
                          seed=0, devices=jax.devices()[:4], label="cpu")
    assert "bit-equal" in capsys.readouterr().out


@pytest.mark.parametrize("argv", [[], ["--mesh4"]])
def test_main_refuses_a_non_gpu_platform(argv, capsys):
    assert jax.devices()[0].platform == "cpu"
    assert chip_smoke.main(argv) != 0
    captured = capsys.readouterr()
    assert '"ok"' not in captured.out
    assert "no GPU" in captured.err


def _gpu_count() -> int:
    if shutil.which("nvidia-smi") is None:
        return 0
    r = subprocess.run(["nvidia-smi", "-L"], capture_output=True, text=True)
    return r.stdout.count("GPU ") if r.returncode == 0 else 0


@pytest.fixture
def gpu_env():
    """Environment for a subprocess on the GPU (the CPU-forcing
    variables removed); skips where no NVIDIA GPU is present."""
    if _gpu_count() < 1:
        pytest.skip("needs an NVIDIA GPU")
    return {k: v for k, v in os.environ.items()
            if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}


def _run_smoke(env, argv, want_count):
    r = subprocess.run([sys.executable, "chip_smoke.py", *argv], cwd=REPO,
                       env=env, capture_output=True, text=True, timeout=1500)
    assert r.returncode == 0, (r.stdout[-4000:], r.stderr[-4000:])
    last = json.loads(r.stdout.strip().splitlines()[-1])
    assert last["ok"] is True
    assert last["device"]["platform"] == "gpu"
    assert last["device"]["count"] == want_count


@pytest.mark.chip
def test_chip_smoke_on_the_gpu(gpu_env):
    _run_smoke(gpu_env, [], _gpu_count())


@pytest.mark.chip
def test_chip_smoke_mesh4_on_four_gpus(gpu_env):
    if _gpu_count() < 4:
        pytest.skip("needs four NVIDIA GPUs")
    _run_smoke(gpu_env, ["--mesh4"], 4)
