"""Subprocess smoke tests for the reference-compatible CLI drivers.

The unit suites exercise the library; these run the actual entry points
(`example.py`, `bench.py`) the way a user does — argument parsing,
backend selection, metric printing, checkpoint/log side effects — at
tiny configs on the CPU backend. Mirrors the reference driver's role
(`/root/reference/example.py`).
"""

import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

TINY = ["--input_dim", "64", "--column_dim", "64", "--cell_dim", "4",
        "--activation_threshold", "2", "--matching_threshold", "2",
        "--sampling_synapses", "8", "--input_patterns", "3"]


def run(args, timeout=420):
    r = subprocess.run(
        [sys.executable] + args, cwd=REPO, capture_output=True,
        text=True, timeout=timeout,
        env=dict(os.environ, JAX_PLATFORMS="cpu"),
    )
    assert r.returncode == 0, (r.stdout[-2000:], r.stderr[-2000:])
    return r


def test_example_oracle_differential(tmp_path):
    r = run(["example.py", "--cpu", "--oracle", "--epochs", "2",
             *TINY, "--quiet"])
    assert "verified bit-exact against the BAMI oracle" in (
        r.stdout + r.stderr
    )


def test_example_scan_batch_log_checkpoint(tmp_path):
    log = tmp_path / "metrics.jsonl"
    ckpt = tmp_path / "ckpt"
    r = run(["example.py", "--cpu", "--scan", "--batch", "2",
             "--epochs", "2", *TINY, "--log", str(log),
             "--checkpoint", str(ckpt), "--quiet"])
    assert "timesteps/s" in r.stdout + r.stderr
    lines = [json.loads(l) for l in log.read_text().splitlines()]
    assert lines and any("bursting" in l for l in lines)
    assert os.path.isdir(ckpt) and os.listdir(ckpt)
    # resume from the checkpoint (bit-identical resume is covered by
    # tests/test_checkpoint.py; here: the CLI wiring works)
    run(["example.py", "--cpu", "--scan", "--batch", "2",
         "--epochs", "1", *TINY, "--checkpoint", str(ckpt), "--quiet"])


def test_bench_modes_print_one_json_line(tmp_path):
    for extra in (["--mode", "sp"], ["--serve"]):
        r = run(["bench.py", "--cpu", "--batch", "2", "--steps", "4",
                 "--repeats", "1", *extra])
        json_lines = [json.loads(l) for l in r.stdout.splitlines()
                      if l.startswith("{")]
        assert len(json_lines) == 1, r.stdout
        rec = json_lines[0]
        assert {"metric", "value", "unit", "vs_baseline", "device"} <= set(rec)
        assert rec["value"] > 0
        assert rec["device"]["platform"] == "cpu"
