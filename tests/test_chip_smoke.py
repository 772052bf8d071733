"""chip_smoke.py: its refusal to run without a GPU or outside a
checkout, and each phase function at a tiny size on the CPU (the chip
runs the same functions at full size)."""

import os
import shutil
import subprocess
import sys

import pytest

import chip_smoke

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(cwd, script, env_extra):
    env = dict(os.environ, **env_extra)
    env.pop("XLA_FLAGS", None)
    return subprocess.run(
        [sys.executable, script], cwd=cwd, env=env, capture_output=True,
        text=True, timeout=300,
    )


def test_refuses_cpu_platform():
    proc = _run(REPO, os.path.join(REPO, "chip_smoke.py"), {"JAX_PLATFORMS": "cpu"})
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
    assert "needs platform 'gpu'" in proc.stdout


def test_refuses_outside_a_checkout(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    proc = _run(str(tmp_path), "chip_smoke.py", {"JAX_PLATFORMS": "cpu"})
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_phase_device():
    assert chip_smoke.phase_device(require="cpu")["platform"] == "cpu"
    with pytest.raises(chip_smoke.SmokeFailure):
        chip_smoke.phase_device(require="gpu")


def test_phase_counts_tiny(monkeypatch):
    from hic_genome_assembler_tpu.cluster import breakpoints

    monkeypatch.setattr(breakpoints, "_HOST_N", 0)  # force the device path
    out = chip_smoke.phase_counts(n=300, n_growing=6, n_fixed=8, reps=1)
    assert out["exact"] and out["fixed_windows"] == 8
    assert out["empty_windows"] == 1
    assert out["growing_starts"] >= 4


def test_phase_scorer_tiny():
    out = chip_smoke.phase_scorer(sizes=(6, 5, 4, 3), n_random=20)
    assert out["candidates"] == 12 * 16
    assert out["max_rel_err"] < out["budget"]


def test_phase_hmm_tiny():
    out = chip_smoke.phase_hmm(n=200)
    assert out["paths_equal"]
    assert out["D"] == int(0.2 * out["T"])


def test_phase_multichip_tiny(tmp_path, monkeypatch):
    """The --chips 4 phase on 4 virtual CPU devices per process: mesh
    4x1, 2x2 and two-process EP byte-identical to the one-device run."""
    monkeypatch.setenv("XLA_FLAGS", "--xla_force_host_platform_device_count=4")
    (tmp_path / "work").mkdir()
    out = chip_smoke.phase_multichip(
        str(tmp_path / "work"), str(tmp_path), n_chroms=3, scaffolds=6,
        timeout=240, require="cpu",
    )
    assert out["devices"]["mesh_2x2"]["count"] == 4
    assert all(all(files.values()) for files in out["byte_identical"].values())


def test_phase_pipeline_tiny(tmp_path):
    out = chip_smoke.phase_pipeline(str(tmp_path), seed=3, n_chroms=3, scaffolds=6)
    assert out["orders_recovered"] == out["orders_checked"] == 3
    assert out["entry_lengths_ok"] == out["ordered_groups"]
    assert out["precision_violations"] == 0
    assert set(out["profiling_summary"]) >= {f"part{k}/total" for k in (1, 2, 3, 4)}
