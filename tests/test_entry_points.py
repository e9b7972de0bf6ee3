"""Entry points around the package: the GPU smoke script (its refusal off
the card, and its parity and distributed-BA phases on the CPU at a tiny
size) and the compile-cache placement."""

import os
import shutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _env(**kw):
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    for k, v in kw.items():
        if v is None:
            env.pop(k, None)
        else:
            env[k] = v
    return env


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_gpu(tmp_path, alone):
    """On the CPU, and in a directory holding nothing else of the repo,
    the script exits non-zero and prints no result."""
    script = os.path.join(REPO, "chip_smoke.py")
    cwd = REPO
    if alone:
        shutil.copy(script, tmp_path / "chip_smoke.py")
        script, cwd = str(tmp_path / "chip_smoke.py"), str(tmp_path)
    r = subprocess.run(
        [sys.executable, script], cwd=cwd, env=_env(PYTHONPATH=None),
        capture_output=True, text=True, timeout=300,
    )
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout


@pytest.mark.parametrize("preset", [False, True])
def test_compile_cache_placement(tmp_path, preset):
    """JAX_COMPILATION_CACHE_DIR wins when set; otherwise the cache sits
    at the fixed .jax_cache next to the package."""
    want = str(tmp_path / "cc") if preset else os.path.join(REPO, ".jax_cache")
    code = (
        "import jax, orbslam2_with_quadrics_tpu as p; "
        "print(p.CACHE_DIR); print(jax.config.jax_compilation_cache_dir)"
    )
    r = subprocess.run(
        [sys.executable, "-c", code], cwd=str(tmp_path),
        env=_env(JAX_COMPILATION_CACHE_DIR=want if preset else None,
                 PYTHONPATH=REPO),
        capture_output=True, text=True, timeout=120,
    )
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.split() == [want, want]


def test_chip_smoke_parity_phase_on_cpu():
    """The parity phase (each kept formulation vs its plain reference)
    passes on the CPU at the rehearsal size."""
    import chip_smoke

    chip_smoke.phase_parity(chip_smoke.TINY)


@pytest.mark.gpu
def test_chip_smoke_parity_phase_on_gpu(gpu_env):
    """The parity phase at TUM widths on the card, each kept formulation
    against its plain reference (chip_smoke.py runs it first)."""
    code = ("import chip_smoke as s; s.phase_device(False, 1); "
            "s.phase_parity(s.FULL)")
    r = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=gpu_env,
        capture_output=True, text=True, timeout=900,
    )
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]


def test_chip_smoke_dist_ba_phase_on_virtual_devices():
    """Four-device distributed BA agrees with one-device BA within the
    stated tolerance on virtual CPU devices."""
    import jax

    import chip_smoke

    assert len(jax.devices()) >= 4
    chip_smoke.phase_dist_ba(chip_smoke.TINY)
