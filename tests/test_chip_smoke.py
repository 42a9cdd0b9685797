"""chip_smoke.py: refuses to run without a GPU, and (``gpu`` marker) runs
each of its phases on a card when one is present."""

import os
import shutil
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE = os.path.join(ROOT, "chip_smoke.py")


def _run(args, cwd, env_update, timeout):
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "PYTHONPATH")}
    env.update(env_update)
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=timeout)


@pytest.mark.parametrize("where", ["checkout", "bare_directory"])
def test_chip_smoke_fails_without_gpu(tmp_path, where):
    """On the CPU, and in a directory holding only the script, it exits
    nonzero and never prints a result."""
    if where == "checkout":
        args, cwd = [SMOKE], ROOT
    else:
        shutil.copy(SMOKE, tmp_path / "chip_smoke.py")
        args, cwd = ["chip_smoke.py"], str(tmp_path)
    proc = _run(args, cwd, {"JAX_PLATFORMS": "cpu"}, timeout=300)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
    assert "needs 1 GPU" in proc.stderr


@pytest.fixture
def gpu_card():
    """Skips unless nvidia-smi lists a GPU (decided here, at run time)."""
    smi = shutil.which("nvidia-smi")
    if smi is None:
        pytest.skip("no NVIDIA GPU: nvidia-smi not found")
    listed = subprocess.run([smi, "-L"], capture_output=True, text=True)
    if listed.returncode != 0 or "GPU" not in listed.stdout:
        pytest.skip("no NVIDIA GPU listed by nvidia-smi")


@pytest.mark.gpu
@pytest.mark.parametrize("phase", ["experiment", "closure", "timetrace",
                                   "zstack", "v8"])
def test_chip_smoke_phase_on_gpu(gpu_card, phase):
    proc = _run([SMOKE, "--phase", phase], ROOT, {}, timeout=1200)
    assert proc.returncode == 0, proc.stdout[-4000:] + proc.stderr[-4000:]
    assert proc.stdout.strip().splitlines()[-1].startswith('{"ok": true')
