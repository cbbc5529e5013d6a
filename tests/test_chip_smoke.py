"""chip_smoke.py without a card: every phase at a tiny size on the CPU,
and the script's refusal to report anything when JAX finds no GPU. The
``gpu``-marked case runs the whole script on a card."""

import json
import os
import shutil
import subprocess
import sys

import pytest

import chip_smoke as cs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PHASE_NAMES = [name for name, _ in cs.PHASES] + ["multi"]


@pytest.mark.parametrize("name", PHASE_NAMES)
def test_phase_passes_at_tiny_size_on_cpu(name):
    if name == "multi":
        p = cs.run_phase(name, cs.phase_multi, cs.TINY, 4)
    else:
        p = cs.run_phase(name, dict(cs.PHASES)[name], cs.TINY)
    assert p.ok, p.line()


@pytest.mark.parametrize("where,args", [
    ("checkout", []), ("checkout", ["--multi"]), ("alone", [])])
def test_refuses_without_gpu_or_program(tmp_path, where, args):
    """No GPU, or chip_smoke.py copied alone into an empty directory:
    non-zero exit and no result line."""
    cwd = REPO
    if where == "alone":
        cwd = str(tmp_path)
        shutil.copy(os.path.join(REPO, "chip_smoke.py"), cwd)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    r = subprocess.run([sys.executable, "chip_smoke.py", *args], cwd=cwd,
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
    assert ("needs" if where == "checkout" else "ModuleNotFoundError") in (
        r.stderr)


@pytest.mark.gpu
def test_smoke_on_gpu(gpu_env):
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                       env=gpu_env, capture_output=True, text=True,
                       timeout=1500)
    assert r.returncode == 0, r.stdout[-4000:] + r.stderr[-4000:]
    last = json.loads(r.stdout.strip().splitlines()[-1])
    assert last["ok"] and last["device"]["platform"] == "gpu"
