"""Runtime policies: where the compile cache lives, and that the
measuring entry points refuse to run without a GPU instead of falling
back to the CPU."""
import json
import os
import shutil
import subprocess
import sys

import jax
import pytest

from lsc_planner_tpu import runtime

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))


def test_cache_dir_from_environment_is_honoured(monkeypatch, tmp_path):
    """With JAX_COMPILATION_CACHE_DIR set, JAX reads it itself and the
    program sets no directory of its own."""
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert runtime.enable_compilation_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_cache_dir_default_is_fixed(monkeypatch):
    """Without the variable the cache is <repo>/.jax_cache, whatever the
    working directory (the path is part of the cache's identity)."""
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    monkeypatch.chdir("/")
    before = jax.config.jax_compilation_cache_dir
    try:
        path = runtime.enable_compilation_cache()
        assert path == os.path.join(ROOT, ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == path
        assert os.path.isdir(path)
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def _cpu_env():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    return env


@pytest.mark.parametrize("script,args,alone", [
    ("chip_smoke.py", [], False),
    ("chip_smoke.py", ["--four-cards"], False),
    ("chip_smoke.py", [], True),
    ("bench.py", [], False),
])
def test_refuses_without_gpu(script, args, alone, tmp_path):
    """On the CPU (and, for chip_smoke.py, in a directory holding nothing
    else of the repo) the script exits non-zero and prints no result."""
    cwd = ROOT
    if alone:
        shutil.copy(os.path.join(ROOT, script), tmp_path)
        cwd = str(tmp_path)
    r = subprocess.run([sys.executable, script, *args], cwd=cwd,
                       env=_cpu_env(), capture_output=True, text=True,
                       timeout=300)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
    assert '"metric"' not in r.stdout
    if not alone:
        assert "no GPU" in r.stderr


@pytest.fixture
def gpu_card():
    """Decided here, not at import: skip unless nvidia-smi sees a card."""
    smi = shutil.which("nvidia-smi")
    if smi is None or subprocess.run([smi, "-L"], capture_output=True
                                     ).returncode != 0:
        pytest.skip("no NVIDIA GPU on this machine")


@pytest.mark.gpu
def test_chip_smoke_on_the_card(gpu_card):
    """chip_smoke.py's one-card phases pass on the card (its own process:
    this one is pinned to the CPU by conftest)."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                       env=env, capture_output=True, text=True,
                       timeout=1200)
    assert r.returncode == 0, r.stderr[-2000:]
    last = json.loads(r.stdout.strip().splitlines()[-1])
    assert last["ok"] is True and last["device"]["platform"] == "gpu"
