"""Process-level runtime policies: the compile cache and matmul precision.

Call `enable_compilation_cache()` before the first jit in every entry
point.  Wrap every jitted planning-cycle function in `exact_f32`.
"""
from __future__ import annotations

import functools
import os

import jax

# fixed, so that one checkout's runs hit the same cache (the path is part
# of the cache's identity)
DEFAULT_CACHE_DIR = os.path.abspath(
    os.path.join(os.path.dirname(__file__), os.pardir, ".jax_cache"))


def enable_compilation_cache() -> str:
    """Enable JAX's persistent compilation cache; returns its directory.

    Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already reads it and
    no directory is set here; otherwise the cache lives in
    ``<repo>/.jax_cache``."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    os.makedirs(DEFAULT_CACHE_DIR, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE_DIR)
    return DEFAULT_CACHE_DIR


def exact_f32(fn):
    """Trace `fn` with every contraction at full f32 precision.

    This is the planner's one matmul-precision policy.  On the H100 an
    f32 matrix product at default precision may run in TF32 (~11 bits):
    ~7 cm at the 1024-agent circle's ~148 m coordinates, the order of
    the 0.1 m grid margin and the 4 mm LSC guard band.  The cycle entry
    points (``SyncSimulator._cycle_jit``, ``make_scan_cycle`` and the
    sharded cycle in parallel/shard.py) wrap their traced function in
    this once instead of annotating each contraction."""
    @functools.wraps(fn)
    def traced(*args, **kwargs):
        with jax.default_matmul_precision("highest"):
            return fn(*args, **kwargs)
    return traced


def gpu_device_info() -> dict:
    """Describe the device this process measures on; exit unless a GPU.

    Returns JAX's view (platform, device_kind, device count) and the
    card's name and power limit as nvidia-smi reports them.  A
    measurement without a GPU is refused here rather than run on the
    CPU."""
    import subprocess
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"no GPU: JAX's default device is {dev.platform} "
                         f"({dev.device_kind}); refusing to measure")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(jax.devices()),
            "nvidia_smi": smi.stdout.strip().splitlines()}
