"""Test configuration: virtual 8-device CPU mesh + float64 for golden math.

Production runs are float32 on a GPU; tests validate the math in float64
on a virtual CPU mesh (XLA_FLAGS host-platform device count) so sharding
tests run without hardware.  Tests that need a GPU carry the `gpu`
marker and skip here.
"""
import os
import types

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(42)


# Generated stand-in for the reference's simple_forest.bt: a 10 x 10 x
# 2.5 m world at 0.1 m with vertical tree trunks.
FOREST_WMIN = np.array([-5.0, -5.0, 0.0])
FOREST_WMAX = np.array([5.0, 5.0, 2.5])
FOREST_RES = 0.1
# the four corners (+-4, +-4) are kept clear within this radius, so
# missions may start and end there
FOREST_CLEAR_R = 1.0


def forest_keys(seed: int = 0, n_trees: int = 30):
    """Occupied voxel keys of a seeded forest: `n_trees` full-height
    vertical cylinders (radius 0.15-0.3 m) whose centres lie in
    [-4.5, 4.5]^2 and at least FOREST_CLEAR_R + radius from every
    corner (+-4, +-4).  A voxel is occupied when its centre lies inside
    a trunk.  Returns (keys (K, 3) int64, trunk centres (n_trees, 2))."""
    rng = np.random.default_rng(seed)
    corners = np.array([[-4.0, -4.0], [-4.0, 4.0], [4.0, -4.0], [4.0, 4.0]])
    trunks = []
    while len(trunks) < n_trees:
        c = rng.uniform(-4.5, 4.5, size=2)
        r = rng.uniform(0.15, 0.3)
        if np.linalg.norm(corners - c, axis=1).min() > FOREST_CLEAR_R + r:
            trunks.append((c, r))
    lo = np.floor(FOREST_WMIN / FOREST_RES).astype(int)
    hi = np.floor(FOREST_WMAX / FOREST_RES).astype(int)    # exclusive
    ii, jj = np.meshgrid(np.arange(lo[0], hi[0]), np.arange(lo[1], hi[1]),
                         indexing="ij")
    centre = (np.stack([ii, jj], -1) + 0.5) * FOREST_RES
    inside = np.zeros(ii.shape, bool)
    for c, r in trunks:
        inside |= np.linalg.norm(centre - c, axis=-1) < r
    cols = np.stack([ii[inside], jj[inside]], -1)
    kk = np.arange(lo[2], hi[2])
    keys = np.concatenate([np.column_stack([cols, np.full(len(cols), k)])
                           for k in kk]).astype(np.int64)
    return keys, np.stack([c for c, _ in trunks])


@pytest.fixture(scope="module")
def forest(tmp_path_factory):
    """The seeded forest written as an octomap .bt file (world/mapping
    save_bt).  Attributes: path, keys, trunks."""
    from lsc_planner_tpu.world import mapping
    keys, trunks = forest_keys()
    path = str(tmp_path_factory.mktemp("forest") / "forest.bt")
    mapping.save_bt(path, keys, FOREST_RES)
    return types.SimpleNamespace(path=path, keys=keys, trunks=trunks)
