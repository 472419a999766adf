"""Native C++ layer tests: build, parse parity, EDT parity, A* oracle."""
import numpy as np
import pytest

from lsc_planner_tpu import native


@pytest.fixture(scope="module")
def lib():
    if native.load() is None:
        pytest.skip("native toolchain unavailable")
    return native


def test_bt_parse_matches_python(lib, forest):
    from lsc_planner_tpu.world.octomap_io import load_bt, rasterize
    tree = load_bt(forest.path)
    occ_py, k0 = rasterize(tree, [-5, -5, 0], [5, 5, 2.5])
    assert occ_py.any()
    res = lib.bt_resolution(forest.path)
    np.testing.assert_allclose(res, tree.resolution)
    occ_c = lib.bt_rasterize(forest.path, k0, np.asarray(occ_py.shape))
    assert (occ_c == occ_py).all()


def test_edt_matches_scipy(lib):
    from scipy import ndimage
    rng = np.random.default_rng(0)
    occ = rng.random((40, 30, 20)) < 0.05
    d_ref = np.minimum(
        ndimage.distance_transform_edt(~occ, sampling=0.1), 1.0)
    d_c = lib.edt3d(occ, 0.1, 1.0)
    np.testing.assert_allclose(d_c, d_ref, atol=1e-5)


def test_astar_matches_wavefront_cost(lib):
    """Native A* path length equals the wavefront geodesic distance."""
    import jax.numpy as jnp
    rng = np.random.default_rng(1)
    occ = rng.random((21, 21, 5)) < 0.2
    occ[0, 0, 0] = occ[20, 20, 4] = False
    path = lib.astar6(occ, [0, 0, 0], [20, 20, 4])
    if len(path) == 0:
        pytest.skip("random map happened to be disconnected")
    # wavefront distance from the goal column: A* stops at (x, y) match
    from lsc_planner_tpu.ops.grid_search import GridPlanner
    from lsc_planner_tpu.missions import make_circle_mission
    from lsc_planner_tpu.config import Param
    mission = make_circle_mission(2, radius=1.0,
                                  world=(0, 0, 0, 5.0, 5.0, 1.0))
    p = Param(grid_resolution=0.25)
    gp = GridPlanner(mission, p, esdf=None)
    assert tuple(gp.dims) == (21, 21, 5)
    D = gp.wavefront(jnp.asarray(occ), jnp.asarray([20, 20, 4]))
    d_start = float(D[0, 0, 0])
    # A* g-cost = steps = path length - 1; its goal test ignores z, so it
    # may stop early in the goal column (<= full 3-D geodesic)
    assert len(path) - 1 <= d_start + 1e-6
    assert len(path) - 1 >= d_start - 4  # within the z-column slack
