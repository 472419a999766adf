"""Tests for the world layer: .bt parsing, ESDF, SAT box checks, SFC
expansion, and the forest-world end-to-end slice.  The forest is the
seeded .bt world generated by the `forest` fixture (conftest.py)."""
import collections

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from lsc_planner_tpu.config import Param, GoalMode, SP_EPSILON_FLOAT
from lsc_planner_tpu.world.octomap_io import load_bt, rasterize
from lsc_planner_tpu.world.esdf import ESDF, OccupancySAT
from lsc_planner_tpu.world.corridor import CorridorBuilder

WMIN = np.array([-5.0, -5.0, 0.0])
WMAX = np.array([5.0, 5.0, 2.5])


@pytest.fixture(scope="module")
def esdf(forest):
    return ESDF.from_bt(forest.path, WMIN, WMAX, dtype=jnp.float64)


def test_bt_statistics(esdf, forest):
    """The generated 10x10x2.5 m forest reads back as exactly the
    generator's voxels: full-height trunk columns, a few % occupied."""
    occ = np.asarray(esdf.occ)
    assert occ.shape == (101, 101, 26)
    want = np.zeros_like(occ)
    want[tuple((forest.keys - np.asarray(esdf.origin_key)).T)] = True
    assert (occ == want).all()
    assert 0.03 < occ.mean() < 0.12
    col = occ.sum(axis=2)
    # every trunk centre is a solid column up to the 2.5 m ceiling
    ci = np.floor(forest.trunks / esdf.resolution).astype(int) - \
        np.asarray(esdf.origin_key)[:2]
    assert (col[ci[:, 0], ci[:, 1]] == 25).all()
    assert set(np.unique(col)) == {0, 25}


def test_esdf_matches_bruteforce(esdf, rng):
    """EDT values = min distance to occupied cell centers."""
    occ = esdf.occ
    occ_idx = np.argwhere(occ)
    res = esdf.resolution
    centers = (occ_idx + 0.5) * res + esdf.origin_key * res
    for _ in range(20):
        p = rng.uniform(WMIN + 0.1, WMAX - 0.1)
        d = float(esdf.at_points(jnp.asarray(p)))
        cell = np.floor((p - esdf.origin_key * res) / res).astype(int)
        c_center = (cell + 0.5) * res + esdf.origin_key * res
        brute = np.linalg.norm(centers - c_center, axis=1).min()
        brute = min(brute, esdf.max_dist)
        np.testing.assert_allclose(d, brute, atol=1e-6)


def _brute_obstructed(esdf, lo, hi, margin):
    """Literal re-implementation of isObstacleInBox's corner sampling
    (corridor_constructor.hpp:81-122) as the oracle."""
    res = esdf.resolution
    lo_m = np.asarray(lo, float) * res
    hi_m = np.asarray(hi, float) * res
    size = [int(round((hi_m[i] - lo_m[i]) / res)) + 1 for i in range(3)]
    thr = margin + 0.5 * res - SP_EPSILON_FLOAT
    for bi in range(max(size[0], 2)):
        for bj in range(max(size[1], 2)):
            for bk in range(max(size[2], 2)):
                it = (bi, bj, bk)
                sp = np.zeros(3)
                for i in range(3):
                    if size[i] == 1 and it[i] > 0:
                        sp[i] = lo_m[i]
                    else:
                        sp[i] = lo_m[i] + it[i] * res
                delta = np.zeros(3)
                for i in range(3):
                    if it[i] == 0 and lo_m[i] > WMIN[i] + SP_EPSILON_FLOAT:
                        delta[i] = -SP_EPSILON_FLOAT
                    else:
                        delta[i] = SP_EPSILON_FLOAT
                d = float(esdf.at_points(jnp.asarray(sp + delta)))
                if d < thr:
                    return True
    return False


def test_sat_box_check_matches_reference_sampling(esdf, rng):
    sat = OccupancySAT.build(esdf, margin=0.15)
    for _ in range(40):
        lo = rng.integers(-45, 35, size=3)
        lo[2] = rng.integers(1, 15)
        ext = rng.integers(0, 8, size=3)
        hi = lo + ext
        got = bool(sat.box_obstructed(
            jnp.asarray(lo, jnp.int32), jnp.asarray(hi, jnp.int32),
            jnp.asarray(lo * esdf.resolution <= WMIN + SP_EPSILON_FLOAT)))
        want = _brute_obstructed(esdf, lo, hi, 0.15)
        assert got == want, (lo, hi, got, want)


def test_corridor_expansion_properties(esdf, rng):
    builder = CorridorBuilder(esdf, WMIN, WMAX, agent_radius=0.15,
                              dtype=jnp.float64)
    free_pts = []
    while len(free_pts) < 10:
        p = rng.uniform(WMIN + 0.5, WMAX - 0.5)
        if float(esdf.at_points(jnp.asarray(p))) > 0.4:
            free_pts.append(p)
    pts = jnp.asarray(np.stack(free_pts))
    goals = jnp.asarray(np.tile([[4.0, 4.0, 1.0]], (10, 1)))
    bmin, bmax, ok = builder.expand_boxes(pts, goals)
    bmin, bmax = np.asarray(bmin), np.asarray(bmax)
    assert np.asarray(ok).all()
    # seed point inside the box
    assert (pts >= bmin - 1e-9).all() and (pts <= bmax + 1e-9).all()
    # box within world
    assert (bmin >= WMIN - 1e-6).all() and (bmax <= WMAX + 1e-6).all()
    # box interior is actually free: clearance at interior samples >= radius
    for b in range(10):
        for _ in range(30):
            q = rng.uniform(bmin[b] + 1e-3, np.maximum(
                bmax[b] - 1e-3, bmin[b] + 2e-3))
            d = float(esdf.at_points(jnp.asarray(q)))
            assert d > 0.15 - esdf.resolution, (b, q, d)
    # boxes are maximal-ish: strictly larger than the seed cell
    assert ((bmax - bmin).max(axis=1) > 0.5).all()


def test_forest_e2e(esdf):
    """4 agents crossing the forest with LSC + SFC + grid goal planning."""
    from lsc_planner_tpu.missions import Mission, AgentSpec
    from lsc_planner_tpu.sim.simulator import SyncSimulator

    esdf32 = esdf
    starts = [(-4.0, -4.0, 1.0), (4.0, 4.0, 1.0),
              (-4.0, 4.0, 1.0), (4.0, -4.0, 1.0)]
    goals = [(4.0, 4.0, 1.0), (-4.0, -4.0, 1.0),
             (4.0, -4.0, 1.0), (-4.0, 4.0, 1.0)]
    agents = []
    for qi, (s, g) in enumerate(zip(starts, goals)):
        a = AgentSpec(id=qi, cid=qi + 1)
        a.start, a.goal = np.asarray(s, float), np.asarray(g, float)
        agents.append(a)
    mission = Mission(world_min=WMIN, world_max=WMAX, agents=agents,
                      mission_file_name="forest4")
    # perfectly symmetric swaps rely on float tie-breaking; the reference
    # benchmark preset injects goal noise for exactly this reason
    # (multisim_max_noise=0.02, launch/simulation.launch:48)
    mission.add_noise(0.02, 3, rng=np.random.default_rng(7))
    p = Param(goal_mode=GoalMode.PRIOR_BASED, world_use_octomap=True,
              qp_iterations=14)
    sim = SyncSimulator(mission, p, esdf=esdf32, dtype=jnp.float64)
    summary = sim.run(max_iterations=400)
    assert summary["iterations"] < 400, "did not reach goals in forest"
    assert not summary["is_collided"]
    assert summary["safety_ratio_agent"] >= 1.0
    # also verify no collision with the static world along the way:
    # sampled clearance during flight must exceed the radius
    state = summary["final_state"]
    assert float(state.primal_res.max()) < 1e-5


def test_box_pair_planes():
    """Two overlapping boxes forming an L: the incut edge of the
    intersection must produce a separating plane that keeps the hull
    points in the union (SFC::update analog)."""
    from lsc_planner_tpu.planner.constraints import box_pair_planes
    # box1: [0,2]x[0,1]x[0,1]; box2: [1,3]x[0,2]x[0,1] -> L-shape in xy
    hull = np.array([[0.5, 0.5, 0.5], [1.5, 0.5, 0.5], [1.5, 1.5, 0.5]])
    pts, nrms = box_pair_planes(hull, [0, 0, 0], [2, 1, 1],
                                [1, 0, 0], [3, 2, 1])
    assert len(pts) >= 1
    # every returned plane keeps the hull on its nonnegative side
    for p, n in zip(pts, nrms):
        margins = (hull - p) @ n
        assert margins.min() > -1e-6
    # a point inside the incut corner region (x<1, y>1) must be cut off
    bad = np.array([0.2, 1.8, 0.5])
    assert any((bad - p) @ n < -1e-6 for p, n in zip(pts, nrms))


def test_box_pair_planes_disjoint():
    from lsc_planner_tpu.planner.constraints import box_pair_planes
    hull = np.array([[0.5, 0.5, 0.5]])
    pts, nrms = box_pair_planes(hull, [0, 0, 0], [1, 1, 1],
                                [2, 2, 2], [3, 3, 3])
    assert len(pts) == 0


def _bfs_distance(occ, goal):
    """Plain breadth-first 6-connected distance from `goal` (the goal
    cell counts as free; inf where unreachable)."""
    D = np.full(occ.shape, np.inf)
    D[tuple(goal)] = 0.0
    queue = collections.deque([tuple(goal)])
    while queue:
        c = queue.popleft()
        for ax in range(3):
            for s in (-1, 1):
                nb = list(c)
                nb[ax] += s
                nb = tuple(nb)
                if 0 <= nb[ax] < occ.shape[ax] and not occ[nb] and \
                        D[nb] == np.inf:
                    D[nb] = D[c] + 1.0
                    queue.append(nb)
    return D


def test_wavefront_matches_bfs_with_pockets(rng):
    """The XLA wavefront scan equals a plain BFS exactly, including
    unreachable pockets (walled-off cells stay inf)."""
    from lsc_planner_tpu.ops.grid_search import GridPlanner
    from lsc_planner_tpu.missions import make_circle_mission
    mission = make_circle_mission(2, radius=1.0,
                                  world=(0, 0, 0, 5.0, 5.0, 1.0))
    gp = GridPlanner(mission, Param(grid_resolution=0.25), esdf=None)
    assert tuple(gp.dims) == (21, 21, 5)
    occ = rng.random((21, 21, 5)) < 0.25
    # two sealed pockets: a boxed cell and a walled corner region
    occ[9:12, 9:12, 1:4] = True
    occ[10, 10, 2] = False
    occ[:4, 17:, :] = False
    occ[4, 17:, :] = True
    occ[:4, 16, :] = True
    goals = np.array([[20, 0, 4], [15, 3, 1]], np.int32)
    for g in goals:
        occ[tuple(g)] = False
        got = np.asarray(gp.wavefront(jnp.asarray(occ), jnp.asarray(g)))
        want = _bfs_distance(occ, g)
        assert np.isinf(want[10, 10, 2]) and np.isinf(want[0, 20, 0])
        assert gp.max_wavefront_iters >= np.max(want[np.isfinite(want)])
        np.testing.assert_array_equal(got, want)


def test_exact_castray_matches_reference_recursion(esdf, rng):
    """_ray_safe_bisect must reproduce the reference castRay recursion
    (grid_based_planner.cpp:409-433) point for point on the forest map."""
    from lsc_planner_tpu.ops.grid_search import GridPlanner
    from lsc_planner_tpu.missions import make_circle_mission

    p = Param(grid_los_exact_castray=True)
    mission = make_circle_mission(4, radius=3.0,
                                  world=(-5, -5, 0, 5, 5, 2.5))
    gp = GridPlanner(mission, p, esdf=esdf, dtype=jnp.float64)

    res = p.world_resolution
    eps = SP_EPSILON_FLOAT

    def castray_ref(a, b, margin):
        d2g = np.linalg.norm(a - b)
        thr = np.sqrt(0.25 * d2g * d2g + margin * margin)
        ca = float(esdf.at_points(jnp.asarray(a)))
        cb = float(esdf.at_points(jnp.asarray(b)))
        if ca < margin + 0.5 * res - eps:
            return False
        if cb < margin + 0.5 * res - eps:
            return False
        if thr < 1.0 and ca > thr and cb > thr:
            return True
        mid = 0.5 * (a + b)
        return castray_ref(a, mid, margin) and castray_ref(mid, b, margin)

    N, P = 4, 7
    origin = rng.uniform([-4, -4, 0.3], [4, 4, 2.0], size=(N, 3))
    pts = rng.uniform([-4.5, -4.5, 0.2], [4.5, 4.5, 2.3], size=(N, P, 3))
    radius = np.full(N, 0.15)
    ratios = np.asarray([1.5, 1.4, 1.3, 1.2, 1.1, 1.0])

    got = np.asarray(gp._ray_safe_bisect(
        jnp.asarray(pts), jnp.asarray(origin), jnp.asarray(radius),
        jnp.asarray(ratios)))
    for i in range(N):
        for r, ratio in enumerate(ratios):
            for j in range(P):
                want = castray_ref(origin[i], pts[i, j],
                                   radius[i] * ratio)
                assert got[i, r, j] == want, (i, r, j)


class TestMapping:
    def test_bt_writer_roundtrip(self, rng, tmp_path):
        from lsc_planner_tpu.world import mapping, octomap_io
        pts = rng.uniform(-5, 5, size=(2000, 3))
        keys = mapping.voxelize(pts, 0.25)
        mapping.save_bt(str(tmp_path / "cloud.bt"), keys, 0.25)
        tree = octomap_io.load_bt(str(tmp_path / "cloud.bt"))
        out = []
        for low, size in zip(tree.occupied_low, tree.occupied_size):
            for dx in range(size):
                for dy in range(size):
                    for dz in range(size):
                        out.append(low + np.array([dx, dy, dz]))
        out = np.unique(np.asarray(out), axis=0)
        np.testing.assert_array_equal(
            np.sort(out.tolist()), np.sort(keys.tolist()))

    def test_bt_writer_prunes_solid_cubes(self, tmp_path):
        from lsc_planner_tpu.world import mapping, octomap_io
        g = np.stack(np.meshgrid(*[np.arange(8)] * 3, indexing="ij"),
                     -1).reshape(-1, 3)
        mapping.save_bt(str(tmp_path / "cube.bt"), g, 0.1)
        tree = octomap_io.load_bt(str(tmp_path / "cube.bt"))
        assert len(tree.occupied_size) == 1
        assert tree.occupied_size[0] == 8

    def test_pcd_ascii_and_binary(self, rng, tmp_path):
        from lsc_planner_tpu.world import mapping
        pts = rng.normal(size=(64, 3)).astype(np.float32)
        p_ascii = tmp_path / "a.pcd"
        hdr = ("VERSION .7\nFIELDS x y z\nSIZE 4 4 4\nTYPE F F F\n"
               "COUNT 1 1 1\nWIDTH 64\nHEIGHT 1\n"
               "VIEWPOINT 0 0 0 1 0 0 0\nPOINTS 64\n")
        body = "\n".join(" ".join(f"{v:.7g}" for v in p) for p in pts)
        p_ascii.write_text(hdr + "DATA ascii\n" + body + "\n")
        got = mapping.load_pcd(str(p_ascii))
        np.testing.assert_allclose(got, pts, atol=1e-5)

        p_bin = tmp_path / "b.pcd"
        with open(p_bin, "wb") as f:
            f.write((hdr + "DATA binary\n").encode())
            f.write(pts.astype("<f4").tobytes())
        got = mapping.load_pcd(str(p_bin))
        np.testing.assert_allclose(got, pts, atol=1e-6)

    def test_pointcloud_to_planner_world(self, tmp_path):
        """Full pipeline: synthetic sensor cloud of a pillar -> .bt ->
        ESDF the planner can consume."""
        from lsc_planner_tpu.world import mapping
        from lsc_planner_tpu.world.esdf import ESDF
        zz, aa = np.meshgrid(np.linspace(0, 2.4, 40),
                             np.linspace(0, 2 * np.pi, 60))
        cloud = np.stack([1.0 + 0.3 * np.cos(aa), 0.3 * np.sin(aa), zz],
                         -1).reshape(-1, 3)
        out = str(tmp_path / "pillar.bt")
        mapping.pointcloud_to_bt(cloud, 0.2, out)
        esdf = ESDF.from_bt(out, (-3, -3, 0), (3, 3, 2.4))
        d_inside = float(esdf.at_points(jnp.asarray([[1.0, 0.0, 1.0]]))[0])
        d_far = float(esdf.at_points(jnp.asarray([[-2.5, -2.5, 1.0]]))[0])
        assert d_inside <= 0.31
        assert d_far == pytest.approx(1.0)   # dynamicEDT3D max_dist clamp


def test_office_bt_convention_autodetect():
    """office.bt uses the opposite occupied-bit convention from the
    forest worlds (reading it the forest way yields a 92 %-solid block);
    from_bt must auto-detect and return a plausible floor plan with the
    mission agents in free space."""
    import os
    path = "/root/reference/world/office.bt"
    if not os.path.exists(path):
        import pytest
        pytest.skip("reference assets not mounted")
    import json
    d = json.load(open(
        "/root/reference/missions/office/20agents/multi_random_20agents_1"
        ".json"))
    esdf = ESDF.from_bt(path, (-5, -7.5, 0), (5, 7.5, 2.5))
    occ_frac = float(np.asarray(esdf.occ).mean())
    assert 0.01 < occ_frac < 0.3, occ_frac
    pts = jnp.asarray([a["start"] for a in d["agents"]] +
                      [a["goal"] for a in d["agents"]])
    clear = np.asarray(esdf.at_points(pts))
    assert (clear >= 0.15).all(), clear.min()
