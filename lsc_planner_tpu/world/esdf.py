"""Euclidean signed-distance field + summed-area occupancy for SFC/A*.

Replaces octomap's dynamicEDT3D (DynamicEDTOctomap::update + getDistance,
the reference's single map-query API -- SURVEY.md L2->L1 interface).  The
EDT is precomputed once per world on the host (exact Felzenszwalb transform
via scipy) and shipped to the device as a dense grid; all per-cycle queries
are pure gathers.

For SFC box expansion the O(box volume) per-check scans of
CorridorConstructor::isObstacleInBox (corridor_constructor.hpp:81-122)
are replaced by an O(1) summed-area-table (3-D integral image) box count
with an inclusion-exclusion correction that reproduces the reference's
exact corner-sampling cell set.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..config import SP_EPSILON_FLOAT


@dataclasses.dataclass
class ESDF:
    """Dense euclidean distance field over the mission bbox.

    dist[i, j, k] = distance (m) from the center of voxel (origin_key + ijk)
    to the nearest occupied voxel center, clamped at max_dist -- the
    dynamicEDT3D convention (maxdist=1.0, treat-unknown-as-free, see
    multi_sync_simulator.cpp:153-167).
    Cell centers sit at (key + 0.5) * resolution.
    """
    dist: jnp.ndarray            # (X, Y, Z) float
    origin_key: np.ndarray       # (3,) int64
    resolution: float
    max_dist: float = 1.0
    occ: Optional[np.ndarray] = None   # host copy of the occupancy grid

    @classmethod
    def from_occupancy(cls, occ: np.ndarray, origin_key, resolution: float,
                       max_dist: float = 1.0, dtype=jnp.float32) -> "ESDF":
        d = None
        try:
            from .. import native
            if native.load() is not None and occ.any():
                d = native.edt3d(occ, resolution, max_dist)
        except Exception:
            d = None
        if d is None:
            from scipy import ndimage
            if occ.any():
                d = ndimage.distance_transform_edt(~occ,
                                                   sampling=resolution)
            else:
                d = np.full(occ.shape, np.inf)
            d = np.minimum(d, max_dist).astype(np.float32)
        return cls(dist=jnp.asarray(d, dtype),
                   origin_key=np.asarray(origin_key, np.int64),
                   resolution=float(resolution), max_dist=float(max_dist),
                   occ=occ)

    @classmethod
    def from_bt(cls, path: str, world_min, world_max,
                max_dist: float = 1.0, dtype=jnp.float32) -> "ESDF":
        """Load a .bt octomap and rasterize it over [world_min, world_max].

        The occupied-bit convention of the child descriptors is
        AUTO-DETECTED: the reference's shipped worlds disagree (the
        forest files read sensibly with the first bit, office.bt with
        the second -- see octomap_io.load_bt), so if a reading yields a
        mostly-solid bbox (> 50 % occupied: implausible for a world
        agents plan through) the opposite convention is used."""
        res = None
        try:
            from .. import native
            if native.load() is not None:
                res = native.bt_resolution(path)
        except Exception:
            res = None
        if res is not None and res > 0:
            from .. import native
            wmin = np.asarray(world_min, np.float64)
            wmax = np.asarray(world_max, np.float64)
            k0 = np.floor(wmin / res).astype(np.int64)
            k1 = np.floor(wmax / res).astype(np.int64)
            dims = k1 - k0 + 1
            occ = native.bt_rasterize(path, k0, dims)
            if occ.mean() <= 0.5:
                return cls.from_occupancy(occ, k0, res, max_dist, dtype)
            # implausible reading -> python parser, swapped bits
        from .octomap_io import load_bt, rasterize
        tree = load_bt(path)
        occ, k0 = rasterize(tree, world_min, world_max)
        if occ.mean() > 0.5:
            tree = load_bt(path, occupied_bit="second")
            occ, k0 = rasterize(tree, world_min, world_max)
        return cls.from_occupancy(occ, k0, tree.resolution, max_dist,
                                  dtype)

    @classmethod
    def from_boxes(cls, boxes, world_min, world_max,
                   resolution: float = 0.1, max_dist: float = 1.0,
                   dtype=jnp.float32) -> "ESDF":
        """Synthesize a distance field from mission `static` AABB
        obstacles alone (empty-world missions with walls).  The reference
        merges such boxes into the planner's occupancy grid
        (grid_based_planner.cpp:125-160); here they become first-class
        world geometry so the SFC corridor, wavefront grid planner, LOS
        checks, and mission-compatibility gate all see them."""
        world_min = np.asarray(world_min, np.float64)
        world_max = np.asarray(world_max, np.float64)
        k0 = np.floor(world_min / resolution).astype(np.int64)
        k1 = np.floor(world_max / resolution).astype(np.int64)
        dims = k1 - k0 + 1
        occ = np.zeros(tuple(dims), bool)
        base = cls(dist=jnp.full(tuple(dims), max_dist, dtype),
                   origin_key=k0, resolution=float(resolution),
                   max_dist=float(max_dist), occ=occ)
        return base.merge_boxes(boxes)

    def merge_boxes(self, boxes) -> "ESDF":
        """Fold AABB obstacles into this field: dist' = min(dist,
        analytic box distance) -- exact (sub-voxel) where the rasterized
        EDT is only cell-accurate -- and occ' marks interior cells."""
        boxes = np.asarray(boxes, np.float64).reshape(-1, 6)
        if boxes.shape[0] == 0:
            return self
        X, Y, Z = self.dist.shape
        res = self.resolution
        centers = (np.stack(np.meshgrid(
            np.arange(X), np.arange(Y), np.arange(Z), indexing="ij"),
            axis=-1) + 0.5 + self.origin_key) * res      # (X, Y, Z, 3)
        d = np.asarray(self.dist, np.float64)
        occ = (self.occ.copy() if self.occ is not None
               else np.zeros((X, Y, Z), bool))
        for lo_hi in boxes:
            lo, hi = lo_hi[:3], lo_hi[3:]
            q = np.maximum(np.maximum(lo - centers, centers - hi), 0.0)
            bd = np.sqrt(np.sum(q * q, axis=-1))
            d = np.minimum(d, bd)
            occ |= bd <= 0.0
        return dataclasses.replace(
            self, dist=jnp.asarray(np.minimum(d, self.max_dist),
                                   self.dist.dtype), occ=occ)

    # ------------------------------------------------------------------
    def at_points(self, pts):
        """getDistance at metric points (..., 3): nearest-cell lookup with
        clamped indices (out-of-grid treated as the border cell)."""
        res = self.resolution
        origin = jnp.asarray(self.origin_key, pts.dtype) * res
        idx = jnp.floor((pts - origin) / res).astype(jnp.int32)
        dims = jnp.asarray(self.dist.shape, jnp.int32)
        idx = jnp.clip(idx, 0, dims - 1)
        return self.dist[idx[..., 0], idx[..., 1], idx[..., 2]]


@dataclasses.dataclass
class OccupancySAT:
    """3-D integral image of a thresholded occupancy indicator.

    sat[i, j, k] = number of 'occupied-for-this-margin' cells in the
    prefix box [0, i) x [0, j) x [0, k).
    """
    sat: jnp.ndarray             # (X+1, Y+1, Z+1) int32
    origin_key: np.ndarray
    resolution: float
    margin: float

    @classmethod
    def build(cls, esdf: ESDF, margin: float) -> "OccupancySAT":
        """Threshold from isObstacleInBox (corridor_constructor.hpp:114):
        occupied iff dist < margin + 0.5*resolution - eps."""
        thr = margin + 0.5 * esdf.resolution - SP_EPSILON_FLOAT
        ind = (np.asarray(esdf.dist) < thr).astype(np.int32)
        sat = np.zeros(tuple(s + 1 for s in ind.shape), np.int32)
        sat[1:, 1:, 1:] = ind.cumsum(0).cumsum(1).cumsum(2)
        return cls(sat=jnp.asarray(sat),
                   origin_key=np.asarray(esdf.origin_key),
                   resolution=esdf.resolution, margin=margin)

    def _box_count(self, lo, hi):
        """Occupied-cell count in the cell box [lo, hi] inclusive; lo/hi
        (..., 3) int32 in grid-local cell indices.  Empty/out-of-range
        boxes count 0."""
        dims = jnp.asarray([self.sat.shape[0] - 1, self.sat.shape[1] - 1,
                            self.sat.shape[2] - 1], jnp.int32)
        lo_c = jnp.clip(lo, 0, dims)
        hi_c = jnp.clip(hi + 1, 0, dims)
        empty = jnp.any(hi_c <= lo_c, axis=-1)

        def at(ix, iy, iz):
            return self.sat[ix, iy, iz]

        x0, y0, z0 = lo_c[..., 0], lo_c[..., 1], lo_c[..., 2]
        x1, y1, z1 = hi_c[..., 0], hi_c[..., 1], hi_c[..., 2]
        c = (at(x1, y1, z1) - at(x0, y1, z1) - at(x1, y0, z1)
             - at(x1, y1, z0) + at(x0, y0, z1) + at(x0, y1, z0)
             + at(x1, y0, z0) - at(x0, y0, z0))
        return jnp.where(empty, 0, c)

    def box_obstructed(self, lo_corner, hi_corner, at_world_min):
        """Reference-exact isObstacleInBox over a lattice box.

        lo_corner/hi_corner: (..., 3) int32 ABSOLUTE voxel-corner indices
        (metric coordinate / resolution); at_world_min: (..., 3) bool --
        whether the box's low face sits at the world minimum (flips the
        corner-sampling delta, corridor_constructor.hpp:103-110).

        The sampled cell set per axis is {lo-1} u [lo+1, hi] away from the
        world boundary and [lo, hi] at it; reproduced by inclusion-
        exclusion over the per-axis excluded plane {lo}.  A zero-width
        axis (hi == lo) samples the plane from both sides, {lo-1, lo},
        so it has no excluded plane.
        """
        k0 = jnp.asarray(self.origin_key, jnp.int32)
        lo = lo_corner - k0
        hi = hi_corner - k0
        # base cell box per axis: [lo-1 + bound, hi]
        bound = at_world_min.astype(jnp.int32)
        a = lo - 1 + bound
        b = hi
        total = jnp.zeros(lo.shape[:-1], jnp.int32)
        for mask in range(8):
            T = [(mask >> ax) & 1 for ax in range(3)]
            # term: axes in T fixed to the excluded plane cell index lo_ax
            t_lo = jnp.stack(
                [jnp.where(T[ax] == 1, lo[..., ax], a[..., ax])
                 for ax in range(3)], axis=-1)
            t_hi = jnp.stack(
                [jnp.where(T[ax] == 1, lo[..., ax], b[..., ax])
                 for ax in range(3)], axis=-1)
            cnt = self._box_count(t_lo, t_hi)
            # a bound or zero-width axis has no excluded plane: its T=1
            # terms vanish
            valid = jnp.ones(lo.shape[:-1], bool)
            for ax in range(3):
                if T[ax]:
                    valid = valid & (bound[..., ax] == 0) & \
                        (hi[..., ax] > lo[..., ax])
            sign = (-1) ** sum(T)
            total = total + jnp.where(valid, sign * cnt, 0)
        return total > 0
