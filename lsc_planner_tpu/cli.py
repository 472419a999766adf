"""Command-line entry point: run missions, sweeps, and replays.

Reference: multi_sync_simulator_node (src/multi_sync_simulator_node.cpp)
plus the testall_* launch harness -- a mission argument that is a file runs
once; a directory is swept recursively, appending one summary row per run
(param.cpp:106-141, multi_sync_simulator_node.cpp:43-75).

Usage:
  python -m lsc_planner_tpu.cli --mission path/to/mission.json
  python -m lsc_planner_tpu.cli --mission missions_dir --world world.bt
  python -m lsc_planner_tpu.cli --replay result.csv
  python -m lsc_planner_tpu.cli --generate circle:20 --out mission.json
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import sys

import numpy as np


def build_parser():
    ap = argparse.ArgumentParser(prog="lsc_planner_tpu")
    ap.add_argument("--mission", help="mission JSON file or directory")
    ap.add_argument("--world", default="", help="octomap .bt file")
    ap.add_argument("--param", default="", help="param JSON overrides")
    ap.add_argument("--log-dir", default="log")
    ap.add_argument("--save-result", action="store_true")
    ap.add_argument("--max-iterations", type=int, default=None)
    ap.add_argument("--replay", help="replay a result CSV")
    ap.add_argument("--generate",
                    help="generate a mission: circle:N | square:N | "
                         "random:N[:seed]")
    ap.add_argument("--out", default="mission.json")
    ap.add_argument("--dtype", default="float32",
                    choices=["float32", "float64"])
    ap.add_argument("--platform", default="",
                    help="jax platform to run on (cpu/gpu); default: JAX's "
                         "own choice.  The run's JSON summary names the "
                         "backend it ran on")
    ap.add_argument("--plot", default="",
                    help="render the run to this PNG (requires "
                         "--save-result)")
    ap.add_argument("--set", action="append", default=[],
                    help="param override key=value (repeatable)")
    return ap


def _load_param(args):
    from .config import Param
    d = {}
    if args.param:
        with open(args.param) as f:
            d.update(json.load(f))
    for kv in args.set:
        k, _, v = kv.partition("=")
        try:
            v = json.loads(v)
        except json.JSONDecodeError:
            pass
        d[k] = v
    if args.world:
        d.setdefault("world_use_octomap", True)
    return Param.from_dict(d)


def run_one(mission_path: str, args, param, world: str = None) -> dict:
    import jax
    import jax.numpy as jnp
    from .missions import load_mission
    from .sim.simulator import SyncSimulator
    from .sim.logging import ResultLogger, append_summary

    if world is None:
        world = args.world
    mission = load_mission(mission_path, param,
                           world_file_name=world)
    esdf = None
    if world:
        from .world.esdf import ESDF
        esdf = ESDF.from_bt(world, mission.world_min,
                            mission.world_max)
    dtype = jnp.float64 if args.dtype == "float64" else jnp.float32
    sim = SyncSimulator(mission, param, esdf=esdf, dtype=dtype)
    log = None
    if args.save_result:
        # sim.O_dyn excludes mission `static` boxes (world geometry, not
        # logged as moving obstacles)
        log = ResultLogger(args.log_dir, sim.param, mission.qn,
                           sim.O_dyn)
    summary = sim.run(max_iterations=args.max_iterations, log=log)
    summary.pop("final_state", None)
    if args.save_result:
        append_summary(args.log_dir, sim.param, mission.qn, summary,
                       mission_file=mission_path, world_file=world)
        if args.plot:
            from .sim.replay import read_result_csv
            from .sim.visualize import plot_run
            data = read_result_csv(log.path)
            plot_run(data, args.plot,
                     world_min=mission.world_min,
                     world_max=mission.world_max,
                     occupancy=esdf.occ if esdf is not None else None,
                     occ_origin=esdf.origin_key if esdf is not None
                     else None,
                     occ_resolution=esdf.resolution if esdf is not None
                     else None)
            print(f"plot written to {args.plot}")
    dev = jax.devices()[0]
    print(json.dumps({"mission": mission_path,
                      "backend": dev.platform,
                      "device_kind": dev.device_kind, **{
                          k: v for k, v in summary.items()
                          if not hasattr(v, "shape")}}))
    return summary


def main(argv=None):
    args = build_parser().parse_args(argv)

    import jax
    from .runtime import enable_compilation_cache
    enable_compilation_cache()
    if args.platform:
        jax.config.update("jax_platforms", args.platform)
    if args.dtype == "float64":
        # without x64 enabled JAX silently truncates requested f64 arrays
        # to f32, defeating validation runs
        jax.config.update("jax_enable_x64", True)

    if args.generate:
        from .missions import (make_circle_mission, make_square_mission,
                               make_random_mission)
        kind, _, rest = args.generate.partition(":")
        parts = rest.split(":")
        n = int(parts[0])
        if kind == "circle":
            m = make_circle_mission(n)
        elif kind == "square":
            m = make_square_mission(n)
        elif kind == "random":
            seed = int(parts[1]) if len(parts) > 1 else 0
            m = make_random_mission(n, seed=seed)
        else:
            raise SystemExit(f"unknown generator {kind}")
        m.save(args.out)
        print(f"wrote {args.out} ({m.qn} agents)")
        return 0

    if args.replay:
        from .sim.replay import read_result_csv
        data = read_result_csv(args.replay)
        print(json.dumps({
            "agents": data.qn, "rows": len(data.t),
            "t_final": float(data.t[-1]),
            "total_distance": float(np.sum(np.linalg.norm(
                np.diff(data.pos, axis=0), axis=-1))),
        }))
        return 0

    if not args.mission:
        build_parser().print_help()
        return 1

    param = _load_param(args)
    if os.path.isdir(args.mission):
        files = sorted(glob.glob(os.path.join(args.mission, "**", "*.json"),
                                 recursive=True))
        worlds = [args.world] * len(files)
        if args.world and os.path.isdir(args.world):
            # the reference's testall sweeps pair the lexicographically
            # sorted mission list with the sorted world list index-wise
            # (param.cpp:106-141: both collected via std::set)
            worlds = sorted(glob.glob(os.path.join(args.world, "**",
                                                   "*.bt"),
                            recursive=True))
            if len(worlds) != len(files):
                raise SystemExit(
                    f"world dir has {len(worlds)} .bt files but mission "
                    f"dir has {len(files)} .json files")
        for f, w in zip(files, worlds):
            run_one(f, args, param, world=w)
    else:
        run_one(args.mission, args, param)
    return 0


if __name__ == "__main__":
    sys.exit(main())
