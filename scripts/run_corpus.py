#!/usr/bin/env python
"""Run the reference's 279-mission benchmark corpus (testall analog).

Reference: launch/testall_{empty,forest,office}.launch +
param.cpp:106-141 + multi_sync_simulator_node.cpp:43-75 -- the de-facto
quality proof of the reference is this batch sweep, one summary row per
mission.  This driver runs the SAME shipped mission JSONs (and world
pairings) through the batched pipeline and writes:

  results/corpus_<tag>.csv     one row per run (reference summary analog)
  results/CORPUS_<tag>.md      aggregate success-rate table

Scenario sets (exactly the reference's):
  empty   missions/empty/{10..60}agents/*.json       (180, no octomap)
  forest  missions/forest/20agents/*.json x world/forest/*.bt
          paired lexicographically (param.cpp std::set order)   (30)
  office  missions/office/20agents/*.json x world/office.bt     (30)
  named   circle20 / square16+simple_forest / simple3 / simple4 ...

Usage:
  python scripts/run_corpus.py --scenario all --platform gpu
  python scripts/run_corpus.py --scenario empty --limit 3 --platform cpu
"""
import argparse
import csv
import glob
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

REF = "/root/reference"


def mission_list(scenario):
    """Yield (scenario, mission_path, world_path_or_None)."""
    out = []
    if scenario in ("empty", "all"):
        for f in sorted(glob.glob(
                f"{REF}/missions/empty/**/*.json", recursive=True)):
            out.append(("empty", f, None))
    if scenario in ("forest", "all"):
        ms = sorted(glob.glob(f"{REF}/missions/forest/**/*.json",
                              recursive=True))
        ws = sorted(glob.glob(f"{REF}/world/forest/**/*.bt",
                              recursive=True))
        assert len(ms) == len(ws), (len(ms), len(ws))
        out += [("forest", m, w) for m, w in zip(ms, ws)]
    if scenario in ("office", "all"):
        for f in sorted(glob.glob(f"{REF}/missions/office/**/*.json",
                                  recursive=True)):
            out.append(("office", f, f"{REF}/world/office.bt"))
    if scenario in ("named", "all"):
        # every shipped named mission except multi_empty.json (an
        # agent-less template the reference fills from multisim/qn,
        # mission.cpp:321-335 -- not a benchmark scenario)
        named = [("multi_circle20.json", None),
                 ("multi_simple3.json", None),
                 ("multi_simple4.json", None),
                 ("multi_square8.json", None),
                 ("multi_exp_circle16.json", None),
                 ("multi_exp_initial16.json", None),
                 ("multi_exp_maze10.json", None),
                 ("multi_square16.json", f"{REF}/world/simple_forest.bt")]
        for m, w in named:
            out.append(("named", f"{REF}/missions/{m}", w))
    return out


FIELDS = ["scenario", "mission", "world", "qn", "finished", "iterations",
          "flight_time_s", "distance_m", "is_collided", "min_safety",
          "avg_plan_ms", "wall_s", "error"]


def run_one(scenario, mpath, wpath, args, param):
    import jax.numpy as jnp
    from lsc_planner_tpu.missions import load_mission
    from lsc_planner_tpu.sim.simulator import SyncSimulator

    t0 = time.perf_counter()
    # missions/empty/50agents/0816/ is a DISTINCT archived mission set
    # whose files share basenames with 50agents/ proper (both are part
    # of the reference's recursive testall sweep, param.cpp:110-122);
    # keep the subdir in the row key so the two sets don't collapse.
    mname = os.path.basename(mpath)
    if "/0816/" in mpath:
        mname = "0816/" + mname
    row = {"scenario": scenario, "mission": mname,
           "world": os.path.basename(wpath) if wpath else "",
           "error": ""}
    try:
        p = param
        if wpath:
            import dataclasses as _dc; p = _dc.replace(param, world_use_octomap=True)
        mission = load_mission(mpath, p, world_file_name=wpath or "")
        esdf = None
        if wpath:
            from lsc_planner_tpu.world.esdf import ESDF
            esdf = ESDF.from_bt(wpath, mission.world_min,
                                mission.world_max)
        dtype = jnp.float64 if args.dtype == "float64" else jnp.float32
        sim = SyncSimulator(mission, p, esdf=esdf, dtype=dtype)
        summary = sim.run(max_iterations=args.max_iterations,
                          steps_per_dispatch=args.steps_per_dispatch)
        import math
        finished = (summary["iterations"] < args.max_iterations and
                    not math.isnan(summary["total_flight_time"]))
        row.update(qn=mission.qn, finished=finished,
                   iterations=summary["iterations"],
                   flight_time_s=round(summary["total_flight_time"], 2),
                   distance_m=round(summary["total_flight_distance"], 2),
                   is_collided=summary["is_collided"],
                   min_safety=round(summary["safety_ratio_agent"], 4),
                   avg_plan_ms=round(
                       summary["average_planning_time"] * 1e3, 3))
    except Exception as e:  # noqa: BLE001 -- a sweep must survive any run
        row.update(qn=0, finished=False, iterations=0, flight_time_s=0,
                   distance_m=0, is_collided=True, min_safety=0,
                   avg_plan_ms=0, error=f"{type(e).__name__}: {e}")
    row["wall_s"] = round(time.perf_counter() - t0, 1)
    return row


def aggregate(rows):
    """Aggregate success table: scenario x qn."""
    groups = {}
    for r in rows:
        key = (r["scenario"], r["qn"])
        groups.setdefault(key, []).append(r)
    lines = ["| scenario | agents | runs | success | collided | "
             "avg flight (s) | avg dist (m) | min safety (worst) |",
             "|---|---|---|---|---|---|---|---|"]
    for (sc, qn), g in sorted(groups.items()):
        succ = [r for r in g
                if r["finished"] and not r["is_collided"]
                and float(r["min_safety"]) >= 1.0]
        coll = [r for r in g if r["is_collided"]]
        ft = [float(r["flight_time_s"]) for r in succ]
        dd = [float(r["distance_m"]) for r in succ]
        ws = min((float(r["min_safety"]) for r in g
                  if float(r["min_safety"]) > 0), default=0)
        lines.append(
            f"| {sc} | {qn} | {len(g)} | {len(succ)} | {len(coll)} | "
            f"{sum(ft)/len(ft):.1f} | {sum(dd)/len(dd):.1f} | {ws:.4f} |"
            if succ else
            f"| {sc} | {qn} | {len(g)} | 0 | {len(coll)} | - | - | "
            f"{ws:.4f} |")
    return "\n".join(lines)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--scenario", default="all",
                    choices=["empty", "forest", "office", "named", "all"])
    ap.add_argument("--platform", default="")
    ap.add_argument("--dtype", default="float32")
    ap.add_argument("--steps-per-dispatch", type=int, default=10)
    ap.add_argument("--max-iterations", type=int, default=600)
    ap.add_argument("--limit", type=int, default=0)
    ap.add_argument("--tag", default="r03")
    ap.add_argument("--qn", type=int, default=0,
                    help="restrict empty sweep to this agent count")
    args = ap.parse_args()

    import jax
    from lsc_planner_tpu.runtime import enable_compilation_cache
    enable_compilation_cache()
    if args.platform:
        jax.config.update("jax_platforms", args.platform)
    if args.dtype == "float64":
        jax.config.update("jax_enable_x64", True)

    from lsc_planner_tpu.config import Param, GoalMode
    param = Param(goal_mode=GoalMode.PRIOR_BASED)

    runs = mission_list(args.scenario)
    if args.qn:
        runs = [r for r in runs if f"/{args.qn}agents/" in r[1]]
    if args.limit:
        # spread the limit across scenario groups (first k of each)
        by_group = {}
        for r in runs:
            by_group.setdefault((r[0], os.path.dirname(r[1])),
                                []).append(r)
        runs = [r for g in by_group.values() for r in g[:args.limit]]

    os.makedirs("results", exist_ok=True)
    csv_path = f"results/corpus_{args.tag}.csv"
    exists = os.path.exists(csv_path)
    done = set()
    if exists:
        with open(csv_path) as f:
            for r in csv.DictReader(f):
                if not r["error"]:
                    done.add((r["scenario"], r["mission"]))
    rows = []
    with open(csv_path, "a", newline="") as f:
        wr = csv.DictWriter(f, FIELDS)
        if not exists:
            wr.writeheader()
        for i, (sc, m, w) in enumerate(runs):
            if (sc, os.path.basename(m)) in done:
                continue
            row = run_one(sc, m, w, args, param)
            wr.writerow(row)
            f.flush()
            rows.append(row)
            ok = ("OK" if row["finished"] and not row["is_collided"]
                  else "FAIL")
            print(f"[{i+1}/{len(runs)}] {ok} {sc}/{row['mission']} "
                  f"qn={row['qn']} it={row['iterations']} "
                  f"safety={row['min_safety']} wall={row['wall_s']}s "
                  f"{row['error']}", flush=True)

    # aggregate over the FULL csv (including prior partial runs),
    # keeping only the LATEST row per mission (reruns supersede errors)
    with open(csv_path) as f:
        latest = {}
        for r in csv.DictReader(f):
            latest[(r["scenario"], r["mission"])] = r
        all_rows = list(latest.values())
    for r in all_rows:
        r["qn"] = int(r["qn"])
        r["finished"] = r["finished"] in ("True", True)
        r["is_collided"] = r["is_collided"] in ("True", True)
    md = aggregate(all_rows)
    with open(f"results/CORPUS_{args.tag}.md", "w") as f:
        f.write(
            f"# Corpus evaluation ({args.tag})\n\n"
            f"Reference mission corpus (`/root/reference/missions/`, the\n"
            f"testall_* sweep sets) through the batched pipeline.\n"
            f"platform={jax.devices()[0].platform}, dtype={args.dtype}, "
            f"steps_per_dispatch={args.steps_per_dispatch}, "
            f"qp_iterations=default(40 cap, early exit), goal_mode=prior_based, LSC.\n"
            f"success = finished within cap AND zero collisions AND "
            f"min safety ratio >= 1.\n\n{md}\n")
    print(md)


if __name__ == "__main__":
    main()
