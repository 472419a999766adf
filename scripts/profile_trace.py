#!/usr/bin/env python
"""Per-stage device time of the production planning cycle, from a trace.

For each cell (bench.py's 16-, 64- and 1024-agent circles and the
20-agent obstacle mission of chip_smoke.py phase 4) this warms
`make_scan_cycle(10)`, times 3 untraced dispatches on the host clock,
then records one dispatch (10 cycles) with jax.profiler and reduces the
device plane to:

  * busy time (union of kernel intervals) and idle share of the window
    from the first kernel's start to the last kernel's end;
  * device time per stage.  Each kernel's HLO instruction (its `hlo_op`
    annotation, or, for kernels that XLA launches inside a CUDA-graph
    command buffer, the instruction named by the kernel's own name) is
    looked up in the compiled module, whose metadata keeps the Python
    call stack that traced it (a fusion keeps its root's).  A Cholesky or triangular-solve
    instruction (or library call), or a frame in `_cholesky` or
    `_chol_solve` (ops/qp.py), makes it the IPM's factorisation and
    substitutions; a frame in `wavefront` (ops/grid_search.py) the
    wavefront; otherwise the innermost frame's file names the stage: the
    rest of the IPM (ops/qp.py), QP assembly (planner/optimizer.py), and
    so on.

Usage:
    python scripts/profile_trace.py [--cells 16,64,1024,forest20]
                                    [--out chiprun_out/trace]

Writes <out>/<cell>.json (the reduction, plus device time per HLO
instruction) and prints one line per cell.  Needs a GPU; --cpu runs the
same reduction on JAX's CPU backend for a dry run.  --no-command-buffer
launches every kernel on its own (XLA_FLAGS
--xla_gpu_enable_command_buffer=): kernel times stay, the gaps between
kernels do not, so use it to check the attribution, not the idle share.
"""
import argparse
import collections
import glob
import json
import os
import re
import shutil
import sys
import time

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))
sys.path.insert(0, ROOT)

STAGE_FILES = [            # (path suffix, stage); first match wins
    ("lsc_planner_tpu/ops/qp.py", "qp: IPM (rest)"),
    ("lsc_planner_tpu/planner/optimizer.py", "qp: assembly + recovery"),
    ("lsc_planner_tpu/ops/grid_search.py", "goal: grid (rest)"),
    ("lsc_planner_tpu/planner/goal.py", "goal: priority rules"),
    ("lsc_planner_tpu/planner/constraints.py", "lsc/sfc constraints"),
    ("lsc_planner_tpu/ops/hull.py", "lsc/sfc constraints"),
    ("lsc_planner_tpu/ops/geometry.py", "lsc/sfc constraints"),
    ("lsc_planner_tpu/world/corridor.py", "sfc corridor"),
    ("lsc_planner_tpu/world/esdf.py", "sfc corridor"),
    ("lsc_planner_tpu/planner/prediction.py", "prediction + rollout"),
    ("lsc_planner_tpu/ops/bernstein.py", "prediction + rollout"),
    ("lsc_planner_tpu/sim/audit.py", "audit"),
    ("lsc_planner_tpu/sim/simulator.py", "cycle glue (knn, rescue)"),
]


FACTOR = "qp: factorisation + substitutions"
# HLO opcodes / library-call targets of the factorisation + substitutions
FACTOR_OPS = re.compile(r"cholesky|triangular|potrf|trsm", re.I)
STAGE_FUNCTIONS = {      # (path suffix, function) -> stage
    ("lsc_planner_tpu/ops/qp.py", "_cholesky"): FACTOR,
    ("lsc_planner_tpu/ops/qp.py", "_chol_solve"): FACTOR,
    ("lsc_planner_tpu/ops/grid_search.py", "wavefront"): "goal: wavefront",
}


def _table(text, section):
    """Rows `<id> <rest>` of one section of the HLO text's header."""
    m = re.search(rf"^{section}\n(.*?)(?:\n\n|\Z)", text, re.S | re.M)
    rows = {}
    for line in (m.group(1).splitlines() if m else []):
        key, _, rest = line.strip().partition(" ")
        rows[int(key)] = rest
    return rows


def _field(row, name):
    return int(re.search(rf"{name}=(\d+)", row).group(1))


def instruction_stacks(hlo_text):
    """HLO instruction name -> (kind, [(file, function, line)] innermost
    first): kind is the opcode or library-call target, the stack comes
    from the module's stack-frame tables."""
    files = {k: v.strip('"') for k, v in _table(hlo_text, "FileNames")
             .items()}
    funcs = {k: v.strip('"') for k, v in _table(hlo_text, "FunctionNames")
             .items()}
    locs = {k: (files.get(_field(v, "file_name_id")),
                funcs.get(_field(v, "function_name_id")),
                _field(v, "line"))
            for k, v in _table(hlo_text, "FileLocations").items()}
    frames = {k: (_field(v, "file_location_id"),
                  _field(v, "parent_frame_id"))
              for k, v in _table(hlo_text, "StackFrames").items()}
    stacks = {}
    for line in hlo_text.splitlines():
        m = re.match(r"^\s*(?:ROOT\s+)?%?([\w.\-]+)\s*=\s*(.*)$", line)
        if not m:
            continue
        rest = m.group(2)
        target = re.search(r'custom_call_target="([^"]+)"', rest)
        op = re.search(r"\s([a-z][\w\-]*)\(", " " + rest)
        kind = target.group(1) if target else (op.group(1) if op else "")
        chain, seen = [], set()
        fm = re.search(r"stack_frame_id=(\d+)", rest)
        fid = int(fm.group(1)) if fm else None
        while fid in frames and fid not in seen:
            seen.add(fid)
            loc, parent = frames[fid]
            chain.append(locs.get(loc))
            fid = parent
        stacks[m.group(1)] = (kind, chain)
    return stacks


def stage_of(entry):
    kind, stack = entry if entry else ("", [])
    if FACTOR_OPS.search(kind):
        return FACTOR
    if not stack:
        return "unattributed"
    for frame in stack:
        for (suffix, func), stage in STAGE_FUNCTIONS.items():
            if frame and frame[0].endswith(suffix) and \
                    func in frame[1].split("."):
                return stage
    path = stack[0][0] if stack[0] else ""
    for suffix, stage in STAGE_FILES:
        if path.endswith(suffix):
            return stage
    return "other"


def busy_ns(intervals):
    total, end = 0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


LIBRARY_KERNELS = [        # kernel-name pattern -> HLO kind, for
    (re.compile(r"potrf|chol", re.I), "cusolver_potrf"),  # library calls
    (re.compile(r"trsm", re.I), "__cublas$triangularSolve"),  # in graphs
    (re.compile(r"gemm|gemv|cutlass", re.I), "__cublas$gemm"),
]


def resolve(op, name, stacks):
    """(instruction, stacks entry) of one kernel event."""
    if op in stacks and op != "command_buffer":
        return op, stacks[op]
    base = name.split("(")[0].strip()
    for cand in (base, re.sub(r"_(\d+)$", r".\1", base)):
        if cand in stacks:
            return cand, stacks[cand]
    for pattern, kind in LIBRARY_KERNELS:
        if pattern.search(base):
            return f"library:{kind}", (kind, [])
    return f"{op}:{base[:60]}", None


def reduce_trace(path, stacks, device_prefix):
    """Device busy/idle and time per stage from one .xplane.pb."""
    from jax.profiler import ProfileData
    pd = ProfileData.from_file(path)
    planes = [p for p in pd.planes if p.name.startswith(device_prefix)]
    inventory, kernels = [], []
    for plane in planes:
        for line in plane.lines:
            evs = list(line.events)
            with_op = [e for e in evs if "hlo_op" in dict(e.stats)]
            inventory.append({"plane": plane.name, "line": line.name,
                              "events": len(evs), "with_hlo_op":
                              len(with_op)})
            # kernel lines: one event per kernel/op execution; the
            # per-module and per-step summary lines would double count
            if re.search(r"module|step|launch|source", line.name, re.I):
                continue
            kernels += [(e, dict(e.stats)) for e in with_op]
    if not kernels:
        return {"inventory": inventory, "error": "no device kernels found"}
    spans = [(e.start_ns, e.start_ns + e.duration_ns) for e, _ in kernels]
    t0 = min(s for s, _ in spans)
    t1 = max(e for _, e in spans)
    busy = busy_ns(spans)
    per_stage = collections.Counter()
    per_op = collections.Counter()
    resolved = {}
    for e, st in kernels:
        op, entry = resolve(st["hlo_op"], e.name, stacks)
        resolved[op] = entry
        per_op[op] += e.duration_ns
        per_stage[stage_of(entry)] += e.duration_ns
    kernel_sum = sum(per_stage.values())
    return {
        "window_ms": (t1 - t0) / 1e6,
        "busy_ms": busy / 1e6,
        "idle_share": 1.0 - busy / max(t1 - t0, 1),
        "kernel_time_ms": kernel_sum / 1e6,
        "kernels": len(kernels),
        "stages_ms": {k: v / 1e6 for k, v in per_stage.most_common()},
        "stage_share": {k: v / kernel_sum for k, v in
                        per_stage.most_common()},
        "top_ops_ms": {k: v / 1e6 for k, v in per_op.most_common(40)},
        "op_stacks": {k: ((resolved[k] or ("", []))[0],
                          (resolved[k] or ("", []))[1][:3])
                      for k, _ in per_op.most_common(40)},
        "inventory": inventory,
    }


def make_sim(cell):
    import chip_smoke
    from lsc_planner_tpu.sim.simulator import SyncSimulator
    if cell == "forest20":
        return SyncSimulator(chip_smoke.forest_mission(20),
                             chip_smoke.circle_param(-1))
    qn = int(cell)
    return chip_smoke.circle_sim(qn, 32 if qn >= 1024 else -1)


def profile_cell(cell, out_dir, device_prefix):
    import jax
    import numpy as np
    sim = make_sim(cell)
    multi = sim.make_scan_cycle(10)
    state = sim.initial_state()
    t0 = time.perf_counter()
    compiled = multi.lower(state).compile()
    t_compile = time.perf_counter() - t0
    stacks = instruction_stacks(compiled.as_text())
    for _ in range(2):                    # warm: into the crossing phase
        state, _ = multi(state)
    state.traj.block_until_ready()
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        state, _ = multi(state)
        state.traj.block_until_ready()
        walls.append((time.perf_counter() - t0) / 10)
    trace_dir = os.path.join(out_dir, f"xplane_{cell}")
    shutil.rmtree(trace_dir, ignore_errors=True)
    jax.profiler.start_trace(trace_dir)
    state, (info, _, _) = multi(state)
    state.traj.block_until_ready()
    jax.profiler.stop_trace()
    files = glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"),
                      recursive=True)
    red = reduce_trace(files[0], stacks, device_prefix)
    shutil.rmtree(trace_dir, ignore_errors=True)
    stats = jax.devices()[0].memory_stats() or {}
    red.update({
        "cell": cell, "agents": sim.N,
        "compile_s": t_compile,
        "wall_ms_per_cycle": [1e3 * w for w in walls],
        "qp_iters": [int(v) for v in np.asarray(info.qp_iters)],
        "safety_agent_min": float(state.safety_agent_min),
        "peak_bytes_in_use": stats.get("peak_bytes_in_use"),
    })
    return red


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cells", default="16,64,1024,forest20")
    ap.add_argument("--out", default=os.path.join(ROOT, "chiprun_out",
                                                  "trace"))
    ap.add_argument("--cpu", action="store_true",
                    help="dry run on the CPU backend (no device metrics)")
    ap.add_argument("--no-command-buffer", action="store_true",
                    help="launch kernels one by one (attribution check)")
    args = ap.parse_args()
    if args.no_command_buffer:
        os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") +
                                   " --xla_gpu_enable_command_buffer=")
    import jax
    from lsc_planner_tpu.runtime import (enable_compilation_cache,
                                         gpu_device_info)
    enable_compilation_cache()
    if args.cpu:
        device, prefix = {"kind": "cpu", "nvidia_smi": []}, "/host:CPU"
    else:
        device, prefix = gpu_device_info(), "/device:GPU"
    print(f"device {device['kind']} {device['nvidia_smi']} "
          f"jax {jax.__version__}", flush=True)
    os.makedirs(args.out, exist_ok=True)
    for cell in args.cells.split(","):
        red = profile_cell(cell, args.out, prefix)
        red["device"] = device
        red["xla_flags"] = os.environ.get("XLA_FLAGS", "")
        with open(os.path.join(args.out, f"{cell}.json"), "w") as f:
            json.dump(red, f, indent=1)
        stages = ", ".join(f"{k} {v:.3f}" for k, v in
                           red.get("stages_ms", {}).items())
        print(f"cell {cell}: wall {red['wall_ms_per_cycle']} ms/cycle, "
              f"window {red.get('window_ms', 0):.3f} ms / 10 cycles, "
              f"idle share {red.get('idle_share', float('nan')):.3f}, "
              f"stages (ms / 10 cycles): {stages}", flush=True)


if __name__ == "__main__":
    main()
