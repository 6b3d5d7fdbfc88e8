#!/usr/bin/env python
"""Profile one batch solve on the GPU and attribute its device time to the
inner-ADMM stages.

Runs ``solve_lowrank_multi_pair_batch`` on the bench workload (16x16,
m=1024, batch 64, library defaults) once to compile, then traces one more
call with ``jax.profiler`` and reduces the trace to:

  - device busy time of the traced call, per device line;
  - device time of the ops under each named scope of the ADMM body
    (``admm_x_update``, ``admm_prox_dual``, ``admm_zprox``), and their
    shares of the busy time;
  - the most expensive ops with their counts.

An op is attributed to a scope when its op names carry the scope: the
trace event's ``tf_op`` stat, and the op_name metadata of its HLO
instruction (and, for a fusion, of every instruction it fuses) in the
optimized HLO that ``--xla_dump_to`` wrote (pass ``--hlo-dir`` with the
same directory).  A fusion spanning several scopes counts as "mixed".

Usage (on a GPU host)::

    XLA_FLAGS="--xla_dump_to=/tmp/hlo --xla_dump_hlo_as_text \\
      --xla_dump_hlo_module_re=.*batch.*" \\
      python scripts/trace_batch.py --out chiprun_out/trace_batch.json \\
      --hlo-dir /tmp/hlo
"""

from __future__ import annotations

import argparse
import collections
import glob
import json
import os
import re
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCOPES = ("admm_x_update", "admm_prox_dual", "admm_zprox")
_INSTR = re.compile(r'^\s*(?:ROOT\s+)?%?([\w.\-]+)\s*=')
_CALLS = re.compile(r'calls=%?([\w.\-]+)')
_OPNAME = re.compile(r'op_name="([^"]*)"')
_COMP = re.compile(r'^(?:ENTRY\s+)?%?([\w.\-]+)\s.*\{\s*$')


def parse_hlo(text: str) -> dict:
    """``{instruction: set of op_name metadata}`` of one optimized HLO
    module; a fusion (or any caller) also takes the op names of the
    computation it calls, so a fused kernel carries every stage it fuses."""
    comp_ops = collections.defaultdict(set)
    instr_ops, instr_calls = {}, {}
    comp = None
    for line in text.splitlines():
        m = _COMP.match(line)
        if m and "=" not in line.split("{")[0]:
            comp = m.group(1)
            continue
        m = _INSTR.match(line)
        if not m:
            continue
        ops = set(_OPNAME.findall(line))
        instr_ops[m.group(1)] = ops
        if comp is not None:
            comp_ops[comp] |= ops
        c = _CALLS.search(line)
        if c:
            instr_calls[m.group(1)] = c.group(1)
    for instr, callee in instr_calls.items():
        instr_ops[instr] = instr_ops[instr] | comp_ops.get(callee, set())
    return instr_ops


def hlo_op_names(hlo_dir: str) -> dict:
    """``{module: {instruction: op names}}`` from the optimized HLO dumps
    (``module_NNNN.<module>.<...>after_optimizations.txt``)."""
    names = {}
    for path in glob.glob(os.path.join(hlo_dir, "*after_optimizations.txt")):
        module = os.path.basename(path).split(".")[1]
        with open(path) as f:
            names[module] = parse_hlo(f.read())
    return names


def _op_names(op_names: dict, module: str, instr: str) -> set:
    for mod, table in op_names.items():
        if module.startswith(mod) and instr in table:
            return table[instr]
    return set()


def scope_of(texts) -> str:
    """The one ADMM scope named in ``texts``, "mixed" for several, else
    "other"."""
    found = {s for t in texts for s in SCOPES if s in t}
    if len(found) == 1:
        return found.pop()
    return "mixed" if found else "other"


def _busy_ns(intervals) -> int:
    """Length of the union of ``(start, end)`` intervals."""
    total, end_max = 0, None
    for start, end in sorted(intervals):
        if end_max is None or start > end_max:
            total += end - start
            end_max = end
        elif end > end_max:
            total += end - end_max
            end_max = end
    return total


def reduce_trace(xspace_path: str, op_names: dict | None = None) -> dict:
    """Per device line: busy time, scope totals, top ops."""
    from jax.profiler import ProfileData

    op_names = op_names or {}
    pd = ProfileData.from_file(xspace_path)
    out = {"lines": []}
    for plane in pd.planes:
        if "GPU" not in plane.name and "device" not in plane.name.lower():
            continue
        for line in plane.lines:
            events = list(line.events)
            if not events:
                continue
            per_op = collections.defaultdict(lambda: [0, 0, ""])
            scope_ns = collections.Counter()
            stat_keys = set()
            spans = []
            for ev in events:
                dur = int(ev.duration_ns)
                spans.append((int(ev.start_ns), int(ev.start_ns) + dur))
                stats = {k: v for k, v in ev.stats}
                stat_keys.update(stats)
                module = str(stats.get("hlo_module", ""))
                instr = str(stats.get("hlo_op", ev.name))
                texts = {str(stats.get("tf_op", ""))}
                texts |= _op_names(op_names, module, instr)
                texts |= _op_names(op_names, module, ev.name)
                scope = scope_of(texts)
                scope_ns[scope] += dur
                rec = per_op[ev.name]
                rec[0] += 1
                rec[1] += dur
                rec[2] = scope
            busy = _busy_ns(spans)
            top = sorted(per_op.items(), key=lambda kv: -kv[1][1])[:60]
            out["lines"].append({
                "plane": plane.name, "line": line.name,
                "events": len(events), "busy_ns": busy,
                "sum_ns": sum(v[1] for v in per_op.values()),
                "scope_ns": dict(scope_ns),
                "scope_share_of_busy": {k: v / busy for k, v in
                                        scope_ns.items()} if busy else {},
                "stat_keys": sorted(stat_keys),
                "top_ops": [{"name": k[:120], "count": c, "ns": ns,
                             "scope": sc}
                            for k, (c, ns, sc) in top],
            })
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", required=True, help="JSON summary path")
    ap.add_argument("--trace-dir", default=None,
                    help="where the profiler writes (default: next to --out)")
    ap.add_argument("--hlo-dir", default=None,
                    help="--xla_dump_to directory of this run")
    args = ap.parse_args(argv)

    sys.path.insert(0, ROOT)
    import jax
    from bench import NR, NT, build_solve_problem
    from twoace.config import AdmmConfig
    from twoace.ops.pair_solver import solve_lowrank_multi_pair_batch
    from twoace.utils.device import describe_devices, require_gpu

    require_gpu()
    trace_dir = args.trace_dir or os.path.join(
        os.path.dirname(os.path.abspath(args.out)), "trace")
    ap_, b, _ = build_solve_problem()
    cfg = AdmmConfig()
    key = jax.random.PRNGKey(0)
    res = jax.block_until_ready(
        solve_lowrank_multi_pair_batch(key, ap_, b, NT, NR, cfg))
    t0 = time.perf_counter()
    with jax.profiler.trace(trace_dir):
        res = jax.block_until_ready(
            solve_lowrank_multi_pair_batch(key, ap_, b, NT, NR, cfg))
    wall = time.perf_counter() - t0
    paths = sorted(glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"),
                             recursive=True), key=os.path.getmtime)
    op_names = hlo_op_names(args.hlo_dir) if args.hlo_dir else {}
    summary = reduce_trace(paths[-1], op_names)
    summary.update(describe_devices())
    summary.update({
        "workload": {"nt": NT, "nr": NR, "m": int(b.shape[1]),
                     "batch": int(b.shape[0]), "cfg": "AdmmConfig()"},
        "traced_wall_s": wall,
        "hlo_modules": sorted(op_names),
        "selected_iters_per_instance":
            float(jax.numpy.mean(res.iters.astype(jax.numpy.float32))),
    })
    with open(args.out, "w") as f:
        json.dump(summary, f, indent=1)
    for line in summary["lines"]:
        print(json.dumps({k: line[k] for k in
                          ("plane", "line", "events", "busy_ns",
                           "scope_ns")}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
