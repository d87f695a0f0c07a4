"""Trace reduction: device time per codec stage from a profiler trace.

The codec names its stages with ``jax.named_scope`` (codec.py:
interp_conv, cdf_table, sf_lookup, rans_decode, rans_encode).  The
scopes reach the compiled program as HLO op metadata (``op_name``), not
the trace's kernel events, so a kernel is attributed through the
program's optimized HLO text (``compiled.as_text()``): the event's HLO
instruction (its ``hlo_op`` stat, or failing that its kernel name) -> the
instructions it fuses -> the stage scopes in their op_names.  A fusion
whose instructions carry several stages counts toward the joined label
(``cdf_table+rans_decode``), one with none toward "other", and a kernel
that the HLO does not name (a copy, another program) toward
"unattributed".  Busy time is the union of the kernel intervals, idle
share 1 - busy / window.  Used by chip_smoke.py and
tools/profile_codec.py.
"""
from __future__ import annotations

import glob
import os
import re

STAGES = ("interp_conv", "cdf_table", "sf_lookup", "rans_decode",
          "rans_encode")

_COMPUTATION = re.compile(r"^(?:ENTRY\s+)?%?([\w.\-]+)\s+\(.*\{\s*$")
_INSTRUCTION = re.compile(r"^\s*(?:ROOT\s+)?%?([\w.\-]+)\s*=\s*(.*)$")
_CALLS = re.compile(r"\bcalls=%?([\w.\-]+)")
_OP_NAME = re.compile(r'op_name="([^"]*)"')


def _key(name: str) -> str:
    # kernel names are HLO instruction names with '.' and '-' replaced
    return re.sub(r"[^0-9A-Za-z]", "_", name)


def hlo_stages(hlo_text: str) -> dict:
    """Map each instruction of an optimized HLO module (by ``_key`` of its
    name) to ``(stage label, op_name)``: the label joins the stage scopes
    found in the op_names of the instruction and of every instruction of
    the computation it calls (a fusion's body); op_name is its own."""
    comps = {}  # computation -> [(instr, own op_name, callee)]
    cur = None
    for line in hlo_text.splitlines():
        m = _COMPUTATION.match(line)
        if m:
            cur = comps.setdefault(m.group(1), [])
            continue
        m = _INSTRUCTION.match(line)
        if m and cur is not None:
            op = _OP_NAME.search(m.group(2))
            call = _CALLS.search(m.group(2))
            cur.append((m.group(1), op.group(1) if op else "",
                        call.group(1) if call else None))

    memo = {}

    def body_ops(comp, seen=()):
        if comp not in memo:
            ops = []
            for _name, op, callee in comps.get(comp, ()):
                ops.append(op)
                if callee and callee not in seen:
                    ops += body_ops(callee, seen + (comp,))
            memo[comp] = ops
        return memo[comp]

    out = {}
    for instrs in comps.values():
        for name, op, callee in instrs:
            ops = [op] + (body_ops(callee) if callee else [])
            found = [s for s in STAGES if any(s in o for o in ops)]
            out[_key(name)] = ("+".join(found) or "other", op)
    return out


def _stat(event, name):
    for k, v in event.stats:
        if k == name:
            return v
    return None


def reduce_trace(trace_dir: str, hlo_text: str | None = None,
                 plane_prefix: str = "/device:GPU"):
    """Device time per stage (ms), busy time and idle share of the traced
    window, from the device planes of the newest .xplane.pb under
    trace_dir; stages are resolved through ``hlo_text`` (see module doc).

    GPU planes: the kernel and copy events of the stream lines ("XLA
    Ops" mirrors them, "XLA Modules" spans whole programs).  Other planes
    (the CPU client): the events that carry an ``hlo_op`` stat."""
    from jax.profiler import ProfileData

    path = sorted(glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"),
                            recursive=True))[-1]
    pd = ProfileData.from_file(path)
    stages = hlo_stages(hlo_text) if hlo_text else {}
    per_stage = {}
    spans = []
    top = {}
    layout = {}
    for plane in pd.planes:
        if not plane.name.startswith(plane_prefix):
            continue
        lines = list(plane.lines)
        layout[plane.name] = sorted(ln.name for ln in lines)
        streams = [ln for ln in lines if "Stream" in ln.name]
        for ln in streams or lines:
            for ev in ln.events:
                hlo_op = _stat(ev, "hlo_op")
                if not streams and hlo_op is None:
                    continue
                # kernels that run inside a while loop may carry the
                # loop's (or a command buffer's) name as hlo_op
                st, op = (stages.get(_key(str(hlo_op)))
                          or stages.get(_key(ev.name))
                          or ("unattributed", ""))
                dur = ev.duration_ns / 1e6
                per_stage[st] = per_stage.get(st, 0.0) + dur
                spans.append((ev.start_ns, ev.start_ns + ev.duration_ns))
                key = (st, ev.name, op)
                top[key] = top.get(key, 0.0) + dur
    spans.sort()
    busy, window = 0.0, 0.0
    if spans:
        window = (spans[-1][1] - spans[0][0]) / 1e6
        cur_s, cur_e = spans[0]
        for s, e in spans[1:]:
            if s > cur_e:
                busy += cur_e - cur_s
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        busy = (busy + cur_e - cur_s) / 1e6
    tops = sorted(top.items(), key=lambda kv: -kv[1])[:25]
    return dict(stage_ms=dict(sorted(per_stage.items(),
                                     key=lambda kv: -kv[1])),
                busy_ms=busy, window_ms=window,
                idle_share=(1 - busy / window) if window else None,
                top_ops=[[st, name, ms, op] for (st, name, op), ms in tops],
                planes=layout)


def profile_dispatch(fn, trace_dir: str, hlo_text: str | None = None,
                     reps: int = 3):
    """Trace ``reps`` back-to-back calls of the (warm) dispatch ``fn`` and
    reduce the trace (``hlo_text``: the optimized HLO of the program that
    ``fn`` runs); times are per call (ms)."""
    import jax

    jax.profiler.start_trace(trace_dir)
    for _ in range(reps):
        out = fn()
    jax.block_until_ready(out)
    jax.profiler.stop_trace()
    r = reduce_trace(trace_dir, hlo_text)
    r["stage_ms"] = {k: v / reps for k, v in r["stage_ms"].items()}
    r["busy_ms"] /= reps
    r["window_ms"] /= reps
    r["top_ops"] = [[st, name, ms / reps, op]
                    for st, name, ms, op in r["top_ops"]]
    return r
