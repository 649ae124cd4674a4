"""The program's own spans in a traced window (``Trace.host_ops``).

A solve of the port is the span ``tnt.solve``; each blocking host
synchronization inside it is a ``host_sync/<site>`` span
(``optimization_tpu_torch.core.profiling.annotate``, recorded as CPU
operations on the profiler's clock, as the device's operations are).
Containment is found by intersecting intervals, never by walking back a
fixed number of operations, so a span opened long before an instant still
counts as open at it.
"""

from __future__ import annotations

from portbench.tracing import _union as union

SOLVE = "tnt.solve"
SYNC = "host_sync/"


def solve_split(trace):
    """(issue, wait, idle) nanoseconds summed over the window's ``tnt.solve``
    spans: the part of their length outside ``host_sync/*`` spans (the
    host issuing work), the part inside them (the host blocked on the
    card), and the part in which no operation ran on the device.  Issue
    and wait add up to the spans' length.  None where the window holds no
    ``tnt.solve`` span (a program without spans)."""
    if trace is None:
        return None
    roots = union((s, s + d) for n, s, d in trace.host_ops if n == SOLVE)
    if not roots:
        return None
    syncs = union((s, s + d) for n, s, d in trace.host_ops
                  if n.startswith(SYNC))
    root = sum(b - a for a, b in roots)
    wait = overlap(roots, syncs)
    return root - wait, wait, root - overlap(roots, trace.busy)


def per_outer_iteration_ms(run):
    """:func:`solve_split` in ms over the window's outer TNT iterations;
    None without spans or iterations."""
    split = solve_split(run.trace)
    outer = sum(s["outer"] for s in run.solves)
    if split is None or outer == 0:
        return None
    return tuple(t / 1e6 / outer for t in split)


def overlap(u, v) -> int:
    """Length of the intersection of two sorted, disjoint interval lists."""
    total, i, j = 0, 0, 0
    while i < len(u) and j < len(v):
        a, b = max(u[i][0], v[j][0]), min(u[i][1], v[j][1])
        if b > a:
            total += b - a
        if u[i][1] < v[j][1]:
            i += 1
        else:
            j += 1
    return total
