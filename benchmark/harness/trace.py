"""What a ``torch.profiler`` trace of the card says: the union of the
device's busy intervals, device time by kernel, and the longest idle gaps
with what the host was doing in each."""
from __future__ import annotations

import ctypes


def device_intervals(prof):
    """[(start_us, end_us, name)] of every operation the profiler saw run
    on the card (kernels, copies, sets)."""
    import torch

    out = []
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            tr = ev.time_range
            if tr.end > tr.start:
                out.append((float(tr.start), float(tr.end), ev.name))
    return sorted(out)


def host_intervals(prof):
    import torch

    return [(float(ev.time_range.start), float(ev.time_range.end), ev.name)
            for ev in prof.events() if ev.device_type == torch.autograd.DeviceType.CPU]


def union(intervals):
    """Merged [start, end] spans of ``intervals``; overlapping operations
    count once."""
    merged = []
    for s, e, _ in intervals:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def kernel_table(intervals) -> dict:
    """{name: [total seconds, launches]} over the device operations."""
    table = {}
    for s, e, name in intervals:
        row = table.setdefault(name, [0.0, 0])
        row[0] += (e - s) * 1e-6
        row[1] += 1
    return table


def idle_gaps(merged, hosts, top: int = 10):
    """The ``top`` longest gaps between busy spans, each named by the
    shortest host operation that covers its middle."""
    gaps = sorted(((s1 - e0, e0, s1) for (_, e0), (s1, _) in zip(merged, merged[1:])
                   if s1 > e0), reverse=True)[:top]
    out = []
    for dur, e0, s1 in gaps:
        mid = 0.5 * (e0 + s1)
        covering = [(e - s, n) for s, e, n in hosts if s <= mid <= e]
        out.append([min(covering)[1] if covering else "host idle", dur * 1e-6])
    return out


def graph_nodes(graph) -> dict:
    """Node counts by type of a graph captured with ``keep_graph=True``,
    through libcuda's ``cuGraphGetNodes``: 0 kernel, 1 memcpy, 2 memset."""
    cu = ctypes.CDLL("libcuda.so.1")
    handle = ctypes.c_void_p(int(graph.raw_cuda_graph()))
    n = ctypes.c_size_t(0)
    if cu.cuGraphGetNodes(handle, None, ctypes.byref(n)) != 0:
        raise RuntimeError("cuGraphGetNodes failed")
    nodes = (ctypes.c_void_p * n.value)()
    if cu.cuGraphGetNodes(handle, nodes, ctypes.byref(n)) != 0:
        raise RuntimeError("cuGraphGetNodes failed")
    names = {0: "kernel", 1: "memcpy", 2: "memset"}
    counts = {}
    for node in nodes:
        t = ctypes.c_int(-1)
        cu.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(t))
        key = names.get(t.value, f"type{t.value}")
        counts[key] = counts.get(key, 0) + 1
    return counts
