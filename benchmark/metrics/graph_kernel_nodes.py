"""Kernel nodes of the captured non-solve tick (``cuGraphGetNodes`` on the
loop's graph)."""


def read(rec, cell, cfg):
    nodes = rec.get("graph_nodes")
    return float(nodes["kernel"]) if nodes and nodes.get("kernel") else None
