"""Haplotype-block discovery: connected components of the pruned
variant-overlap graph (mirrors build_haplotypes/build_haplotype_v3,
/root/reference/phaser/phaser.py:1861-1882, 1985-1998).

Union-find on the host; with device enabled, large graphs run the
pointer-jumping label-propagation kernel (kernels.components) — both produce
the same components; ordering here reproduces the reference's seed order.
"""

from __future__ import annotations

from typing import Dict, List, Set

import numpy as np

from .connections import ContigConnections

# device label propagation pays off only on big graphs; below this the host
# union-find finishes in microseconds while a device launch costs a dispatch
_DEVICE_EDGE_GATE = 100_000


def find_blocks(conn: ContigConnections, vt,
                device: str = "host") -> List[List[int]]:
    """Blocks as lists of table indices.

    Order: by first overlap-key rank among members (reference seed order).
    Within a block: sort_var_ids semantics — (contig, int(pos)), ties by
    table index (the reference's tie order is Python-set-iteration dependent).
    """
    adj = conn.adj
    if not adj:
        return []

    n_edges = sum(len(nbrs) for nbrs in adj.values())  # 2x undirected count
    blocks: List[List[int]] = []
    if device not in ("host", "off") and n_edges >= _DEVICE_EDGE_GATE:
        from ..utils.trace import device_section
        with device_section():
            blocks = _device_blocks(adj)
    if not blocks:
        blocks = _host_blocks(adj)

    rank = conn.var_rank
    blocks.sort(key=lambda mem: min(int(rank[v]) for v in mem))
    out = []
    for mem in blocks:
        mem = sorted(mem, key=lambda v: (int(vt.pos[v]), v))
        out.append(mem)
    return out


def _host_blocks(adj: Dict[int, Set[int]]) -> List[List[int]]:
    parent: Dict[int, int] = {v: v for v in adj}

    def find(x: int) -> int:
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    for a, nbrs in adj.items():
        for b in nbrs:
            ra, rb = find(a), find(b)
            if ra != rb:
                parent[ra] = rb

    comps: Dict[int, List[int]] = {}
    for v in adj:
        comps.setdefault(find(v), []).append(v)
    return list(comps.values())


def _device_blocks(adj: Dict[int, Set[int]]) -> List[List[int]]:
    """Flatten the adjacency to an edge list and run the device kernel."""
    from ..kernels.components import connected_components
    ea = []
    eb = []
    for a, nbrs in adj.items():
        for b in nbrs:
            if a < b:  # one direction suffices for an undirected CC
                ea.append(a)
                eb.append(b)
    if not ea:
        # isolated self-connected keys only; treat each as its own block
        return [[v] for v in adj]
    comps = connected_components(np.asarray(ea, np.int64),
                                 np.asarray(eb, np.int64), 0)
    # vertices present in adj but in no a<b edge (possible only if adj held
    # a vertex with an empty neighbor set) become singletons
    seen = {v for mem in comps for v in mem}
    comps.extend([v] for v in adj if v not in seen)
    return comps
