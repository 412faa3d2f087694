"""Reverse-auction scheduling: bids, filters, greedy and DAG-optimal schedulers.

The port's copy of `pipeedge_tpu/sched/revauct.py` (pure Python; the port
imports nothing of the JAX package), after PipeEdge's `sched/revauct.py`. Each
device "bids" every memory-feasible contiguous layer range with its compute
latency as cost (bid_latency, revauct.py:18-29); the auctioneer assembles a
pipeline from the bids with one of three schedulers:

- greedy host count (revauct.py:53-116): fewest devices, data host first/last;
- optimal latency over a device order: shortest path over the shard-bid DAG
  (nodes = (device, shard) weighted by compute, edges weighted by comm time
  with link bw = min of both directions — revauct.py:121-223);
- optimal throughput: minimax path minimizing the max stage latency
  (revauct.py:225-251). PipeEdge implements this as a stateful weight
  function inside networkx Dijkstra; here it is a direct minimax Dijkstra
  (max is monotone, so Dijkstra's greedy invariant holds) over a hand-rolled
  graph — no networkx dependency.
"""
from __future__ import annotations

import heapq
import logging
import time
from typing import Dict, List, Mapping, Optional, Tuple

from . import communication_time_bw, computation_time, mem_bytes, ubatch_bytes

logger = logging.getLogger(__name__)

ShardBid = Tuple[Tuple[int, int], float]
"""A shard bid: ((start_layer, end_layer), cost) — layers 0-based here."""

DeviceBidData = Tuple[Mapping[Tuple[int, int], float], Mapping[str, dict]]
"""A device's bids: (shard -> cost, neighbor host -> link properties)."""

NodeID = Tuple[str, Tuple[int, int]]
"""DAG node: (device, (m, n)); dummies use (-1, -1) and (L, L)."""


def bid_latency(yml_model: dict, yml_dev_type: dict, yml_dtm_profile: dict,
                ubatch_size: int, dtype: str = 'torch.float32') -> List[ShardBid]:
    """All memory-feasible O(L^2) shards with compute-latency costs."""
    bids = []
    dev_mem = yml_dev_type['mem_MB'] * 1024 * 1024
    n_layers = yml_model['layers']
    for layer_l in range(n_layers):
        for layer_r in range(layer_l, n_layers):
            if dev_mem > mem_bytes(yml_model, layer_l, layer_r, dtype, ubatch_size):
                cost = computation_time(yml_dtm_profile, layer_l, layer_r)
                bids.append(((layer_l, layer_r), cost))
    return bids


def filter_bids_chunk(yml_model: dict, bids: Mapping[Tuple[int, int], float],
                      chunk: int = 4) -> Dict[Tuple[int, int], float]:
    """Keep only shards aligned to `chunk`-sublayer boundaries (the tail shard
    may be short if chunk doesn't divide the layer count)."""
    model_layers = yml_model['layers']
    return {shard: cost for shard, cost in bids.items()
            if shard[0] % chunk == 0 and
            (shard[1] + 1 >= model_layers or (shard[1] + 1) % chunk == 0)}


def filter_bids_largest(bids: Mapping[Tuple[int, int], float]) \
        -> Dict[Tuple[int, int], float]:
    """Keep only the largest shard for each start layer."""
    best: Dict[int, ShardBid] = {}
    for shard, cost in bids.items():
        if shard[0] not in best or shard[1] > best[shard[0]][0][1]:
            best[shard[0]] = (shard, cost)
    return {shard: cost for shard, cost in best.values()}


def sched_greedy_host_count(yml_model: dict, _ubatch_size: int, _dtype: str,
                            bids: Mapping[str, DeviceBidData], host_src: str,
                            host_dest: str) -> List[Mapping[str, List[int]]]:
    """Schedule for minimum device count: full connectivity assumed,
    bandwidths ignored (PipeEdge revauct.py:53-116).

    Source host gets the largest shard starting at layer 0, dest host the
    largest shard ending at the last layer, remaining layers greedily filled
    with the largest supported shards (ties broken by lower cost). May fail
    (return []) even when a feasible pipeline exists.
    """
    # host -> {start_layer: (max_end_layer, cost)}
    max_lut: Dict[str, Dict[int, Tuple[int, float]]] = {h: {} for h in bids}
    for host, (shard_bids, _) in bids.items():
        for shard, cost in shard_bids.items():
            if max_lut[host].get(shard[0], (-1, -1))[0] < shard[1]:
                max_lut[host][shard[0]] = (shard[1], cost)

    sched: List[Mapping[str, List[int]]] = []
    insert_offset = 0
    lay_start = 0
    lay_end = yml_model['layers'] - 1
    used = set()
    if host_src in max_lut and lay_start in max_lut[host_src]:
        lay_max = max_lut[host_src][lay_start][0]
        sched.append({host_src: [lay_start, lay_max]})
        used.add(host_src)
        lay_start = lay_max + 1
    # dest gets the tail (src may not, unless it already took the whole model)
    if host_dest in max_lut and host_src != host_dest:
        lay_min = lay_end + 1
        for lay_s, (lay_e, _) in max_lut[host_dest].items():
            if lay_e == lay_end:
                lay_min = min(lay_s, lay_min)
        if lay_min <= lay_end:
            sched.append({host_dest: [lay_min, lay_end]})
            used.add(host_dest)
            lay_end = lay_min - 1
            insert_offset = 1
    while lay_start <= lay_end:
        best: Tuple[Optional[str], int, float] = (None, -1, -1.0)
        for dev, lut in max_lut.items():
            if dev not in used and lay_start in lut:
                cand_end, cand_cost = lut[lay_start]
                if cand_end > best[1] or (cand_end == best[1] and cand_cost < best[2]):
                    best = (dev, cand_end, cand_cost)
        if best[0] is None:
            return []
        sched.insert(len(sched) - insert_offset, {best[0]: [lay_start, best[1]]})
        used.add(best[0])
        lay_start = best[1] + 1
    if host_dest not in sched[-1]:
        sched.append({host_dest: []})
    return sched


class _ShardDag:
    """Shard-bid DAG with node weights (compute) and edge weights (comm)."""

    def __init__(self):
        self.node_weight: Dict[NodeID, float] = {}
        self.adj: Dict[NodeID, List[Tuple[NodeID, float]]] = {}

    def add_node(self, node: NodeID, weight: float) -> None:
        self.node_weight[node] = weight
        self.adj.setdefault(node, [])

    def add_edge(self, src: NodeID, dst: NodeID, weight: float) -> None:
        self.adj[src].append((dst, weight))


def _link_bw_mbps(bids: Mapping[str, DeviceBidData], dev_a: str, dev_b: str) -> float:
    """Effective link bandwidth: min of what each side reports for the other."""
    return min(bids[dev_a][1].get(dev_b, {}).get('bw_Mbps', 0),
               bids[dev_b][1].get(dev_a, {}).get('bw_Mbps', 0))


def _build_dag(bids: Mapping[str, DeviceBidData], yml_model: dict,
               ubatch_size: int, dtype: str, devices: List[str],
               strict_order: bool) -> _ShardDag:
    """Nodes for every (device, bid shard); edges where shards abut and the
    devices are adjacent in (strict) or consistent with (relaxed) the order."""
    dag = _ShardDag()
    n_layers = yml_model['layers']
    start_lut: Dict[str, Dict[int, List[NodeID]]] = \
        {d: {i: [] for i in range(n_layers)} for d in devices}
    for dev in devices:
        for shard, cost in bids[dev][0].items():
            node = (dev, shard)
            dag.add_node(node, cost)
            start_lut[dev][shard[0]].append(node)
    edge_bytes = [ubatch_bytes(yml_model['parameters_out'][l], ubatch_size,
                               dtype=dtype) for l in range(n_layers)]
    for idx, dev_a in enumerate(devices[:-1]):
        successors = devices[idx + 1:idx + 2] if strict_order else devices[idx + 1:]
        for dev_b in successors:
            bw = _link_bw_mbps(bids, dev_a, dev_b)
            if bw <= 0:
                continue
            for starts in start_lut[dev_a].values():
                for node_a in starts:
                    lay_end = node_a[1][1]
                    comm = communication_time_bw(bw, edge_bytes[lay_end])
                    for node_b in start_lut[dev_b].get(lay_end + 1, []):
                        dag.add_edge(node_a, node_b, comm)
    return dag


def _add_dummies(dag: _ShardDag, yml_model: dict, ubatch_size: int, dtype: str,
                 bids: Mapping[str, DeviceBidData], host_src: str,
                 host_dest: str, devices: List[str], strict_first: bool,
                 strict_last: bool) -> Tuple[NodeID, NodeID]:
    """Dummy source/dest nodes wired to first-layer / last-layer shards."""
    n_layers = yml_model['layers']
    node_src: NodeID = (host_src, (-1, -1))
    node_dest: NodeID = (host_dest, (n_layers, n_layers))
    dag.add_node(node_src, 0)
    dag.add_node(node_dest, 0)
    in_bytes = ubatch_bytes(yml_model['parameters_in'], ubatch_size, dtype=dtype)
    out_bytes = ubatch_bytes(yml_model['parameters_out'][-1], ubatch_size,
                             dtype=dtype)
    for node in list(dag.node_weight):
        dev, (lay_start, lay_end) = node
        if node in (node_src, node_dest):
            continue
        if lay_start == 0 and (dev == devices[0] or not strict_first):
            if dev == host_src:
                dag.add_edge(node_src, node, 0)
            else:
                bw = _link_bw_mbps(bids, host_src, dev)
                if bw > 0:
                    dag.add_edge(node_src, node,
                                 communication_time_bw(bw, in_bytes))
        if lay_end == n_layers - 1 and (dev == devices[-1] or not strict_last):
            if dev == host_dest:
                dag.add_edge(node, node_dest, 0)
            else:
                bw = _link_bw_mbps(bids, dev, host_dest)
                if bw > 0:
                    dag.add_edge(node, node_dest,
                                 communication_time_bw(bw, out_bytes))
    return node_src, node_dest


def _dijkstra(dag: _ShardDag, source: NodeID, target: NodeID,
              objective: str) -> Tuple[List[NodeID], float]:
    """Shortest path under 'latency' (additive node+edge weights) or
    'throughput' (minimax over max(edge, node) stage latencies). Both
    relaxations are monotone, so plain Dijkstra applies."""
    inf = float('inf')
    dist = {source: dag.node_weight[source]}
    prev: Dict[NodeID, NodeID] = {}
    heap = [(dist[source], source)]
    visited = set()
    while heap:
        d, u = heapq.heappop(heap)
        if u in visited:
            continue
        visited.add(u)
        if u == target:
            break
        for v, edge_w in dag.adj.get(u, []):
            if objective == 'latency':
                cand = d + edge_w + dag.node_weight[v]
            else:  # throughput: minimize the bottleneck stage latency
                cand = max(d, edge_w, dag.node_weight[v])
            if cand < dist.get(v, inf):
                dist[v] = cand
                prev[v] = u
                heapq.heappush(heap, (cand, v))
    if target not in visited:
        return [], inf
    path = [target]
    while path[-1] != source:
        path.append(prev[path[-1]])
    path.reverse()
    return path, dist[target]


def _path_to_sched(path: List[NodeID], host_src: str, host_dest: str) \
        -> List[Mapping[str, List[int]]]:
    """Collapse/replace dummy endpoints (PipeEdge revauct.py:254-273)."""
    if len(path) > 0:
        assert len(path) > 2
        if path[0][0] == path[1][0]:
            path.pop(0)  # source device took the first shard
        else:
            path[0] = (host_src, ())
        if path[-1][0] == path[-2][0]:
            path.pop()   # dest device took the last shard
        else:
            path[-1] = (host_dest, ())
    return [{node[0]: list(node[1])} for node in path]


def _sched_optimal(objective: str, yml_model: dict, ubatch_size: int,
                   dtype: str, bids: Mapping[str, DeviceBidData],
                   host_src: str, host_dest: str, devices: List[str],
                   strict_order: bool, strict_first: bool,
                   strict_last: bool) -> Tuple[List[Mapping[str, List[int]]], float]:
    if host_src in devices:
        assert devices[0] == host_src
    if host_dest != host_src and host_dest in devices:
        assert devices[-1] == host_dest
    t_start = time.time()
    dag = _build_dag(bids, yml_model, ubatch_size, dtype, devices, strict_order)
    node_src, node_dest = _add_dummies(dag, yml_model, ubatch_size, dtype, bids,
                                       host_src, host_dest, devices,
                                       strict_first, strict_last)
    logger.info("DAG construction time (sec): %f", time.time() - t_start)
    t_start = time.time()
    path, cost = _dijkstra(dag, node_src, node_dest, objective)
    logger.info("DAG search time (sec): %f", time.time() - t_start)
    if not path:
        logger.debug("No possible paths.")
    return _path_to_sched(path, host_src, host_dest), cost


def sched_optimal_latency_dev_order(yml_model: dict, ubatch_size: int,
                                    dtype: str, bids: Mapping[str, DeviceBidData],
                                    host_src: str, host_dest: str,
                                    devices: List[str], strict_order: bool = True,
                                    strict_first: bool = True,
                                    strict_last: bool = True) \
        -> Tuple[List[Mapping[str, List[int]]], float]:
    """Optimal end-to-end latency subject to the device order; returns
    (schedule, predicted latency seconds)."""
    return _sched_optimal('latency', yml_model, ubatch_size, dtype, bids,
                          host_src, host_dest, devices, strict_order,
                          strict_first, strict_last)


def sched_optimal_throughput_dev_order(yml_model: dict, ubatch_size: int,
                                       dtype: str,
                                       bids: Mapping[str, DeviceBidData],
                                       host_src: str, host_dest: str,
                                       devices: List[str],
                                       strict_order: bool = True,
                                       strict_first: bool = True,
                                       strict_last: bool = True) \
        -> Tuple[List[Mapping[str, List[int]]], float]:
    """Optimal pipeline throughput (compute/comm overlapped) subject to the
    device order; returns (schedule, predicted items/sec)."""
    sched, cost = _sched_optimal('throughput', yml_model, ubatch_size, dtype,
                                 bids, host_src, host_dest, devices,
                                 strict_order, strict_first, strict_last)
    return sched, (1 / cost if cost > 0 else float('inf'))
