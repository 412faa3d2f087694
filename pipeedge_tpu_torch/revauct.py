"""Pipeline reverse-auction scheduler CLI of the port.

The repository's `revauct.py`: every device bids its memory-feasible
shards (from its timing profile) and its neighbour bandwidths; the
auctioneer filters and orders the bids and runs the latency-,
throughput- or host-count-optimizing scheduler (`sched/revauct.py`),
printing the 1-indexed schedule YAML that `runtime.py -pt` takes:

    python -m pipeedge_tpu_torch.revauct 0 4 \\
        -m google/vit-large-patch16-224 -u 8 \\
        -sm pipeedge_tpu_torch/profiles/h100/models.yml \\
        -sdt pipeedge_tpu_torch/profiles/h100/device_types.yml \\
        -sd pipeedge_tpu_torch/profiles/h100/devices.yml \\
        -sdnw pipeedge_tpu_torch/profiles/h100/device_neighbors_world.yml

`--comm local` (the default) fans the bids out through a thread pool in
one process; hosts in the YAML play the role of ranks. `--comm dcn` is
PipeEdge's own deployment: one process per rank over the DCN command
plane (`comm/dcn.py`). Rank 0 is the auctioneer and a bidder; it sends
CMD_BID to every rank, each bidder answers on CHANNEL_BIDS from its own
profile files only, and CMD_STOP releases them on every exit path:

    python -m pipeedge_tpu_torch.revauct R 3 -c dcn --host hR \\
        --dev-type h100 --dcn-addrs h:p0,h:p1,h:p2 -sm ... -sdt ... -sdnw ...

No PyYAML: the port's `sched/miniyaml.py` reads and writes the files.
"""
from __future__ import annotations

import argparse
import json
import logging
import queue
import random
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Optional, Sequence, Tuple

import numpy as np

from . import sched
from .models import registry
from .sched import miniyaml, revauct, yaml_files

logger = logging.getLogger(__name__)

# the auction's profile dtype key (PipeEdge's revauct.py fixes it too)
DTYPE = 'torch.float32'


def _find_profiles(yml_models, yml_dev_types, dev_type, model: str,
                   ubatch_size: int, dtype: str) -> Tuple:
    """Locate (model, device type, matching model profile) in the YAML
    config (PipeEdge revauct.py:40-64)."""
    yml_model = yml_models.get(model)
    yml_dev_type = yml_dev_types.get(dev_type)
    yml_dtm_profile = None
    if yml_dev_type is not None:
        for prof in (yml_dev_type.get('model_profiles') or {}).get(model, []):
            if sched.normalize_dtype(prof['dtype']) == \
                    sched.normalize_dtype(dtype) and \
                    prof['batch_size'] == ubatch_size:
                yml_dtm_profile = prof
                break
    return yml_model, yml_dev_type, yml_dtm_profile


def bid_latency_for_host(host: str, dev_type: str, cfg: dict, model: str,
                         ubatch_size: int, dtype: str = 'torch.float32'):
    """One device's auction response: (host, (shards, costs, neighbors)),
    the payload of PipeEdge's RPC handler (revauct.py:68-87)."""
    t_start = time.time()
    yml_model, yml_dev_type, yml_dtm_profile = _find_profiles(
        cfg['yml_models'], cfg['yml_dev_types'], dev_type, model, ubatch_size,
        dtype)
    shards, costs = [], []
    if yml_model is not None and yml_dev_type is not None and \
            yml_dtm_profile is not None:
        for shard, cost in revauct.bid_latency(yml_model, yml_dev_type,
                                               yml_dtm_profile, ubatch_size,
                                               dtype=dtype):
            shards.append(shard)
            costs.append(cost)
    else:
        # an empty bid silently shrinks the auctioned fleet: say why
        logger.warning(
            "host %s bids NOTHING: model=%s dev_type=%s ubatch=%d dtype=%s "
            "has no matching profile in the local device files",
            host, model, dev_type, ubatch_size, dtype)
    neighbors = cfg['yml_dev_neighbors_world'].get(host, {})
    logger.debug("Reverse auction bid time (ms): %f",
                 1000 * (time.time() - t_start))
    return host, (shards, costs, neighbors)


def _load_cfg(args) -> dict:
    return {
        'yml_models': yaml_files.yaml_models_load(args.sched_models_file),
        'yml_dev_types': yaml_files.yaml_device_types_load(
            args.sched_dev_types_file),
        'yml_dev_neighbors_world': yaml_files.yaml_device_neighbors_world_load(
            args.sched_dev_neighbors_world),
    }


def schedule(args, yml_model, bids_in_order) -> list:
    """Auctioneer tail: filter and order the collected bids and run the
    selected scheduler (PipeEdge revauct.py:182-239). Returns the
    1-indexed schedule, `[{host: [first, last]}, ...]`."""
    bid_data_by_host = {
        host: ({tuple(s): c for s, c in zip(payload[0], payload[1])},
               payload[2])
        for host, payload in bids_in_order}

    if args.filter_bids_chunk > 1:
        bid_data_by_host = {
            h: (revauct.filter_bids_chunk(yml_model, b[0],
                                          chunk=args.filter_bids_chunk), b[1])
            for h, b in bid_data_by_host.items()}
    if args.filter_bids_largest:
        bid_data_by_host = {h: (revauct.filter_bids_largest(b[0]), b[1])
                            for h, b in bid_data_by_host.items()}

    data_host = args.data_host if args.data_host else \
        next(iter(bid_data_by_host))
    dev_order = list(bid_data_by_host.keys())
    rng = random.Random(args.seed)
    rng.shuffle(dev_order)
    dev_order = dev_order[:args.dev_count]
    for idx, dev in enumerate(dev_order):
        if dev == data_host:
            dev_order[0], dev_order[idx] = dev_order[idx], dev_order[0]
    logger.info("Device order: %s", dev_order)

    strict_order = not args.no_strict_order
    t_start = time.time()
    if args.scheduler == 'latency_ordered':
        sched_out, pred = revauct.sched_optimal_latency_dev_order(
            yml_model, args.ubatch_size, DTYPE, bid_data_by_host, data_host,
            data_host, dev_order, strict_order=strict_order,
            strict_first=args.strict_first, strict_last=args.strict_last)
        logger.info("Latency prediction (sec): %s", pred)
    elif args.scheduler == 'throughput_ordered':
        sched_out, pred = revauct.sched_optimal_throughput_dev_order(
            yml_model, args.ubatch_size, DTYPE, bid_data_by_host, data_host,
            data_host, dev_order, strict_order=strict_order,
            strict_first=args.strict_first, strict_last=args.strict_last)
        logger.info("Throughput prediction (items/sec): %s", pred)
    else:
        sched_out = revauct.sched_greedy_host_count(
            yml_model, args.ubatch_size, DTYPE, bid_data_by_host, data_host,
            data_host)
    logger.info("Scheduler function runtime (sec): %s", time.time() - t_start)
    logger.info("Schedule stages: %d", len(sched_out))
    # the runtime's 1-based layer numbering (PipeEdge revauct.py:233-235)
    return [{host: [l + 1 for l in layers] for host, layers in part.items()}
            for part in sched_out]


def main_local(args) -> Optional[list]:
    """Single-controller auction: every device config is local; the bids
    fan out to a thread pool. Prints and returns the schedule (None on a
    rank other than 0, which has nothing to do)."""
    if args.rank != 0:
        logger.info("Single-controller auction: rank %d idle", args.rank)
        return None
    cfg = _load_cfg(args)
    host_types = {}
    for dev_type, hosts in yaml_files.yaml_devices_load(
            args.sched_dev_file).items():
        for host in hosts:
            host_types[host] = dev_type

    hosts = list(cfg['yml_dev_neighbors_world'].keys())[:args.worldsize]
    yml_model = cfg['yml_models'][args.model_name]

    t_start = time.time()
    with ThreadPoolExecutor() as pool:
        futs = [pool.submit(bid_latency_for_host, host,
                            host_types.get(host, ''), cfg, args.model_name,
                            args.ubatch_size, DTYPE) for host in hosts]
        bids_in_order = [f.result() for f in futs]
    logger.debug("Reverse auction total time (ms): %f",
                 1000 * (time.time() - t_start))
    if args.data_host is None:
        args.data_host = hosts[0]
    out = schedule(args, yml_model, bids_in_order)
    logger.info("Schedule:")
    print(miniyaml.dumps(out, sort_keys=False))
    return out


def main_dcn(args) -> Optional[list]:
    """Distributed auction over the DCN command plane: rank-local bids,
    PipeEdge's deployment shape (one process per device, revauct.py:168-
    180). Rank 0 is the auctioneer and a bidder; it prints and returns
    the schedule (None on a bidder)."""
    from .comm import CMD_BID, CMD_STOP, dcn

    cfg = _load_cfg(args)
    bid_req_q: "queue.Queue" = queue.Queue()
    stop_ev = threading.Event()

    def handler(cmd, tensors):
        if cmd == CMD_BID:
            bid_req_q.put(tensors)
        elif cmd == CMD_STOP:
            stop_ev.set()

    addrs = dcn.parse_rank_addrs(args.dcn_addrs, args.worldsize, args.port)
    with dcn.DistDcnContext(args.worldsize, args.rank, addrs,
                            cmd_handler=handler) as ctx:
        if args.rank != 0:
            _bid_dcn(args, cfg, ctx, bid_req_q, stop_ev)
            return None
        # the auction request (PipeEdge's rpc_async fan-out,
        # revauct.py:171-174); rank 0 bids locally
        try:
            ctx.cmd_broadcast(CMD_BID, [
                np.frombuffer(args.model_name.encode(), np.uint8),
                np.asarray(args.ubatch_size, np.int32),
                np.frombuffer(DTYPE.encode(), np.uint8)])
        except ConnectionError as exc:
            # release the bidders that are up before failing
            ctx.cmd_broadcast(CMD_STOP, best_effort=True)
            raise RuntimeError(
                f"auction request undeliverable: {exc}") from None
        try:
            bids_in_order = [bid_latency_for_host(
                args.host, args.dev_type, cfg, args.model_name,
                args.ubatch_size, DTYPE)]
            for rank in range(1, args.worldsize):
                try:
                    blob = ctx.recv_tensors(rank,
                                            timeout=args.auction_timeout,
                                            channel=dcn.CHANNEL_BIDS)
                except (queue.Empty, ConnectionError) as exc:
                    raise RuntimeError(
                        f"no bid from rank {rank} within "
                        f"{args.auction_timeout}s ({exc.__class__.__name__}"
                        f"); is it up and bidding?") from None
                bid = json.loads(bytes(blob[0]).decode())
                bids_in_order.append(
                    (bid['host'],
                     (bid['shards'], bid['costs'], bid['neighbors'])))
        finally:
            # even on a failed collection (a bidder died), release the
            # others, which would otherwise wait out their timeout
            ctx.cmd_broadcast(CMD_STOP, best_effort=True)
    if args.data_host is None:
        args.data_host = args.host
    out = schedule(args, cfg['yml_models'][args.model_name], bids_in_order)
    logger.info("Schedule:")
    print(miniyaml.dumps(out, sort_keys=False))
    return out


def _bid_dcn(args, cfg, ctx, bid_req_q, stop_ev) -> None:
    """A bidder: wait for the request and answer from the local profiles
    only (this process never sees the other ranks' device files)."""
    from .comm import dcn

    try:
        tensors = bid_req_q.get(timeout=args.auction_timeout)
    except queue.Empty:
        raise RuntimeError(
            f"rank {args.rank}: no CMD_BID within {args.auction_timeout}s; "
            "is the auctioneer up?") from None
    model = bytes(np.asarray(tensors[0])).decode()
    ubatch_size = int(np.asarray(tensors[1]))
    dtype = bytes(np.asarray(tensors[2])).decode()
    host, payload = bid_latency_for_host(
        args.host, args.dev_type, cfg, model, ubatch_size, dtype)
    blob = json.dumps({'host': host, 'shards': payload[0],
                       'costs': payload[1],
                       'neighbors': payload[2]}).encode()
    try:
        ctx.send_tensors(0, [np.frombuffer(blob, np.uint8)],
                         channel=dcn.CHANNEL_BIDS)
    except OSError as exc:
        raise RuntimeError(
            f"rank {args.rank}: could not deliver bid to the auctioneer "
            f"({exc}); is rank 0 still up?") from None
    if stop_ev.wait(timeout=args.auction_timeout):
        logger.info("rank %d: released by auctioneer", args.rank)
    else:
        logger.warning("rank %d: no CMD_STOP within %ss; exiting",
                       args.rank, args.auction_timeout)


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(
        description="Pipeline Reverse Auction Scheduler (PyTorch port)",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument("rank", type=int,
                        help="this node's rank (0 = auctioneer)")
    parser.add_argument("worldsize", type=int,
                        help="number of devices to auction over")
    netcfg = parser.add_argument_group('Network configuration (--comm dcn)')
    netcfg.add_argument("-c", "--comm", default="local",
                        choices=["local", "dcn"],
                        help="bid fan-out: local thread pool (single "
                             "controller) or distributed rank-local bids "
                             "over the DCN command plane")
    netcfg.add_argument("--dcn-addrs", type=str, default=None,
                        help="comma-separated host:port per rank")
    netcfg.add_argument("--port", type=int, default=29500,
                        help="base port when --dcn-addrs is unset "
                             "(rank i listens on port+i)")
    netcfg.add_argument("--auction-timeout", type=float, default=120.0)
    devcfg = parser.add_argument_group('Device configuration')
    devcfg.add_argument("-sm", "--sched-models-file", default='models.yml')
    devcfg.add_argument("-sdt", "--sched-dev-types-file",
                        default='device_types.yml')
    devcfg.add_argument("-sd", "--sched-dev-file", default='devices.yml',
                        help="device types to hosts mapping YAML file "
                             "(--comm local only)")
    devcfg.add_argument("-sdnw", "--sched-dev-neighbors-world",
                        default='device_neighbors_world.yml')
    devcfg.add_argument("--host", type=str, default=None,
                        help="this bidder's hostname (--comm dcn); default "
                             "rank<N>")
    devcfg.add_argument("--dev-type", type=str, default=None,
                        help="this bidder's device type name in its local "
                             "device_types file (--comm dcn)")
    devcfg.add_argument("-D", "--data-host", type=str, default=None,
                        help="host where inputs are loaded and outputs "
                             "processed; default: first host / auctioneer")
    modcfg = parser.add_argument_group('Model configuration')
    modcfg.add_argument("-m", "--model-name", type=str,
                        default="google/vit-base-patch16-224",
                        choices=registry.get_model_names())
    modcfg.add_argument("-u", "--ubatch-size", default=8, type=int)
    schcfg = parser.add_argument_group('Additional scheduler options')
    schcfg.add_argument("--filter-bids-chunk", type=int, default=1)
    schcfg.add_argument("--filter-bids-largest", action='store_true')
    schcfg.add_argument("-sch", "--scheduler", default="latency_ordered",
                        choices=["latency_ordered", "throughput_ordered",
                                 "greedy_host_count"])
    schcfg.add_argument("-d", "--dev-count", type=int, default=None)
    schcfg.add_argument("--no-strict-order", action='store_true')
    schcfg.add_argument("--strict-first", action='store_true')
    schcfg.add_argument("--strict-last", action='store_true')
    schcfg.add_argument("--seed", type=int, default=None,
                        help="seed the device-order shuffle")
    args = parser.parse_args(argv)
    if args.host is None:
        args.host = f"rank{args.rank}"
    if args.comm == "dcn" and not args.dev_type:
        parser.error("--comm dcn requires --dev-type (this bidder's entry "
                     "in its local device_types file)")
    return args


def main(argv: Optional[Sequence[str]] = None) -> Optional[list]:
    logging.basicConfig(format='%(message)s', level=logging.INFO)
    args = parse_args(argv)
    return main_dcn(args) if args.comm == "dcn" else main_local(args)


if __name__ == "__main__":
    main()
