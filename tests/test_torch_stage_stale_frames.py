"""A `-c dcn` worker's round end drops its stage's stale input frames.

A round cut off by a death can leave frames on a surviving worker's
input channel: what its upstream sent before learning of the death,
after the worker's stage stopped taking frames. With the channel's
queue full (depth 1) the connection's reader parks on the next such
frame, and every later frame of that connection waits behind it: the
next round's input on the other parity never arrives. The one after
reads this channel again and would take a stale frame as its first.
`runtime._end_stage` stops the stage and drops those frames, repeating
while the parked reader puts more, so both later rounds get their own.
"""
import queue
import socket

import numpy as np
import pytest

from pipeedge_tpu_torch import runtime
from pipeedge_tpu_torch.comm import dcn


def _free_ports(n):
    socks = [socket.create_server(("127.0.0.1", 0)) for _ in range(n)]
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    return ports


def _value(tensors) -> float:
    return float(np.asarray(tensors[0])[0])


@pytest.mark.parametrize("stale", [1, 2, 3])
def test_round_end_drops_stale_input_frames(stale):
    """`stale` frames of round 0 wait on the worker's input channel (1:
    the queue full; 2: its reader parked too; 3: one more behind it on
    the socket); round 1's frame (the other parity) arrives only after
    the round end, and round 2's (round 0's parity) is the first frame
    read there."""
    addrs = [("127.0.0.1", p) for p in _free_ports(2)]
    ctxs = [dcn.DistDcnContext(2, r, addrs) for r in range(2)]
    for c in ctxs:
        c.init()
    upstream, worker = ctxs
    even = dcn.CHANNEL_DATA
    odd = dcn.CHANNEL_DATA + dcn.CHANNEL_ROUND_PARITY
    # round 0's stage on the worker, no longer taking frames (its
    # downstream died)
    stage = dcn.DcnPipelineStage(worker, 0, None, work_cb=lambda ts: ts,
                                 recv_channel=even)
    try:
        for i in range(stale):
            upstream.send_tensors(1, [np.full(1, i, np.float32)],
                                  channel=even)
        upstream.send_tensors(1, [np.full(1, 7, np.float32)], channel=odd)
        if stale == 1:
            # a free reader passes round 1's frame, sent after the stale one
            assert _value(worker.recv_tensors(0, timeout=10,
                                              channel=odd)) == 7
        else:
            # the parked reader holds back round 1's frame
            with pytest.raises(queue.Empty):
                worker.recv_tensors(0, timeout=1.0, channel=odd)
        assert runtime._end_stage(worker, stage, 1, 0) == stale
        if stale > 1:
            assert _value(worker.recv_tensors(0, timeout=10,
                                              channel=odd)) == 7
        upstream.send_tensors(1, [np.full(1, 9, np.float32)], channel=even)
        assert _value(worker.recv_tensors(0, timeout=10, channel=even)) == 9
        assert worker.drop_queued(even) == 0
    finally:
        for c in ctxs:
            c.shutdown()
