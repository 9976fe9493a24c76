"""The port's §3.1 ring-buffer protocol (``xccl/primitives.py``): the
reference's property cases (``tests/test_properties.py``) — FIFO
delivery with no loss, event-id sanity, backpressure — and the same
modeled transfer times and protocol state as the reference's copy.
"""
from __future__ import annotations

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.xccl import primitives as jprim
from repro_torch.xccl import primitives as tprim


@settings(max_examples=30, deadline=None)
@given(msgs=st.lists(st.binary(min_size=0, max_size=300_000),
                     min_size=1, max_size=8))
def test_p2p_protocol_fifo_no_loss(msgs):
    a, b, ch = tprim.make_pair(ring_slots=64)
    for i, m in enumerate(msgs):
        ch.send(m, event_id=i)
        got = ch.recv(event_id=i)
        assert got == m, "payload corrupted"
        assert ch.acked(i)


def test_p2p_event_id_sanity_and_backpressure():
    a, b, ch = tprim.make_pair(ring_slots=2)
    ch.send(b"x", event_id=1)
    ch.recv(event_id=1)
    with pytest.raises(tprim.XCCLError):
        ch.send(b"y", event_id=1)        # replayed event
    with pytest.raises(tprim.XCCLError):
        ch.send(b"z" * (64 * 1024 * 2 + 1), event_id=2)  # ring full
    with pytest.raises(tprim.XCCLError, match="expected event 3"):
        ch.recv(event_id=3)              # nothing sent under event 3


@settings(max_examples=20, deadline=None)
@given(sizes=st.lists(st.integers(0, 1_000_000), min_size=1, max_size=6),
       cores=st.integers(1, 16), fabric=st.sampled_from(["ub", "roce"]),
       asynchronous=st.booleans())
def test_same_protocol_state_and_times_as_reference(sizes, cores, fabric,
                                                    asynchronous):
    """Both copies chunk, account and time the same messages alike."""
    out = []
    for prim in (jprim, tprim):
        a = prim.NPUMemory(0, 2, ring_slots=64)
        b = prim.NPUMemory(1, 2, ring_slots=64)
        ch = prim.P2PChannel(a, b, n_aiv_cores=cores, fabric=fabric)
        trace = []
        for i, n in enumerate(sizes):
            msg = bytes(range(256)) * (n // 256) + b"\x07" * (n % 256)
            if asynchronous:
                ch.send_async(msg, event_id=i)
                got = ch.poll_async(event_id=i)
            else:
                trace.append(ch.send(msg, event_id=i))
                got = ch.recv(event_id=i)
            assert got == msg
            meta = b.meta[0]
            trace.append((meta.event_id, meta.chunk_id, meta.tail_ptr,
                          a.meta[1].ack_event, b.rings[0].head,
                          b.rings[0].tail))
        out.append((trace, ch.elapsed))
    assert out[0] == out[1]


def test_constants_come_from_the_port_topology():
    from repro_torch.xccl import topology

    assert tprim.UNIFIED_BUFFER_BYTES == topology.UNIFIED_BUFFER_BYTES \
        == jprim.UNIFIED_BUFFER_BYTES
    assert tprim.mte_transfer_time is topology.mte_transfer_time
