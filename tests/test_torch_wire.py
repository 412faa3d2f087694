"""The wire-v2 frame and the KV ship bundle, across the two packages.

- `comm/wire.py`: a frame the port encodes equals the JAX package's frame
  on the same input, array for array (dtype, words, scale, shift, shape
  and the CRC trailer), at bits 0, 4 and 8, with and without CRC; each
  package decodes the other's frames; a corrupted frame raises
  `WireCorruptError` in both; the byte counters agree. The v1 (host)
  frame travels both ways too, and a bfloat16 frame goes onto the DCN
  wire byte for byte as JAX's with `ml_dtypes` blocked (the card's host
  has none).
- `kv/ship.py`: bundles round-trip in the port and decode in the other
  package both ways; the byte form round-trips.
- `PagedKvBackend.export_prefix` / `install_prefix` on the tiny GPT-2:
  the exported rows are the pool's pages, a second backend installs them
  into its trie (idempotently), an int8 cache exports None.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pipeedge_tpu.comm import wire as jwire
from pipeedge_tpu.kv import ship as jship
from pipeedge_tpu_torch.comm import wire as twire
from pipeedge_tpu_torch.kv import PagedKvBackend
from pipeedge_tpu_torch.kv import ship as tship
from pipeedge_tpu_torch.parallel import decode as tdec

# the plain codec's decode differs from XLA's CPU decode by 1-2 ulp
DECODE_ATOL = 2e-6
TINY = "pipeedge/test-tiny-gpt2"


def _payload(kind, seed=0):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(3, 5, 7)).astype(np.float32)
    if kind == "single":
        return (a,)
    return (a, rng.normal(size=(3, 11)).astype(np.float32) * 4)


def _port_frame(arrays, bit, crc):
    ts = tuple(torch.from_numpy(a) for a in arrays)
    return twire.wire_encode_device(ts if len(ts) > 1 else ts[0], bit,
                                    crc=crc).finalize()


def _jax_frame(arrays, bit, crc):
    xs = tuple(jnp.asarray(a) for a in arrays)
    return jwire.wire_encode_device(xs if len(xs) > 1 else xs[0], bit,
                                    crc=crc).finalize()


def _as_tuple(x):
    return x if isinstance(x, tuple) else (x,)


BITS = [0, 4, 8]


@pytest.mark.parametrize("kind", ["single", "pair"])
@pytest.mark.parametrize("crc", [False, True], ids=["nocrc", "crc"])
@pytest.mark.parametrize("bit", BITS)
def test_port_frame_equals_jax_frame(bit, crc, kind):
    arrays = _payload(kind)
    got, want = _port_frame(arrays, bit, crc), _jax_frame(arrays, bit, crc)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)
    assert twire.frame_wire_bytes(got) == jwire.frame_wire_bytes(want)
    assert twire.frame_payload_bytes(got) == jwire.frame_payload_bytes(want)


@pytest.mark.parametrize("crc", [False, True], ids=["nocrc", "crc"])
@pytest.mark.parametrize("bit", BITS)
def test_frames_decode_across_packages(bit, crc):
    arrays = _payload("pair", seed=bit)
    # port -> JAX, and port -> port
    frame = _port_frame(arrays, bit, crc)
    j_out = _as_tuple(jwire.wire_decode(frame, jnp.float32))
    t_out = _as_tuple(twire.wire_decode(frame, torch.float32, device="cpu"))
    # JAX -> port
    jframe = _jax_frame(arrays, bit, crc)
    t_from_j = _as_tuple(twire.wire_decode(jframe, torch.float32,
                                           device="cpu"))
    for a, j, t, tj in zip(arrays, j_out, t_out, t_from_j):
        j = np.asarray(j)
        np.testing.assert_allclose(t.numpy(), j, rtol=0, atol=DECODE_ATOL)
        np.testing.assert_allclose(tj.numpy(), j, rtol=0, atol=DECODE_ATOL)
        if bit == 0:
            np.testing.assert_array_equal(t.numpy(), a)
        else:
            span = a.max() - a.min()
            assert np.abs(t.numpy() - a).max() <= span / (2 ** bit - 1)


@pytest.mark.parametrize("bit", BITS)
def test_corrupt_frame_raises_in_both_packages(bit):
    frame = _port_frame(_payload("single"), bit, crc=True)
    bad = [a.copy() for a in frame]
    body = bad[1]
    body.reshape(-1).view(np.uint8)[3] ^= 0x10
    with pytest.raises(twire.WireCorruptError):
        twire.wire_decode(bad, torch.float32, device="cpu")
    with pytest.raises(jwire.WireCorruptError):
        jwire.wire_decode(bad, jnp.float32)
    # the intact frame still verifies, and the CRC header is found
    assert twire.locate_crc_header(frame) == 0
    twire.wire_decode(frame, torch.float32, device="cpu")


def test_v1_frames_are_refused():
    """A v1 frame whose quads are torn is refused, in both packages."""
    for body in ([np.zeros((2, 3), np.uint32)],
                 [np.zeros((2, 3), np.uint32)] * 5):
        bad = [np.asarray(8, np.int32)] + body
        with pytest.raises(ValueError,
                           match="malformed quantized wire frame"):
            twire.wire_decode(bad, torch.float32, device="cpu")
        with pytest.raises(ValueError,
                           match="malformed quantized wire frame"):
            jwire.wire_decode(bad, jnp.float32)


def test_v1_frame_decodes():
    v1 = [np.asarray(0, np.int32), np.ones((2, 3), np.float32)]
    np.testing.assert_array_equal(
        twire.wire_decode(v1, torch.float32, device="cpu").numpy(),
        np.ones((2, 3), np.float32))


@pytest.mark.parametrize("bit", BITS)
def test_v1_encoder_refuses_a_payload_off_the_cpu(bit):
    """The v1 encoder runs on the host: a payload on another device (here
    `meta`; the card's case is in test_torch_card.py) is refused, naming
    the device encoder, and nothing is copied to the host."""
    on_cpu = torch.zeros((2, 3))
    elsewhere = torch.zeros((2, 3), device="meta")
    for out in (elsewhere, (on_cpu, elsewhere)):
        with pytest.raises(ValueError, match="wire_encode_device"):
            twire.wire_encode(out, bit)


@pytest.mark.parametrize("native", ["1", "0"], ids=["native", "plain"])
@pytest.mark.parametrize("bit", BITS)
def test_v1_frames_both_ways(bit, native, monkeypatch):
    """The port's v1 frame (its native codec, or the plain ops where the
    native codec is not built) is the JAX v1 frame array for array, and
    each package decodes the other's."""
    if native == "1":
        assert bit == 0 or twire.native_wire_codec(bit) is not None
    else:
        monkeypatch.setattr(twire, "native_wire_codec", lambda bit: None)
    arrays = _payload("pair", seed=bit + 3)
    got = twire.wire_encode(tuple(torch.from_numpy(a) for a in arrays), bit)
    want = jwire.wire_encode(tuple(jnp.asarray(a) for a in arrays), bit)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert np.asarray(g).dtype == np.asarray(w).dtype
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    j_from_t = _as_tuple(jwire.wire_decode(got, jnp.float32))
    t_from_j = _as_tuple(twire.wire_decode(want, torch.float32,
                                           device="cpu"))
    for a, j, t in zip(arrays, j_from_t, t_from_j):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0,
                                   atol=DECODE_ATOL)
        if bit == 0:
            np.testing.assert_array_equal(t.numpy(), a)
    assert twire.frame_payload_bytes(got) == jwire.frame_payload_bytes(want)


def _dcn_bytes(module, frame):
    import socket
    a, b = socket.socketpair()
    module._send_frame(a, 1, 0, frame)
    a.close()
    data = bytearray()
    while chunk := b.recv(1 << 16):
        data += chunk
    b.close()
    return bytes(data)


def test_bf16_and_4bit_frames_without_ml_dtypes(monkeypatch):
    """With `ml_dtypes` unimportable, the port's wire encoder and DCN
    framing put a bfloat16 stage output (and int4/uint4 codes) on the wire
    byte for byte as the JAX package's encoder and framing do, and read
    the JAX frame back."""
    import ml_dtypes
    from pipeedge_tpu.comm import dcn as jdcn
    x = np.random.default_rng(4).normal(size=(3, 5)).astype(np.float32)
    jframe = jwire.wire_encode_device(jnp.asarray(x, jnp.bfloat16),
                                      0).finalize()
    want = _dcn_bytes(jdcn, jframe)
    i4 = np.arange(-8, 7, dtype=np.int8)
    u4 = np.arange(0, 15, dtype=np.uint8)
    want4 = _dcn_bytes(jdcn, [i4.astype(ml_dtypes.int4),
                              u4.astype(ml_dtypes.uint4)])
    monkeypatch.setitem(__import__("sys").modules, "ml_dtypes", None)
    t = torch.from_numpy(x).to(torch.bfloat16)
    frame = twire.wire_encode_device(t, 0).finalize()
    from pipeedge_tpu_torch.comm import dcn as tdcn
    assert _dcn_bytes(tdcn, frame) == want
    got4 = [twire.WireArray(i4, twire.CODE_INT4),
            twire.WireArray(u4, twire.CODE_UINT4)]
    assert _dcn_bytes(tdcn, got4) == want4
    import socket
    a, b = socket.socketpair()
    a.sendall(want)
    _, _, _, back = tdcn._recv_frame(b)
    a.close(), b.close()
    assert back[1].wire_code == twire.CODE_BFLOAT16
    out = twire.wire_decode(back, torch.bfloat16, device="cpu")
    assert out.dtype == torch.bfloat16 and torch.equal(out, t)


def test_decode_needs_a_device():
    frame = _port_frame(_payload("single"), 8, crc=False)
    with pytest.raises(TypeError):
        twire.wire_decode(frame, torch.float32)


def _caches(n_stages, seed=0):
    rng = np.random.default_rng(seed)
    return [{name: rng.normal(size=(2, 1, 32, 2, 4)).astype(np.float32)
             for name in ("k", "v")} for _ in range(n_stages)]


@pytest.mark.parametrize("crc", [False, True], ids=["nocrc", "crc"])
@pytest.mark.parametrize("bits", [0, 8])
def test_ship_bundles_round_trip_across_packages(bits, crc):
    caches = _caches(2, seed=bits)
    logits = np.arange(12, dtype=np.float32).reshape(2, 6)
    plen = 17
    tcaches = [{k: torch.from_numpy(v) for k, v in c.items()}
               for c in caches]
    frames = tship.encode_kv_ship(tcaches, plen, logits, bits=bits, crc=crc)
    jframes = jship.encode_kv_ship(
        [{k: jnp.asarray(v) for k, v in c.items()} for c in caches], plen,
        logits, bits=bits, crc=crc)
    assert len(frames) == len(jframes)
    for g, w in zip(frames, jframes):
        np.testing.assert_array_equal(g, w)
    blob = tship.frames_to_bytes(frames)
    back = tship.frames_from_bytes(blob)
    handle = tship.decode_kv_ship(back, torch.float32, device="cpu")
    jhandle = jship.decode_kv_ship(jframes, jnp.float32)
    from_jax = tship.decode_kv_ship(jship.frames_from_bytes(
        jship.frames_to_bytes(jframes)), torch.float32, device="cpu")
    assert handle["prompt_len"] == jhandle["prompt_len"] == plen
    np.testing.assert_array_equal(handle["logits"], logits)
    for c, t, j, tj in zip(caches, handle["stage_rows"],
                           jhandle["stage_rows"], from_jax["stage_rows"]):
        for name in ("k", "v"):
            want = c[name][:, :, :plen]
            np.testing.assert_allclose(t[name].numpy(), np.asarray(j[name]),
                                       rtol=0, atol=DECODE_ATOL)
            np.testing.assert_array_equal(t[name].numpy(),
                                          tj[name].numpy())
            if bits == 0:
                np.testing.assert_array_equal(t[name].numpy(), want)


def test_ship_refuses_int8_caches_and_bad_bundles():
    cache = {"k": torch.zeros(1, 1, 4, 1, 2, dtype=torch.int8),
             "v": torch.zeros(1, 1, 4, 1, 2, dtype=torch.int8),
             "k_scale": torch.zeros(1, 1, 4, 1)}
    with pytest.raises(ValueError, match="int8"):
        tship.encode_kv_ship([cache], 2, np.zeros((1, 1)))
    with pytest.raises(ValueError, match="bits"):
        tship.encode_kv_ship([], 2, np.zeros((1, 1)), bits=4)
    frames = tship.encode_kv_ship(
        [{k: torch.from_numpy(v) for k, v in c.items()}
         for c in _caches(1)], 4, np.zeros((1, 1)))
    with pytest.raises(ValueError, match="trailing"):
        tship.decode_kv_ship(frames + [np.zeros(1)], torch.float32,
                             device="cpu")
    with pytest.raises(ValueError, match="magic"):
        tship.decode_kv_ship(frames[2:], torch.float32, device="cpu")


def _tiny_backend(kv_bits=0, pages=16):
    pipe = tdec.build_decode_pipeline(TINY, [(1, 4), (5, 8)], max_len=48,
                                      cache_bits=kv_bits, device="cpu")
    return pipe, PagedKvBackend(pipe, pages, page_size=4)


def _publish(backend, pipe, tokens):
    """Run a prompt through the backend's prefill and publish its pages
    (the executors' path, one stage-step per stage)."""
    from pipeedge_tpu_torch.parallel import batcher
    ids = np.asarray([tokens], np.int64)
    req = batcher._build_request(pipe, "r0", ids, 2, 0.0, 0, 0, None, None,
                                 None)
    kind, data = backend.admit(req)
    for i in range(len(pipe.stages)):
        data = backend.run_stage(i, req, data, kind)
    backend.release(req)


def test_export_install_prefix_moves_the_pages():
    tokens = list(range(3, 15))      # 12 tokens: 3 full pages of 4
    pipe, src = _tiny_backend()
    _publish(src, pipe, tokens)
    out = src.export_prefix(tokens)
    assert out is not None
    frames, plen, pages = out
    assert (plen, pages) == (12, 3)
    handle = tship.decode_kv_ship(frames, pipe.dtype, device="cpu")
    table = np.asarray([src.trie.lookup(tokens, max_tokens=12)], np.int64)
    for i in range(len(pipe.stages)):
        view = src.pool.gather(i, table)
        for name in ("k", "v"):
            assert torch.equal(handle["stage_rows"][i][name], view[name])
    src.pool.release(table[0].tolist())
    # JAX's decoder reads the port's export
    jhandle = jship.decode_kv_ship(frames, jnp.float32)
    np.testing.assert_array_equal(
        np.asarray(jhandle["stage_rows"][1]["v"]),
        handle["stage_rows"][1]["v"].numpy())

    pipe2, dst = _tiny_backend()
    free0 = dst.pool.free_pages
    assert dst.shared_prompt_tokens(tokens) == 0
    assert dst.install_prefix(tokens, handle) == 3
    assert dst.install_prefix(tokens, handle) == 0      # idempotent
    assert dst.shared_prompt_tokens(tokens + [99]) == 12
    assert dst.pool.free_pages == free0 - 3             # trie-retained
    table = np.asarray([dst.trie.lookup(tokens, max_tokens=12)], np.int64)
    for i in range(len(pipe2.stages)):
        view = dst.pool.gather(i, table)
        for name in ("k", "v"):
            assert torch.equal(view[name], handle["stage_rows"][i][name])
    dst.pool.release(table[0].tolist())
    assert src.export_prefix([1, 2, 3, 4]) is None      # nothing cached


def test_int8_cache_exports_none():
    tokens = list(range(3, 11))
    pipe, backend = _tiny_backend(kv_bits=8)
    _publish(backend, pipe, tokens)
    assert backend.shared_prompt_tokens(tokens + [1]) == 8
    assert backend.export_prefix(tokens) is None
