"""The port's ND4T payloads and DLFQ/DLFR/DLFP frames
(`deeplearning4j_tpu_torch/streaming/ndarray.py`,
`deeplearning4j_tpu_torch/serving/wire.py`) against the JAX package's
(`streaming/ndarray.py`, `serving/wire.py`): for every dtype code,
bf16 and int8 included, the bytes either package writes are equal, and
each package decodes the other's. The port carries bf16 without
`ml_dtypes`: a `torch.bfloat16` tensor goes out through its int16 view
and comes back as one. Mirrors the JAX package's wire tests
(`tests/test_serving_fleet.py` frame round trips, `tests/test_streaming.py`).
"""

import torch_port_threads  # noqa: F401  (caps torch's threads under xdist)

import socket

import ml_dtypes
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.serving import wire as jwire
from deeplearning4j_tpu.serving.server import ShedError as JaxShedError
from deeplearning4j_tpu.streaming import ndarray as jnd
from deeplearning4j_tpu_torch.serving import wire
from deeplearning4j_tpu_torch.serving.server import ShedError
from deeplearning4j_tpu_torch.streaming import (
    LocalLogTransport,
    LocalQueueTransport,
    NDArrayConsumer,
    NDArrayPublisher,
    deserialize_ndarray,
    serialize_ndarray,
)

DTYPES = ["float32", "float64", "int32", "int64", "bfloat16", "int8"]


def _arrays(dtype, shape=(2, 3, 5), seed=0):
    """(the JAX package's numpy array, the port's counterpart): equal
    values; bf16 as an ml_dtypes array and a torch.bfloat16 tensor."""
    rng = np.random.default_rng(seed)
    x = np.asarray(rng.standard_normal(shape)) * 40
    if dtype == "bfloat16":
        j = x.astype(ml_dtypes.bfloat16)
        return j, torch.from_numpy(j.view(np.int16).copy()).view(
            torch.bfloat16)
    j = x.astype(dtype)
    return j, j.copy()


def _as_bits(a):
    if isinstance(a, torch.Tensor):
        return a.view(torch.int16).numpy()
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(2, 3, 5), (7,), (1,), (0, 4)])
def test_nd4t_bytes_equal_both_ways(dtype, shape):
    j, p = _arrays(dtype, shape)
    jb = jnd.serialize_ndarray(j)
    assert serialize_ndarray(p) == jb
    # a numpy bf16 array from another library rides the same bytes
    assert serialize_ndarray(j) == jb
    back = deserialize_ndarray(jb)
    if dtype == "bfloat16":
        assert isinstance(back, torch.Tensor)
        assert back.dtype == torch.bfloat16
    else:
        assert isinstance(back, np.ndarray) and back.dtype == np.dtype(dtype)
    assert tuple(back.shape) == shape
    np.testing.assert_array_equal(_as_bits(back), _as_bits(j))
    jback = jnd.deserialize_ndarray(serialize_ndarray(p))
    assert jback.dtype == j.dtype
    np.testing.assert_array_equal(_as_bits(jback), _as_bits(j))


def test_nd4t_refuses_what_jax_refuses():
    with pytest.raises(TypeError, match="Unsupported dtype"):
        serialize_ndarray(np.zeros(3, np.uint8))
    with pytest.raises(ValueError, match="bad magic"):
        deserialize_ndarray(b"XXXX" + bytes(10))
    bad = bytearray(jnd.serialize_ndarray(np.zeros(2, np.float32)))
    bad[4] = 9
    with pytest.raises(ValueError, match="Unknown ND4T dtype code 9"):
        deserialize_ndarray(bytes(bad))


def test_card_tensor_serializes_from_the_host():
    t = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    assert serialize_ndarray(t) == jnd.serialize_ndarray(t.numpy())


@pytest.mark.parametrize("kind", ["queue", "log"])
def test_transports_carry_port_payloads(kind):
    tr = LocalQueueTransport() if kind == "queue" else LocalLogTransport()
    _, p = _arrays("bfloat16")
    NDArrayPublisher(tr, "t").publish(p)
    NDArrayPublisher(tr, "t").publish(np.arange(4, dtype=np.int8))
    got = NDArrayConsumer(tr, "t").consume(timeout=5)
    assert torch.equal(got.view(torch.int16), p.view(torch.int16))
    np.testing.assert_array_equal(NDArrayConsumer(tr, "t").consume(5),
                                  np.arange(4, dtype=np.int8))
    if kind == "log":
        assert tr.producer_offset("t") == 2
        assert tr.read("t", 0) == serialize_ndarray(p)


# ------------------------------------------------------------ frames
def _request_args(trace_id):
    return dict(temperature=0.7, top_p=0.9, rng=np.array([3, 9], np.uint32),
                emit_start=4, trace_id=trace_id)


@pytest.mark.parametrize("trace_id", [None, "abcdef0123456789"])
def test_request_frames_equal_both_ways(trace_id):
    prompt = np.random.default_rng(1).integers(0, 500, 37)
    kw = _request_args(trace_id)
    jf = jwire.encode_request("lm", "r-1", prompt, 12, **kw)
    pf = wire.encode_request("lm", "r-1", prompt, 12, **kw)
    assert pf == jf
    for frame, decode in ((jf, wire.decode_request),
                          (pf, jwire.decode_request)):
        header, ids = decode(frame)
        np.testing.assert_array_equal(ids, prompt)
        assert header["n_tokens"] == 12 and header["emit_start"] == 4
        assert header.get("trace_id") == trace_id
        np.testing.assert_array_equal(header["rng"], [3, 9])
    plain = wire.encode_request("lm", "r-2", prompt, 5)
    assert plain == jwire.encode_request("lm", "r-2", prompt, 5)
    assert "emit_start" not in wire.decode_request(plain)[0]


@pytest.mark.parametrize("error", [None, "shed", "other"])
def test_reply_frames_equal_and_errors_by_name(error):
    exc = {None: None, "shed": ShedError("over the SLO"),
           "other": KeyError("boom")}[error]
    jexc = {None: None, "shed": JaxShedError("over the SLO"),
            "other": KeyError("boom")}[error]
    pf = wire.encode_reply("r-1", 3, [5, 6, 7], done=error is not None,
                           model="lm", version=2, error=exc)
    jf = jwire.encode_reply("r-1", 3, [5, 6, 7], done=error is not None,
                            model="lm", version=2, error=jexc)
    assert pf == jf
    header, toks = wire.decode_reply(jf)
    np.testing.assert_array_equal(toks, [5, 6, 7])
    err = wire.reply_error(header)
    if error is None:
        assert err is None
    elif error == "shed":
        assert isinstance(err, ShedError) and "over the SLO" in str(err)
    else:
        assert type(err) is RuntimeError and "KeyError" in str(err)
    jerr = jwire.reply_error(jwire.decode_reply(pf)[0])
    assert (jerr is None) == (err is None)


def _handoff_header(n_blocks):
    return dict(request_id="h", prompt_len=9, n_tokens=20, pos=9,
                remaining=19, emit_base=0, emitted=1, last_token=4,
                history=[1, 2, 3], keys=[0, 7], temperature=0.0, top_p=1.0,
                block_len=4, emit_idx=1, n_layers=2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_handoff_frames_equal_both_ways(dtype):
    j, p = _arrays(dtype, shape=(2, 2, 3, 4, 2, 8), seed=3)
    h = _handoff_header(3)
    jf = jwire.encode_handoff(h, j)
    assert wire.encode_handoff(h, p) == jf
    header, kv = wire.decode_handoff(jf)
    assert header == h
    np.testing.assert_array_equal(_as_bits(kv), _as_bits(j))
    jheader, jkv = jwire.decode_handoff(wire.encode_handoff(h, p))
    assert jheader == h
    np.testing.assert_array_equal(_as_bits(jkv), _as_bits(j))


def test_decoders_raise_wire_format_errors():
    h = _handoff_header(3)
    frame = wire.encode_handoff(h, np.zeros((2, 2, 3, 4, 2, 8), np.float32))
    for bad in (frame[:6], b"DLFZ" + frame[4:], frame[:12],
                frame[:8] + b"{not json" + frame[17:]):
        with pytest.raises(wire.WireFormatError):
            wire.decode_handoff(bad)
    with pytest.raises(wire.WireFormatError, match="not a DLFQ frame"):
        wire.decode_request(frame)
    with pytest.raises(wire.WireFormatError, match="block_len"):
        wire.decode_handoff(wire.encode_handoff(
            dict(h, block_len=5), np.zeros((2, 2, 3, 4, 2, 8), np.float32)))
    with pytest.raises(wire.WireFormatError, match="missing"):
        wire.encode_handoff({"request_id": "x"}, np.zeros(1))


def test_socket_framing_round_trip():
    a, b = socket.socketpair()
    try:
        frame = wire.encode_reply("r", 0, [1, 2], done=True)
        wire.send_frame(a, frame)
        assert wire.recv_frame(b) == frame
        a.close()
        with pytest.raises(ConnectionError):
            wire.recv_frame(b)
    finally:
        b.close()
