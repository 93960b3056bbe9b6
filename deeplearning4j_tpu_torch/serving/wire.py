"""Request-plane wire format (counterpart of
`deeplearning4j_tpu/serving/wire.py`; the frames are byte for byte the
JAX package's).

Each message is a JSON header (routing metadata) followed by ND4T
ndarray bytes (`streaming.ndarray.serialize_ndarray`):

    b"DLFQ" <u32 header_len> <header json> <ND4T prompt bytes>
    b"DLFR" <u32 header_len> <header json> <ND4T token-chunk bytes>
    b"DLFP" <u32 header_len> <header json> <ND4T stacked K/V bytes>

A request header may carry ``trace_id``, the trace context a server
rehydrates into a `RequestTrace`. A reply header carries ``seq``,
``done``, the ``model``/``version`` tag and on failure
``error_type``/``error``; `reply_error` re-raises ShedError by name, so
a shed request fails the same way remotely as locally.

The DLFP frame is the prefill-to-decode handoff: the header is the
slot's host state, the payload its K/V blocks stacked
``[n_layers, 2, n_blocks, block_len, heads, head_dim]`` in the pool's
compute dtype (a bf16 pool rides as a `torch.bfloat16` tensor), so a
decode engine adopts the slot bit for bit.

Every decoder raises `WireFormatError` on truncated or corrupt bytes and
on unknown magics. Sockets carry the frames length-prefixed
(`send_frame`/`recv_frame`).
"""

from __future__ import annotations

import json
import struct
from typing import Optional, Tuple

import numpy as np

from deeplearning4j_tpu_torch.streaming.ndarray import (
    deserialize_ndarray,
    serialize_ndarray,
)

REQUEST_MAGIC = b"DLFQ"
REPLY_MAGIC = b"DLFR"
HANDOFF_MAGIC = b"DLFP"

KNOWN_MAGICS = (REQUEST_MAGIC, REPLY_MAGIC, HANDOFF_MAGIC)

# largest frame a socket peer will accept: the K/V handoff for a real
# request is tens of MB at small shapes; 1 GiB bounds a hostile or
# corrupted length prefix without constraining any legitimate frame
MAX_FRAME_BYTES = 1 << 30


class WireFormatError(ValueError):
    """A frame failed to decode: truncated bytes, an unknown or
    mismatched magic, malformed header JSON, or a corrupt ndarray
    payload. Subclasses ValueError so pre-existing `except ValueError`
    call sites keep working."""


def _frame(magic: bytes, header: dict, arr) -> bytes:
    hb = json.dumps(header, sort_keys=True).encode()
    payload = b"" if arr is None else serialize_ndarray(arr)
    return magic + struct.pack("<I", len(hb)) + hb + payload


def _unframe(magic: bytes, data: bytes) -> Tuple[dict, object]:
    if not isinstance(data, (bytes, bytearray, memoryview)):
        raise WireFormatError(
            f"frame must be bytes, got {type(data).__name__}")
    data = bytes(data)
    if len(data) < 8:
        raise WireFormatError(
            f"truncated frame: {len(data)} bytes, need at least 8")
    if data[:4] != magic:
        got = data[:4]
        if got in KNOWN_MAGICS:
            raise WireFormatError(
                f"not a {magic.decode()} frame (got {got.decode()})")
        raise WireFormatError(
            f"not a {magic.decode()} frame (unknown magic {got!r})")
    (hlen,) = struct.unpack_from("<I", data, 4)
    if 8 + hlen > len(data):
        raise WireFormatError(
            f"truncated frame: header claims {hlen} bytes but only "
            f"{len(data) - 8} follow the magic")
    try:
        header = json.loads(data[8:8 + hlen].decode())
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise WireFormatError(f"malformed frame header: {e}") from e
    if not isinstance(header, dict):
        raise WireFormatError(
            f"frame header must be a JSON object, got "
            f"{type(header).__name__}")
    rest = data[8 + hlen:]
    if not rest:
        return header, None
    try:
        return header, deserialize_ndarray(rest)
    except (ValueError, struct.error, TypeError) as e:
        raise WireFormatError(f"corrupt ndarray payload: {e}") from e


def _require(header: dict, keys, magic: bytes) -> None:
    missing = [k for k in keys if k not in header]
    if missing:
        raise WireFormatError(
            f"{magic.decode()} header missing field(s) {missing}")


# ------------------------------------------------------------- requests
def encode_request(model: str, request_id: str, prompt_ids, n_tokens: int,
                   *, temperature: float = 0.0,
                   top_p: Optional[float] = None, rng=None,
                   emit_start: int = 0,
                   trace_id: Optional[str] = None) -> bytes:
    """`trace_id` is the distributed-tracing context field: a client-
    minted id the router rehydrates into a `RequestTrace`, so the
    remote request's server-side spans land on the SAME timeline as the
    client's (one stitched trace per request across the wire).

    `emit_start` is the migration continuation seam: a stream that died
    on one replica after K tokens resubmits to another as
    prompt+received with ``emit_start=K``, preserving the sampled
    fold_in(key, position) chain (zero is omitted from the header —
    pre-migration peers decode these frames unchanged)."""
    header = {
        "model": str(model),
        "request_id": str(request_id),
        "n_tokens": int(n_tokens),
        "temperature": float(temperature),
        "top_p": None if top_p is None else float(top_p),
        "rng": None if rng is None else
               [int(x) for x in np.asarray(rng, np.uint32).reshape(2)],
    }
    if emit_start:
        header["emit_start"] = int(emit_start)
    if trace_id is not None:
        header["trace_id"] = str(trace_id)
    return _frame(REQUEST_MAGIC, header,
                  np.asarray(prompt_ids, np.int64))


def decode_request(data: bytes) -> Tuple[dict, np.ndarray]:
    """(header, prompt_ids). Raises WireFormatError on a non-request
    or corrupt frame."""
    header, prompt = _unframe(REQUEST_MAGIC, data)
    if prompt is None:
        raise WireFormatError("request frame carries no prompt payload")
    _require(header, ("model", "request_id", "n_tokens"), REQUEST_MAGIC)
    if header.get("rng") is not None:
        try:
            header["rng"] = np.asarray(header["rng"], np.uint32)
        except (ValueError, TypeError) as e:
            raise WireFormatError(f"malformed rng field: {e}") from e
    return header, prompt


# --------------------------------------------------------------- replies
def encode_reply(request_id: str, seq: int, tokens, *, done: bool,
                 model: Optional[str] = None,
                 version: Optional[int] = None,
                 error: Optional[BaseException] = None) -> bytes:
    header = {
        "request_id": str(request_id),
        "seq": int(seq),
        "done": bool(done),
        "model": model,
        "version": version,
    }
    if error is not None:
        header["error_type"] = type(error).__name__
        header["error"] = str(error)
    toks = np.asarray([] if tokens is None else tokens, np.int32)
    return _frame(REPLY_MAGIC, header, toks)


def decode_reply(data: bytes) -> Tuple[dict, np.ndarray]:
    """(header, token_chunk). The header's error fields are left to the
    caller: `reply_error(header)` maps error_type "ShedError" back to
    ShedError and everything else to RuntimeError."""
    header, toks = _unframe(REPLY_MAGIC, data)
    _require(header, ("request_id", "seq", "done"), REPLY_MAGIC)
    return header, (np.zeros(0, np.int32) if toks is None
                    else toks.astype(np.int32))


def reply_error(header: dict) -> Optional[BaseException]:
    """Rehydrate a reply header's error, preserving the shed/failure
    distinction across the wire."""
    if "error_type" not in header:
        return None
    from deeplearning4j_tpu_torch.serving.server import ShedError
    msg = f"{header.get('error', '')} (remote {header['error_type']})"
    if header["error_type"] == "ShedError":
        return ShedError(msg)
    return RuntimeError(msg)


# ------------------------------------------------- PFD handoff frames
# Fields every handoff header must carry for a decode worker to rebuild
# the slot's host state exactly (see PagedDecodeEngine.export_handoff).
HANDOFF_FIELDS = ("request_id", "prompt_len", "n_tokens", "pos",
                  "remaining", "emit_base", "emitted", "last_token",
                  "history", "keys", "temperature", "block_len")


def encode_handoff(header: dict, kv) -> bytes:
    """DLFP frame: `header` is the slot-state dict the engine exports,
    `kv` the stacked per-layer K/V blocks
    ``[n_layers, 2, n_blocks, block_len, heads, head_dim]`` (a numpy
    array or a tensor)."""
    _require(header, HANDOFF_FIELDS, HANDOFF_MAGIC)
    return _frame(HANDOFF_MAGIC, header, kv)


def decode_handoff(data: bytes) -> Tuple[dict, object]:
    """(header, kv): kv a numpy array, or a `torch.bfloat16` tensor for
    a bf16 pool. Raises WireFormatError on a non-handoff or
    corrupt frame, including a payload whose shape cannot be a stacked
    K/V block set."""
    header, kv = _unframe(HANDOFF_MAGIC, data)
    _require(header, HANDOFF_FIELDS, HANDOFF_MAGIC)
    if kv is None or kv.ndim != 6 or kv.shape[1] != 2:
        shape = None if kv is None else kv.shape
        raise WireFormatError(
            f"handoff payload is not stacked K/V blocks "
            f"[L, 2, B, block_len, H, Dh] (shape {shape})")
    if kv.shape[3] != int(header["block_len"]):
        raise WireFormatError(
            f"handoff payload block_len {kv.shape[3]} != header "
            f"block_len {header['block_len']}")
    return header, kv


# ------------------------------------------- socket framing (replicas)
def send_frame(sock, frame: bytes) -> None:
    """Write one length-prefixed frame to a connected socket."""
    if len(frame) > MAX_FRAME_BYTES:
        raise WireFormatError(
            f"frame of {len(frame)} bytes exceeds the "
            f"{MAX_FRAME_BYTES}-byte wire bound")
    sock.sendall(struct.pack("<I", len(frame)) + frame)


def _recv_exact(sock, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(min(1 << 20, n - len(buf)))
        if not chunk:
            raise ConnectionError(
                f"peer closed mid-frame ({len(buf)}/{n} bytes)")
        buf += chunk
    return bytes(buf)


def recv_frame(sock) -> bytes:
    """Read one length-prefixed frame. Raises ConnectionError on a
    clean or mid-frame close, WireFormatError on an absurd length
    prefix (corrupt stream)."""
    prefix = bytearray()
    while len(prefix) < 4:
        chunk = sock.recv(4 - len(prefix))
        if not chunk:
            if prefix:
                raise ConnectionError(
                    "peer closed mid-frame (inside length prefix)")
            raise ConnectionError("peer closed the connection")
        prefix += chunk
    (n,) = struct.unpack("<I", bytes(prefix))
    if n > MAX_FRAME_BYTES:
        raise WireFormatError(
            f"length prefix {n} exceeds the {MAX_FRAME_BYTES}-byte "
            f"wire bound (corrupt stream?)")
    return _recv_exact(sock, n)
