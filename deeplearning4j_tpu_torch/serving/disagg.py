"""Disaggregated prefill and decode workers over the DLFP handoff frame
(counterpart of `deeplearning4j_tpu/serving/disagg.py`).

Prefill is a compute-bound burst, decode a bandwidth-bound steady state,
so they can run on different engines that share the paged block table
as the handoff format. `PrefillWorker` admits a prompt, emits the first
token and exports the slot's K/V blocks and host state as a `DLFP`
frame (`serving/wire.py`); `DecodeWorker` adopts the frame into its own
pool and continues the stream.

Parity: the adopted slot decodes as the colocated path would, since the
K/V bytes are copied exactly (no recompute, no cast) and the decode is
the same, so a greedy stream equals the colocated one token for token.

Delivery is at least once: the exporting slot stays decodable until the
frame bytes exist (`PrefillWorker.prefill` evicts after building them;
a socket sender should evict after the send succeeds).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from deeplearning4j_tpu_torch.serving import wire
from deeplearning4j_tpu_torch.serving.engine import PagedDecodeEngine


class PrefillWorker:
    """The compute-bound half: admission waves only, every slot
    exported the moment its first token exists. Slots are transient —
    a prefill worker's pool holds each request only for the handoff
    window, so a small pool fronts a much larger decode fleet."""

    def __init__(self, net, *, n_slots: int = 8, n_blocks: int = 64,
                 block_len: int = 16, quantize: Optional[str] = None,
                 device="cuda", **engine_kw):
        self.engine = PagedDecodeEngine(
            net, n_slots=n_slots, n_blocks=n_blocks,
            block_len=block_len, quantize=quantize, device=device,
            **engine_kw)

    def prefill(self, prompt_ids, n_tokens: int, *,
                request_id: Optional[str] = None,
                temperature: float = 0.0,
                top_p: Optional[float] = None, rng=None,
                emit_start: int = 0) -> Tuple[int, Optional[bytes]]:
        """Run one prompt's prefill and package the handoff. Returns
        `(first_token, frame_bytes)`; `frame_bytes` is None when the
        request finished AT prefill (n_tokens == 1 — there is no
        decode half to hand off). Raises RuntimeError when the wave
        could not be admitted (slots/blocks exhausted — the caller's
        backpressure signal)."""
        req = dict(prompt_ids=np.asarray(prompt_ids), n_tokens=int(n_tokens),
                   request_id=request_id, temperature=temperature,
                   top_p=top_p, rng=rng, emit_start=emit_start)
        out = self.engine.admit_many([req])
        if not out:
            raise RuntimeError(
                "prefill worker could not admit the request "
                f"({self.engine.free_slots} slots, "
                f"{self.engine.free_blocks} blocks free)")
        slot, first, done = out[0]
        if done:
            return int(first), None
        header, kv = self.engine.export_handoff(slot)
        frame = wire.encode_handoff(header, kv)
        # frame built — the K/V bytes are out of the pool, release
        self.engine.evict(slot)
        return int(first), frame


class DecodeWorker:
    """The bandwidth-bound half: adopts handed-off slots and advances
    them one (or k speculative) token(s) per dispatch. Drive it with
    `step()` inside a scheduler, or `decode_to_completion` for
    whole-stream use."""

    def __init__(self, net, *, n_slots: int = 8, n_blocks: int = 64,
                 block_len: int = 16, quantize: Optional[str] = None,
                 device="cuda", **engine_kw):
        self.engine = PagedDecodeEngine(
            net, n_slots=n_slots, n_blocks=n_blocks,
            block_len=block_len, quantize=quantize, device=device,
            **engine_kw)

    def adopt(self, frame: bytes) -> int:
        """Decode a `DLFP` frame and adopt its slot. Returns the local
        slot index; raises WireFormatError on corrupt bytes,
        ValueError/RuntimeError per `PagedDecodeEngine.adopt_handoff`."""
        header, kv = wire.decode_handoff(frame)
        return self.engine.adopt_handoff(header, kv)

    def step(self):
        """One decode dispatch across every adopted slot — the same
        `(emitted, finished)` contract as the engine."""
        return self.engine.step()

    def decode_to_completion(self, slots: List[int]) -> Dict[int, List[int]]:
        """Advance until every listed slot finishes; returns the
        decode-side token stream per slot (the full stream is the
        prefill's first token + this)."""
        out: Dict[int, List[int]] = {s: [] for s in slots}
        pending = set(slots)
        while pending:
            emitted, finished = self.engine.step()
            for s, toks in emitted.items():
                if s in out:
                    out[s].extend(toks)
            pending -= set(finished)
        return out


def run_disaggregated(prefill: PrefillWorker, decode: DecodeWorker,
                      prompts, n_tokens: int, *,
                      channel=None) -> List[List[int]]:
    """Run a batch of greedy requests through the split pipeline:
    prefill on one engine, PFD frames across `channel` (a connected
    socket pair — frames ride `wire.send_frame`/`recv_frame`; None
    keeps the bytes in-process, same encode/decode path), decode on
    the other. Returns the full token stream per prompt, directly
    comparable to the colocated/`generate()` reference."""
    firsts, frames = [], []
    for i, p in enumerate(prompts):
        first, frame = prefill.prefill(p, n_tokens, request_id=f"pfd-{i}")
        firsts.append(first)
        frames.append(frame)
    if channel is not None:
        tx, rx = channel
        delivered = []
        for frame in frames:
            if frame is None:
                delivered.append(None)
                continue
            wire.send_frame(tx, frame)
            delivered.append(wire.recv_frame(rx))
        frames = delivered
    slot_of = {}
    for i, frame in enumerate(frames):
        if frame is not None:
            slot_of[i] = decode.adopt(frame)
    rest = decode.decode_to_completion(list(slot_of.values()))
    return [[firsts[i]] + rest.get(slot_of[i], []) if i in slot_of
            else [firsts[i]] for i in range(len(prompts))]
