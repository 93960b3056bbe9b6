"""Paged continuous-batching decode engine (counterpart of
`deeplearning4j_tpu/serving/engine.py`'s `PagedDecodeEngine` :116).

A fixed set of `n_slots` serving slots advances `steps_per_dispatch`
tokens per `step()` over the paged KV pool; empty slots decode into the
garbage block and are masked out on the host. Admission prefills a WAVE
of prompts — widths padded to a power of two, prompt lengths right-padded
to one power-of-two bucket — with the KV-cache carries
(`zoo.transformer.get_prefill_bucketed`, `generate()`'s forward), then
scatters each sequence's cache into its pool blocks and samples its
first token.

Block allocation is incremental: admission grants the prompt's blocks;
`step()` grows a slot's table as its position crosses block boundaries,
and under pool pressure preempts the lowest-progress slot into
`drain_preempted()` for requeue (the JAX engine's `allocation="upfront"`
A/B baseline is not ported).

Decode-parity contract: for the same prompt the greedy stream equals
`generate()`'s. Sampled token t of a request is the Gumbel-max draw with
noise seeded by (request seed, t) (`zoo.transformer.gumbel_noise`), so a
stream does not depend on what else is in flight, across preemption
included. Speculative decoding, shared prefixes (CoW / radix), int8
weights and the handoff export/adopt are later slices; the constructor
takes none of their arguments.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch.device import resolve_device
from deeplearning4j_tpu_torch.nn.layers import (
    BaseRecurrentLayer,
    PositionalEncodingLayer,
    TransformerEncoderBlock,
    stream_budget,
)
from deeplearning4j_tpu_torch.serving.paged import (
    GARBAGE_BLOCK,
    PagedKVPool,
    blocks_needed,
)
from deeplearning4j_tpu_torch.zoo.transformer import (
    check_decode_policy,
    check_ids,
    get_prefill_bucketed,
    gumbel_noise,
    sample_ids,
)


def bucket_len(n: int, cap: int) -> int:
    """The next power of two >= n, clamped to `cap` (the stream budget)."""
    b = 1
    while b < n:
        b *= 2
    return min(b, cap)


class Slot:
    """Host mirror of one serving slot's in-flight sequence."""

    __slots__ = ("request_id", "blocks", "emitted", "emit_base")

    def __init__(self, request_id, blocks, emit_base=0):
        self.request_id = request_id
        self.blocks = blocks
        self.emitted = 0
        # tokens emitted in EARLIER admissions of a requeued continuation
        self.emit_base = emit_base

    @property
    def progress(self) -> int:
        """Total tokens this REQUEST has emitted (across preemptions)."""
        return self.emit_base + self.emitted


class PagedDecodeEngine:
    """Continuous-batching decode over a `PagedKVPool`. Single-threaded:
    every method is called from one scheduler thread (serving/server.py)
    or directly by a test. `top_k` is engine-static; temperature, top_p
    and the sampling seed are per request."""

    def __init__(self, net, *, n_slots: int = 8, n_blocks: int = 64,
                 block_len: int = 16, top_k: Optional[int] = None,
                 steps_per_dispatch: int = 1, device="cuda"):
        self.device = resolve_device(device)
        if net.device != self.device:
            raise ValueError(f"net lives on {net.device}, engine asked for "
                             f"{self.device}: move the net with .to()")
        check_decode_policy(net)
        self.net = net
        self.n_slots = int(n_slots)
        if self.n_slots < 1:
            raise ValueError(f"n_slots must be >= 1; got {n_slots}")
        self.steps_per_dispatch = int(steps_per_dispatch)
        if self.steps_per_dispatch < 1:
            raise ValueError(
                f"steps_per_dispatch must be >= 1; got {steps_per_dispatch}")
        self.vocab = net.layers[-1].n_out
        self.top_k = None if top_k is None else int(top_k)
        if self.top_k is not None and not 1 <= self.top_k <= self.vocab:
            raise ValueError(f"top_k must be in [1, vocab={self.vocab}]; "
                             f"got {top_k}")
        budget = stream_budget(net.layers)
        if budget is None:
            raise ValueError("net has no bounded stream budget (no "
                             "TransformerEncoderBlock / PositionalEncoding"
                             "Layer) — nothing to page")
        if budget % block_len != 0:
            raise ValueError(
                f"block_len {block_len} must divide the stream budget "
                f"{budget}: the gathered page view must have the "
                f"monolithic cache's length for decode parity")
        self.max_blocks = budget // int(block_len)
        self.max_total_tokens = budget
        self.pool = PagedKVPool(net, n_blocks, block_len)
        self.block_len = int(block_len)
        self._plan: List[Tuple] = []
        pool_j = 0
        for i, layer in enumerate(net.layers):
            if isinstance(layer, TransformerEncoderBlock):
                self._plan.append(("block", i, pool_j))
                pool_j += 1
            elif isinstance(layer, PositionalEncodingLayer):
                self._plan.append(("pos", i))
            elif isinstance(layer, BaseRecurrentLayer):
                raise ValueError(f"layer {i} ({type(layer).__name__}) "
                                 "carries state but has no paged path")
            else:
                self._plan.append(("plain", i))
        S = self.n_slots
        self.block_tables = np.zeros((S, self.max_blocks), np.int64)
        self.pos = np.zeros(S, np.int64)
        self.active = np.zeros(S, bool)
        self.remaining = np.zeros(S, np.int64)
        self.emit_idx = np.zeros(S, np.int64)
        self.last_token = np.zeros(S, np.int64)
        self.seeds = np.zeros(S, np.int64)
        self.temp = np.zeros(S, np.float32)
        self.top_p = np.ones(S, np.float32)
        self.slots: List[Optional[Slot]] = [None] * S
        self.block_grants_total = 0
        self.evict_requeue_total = 0
        self._preempted: List[dict] = []

    # ------------------------------------------------------------ queries
    @property
    def free_slots(self) -> int:
        return sum(1 for s in self.slots if s is None)

    @property
    def active_slots(self) -> int:
        return int(self.active.sum())

    @property
    def free_blocks(self) -> int:
        return self.pool.free_blocks

    def can_admit(self, prompt_len: int) -> bool:
        """A free slot and the prompt's blocks are available now."""
        if not any(s is None for s in self.slots):
            return False
        return blocks_needed(prompt_len, self.block_len) <= self.free_blocks

    def check_budget(self, prompt_len: int, n_tokens: int):
        """Reject requests that can NEVER be admitted: over the
        per-sequence budget, or needing more blocks at the end than the
        pool can ever free (a request must be able to finish alone)."""
        if n_tokens < 1:
            raise ValueError(f"n_tokens must be >= 1; got {n_tokens}")
        total = prompt_len + n_tokens
        if total > self.max_total_tokens:
            raise ValueError(
                f"prompt ({prompt_len}) + n_tokens ({n_tokens}) = {total} "
                f"exceeds the per-sequence page budget "
                f"{self.max_total_tokens}; this request can never be "
                f"admitted")
        usable = self.pool.n_blocks - 1
        needed = blocks_needed(total, self.block_len)
        if needed > usable:
            raise ValueError(
                f"request needs {needed} pool blocks but the pool only "
                f"has {usable} usable (n_blocks {self.pool.n_blocks} incl. "
                f"the garbage block); it can never be admitted")

    # ----------------------------------------------------------- sampling
    def _noise(self, seeds, emit_idx, temps) -> Optional[torch.Tensor]:
        """Gumbel noise [S, V] on the device: rows with temp > 0 get
        their request's (seed, emit index) draw, greedy rows zeros."""
        if not (temps > 0).any():
            return None
        noise = torch.zeros((len(seeds), self.vocab))
        for s in np.flatnonzero(temps > 0):
            noise[s] = gumbel_noise(int(seeds[s]), int(emit_idx[s]),
                                    self.vocab)
        return noise.to(self.device)

    def _sample(self, probs, seeds, emit_idx, temps, top_ps):
        noise = self._noise(seeds, emit_idx, temps)
        dev = self.device
        return sample_ids(probs, torch.as_tensor(temps, device=dev),
                          self.top_k, torch.as_tensor(top_ps, device=dev),
                          noise, greedy_only=noise is None)

    # ---------------------------------------------------------- admission
    def admit_many(self, requests: List[dict]):
        """Admission wave over a FIFO prefix of `requests` (stops at slot
        or block capacity). Each dict: prompt_ids, n_tokens, and
        optionally request_id, temperature, top_p, rng (an int seed) and
        emit_start (a requeued continuation's emitted count). Returns
        [(slot, first_token, done), ...] for the admitted prefix."""
        if not requests:
            return []
        wave = []
        try:
            for r in requests:
                prompt = np.asarray(r["prompt_ids"])
                if prompt.ndim == 2 and prompt.shape[0] == 1:
                    prompt = prompt[0]
                if prompt.ndim != 1 or prompt.size == 0:
                    raise ValueError(f"prompt must be a non-empty 1-D id "
                                     f"sequence; got shape {prompt.shape}")
                prompt = prompt.astype(np.int64)
                check_ids(prompt, self.vocab)
                P, n_tokens = int(prompt.shape[0]), int(r["n_tokens"])
                self.check_budget(P, n_tokens)
                slot = next((i for i, s in enumerate(self.slots)
                             if s is None
                             and all(i != w["slot"] for w in wave)), None)
                if slot is None:
                    break
                nb = blocks_needed(P, self.block_len)
                blocks = self.pool.allocator.allocate(nb)
                if blocks is None:
                    break
                wave.append(dict(blocks=blocks, grants=nb, slot=slot,
                                 prompt=prompt, n_tokens=n_tokens, r=r))
            if not wave:
                return []
            results = {}
            self._admit_wave(wave, results)
            return [results[w["slot"]] for w in wave]
        except Exception:
            # blocks of a failed wave that no Slot took over go back to
            # the pool (otherwise the pool would shrink for good)
            for w in wave:
                s = self.slots[w["slot"]]
                if s is None or s.blocks is not w["blocks"]:
                    try:
                        self.pool.allocator.free(w["blocks"])
                    except ValueError:
                        pass   # already back in the pool
            raise

    def _admit_wave(self, wave, results):
        k = len(wave)
        # width padded to a power of two and lengths to one bucket, as in
        # the JAX engine (there each distinct shape was a compile; here
        # it keeps the batched prefill's shapes to a small set). Dummy
        # rows repeat the last prompt and write only the garbage block.
        k2 = 1
        while k2 < k:
            k2 *= 2
        Pb = bucket_len(max(int(w["prompt"].shape[0]) for w in wave),
                        self.max_total_tokens)
        prompts = np.zeros((k2, Pb), np.int64)
        last_idx = np.zeros(k2, np.int64)
        for j, w in enumerate(wave):
            prompts[j, :w["prompt"].shape[0]] = w["prompt"]
            last_idx[j] = w["prompt"].shape[0] - 1
        for j in range(k, k2):
            prompts[j] = prompts[k - 1]
            last_idx[j] = last_idx[k - 1]
        dev = self.device
        probs, carries = get_prefill_bucketed(self.net)(
            torch.as_tensor(prompts, device=dev),
            self.net.init_carries(k2), torch.as_tensor(last_idx, device=dev))

        bl = self.block_len
        rows = np.full((k2, self.max_blocks), GARBAGE_BLOCK, np.int64)
        seeds = np.zeros(k2, np.int64)
        emit0 = np.zeros(k2, np.int64)
        temps = np.zeros(k2, np.float32)
        top_ps = np.ones(k2, np.float32)
        for j, w in enumerate(wave):
            rows[j, :len(w["blocks"])] = w["blocks"]
            r = w["r"]
            seeds[j] = int(r.get("rng") or 0)
            emit0[j] = int(r.get("emit_start") or 0)
            temps[j] = r.get("temperature") or 0.0
            p = r.get("top_p")
            top_ps[j] = 1.0 if p is None else p
        rows_t = torch.as_tensor(rows, device=dev)
        # scatter each row's monolithic cache into its pool blocks, in
        # place; unowned table entries point at the garbage block
        for (k_pool, v_pool), li in zip(self.pool.kv, self.pool.layer_indices):
            k_cache, v_cache, _ = carries[str(li)]
            C = k_cache.shape[1]
            flat = rows_t[:, :C // bl].reshape(-1)
            shape = (k2 * (C // bl), bl) + tuple(k_cache.shape[2:])
            k_pool[flat] = k_cache.reshape(shape).to(k_pool.dtype)
            v_pool[flat] = v_cache.reshape(shape).to(v_pool.dtype)
        firsts = self._sample(probs, seeds, emit0, temps, top_ps).cpu().numpy()
        for j, w in enumerate(wave):
            self._finish_admission(w, int(firsts[j]), int(seeds[j]), results)

    def _finish_admission(self, w, first, seed, results):
        slot, prompt, blocks = w["slot"], w["prompt"], w["blocks"]
        n_tokens, r = w["n_tokens"], w["r"]
        emit0 = int(r.get("emit_start") or 0)
        done = n_tokens == 1
        s = Slot(r.get("request_id"), blocks, emit_base=emit0)
        s.emitted = 1
        self.slots[slot] = s
        self.block_tables[slot] = GARBAGE_BLOCK
        self.block_tables[slot, :len(blocks)] = blocks
        self.pos[slot] = len(prompt)
        self.remaining[slot] = n_tokens - 1
        self.emit_idx[slot] = emit0 + 1
        self.last_token[slot] = first
        self.seeds[slot] = seed
        self.temp[slot] = r.get("temperature") or 0.0
        p = r.get("top_p")
        self.top_p[slot] = 1.0 if p is None else p
        self.active[slot] = not done
        self.block_grants_total += w["grants"]
        if done:
            self._release(slot)
        results[slot] = (slot, first, done)

    # -------------------------------------------- incremental block grants
    def _lowest_progress_active(self) -> int:
        """Pool-pressure victim: the active slot whose request emitted the
        fewest tokens; ties go to the higher slot index."""
        best, best_p = -1, None
        for i in np.flatnonzero(self.active):
            i = int(i)
            p = self.slots[i].progress
            if best_p is None or p <= best_p:
                best, best_p = i, p
        return best

    def _preempt(self, slot: int):
        s = self.slots[slot]
        self._preempted.append({"slot": slot, "request_id": s.request_id,
                                "emitted": s.progress})
        self.evict_requeue_total += 1
        self._release(slot)

    def drain_preempted(self) -> List[dict]:
        """Preemption notices since the last drain: [{slot, request_id,
        emitted}] — requeue each as prompt + emitted tokens with
        emit_start set."""
        out, self._preempted = self._preempted, []
        return out

    def _allocate_under_pressure(self, s: int, n: int):
        got = self.pool.allocator.allocate(n)
        while got is None:
            victim = self._lowest_progress_active()
            self._preempt(victim)
            if victim == s:
                return None            # s itself lost the pool race
            got = self.pool.allocator.allocate(n)
        return got

    def _grow_block_tables(self):
        """Grant every active slot the blocks its next write window
        `[pos, pos + min(J, remaining))` crosses into."""
        J = self.steps_per_dispatch
        for s in range(self.n_slots):
            if not self.active[s] or self.slots[s] is None:
                continue
            slot = self.slots[s]
            tokens = min(J, int(self.remaining[s]))
            if tokens < 1:
                continue
            needed = blocks_needed(int(self.pos[s]) + tokens, self.block_len)
            have = len(slot.blocks)
            if needed > have:
                got = self._allocate_under_pressure(s, needed - have)
                if got is None or self.slots[s] is None:
                    continue
                slot.blocks.extend(got)
                self.block_tables[s, have:needed] = got
                self.block_grants_total += len(got)

    # ------------------------------------------------------------- decode
    def _one_token(self, tok, pos, block_tables):
        layers = self.net.layers
        h = tok[:, None]
        for entry in self._plan:
            kind, i = entry[0], entry[1]
            if kind == "plain":
                h = layers[i](h)
            elif kind == "pos":
                h = layers[i].forward_at_positions(h, pos)
            else:
                k_pool, v_pool = self.pool.kv[entry[2]]
                h = layers[i].forward_paged(h, k_pool, v_pool, block_tables,
                                            pos)
        return h[:, -1]                                  # [S, V] probs

    @torch.no_grad()
    def step(self) -> Tuple[Dict[int, List[int]], List[int]]:
        """One dispatch: every active slot advances up to
        `steps_per_dispatch` tokens. A slot that finishes mid-chunk keeps
        decoding (into its own pages or the garbage block) and its extra
        tokens are dropped on the host. Returns ({slot: [tokens]},
        [slots finished and released])."""
        self._grow_block_tables()
        if not self.active.any():
            return {}, []
        dev = self.device
        J = self.steps_per_dispatch
        bt = torch.as_tensor(self.block_tables, device=dev)
        tok = torch.as_tensor(self.last_token, device=dev)
        pos = torch.as_tensor(self.pos, device=dev)
        temps = np.where(self.active, self.temp, 0.0).astype(np.float32)
        out = []
        for j in range(J):
            probs = self._one_token(tok, pos, bt)
            tok = self._sample(probs, self.seeds, self.emit_idx + j, temps,
                               self.top_p)
            out.append(tok)
            pos = pos + 1
        toks = torch.stack(out).cpu().numpy()                   # [J, S]
        valids = np.arange(J)[:, None] < self.remaining[None, :]
        taken = valids.sum(axis=0)
        act = self.active.copy()
        last = np.clip(taken - 1, 0, None)
        self.last_token = np.where(act & (taken > 0),
                                   toks[last, np.arange(self.n_slots)],
                                   self.last_token)
        adv = np.where(act, taken, 0)
        self.pos = self.pos + adv
        self.emit_idx = self.emit_idx + adv
        self.remaining = self.remaining - adv
        emitted: Dict[int, List[int]] = {}
        finished = []
        for i in np.flatnonzero(act):
            i = int(i)
            emitted[i] = [int(t) for t in toks[valids[:, i], i]]
            self.slots[i].emitted += int(taken[i])
            if self.remaining[i] <= 0:
                finished.append(i)
                self._release(i)
        return emitted, finished

    # ------------------------------------------------------------- evict
    def evict(self, slot: int):
        """Mid-stream eviction (cancel): free the slot and its blocks."""
        if self.slots[slot] is None:
            raise ValueError(f"slot {slot} is not in use")
        self._release(slot)

    def _release(self, slot: int):
        s = self.slots[slot]
        self.pool.allocator.free(s.blocks)
        self.slots[slot] = None
        self.active[slot] = False
        self.remaining[slot] = 0
        self.block_tables[slot] = GARBAGE_BLOCK
