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

Block allocation is incremental by default: admission grants the
prompt's blocks; `step()` grows a slot's table as its position crosses
block boundaries, and under pool pressure preempts the lowest-progress
slot into `drain_preempted()` for requeue. `allocation="upfront"`
grants a request's whole budget at admission (the A/B baseline).

Weights and dtypes: every dispatch reads the net's serving tree,
resolved per dispatch from the cache keyed on the params version
(`nd.quant.serving_params`): int8 matmul weights under
`quantize="int8"`, the compute-dtype copies under `mixed_bf16`, so a
`fit()` between dispatches serves the new weights. The pool and the
carries are in the compute dtype; probabilities leave the output layer
in fp32.

Shared prefixes: `register_prefix` prefills a prompt prefix once into
pinned pool blocks; an admission whose prompt starts with it maps those
blocks copy-on-write (refcounted grants), forks a partly filled tail
block before its first write, and extends the suffix with one
K-position score (`zoo.transformer.paged_score_forward`); a prompt
equal to the prefix samples its first token from the stored
probabilities. `prefix_cache="radix"` adds a radix tree
(`serving.paged.RadixPrefixCache`) that dedups block-aligned prefixes
across every admission and evicts LRU leaves under pool pressure,
never a block a live slot holds.

Speculative decoding (`speculative=k`): an n-gram proposer over each
slot's history, and with `spec_draft_layers` the first blocks of the
same net as a greedy drafter, propose up to k-1 tokens; one K-position
score verifies them. Greedy slots keep the longest prefix the target's
argmax agrees with; sampled slots ride at depth 1 with their vanilla
draw, or with `spec_sampled=True` take drafts under rejection sampling
(`zoo.transformer.rejection_sample_drafts`).

Decode-parity contract: for the same prompt the greedy stream equals
`generate()`'s (`generate(quantize=...)` for int8), by margin where a
K-wide score and single-token decodes differ in rounding
(`zoo.transformer.stream_agreement`). Sampled token t of a request is
JAX's `categorical(fold_in(request key, t), logits)`: the request's
key is JAX's (`rng` a [2] uint32 key, an int seed meaning
`PRNGKey(seed)`, None the zero key), every slot's Gumbel noise comes
from one launch of the per-row-key threefry kernel, and a stream does
not depend on what else is in flight, across preemption included.

Goodput: every dispatch site classifies the token-positions it launched
into `self.goodput` (`monitor.goodput.GoodputLedger`: useful,
spec_rejected, pad_waste, preempt_discard; warmup and drain by mode)
from host values the engine already holds, so the ledger adds no device
copy. `admit_info` says per slot of the last wave whether it rode a
prefix or forked a block (what a request trace records).

Handoff: `export_handoff(slot)` gathers a live slot's K/V blocks by
value (shared and copy-on-write blocks included) with its host state;
`adopt_handoff(header, kv)` scatters them into private blocks of
another engine, whose next `step()` continues the stream bit for bit
(`serving.disagg`, the DLFP frame of `serving.wire`).
`decode_cost_report()` gives the weight bytes the decode reads and the
FLOPs of one dispatch, counted by `torch.utils.flop_counter`.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch.common import prng
from deeplearning4j_tpu_torch.device import resolve_device
from deeplearning4j_tpu_torch.monitor.goodput import GoodputLedger
from deeplearning4j_tpu_torch.nd import quant
from deeplearning4j_tpu_torch.nn.layers import (
    BaseRecurrentLayer,
    PositionalEncodingLayer,
    TransformerEncoderBlock,
    stream_budget,
)
from deeplearning4j_tpu_torch.serving.paged import (
    GARBAGE_BLOCK,
    PagedKVPool,
    RadixPrefixCache,
    blocks_needed,
)
from deeplearning4j_tpu_torch.zoo.transformer import (
    check_ids,
    get_prefill_bucketed,
    paged_score_forward,
    rejection_sample_drafts,
    request_key,
    sample_ids,
)


def bucket_len(n: int, cap: int) -> int:
    """The next power of two >= n, clamped to `cap` (the stream budget)."""
    b = 1
    while b < n:
        b *= 2
    return min(b, cap)


def _request_fields(r: dict):
    """(key, emit offset, temperature, top_p) of a request dict."""
    p = r.get("top_p")
    return (request_key(r.get("rng")), int(r.get("emit_start") or 0),
            float(r.get("temperature") or 0.0), 1.0 if p is None else p)


class Slot:
    """Host mirror of one serving slot's in-flight sequence."""

    __slots__ = ("request_id", "blocks", "prompt_len", "n_tokens",
                 "emitted", "emit_base", "history")

    def __init__(self, request_id, blocks, prompt_len, n_tokens,
                 emit_base=0, history=None):
        self.request_id = request_id
        self.blocks = blocks
        self.prompt_len = prompt_len
        self.n_tokens = n_tokens
        self.emitted = 0
        # tokens emitted in EARLIER admissions of a requeued continuation
        self.emit_base = emit_base
        # prompt + emitted tokens: the n-gram proposer's history (kept
        # only under speculation)
        self.history: List[int] = history if history is not None else []

    @property
    def progress(self) -> int:
        """Total tokens this REQUEST has emitted (across preemptions)."""
        return self.emit_base + self.emitted


class PagedDecodeEngine:
    """Continuous-batching decode over a `PagedKVPool`. Single-threaded:
    every method is called from one scheduler thread (serving/server.py)
    or directly by a test. `top_k` is engine-static; temperature, top_p
    and the sampling key are per request."""

    def __init__(self, net, *, n_slots: int = 8, n_blocks: int = 64,
                 block_len: int = 16, top_k: Optional[int] = None,
                 steps_per_dispatch: int = 1,
                 quantize: Optional[str] = None,
                 allocation: str = "incremental",
                 speculative: Optional[int] = None,
                 spec_max_ngram: int = 3,
                 spec_sampled: bool = False,
                 spec_draft_layers: Optional[int] = None,
                 prefix_cache: str = "registered", device="cuda"):
        self.device = resolve_device(device)
        if net.device != self.device:
            raise ValueError(f"net lives on {net.device}, engine asked for "
                             f"{self.device}: move the net with .to()")
        self.net = net
        self.n_slots = int(n_slots)
        self.steps_per_dispatch = int(steps_per_dispatch)
        if self.steps_per_dispatch < 1:
            raise ValueError(
                f"steps_per_dispatch must be >= 1; got {steps_per_dispatch}")
        self.top_k = None if top_k is None else int(top_k)
        if self.n_slots < 1:
            raise ValueError(f"n_slots must be >= 1; got {n_slots}")
        if allocation not in ("incremental", "upfront"):
            raise ValueError(
                f"allocation must be 'incremental' or 'upfront'; "
                f"got {allocation!r}")
        self.allocation = allocation
        self.quantize = quantize
        if speculative is not None:
            speculative = int(speculative)
            if speculative < 2:
                raise ValueError(
                    f"speculative (the draft depth k) must be >= 2 — "
                    f"k=1 is ordinary decode; got {speculative}")
        self.spec_k = speculative
        self.spec_max_ngram = int(spec_max_ngram)
        self.spec_sampled = bool(spec_sampled)
        if self.spec_sampled and self.spec_k is None:
            raise ValueError(
                "spec_sampled=True without speculative=k — there is "
                "no draft depth to rejection-sample over")
        if spec_draft_layers is not None:
            spec_draft_layers = int(spec_draft_layers)
            if self.spec_k is None:
                raise ValueError(
                    "spec_draft_layers without speculative=k — the "
                    "drafter only feeds speculative dispatches")
        self.spec_draft_layers = spec_draft_layers
        if prefix_cache not in ("registered", "radix"):
            raise ValueError(
                f"prefix_cache must be 'registered' or 'radix'; "
                f"got {prefix_cache!r}")
        self.prefix_cache_mode = prefix_cache
        # build (and validate) the serving tree now, not inside the
        # first live dispatch; dispatches resolve it from the cache
        quant.serving_params(net, quantize)
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
        self.vocab = net.layers[-1].n_out
        if self.top_k is not None and not 1 <= self.top_k <= self.vocab:
            raise ValueError(f"top_k must be in [1, vocab={self.vocab}]; "
                             f"got {top_k}")
        self.max_blocks = budget // int(block_len)
        self.max_total_tokens = budget
        if self.spec_k is not None and self.spec_k > budget:
            raise ValueError(
                f"speculative depth {self.spec_k} exceeds the stream "
                f"budget {budget} — no slot could ever take a full-"
                f"depth dispatch")
        self.pool = PagedKVPool(net, n_blocks, block_len)
        self.block_len = int(block_len)
        if net.conf.input_preprocessors:
            raise ValueError(
                "paged decode does not support input preprocessors "
                f"(found at {sorted(net.conf.input_preprocessors)})")
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
        # the truncated drafter's walk: the same plan with only the
        # first `spec_draft_layers` blocks (layer i's K/V depends only
        # on layers < i, so the slot's pages are its cache too)
        self._draft_plan: Optional[List[Tuple]] = None
        if self.spec_draft_layers is not None:
            n_layers = sum(1 for e in self._plan if e[0] == "block")
            if not 1 <= self.spec_draft_layers < n_layers:
                raise ValueError(
                    f"spec_draft_layers must be in [1, {n_layers - 1}] "
                    f"(a strict truncation of the {n_layers}-block "
                    f"target); got {self.spec_draft_layers}")
            kept = 0
            self._draft_plan = []
            for e in self._plan:
                if e[0] == "block":
                    if kept >= self.spec_draft_layers:
                        continue
                    kept += 1
                self._draft_plan.append(e)
        S = self.n_slots
        self.block_tables = np.zeros((S, self.max_blocks), np.int64)
        self.pos = np.zeros(S, np.int64)
        self.active = np.zeros(S, bool)
        self.remaining = np.zeros(S, np.int64)
        self.emit_idx = np.zeros(S, np.int64)
        self.last_token = np.zeros(S, np.int64)
        self.keys = np.zeros((S, 2), np.int64)
        self.temp = np.zeros(S, np.float32)
        self.top_p = np.ones(S, np.float32)
        self.slots: List[Optional[Slot]] = [None] * S
        # registered prefixes: key (token tuple) -> {tokens, len, blocks,
        # probs}; the registry holds one reference on each block
        self._prefixes: Dict[tuple, dict] = {}
        self.prefix_pinned_blocks = 0
        self._radix: Optional[RadixPrefixCache] = (
            RadixPrefixCache(self.pool.allocator, self.block_len)
            if prefix_cache == "radix" else None)
        self.radix_hit_tokens_total = 0
        self.radix_evictions_total = 0
        self.block_grants_total = 0
        self.evict_requeue_total = 0
        self.spec_dispatches_total = 0
        self.spec_proposed_total = 0
        self.spec_accepted_total = 0
        self.spec_emitted_total = 0
        self.spec_proposed_by: Dict[str, int] = {"ngram": 0, "truncated": 0}
        self.spec_accepted_by: Dict[str, int] = {"ngram": 0, "truncated": 0}
        self.spec_draft_dispatches_total = 0
        self.prefix_hits_total = 0
        self.prefix_tokens_saved_total = 0
        self.prefix_forks_total = 0
        # every dispatch site classifies its token-positions here
        self.goodput = GoodputLedger()
        self._preempted: List[dict] = []
        # per slot of the last admission wave: grants, prefix hit, fork
        self.admit_info: Dict[int, dict] = {}

    # ------------------------------------------------------------ queries
    @property
    def _params(self) -> quant.ServingTree:
        """The serving tree every dispatch reads, resolved per dispatch
        (a cache lookup unless the params changed since)."""
        return quant.serving_params(self.net, self.quantize)

    def _weights(self):
        return quant.installed(self._params.installable)

    @property
    def free_slots(self) -> int:
        return sum(1 for s in self.slots if s is None)

    @property
    def active_slots(self) -> int:
        return int(self.active.sum())

    @property
    def free_blocks(self) -> int:
        return self.pool.free_blocks

    @property
    def has_prefixes(self) -> bool:
        return bool(self._prefixes)

    def _admit_blocks(self, prompt_len: int, n_tokens: int) -> int:
        """Blocks an admission grants now: the prompt's (incremental) or
        the whole request's (upfront)."""
        if self.allocation == "incremental":
            return blocks_needed(prompt_len, self.block_len)
        return blocks_needed(prompt_len + n_tokens, self.block_len)

    def _match_prefix(self, prompt) -> Optional[dict]:
        """The longest registered prefix of `prompt`, or None."""
        best = None
        # a snapshot: submitter threads call this through check_budget
        # while the scheduler applies registrations
        for e in list(self._prefixes.values()):
            P = e["len"]
            if P > prompt.shape[0] or (best is not None
                                       and P <= best["len"]):
                continue
            if np.array_equal(np.asarray(prompt[:P], np.int64),
                              e["tokens"]):
                best = e
        return best

    def _cow_fresh_blocks(self, entry: dict, map_tokens: int) -> int:
        """Fresh blocks a CoW admission mapping `map_tokens` positions
        allocates: the map minus the shared blocks, plus the forked tail
        when the prefix ends mid-block."""
        nb_sh = blocks_needed(entry["len"], self.block_len)
        fork = 0 if entry["len"] % self.block_len == 0 else 1
        return blocks_needed(map_tokens, self.block_len) - nb_sh + fork

    def _reclaimable_blocks(self) -> int:
        """The free list plus what evicting the unpinned radix tree
        would return."""
        extra = (self._radix.evictable_blocks
                 if self._radix is not None else 0)
        return self.pool.free_blocks + extra

    def _match_radix(self, prompt) -> Optional[dict]:
        """The longest block-aligned radix-cached prefix of `prompt` as a
        CoW entry (no stored probs: the match stays below the full
        prompt, so the suffix extension samples the first token)."""
        if self._radix is None:
            return None
        P = int(prompt.shape[0])
        matched, blocks = self._radix.match(prompt)
        if matched >= P:
            matched -= self.block_len
            blocks = blocks[:-1]
        if matched <= 0:
            return None
        return dict(tokens=np.asarray(prompt[:matched], np.int64),
                    len=matched, blocks=blocks, probs=None, radix=True)

    def _alloc_admit(self, n: int) -> Optional[List[int]]:
        """Admission allocation: on exhaustion evict radix LRU leaves
        (cache-only references, never a live slot's) until it fits."""
        got = self.pool.allocator.allocate(n)
        while got is None and self._radix is not None:
            if not self._radix.evict_lru():
                break
            self.radix_evictions_total += 1
            got = self.pool.allocator.allocate(n)
        return got

    def can_admit(self, prompt_len: int, n_tokens: int = 1,
                  prompt_ids=None) -> bool:
        """A free slot and the blocks the admission grants are available
        now (a prompt that rides a prefix is charged its fresh blocks)."""
        if not any(s is None for s in self.slots):
            return False
        if prompt_ids is not None and (self._prefixes
                                       or self._radix is not None):
            prompt = np.asarray(prompt_ids)
            entry = self._match_prefix(prompt)
            if entry is None:
                entry = self._match_radix(prompt)
            if entry is not None:
                map_tokens = (prompt_len if self.allocation == "incremental"
                              else prompt_len + n_tokens)
                return (self._cow_fresh_blocks(entry, map_tokens)
                        <= self._reclaimable_blocks())
        return (self._admit_blocks(prompt_len, n_tokens)
                <= self._reclaimable_blocks())

    def check_budget(self, prompt_len: int, n_tokens: int, prompt_ids=None):
        """Reject requests that can NEVER be admitted: over the
        per-sequence budget, or needing more blocks at the end than the
        pool can ever free (a request must be able to finish alone;
        blocks pinned by registered prefixes never free). With
        `prompt_ids`, a request riding a registered prefix is charged
        only its fresh blocks."""
        if n_tokens < 1:
            raise ValueError(f"n_tokens must be >= 1; got {n_tokens}")
        total = prompt_len + n_tokens
        if total > self.max_total_tokens:
            raise ValueError(
                f"prompt ({prompt_len}) + n_tokens ({n_tokens}) = {total} "
                f"exceeds the per-sequence page budget "
                f"{self.max_total_tokens} (max_blocks {self.max_blocks} x "
                f"block_len {self.block_len}); this request can never be "
                f"admitted — rebuild the model with a larger max_len")
        usable = self.pool.n_blocks - 1 - self.prefix_pinned_blocks
        needed = blocks_needed(total, self.block_len)
        if prompt_ids is not None and self._prefixes:
            entry = self._match_prefix(np.asarray(prompt_ids))
            if entry is not None:
                needed = self._cow_fresh_blocks(entry, total)
        if needed > usable:
            raise ValueError(
                f"request needs {needed} pool blocks but the pool only "
                f"has {usable} usable (n_blocks {self.pool.n_blocks} incl. "
                f"the reserved garbage block and "
                f"{self.prefix_pinned_blocks} pinned by registered "
                f"prefixes); it can never be admitted — grow n_blocks or "
                f"shorten the request")

    # ----------------------------------------------------------- sampling
    def _noise(self, keys, emit_idx, temps) -> Optional[torch.Tensor]:
        """Gumbel noise [S, V] on the device, row s JAX's
        `gumbel(fold_in(keys[s], emit_idx[s]), (V,))`: the folds on the
        host, every row's words in one launch of the per-row-key kernel.
        None when no row samples."""
        if not (temps > 0).any():
            return None
        skeys = prng.fold_in_rows(torch.as_tensor(np.asarray(keys)),
                                  torch.as_tensor(np.asarray(emit_idx)))
        return prng.gumbel_rows(skeys.to(self.device), self.vocab)

    def _sample(self, probs, keys, emit_idx, temps, top_ps):
        noise = self._noise(keys, emit_idx, temps)
        dev = self.device
        return sample_ids(probs, torch.as_tensor(temps, device=dev),
                          self.top_k, torch.as_tensor(top_ps, device=dev),
                          noise, greedy_only=noise is None)

    # ------------------------------------------------- shared prefixes
    @torch.no_grad()
    def register_prefix(self, token_ids) -> tuple:
        """Prefill a shared prompt prefix ONCE into dedicated pool blocks
        pinned by the registry; later admissions whose prompt starts
        with it map those blocks copy-on-write. Idempotent per id
        sequence; returns the registry key. Raises when the pool cannot
        host the prefix now."""
        prompt = np.asarray(token_ids)
        if prompt.ndim == 2 and prompt.shape[0] == 1:
            prompt = prompt[0]
        if prompt.ndim != 1 or prompt.size == 0:
            raise ValueError(
                f"prefix must be a non-empty 1-D id sequence; got "
                f"shape {prompt.shape}")
        prompt = prompt.astype(np.int64)
        check_ids(prompt, self.vocab)
        P = int(prompt.shape[0])
        if P >= self.max_total_tokens:
            raise ValueError(
                f"prefix of {P} tokens leaves no room to generate "
                f"under the {self.max_total_tokens}-token page budget")
        key = tuple(int(t) for t in prompt)
        if key in self._prefixes:
            return key
        nb = blocks_needed(P, self.block_len)
        blocks = self.pool.allocator.allocate(nb)
        if blocks is None:
            raise ValueError(
                f"pool cannot host a {nb}-block prefix right now "
                f"({self.pool.free_blocks} free) — register prefixes "
                f"before admitting traffic, or grow n_blocks")
        try:
            Pb = bucket_len(P, self.max_total_tokens)
            prompts = np.zeros((1, Pb), np.int64)
            prompts[0, :P] = prompt
            dev = self.device
            with self._weights():
                probs, carries = get_prefill_bucketed(self.net)(
                    torch.as_tensor(prompts, device=dev),
                    self.net.init_carries(1),
                    torch.as_tensor([P - 1], device=dev))
            rows = np.full((1, self.max_blocks), GARBAGE_BLOCK, np.int64)
            rows[0, :nb] = blocks
            self._scatter_carries(carries, rows, 1)
        except Exception:
            self.pool.allocator.free(blocks)
            raise
        self._prefixes[key] = dict(tokens=prompt, len=P, blocks=blocks,
                                   probs=probs[0])
        self.prefix_pinned_blocks += nb
        self.block_grants_total += nb
        # prefilled once so later admissions need not: the P real
        # positions are useful, the bucket's padding is waste
        self.goodput.account(useful=P, pad_waste=Pb - P)
        return key

    def release_prefix(self, key: tuple):
        """Unpin a registered prefix: the registry's references drop;
        blocks still mapped by in-flight slots stay granted until those
        slots release."""
        entry = self._prefixes.pop(tuple(key))
        self.pool.allocator.free(entry["blocks"])
        self.prefix_pinned_blocks -= len(entry["blocks"])

    # ---------------------------------------------------------- admission
    def admit(self, prompt_ids, n_tokens: int, *, request_id=None,
              temperature: float = 0.0, top_p: Optional[float] = None,
              rng=None):
        """One request as a wave of one: (slot, first token, done), or
        None when the slots or blocks cannot take it now."""
        out = self.admit_many([dict(prompt_ids=prompt_ids,
                                    n_tokens=n_tokens,
                                    request_id=request_id,
                                    temperature=temperature,
                                    top_p=top_p, rng=rng)])
        return out[0] if out else None

    def admit_many(self, requests: List[dict]):
        """Admission wave over a FIFO prefix of `requests` (stops at slot
        or block capacity). Each dict: prompt_ids, n_tokens, and
        optionally request_id, temperature, top_p, rng (a [2] uint32 key or
        an int seed, `request_key`) and
        emit_start (a requeued continuation's emitted count). Returns
        [(slot, first_token, done), ...] for the admitted prefix."""
        if not requests:
            return []
        self.admit_info = {}
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
                self.check_budget(P, n_tokens, prompt_ids=prompt)
                slot = next((i for i, s in enumerate(self.slots)
                             if s is None
                             and all(i != w["slot"] for w in wave)), None)
                if slot is None:
                    break
                entry = self._match_prefix(prompt)
                if entry is None:
                    entry = self._match_radix(prompt)
                if entry is None:
                    nb = self._admit_blocks(P, n_tokens)
                    blocks = self._alloc_admit(nb)
                    if blocks is None:
                        break
                    w = dict(blocks=blocks, grants=nb, entry=None, fork=None)
                else:
                    w = self._cow_admit_blocks(entry, P, n_tokens)
                    if w is None:
                        break
                w.update(slot=slot, prompt=prompt, n_tokens=n_tokens, r=r)
                wave.append(w)
            if not wave:
                return []
            results = {}
            norm = [w for w in wave if w["entry"] is None]
            cow = [w for w in wave if w["entry"] is not None]
            with torch.no_grad(), self._weights():
                if norm:
                    self._admit_wave(norm, results)
                if cow:
                    self._admit_wave_shared(cow, results)
            if self._radix is not None:
                # the admitted prompts' full blocks feed the tree (the
                # partial tail block, still being written, never does)
                for w in wave:
                    slot = self.slots[w["slot"]]
                    n_full = len(w["prompt"]) // self.block_len
                    if slot is not None and n_full:
                        self._radix.insert(w["prompt"],
                                           slot.blocks[:n_full])
            return [results[w["slot"]] for w in wave]
        except Exception:
            # blocks of a failed wave that no Slot took over go back to
            # the pool (a CoW entry's list mixes fresh blocks and shared
            # references; `free` drops one reference of each)
            for w in wave:
                s = self.slots[w["slot"]]
                if s is None or s.blocks is not w["blocks"]:
                    try:
                        self.pool.allocator.free(w["blocks"])
                    except ValueError:
                        pass   # already back in the pool
            raise

    def _cow_admit_blocks(self, entry: dict, prompt_len: int,
                          n_tokens: int) -> Optional[dict]:
        """Grants of a shared-prefix admission: one reference on each
        shared block (taken before the fresh allocation, which may evict
        radix leaves), the fresh remainder, and when the prefix ends
        mid-block the fork of its tail into a fresh block (this slot's
        reference on the shared tail drops; the cache keeps its own).
        None when the pool cannot cover the fresh blocks now."""
        alloc = self.pool.allocator
        bl = self.block_len
        P = entry["len"]
        nb_sh = blocks_needed(P, bl)
        map_tokens = (prompt_len if self.allocation == "incremental"
                      else prompt_len + n_tokens)
        n_fresh = self._cow_fresh_blocks(entry, map_tokens)
        alloc.share(entry["blocks"][:nb_sh])
        fresh = [] if n_fresh == 0 else self._alloc_admit(n_fresh)
        if fresh is None:
            alloc.free(entry["blocks"][:nb_sh])
            return None
        if P % bl == 0:
            blocks = list(entry["blocks"][:nb_sh]) + fresh
            fork = None
        else:
            src, dst = entry["blocks"][nb_sh - 1], fresh[0]
            alloc.free([src])
            fork = (src, dst)
            blocks = list(entry["blocks"][:nb_sh - 1]) + [dst] + fresh[1:]
        return dict(blocks=blocks, grants=n_fresh, entry=entry, fork=fork)

    def _scatter_carries(self, carries, rows, k2):
        """Write each row's monolithic K/V cache into its pool blocks
        (`rows` [k2, max_blocks]; unowned entries point at the garbage
        block)."""
        bl = self.block_len
        rows_t = torch.as_tensor(rows, device=self.device)
        for (k_pool, v_pool), li in zip(self.pool.kv, self.pool.layer_indices):
            k_cache, v_cache, _ = carries[str(li)]
            C = k_cache.shape[1]
            flat = rows_t[:, :C // bl].reshape(-1)
            shape = (k2 * (C // bl), bl) + tuple(k_cache.shape[2:])
            k_pool[flat] = k_cache.reshape(shape).to(k_pool.dtype)
            v_pool[flat] = v_cache.reshape(shape).to(v_pool.dtype)

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
        rows = np.full((k2, self.max_blocks), GARBAGE_BLOCK, np.int64)
        keys = np.zeros((k2, 2), np.int64)
        emit0 = np.zeros(k2, np.int64)
        temps = np.zeros(k2, np.float32)
        top_ps = np.ones(k2, np.float32)
        for j, w in enumerate(wave):
            rows[j, :len(w["blocks"])] = w["blocks"]
            keys[j], emit0[j], temps[j], top_ps[j] = _request_fields(w["r"])
        self._scatter_carries(carries, rows, k2)
        firsts = self._sample(probs, keys, emit0, temps, top_ps).cpu().numpy()
        self._account_prefill([(w["prompt"], w["r"]) for w in wave],
                              k2 * Pb)
        for j, w in enumerate(wave):
            self._finish_admission(w, int(firsts[j]), keys[j], results)

    def _admit_wave_shared(self, wave, results):
        """Shared-prefix (CoW) admission: fork the mid-block tails, then
        ONE K-position score extends every hit past its shared region
        (attending the shared blocks through the slot's table) and
        samples the first tokens; a prompt equal to its prefix samples
        from the prefix's stored probabilities, with no forward."""
        pairs = [w["fork"] for w in wave if w["fork"] is not None]
        if pairs:
            self._run_fork(pairs)
        for w in wave:
            slot = w["slot"]
            self.block_tables[slot] = GARBAGE_BLOCK
            self.block_tables[slot, :len(w["blocks"])] = w["blocks"]
            w["suffix"] = w["prompt"][w["entry"]["len"]:]
        firsts, key_of = {}, {}
        S = self.n_slots
        ext = [w for w in wave if w["suffix"].shape[0] > 0]
        if ext:
            K = bucket_len(max(int(w["suffix"].shape[0]) for w in ext),
                           self.max_total_tokens)
            token_mat = np.zeros((S, K), np.int64)
            n_valid = np.zeros(S, np.int64)
            pos = np.zeros(S, np.int64)
            keys = np.zeros((S, 2), np.int64)
            emit0 = np.zeros(S, np.int64)
            temps = np.zeros(S, np.float32)
            top_ps = np.ones(S, np.float32)
            for w in ext:
                s, Ts = w["slot"], int(w["suffix"].shape[0])
                token_mat[s, :Ts] = w["suffix"]
                n_valid[s] = Ts
                pos[s] = w["entry"]["len"]
                keys[s], emit0[s], temps[s], top_ps[s] = _request_fields(
                    w["r"])
                key_of[s] = keys[s]
            probs = self._score(token_mat, pos, n_valid)
            last = probs[torch.arange(S, device=self.device),
                         torch.as_tensor(np.maximum(n_valid - 1, 0),
                                         device=self.device)]
            chosen = self._sample(last, keys, emit0, temps,
                                  top_ps).cpu().numpy()
            for w in ext:
                firsts[w["slot"]] = int(chosen[w["slot"]])
            # the shared prefix was accounted at its registration
            self._account_prefill([(w["suffix"], w["r"]) for w in ext],
                                  S * K)
        exact = [w for w in wave if w["suffix"].shape[0] == 0]
        if exact:
            n = len(exact)
            probs = torch.stack([w["entry"]["probs"] for w in exact])
            keys = np.zeros((n, 2), np.int64)
            emit0 = np.zeros(n, np.int64)
            temps = np.zeros(n, np.float32)
            top_ps = np.ones(n, np.float32)
            for j, w in enumerate(exact):
                keys[j], emit0[j], temps[j], top_ps[j] = _request_fields(
                    w["r"])
                key_of[w["slot"]] = keys[j]
            ids = self._sample(probs, keys, emit0, temps,
                               top_ps).cpu().numpy()
            for j, w in enumerate(exact):
                firsts[w["slot"]] = int(ids[j])
        for w in wave:
            self._finish_admission(w, firsts[w["slot"]], key_of[w["slot"]],
                                   results)

    def _account_prefill(self, rows, positions: int):
        """Goodput of a prefill dispatch over `positions` token-positions
        for `rows` ([(ids prefilled, request dict)]): a fresh request's
        ids are useful, a requeued continuation's (emit_start > 0) were
        prefilled once already, and the rest is padding."""
        redone = sum(len(ids) for ids, r in rows
                     if int(r.get("emit_start") or 0))
        fresh = sum(len(ids) for ids, _ in rows) - redone
        self.goodput.account(useful=fresh, preempt_discard=redone,
                             pad_waste=positions - fresh - redone)

    def _finish_admission(self, w, first, key, results):
        """Slot bookkeeping of both admission paths."""
        slot, prompt, blocks = w["slot"], w["prompt"], w["blocks"]
        n_tokens, r = w["n_tokens"], w["r"]
        _, emit0, temp, top_p = _request_fields(r)
        done = n_tokens == 1
        s = Slot(r.get("request_id"), blocks, len(prompt), n_tokens,
                 emit_base=emit0,
                 history=([int(t) for t in prompt] + [first]
                          if self.spec_k else None))
        s.emitted = 1
        self.slots[slot] = s
        self.block_tables[slot] = GARBAGE_BLOCK
        self.block_tables[slot, :len(blocks)] = blocks
        self.pos[slot] = len(prompt)
        self.remaining[slot] = n_tokens - 1
        self.emit_idx[slot] = emit0 + 1
        self.last_token[slot] = first
        self.keys[slot] = key
        self.temp[slot] = temp
        self.top_p[slot] = top_p
        self.active[slot] = not done
        self.block_grants_total += w["grants"]
        entry = w["entry"]
        self.admit_info[slot] = {
            "grants": int(w["grants"]),
            "prefix_hit": entry is not None,
            "tokens_saved": int(entry["len"]) if entry is not None else 0,
            "cow_fork": w.get("fork") is not None,
        }
        if entry is not None:
            self.prefix_hits_total += 1
            self.prefix_tokens_saved_total += entry["len"]
            if entry.get("radix"):
                self.radix_hit_tokens_total += entry["len"]
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
        """`n` blocks for slot `s`: radix LRU leaves go first, then the
        lowest-progress slot is preempted; None when `s` itself lost."""
        got = self.pool.allocator.allocate(n)
        while got is None:
            if self._radix is not None and self._radix.evict_lru():
                self.radix_evictions_total += 1
                got = self.pool.allocator.allocate(n)
                continue
            victim = self._lowest_progress_active()
            self._preempt(victim)
            if victim == s:
                return None            # s itself lost the pool race
            got = self.pool.allocator.allocate(n)
        return got

    def _grow_block_tables(self, tokens_by_slot=None):
        """Before a dispatch: grant every active slot the blocks its
        write window `[pos, pos + tokens)` crosses into (tokens: `min(J,
        remaining)`, or `tokens_by_slot[s]`), and fork every window
        block it does not own alone (refcount > 1) into a fresh one —
        no dispatch writes a block another holder reads."""
        J = self.steps_per_dispatch
        fork_pairs = []
        for s in range(self.n_slots):
            if not self.active[s] or self.slots[s] is None:
                continue
            slot = self.slots[s]
            tokens = (min(J, int(self.remaining[s])) if tokens_by_slot is None
                      else int(tokens_by_slot.get(s, 0)))
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
            first_b = int(self.pos[s]) // self.block_len
            last_b = (int(self.pos[s]) + tokens - 1) // self.block_len
            for bi in range(first_b, min(last_b + 1, len(slot.blocks))):
                src = slot.blocks[bi]
                if self.pool.allocator.refcount(src) <= 1:
                    continue
                got = self._allocate_under_pressure(s, 1)
                if got is None or self.slots[s] is None:
                    break              # s lost the pool race mid-fork
                dst = got[0]
                fork_pairs.append((s, src, dst))
                slot.blocks[bi] = dst
                self.block_tables[s, bi] = dst
                self.pool.allocator.free([src])
                self.block_grants_total += 1
        # a slot preempted after recording a fork has freed its target
        # (maybe re-granted since): only live slots' forks run
        fork_pairs = [(src, dst) for s, src, dst in fork_pairs
                      if self.slots[s] is not None]
        if fork_pairs:
            self._run_fork(fork_pairs)

    @torch.no_grad()
    def _run_fork(self, pairs):
        """Copy-on-write fork: copy pool blocks src -> dst in every
        layer's K and V pool."""
        dev = self.device
        src = torch.as_tensor([p[0] for p in pairs], device=dev)
        dst = torch.as_tensor([p[1] for p in pairs], device=dev)
        for k_pool, v_pool in self.pool.kv:
            k_pool[dst] = k_pool[src]
            v_pool[dst] = v_pool[src]
        self.prefix_forks_total += len(pairs)

    # ------------------------------------------------------------- decode
    def _walk(self, plan, tok, pos, block_tables):
        """One token a slot through `plan` (the net's walk or the
        drafter's) over the pool: probs [S, V] in the output dtype."""
        layers = self.net.layers
        h = tok[:, None]
        for entry in plan:
            kind, i = entry[0], entry[1]
            if kind == "plain":
                h = layers[i](h)
            elif kind == "pos":
                h = layers[i].forward_at_positions(h, pos)
            else:
                k_pool, v_pool = self.pool.kv[entry[2]]
                h = layers[i].forward_paged(h, k_pool, v_pool, block_tables,
                                            pos)
        return self.net.dtype.cast_output(h[:, -1])

    def _score(self, token_mat, pos, n_valid):
        """The K-position score over the pool (in place): probs
        [S, K, V]."""
        dev = self.device
        return paged_score_forward(
            self.net, self._plan, self.pool.kv,
            torch.as_tensor(self.block_tables, device=dev),
            torch.as_tensor(token_mat, device=dev),
            torch.as_tensor(pos, device=dev),
            torch.as_tensor(n_valid, device=dev))

    @torch.no_grad()
    def step(self, *, speculate: Optional[bool] = None,
             proposers: Optional[tuple] = None
             ) -> Tuple[Dict[int, List[int]], List[int]]:
        """One dispatch: every active slot advances up to
        `steps_per_dispatch` tokens, or with `speculative=k` (and
        `speculate` not False) up to k tokens through one K-position
        score (`_spec_step`; `proposers` restricts the draft backends).
        A slot that finishes mid-chunk keeps decoding (into its own pages
        or the garbage block) and its extra tokens are dropped on the
        host. Returns ({slot: [tokens]}, [slots finished and
        released])."""
        if speculate is None:
            speculate = self.spec_k is not None
        if speculate and self.spec_k:
            return self._spec_step(proposers=proposers)
        if (self.allocation == "incremental" or self._prefixes
                or self._radix is not None):
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
        with self._weights():
            for j in range(J):
                probs = self._walk(self._plan, tok, pos, bt)
                tok = self._sample(probs, self.keys, self.emit_idx + j,
                                   temps, self.top_p)
                out.append(tok)
                pos = pos + 1
        toks = torch.stack(out).cpu().numpy()                   # [J, S]
        valids = np.arange(J)[:, None] < self.remaining[None, :]
        taken = valids.sum(axis=0)
        act = self.active.copy()
        # J * S positions: tokens emitted on live lanes are useful, idle
        # lanes and the tail past a lane's budget are waste
        n_useful = int(np.where(act, taken, 0).sum())
        self.goodput.account(useful=n_useful,
                             pad_waste=J * self.n_slots - n_useful)
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
            if self.spec_k:
                self.slots[i].history.extend(emitted[i])
            if self.remaining[i] <= 0:
                finished.append(i)
                self._release(i)
        return emitted, finished

    # ------------------------------------------------- speculative decode
    def _propose(self, s: int, max_draft: int) -> List[int]:
        """The n-gram proposer over slot `s`'s history (prompt +
        emitted): the continuation after the most recent earlier
        occurrence of the current suffix n-gram (longest n first, up to
        `spec_max_ngram`), preferring an occurrence with a full-depth
        continuation; nothing matched proposes nothing."""
        if max_draft <= 0:
            return []
        hist = self.slots[s].history
        L = len(hist)
        if L < 2:
            return []
        h = np.asarray(hist, np.int64)
        for n in range(min(self.spec_max_ngram, L - 1), 0, -1):
            suffix = h[L - n:]
            win = np.lib.stride_tricks.sliding_window_view(h[:L - 1], n)
            hits = np.flatnonzero((win == suffix).all(axis=1))
            if hits.size:
                full = hits[hits + n + max_draft <= L]
                i = int(full[-1]) if full.size else int(hits[-1])
                cont = h[i + n:i + n + max_draft]
                if cont.size:
                    return [int(t) for t in cont]
        return []

    def _run_draft(self, trunc_slots):
        """One truncated-layer draft pass over `trunc_slots` ([(slot,
        depth)], windows already granted and forked): k-1 greedy
        micro-steps of the drafter's walk, writing draft K/V into each
        slot's not-yet-committed window, which the verify score of the
        same `_spec_step` rewrites before anything reads it. A slot
        writes only its depth-1 steps (its later rows point at the
        garbage block), so no step passes its window. Returns the
        [k-1, S] draft matrix (rows of other slots are garbage)."""
        S, K, dev = self.n_slots, self.spec_k, self.device
        depth = np.zeros(S, np.int64)
        for s, d in trunc_slots:
            depth[s] = d
        tok = torch.as_tensor(self.last_token, device=dev)
        pos = torch.as_tensor(self.pos, device=dev)
        drafts = []
        with self._weights():
            for j in range(K - 1):
                live = (j < depth - 1)[:, None]
                bt = torch.as_tensor(
                    np.where(live, self.block_tables, GARBAGE_BLOCK),
                    device=dev)
                tok = torch.argmax(self._walk(self._draft_plan, tok, pos, bt),
                                   dim=-1)
                drafts.append(tok)
                pos = pos + 1
        self.spec_draft_dispatches_total += 1
        # the drafter's real lanes are speculation overhead (the verify
        # score emits), the masked lanes padding
        real = sum(d - 1 for _, d in trunc_slots)
        self.goodput.account(spec_rejected=real,
                             pad_waste=(K - 1) * S - real)
        return torch.stack(drafts).cpu().numpy()

    def _spec_step(self, proposers: Optional[tuple] = None
                   ) -> Tuple[Dict[int, List[int]], List[int]]:
        """One speculative dispatch: drafts of up to k-1 tokens a slot,
        ONE k-position score of [last_token, d1, ..., d_{k-1}], and per
        greedy slot the longest draft prefix the target's argmax agrees
        with, then the target's own token (so the stream is the target's
        greedy stream). Sampled slots ride at depth 1 with their vanilla
        draw, or with `spec_sampled` take drafts under rejection
        sampling. Rejected lanes' K/V sits past the advanced `pos` and is
        rewritten before it is read. Emits 1..k tokens a slot."""
        if not self.active.any():
            return {}, []
        K, S = self.spec_k, self.n_slots
        allow_ngram = proposers is None or "ngram" in proposers
        allow_trunc = (self._draft_plan is not None
                       and (proposers is None or "truncated" in proposers))
        token_mat = np.zeros((S, K), np.int64)
        n_valid = np.zeros(S, np.int64)
        by_proposer: Dict[int, str] = {}
        trunc_slots: List[Tuple[int, int]] = []
        for s in np.flatnonzero(self.active):
            s = int(s)
            token_mat[s, 0] = self.last_token[s]
            if self.temp[s] > 0 and not self.spec_sampled:
                n_valid[s] = 1          # sampling has no greedy oracle
                continue
            depth = int(min(K, self.remaining[s]))
            draft = self._propose(s, depth - 1) if allow_ngram else []
            if draft:
                by_proposer[s] = "ngram"
                n_valid[s] = 1 + len(draft)
                token_mat[s, 1:1 + len(draft)] = draft
            elif allow_trunc and depth >= 2:
                trunc_slots.append((s, depth))
                n_valid[s] = depth
            else:
                n_valid[s] = 1
        if trunc_slots:
            # grant and fork the drafting slots' whole windows first: the
            # draft writes into them
            self._grow_block_tables(dict(trunc_slots))
            trunc_slots = [(s, d) for s, d in trunc_slots
                           if self.slots[s] is not None and self.active[s]]
        if trunc_slots:
            drafts = self._run_draft(trunc_slots)
            for s, d in trunc_slots:
                by_proposer[s] = "truncated"
                token_mat[s, 1:d] = drafts[:d - 1, s]
        # grant (and fork) each slot's write window before the score
        self._grow_block_tables(
            {int(s): int(n_valid[s]) for s in np.flatnonzero(self.active)})
        n_valid = np.where(self.active, n_valid, 0)
        if not self.active.any():
            return {}, []
        greedy_only = not bool((self.temp[self.active] > 0).any())
        use_rs = self.spec_sampled and not greedy_only
        dev = self.device
        with self._weights():
            probs = self._score(token_mat, self.pos, n_valid)
        greedy_mat = torch.argmax(probs, dim=-1).cpu().numpy()
        if use_rs:
            n_acc, final = rejection_sample_drafts(
                probs, torch.as_tensor(token_mat, device=dev),
                torch.as_tensor(n_valid, device=dev), self.keys,
                self.emit_idx, torch.as_tensor(self.temp, device=dev),
                torch.as_tensor(self.top_p, device=dev), self.top_k)
            n_acc, final = n_acc.cpu().numpy(), final.cpu().numpy()
        elif not greedy_only:
            last = probs[torch.arange(S, device=dev),
                         torch.as_tensor(np.maximum(n_valid - 1, 0),
                                         device=dev)]
            chosen = self._sample(last, self.keys, self.emit_idx,
                                  np.where(self.active, self.temp, 0.0),
                                  self.top_p).cpu().numpy()
        self.spec_dispatches_total += 1
        # S * K positions: emitted tokens are useful, valid draft lanes
        # the target rejected are spec_rejected, the rest padding
        gp_useful = gp_rejected = 0
        emitted: Dict[int, List[int]] = {}
        finished = []
        for s in np.flatnonzero(self.active):
            s = int(s)
            v = int(n_valid[s])
            if self.temp[s] > 0:
                if use_rs:
                    acc = min(int(n_acc[s]), v - 1)
                    toks = [int(token_mat[s, j])
                            for j in range(1, 1 + acc)] + [int(final[s])]
                else:
                    toks = [int(chosen[s])]
            else:
                row = greedy_mat[s]
                toks = [int(row[0])]
                for j in range(1, v):
                    if int(token_mat[s, j]) != toks[-1]:
                        break
                    toks.append(int(row[j]))
            if v > 1:
                self.spec_proposed_total += v - 1
                self.spec_accepted_total += len(toks) - 1
                prop = by_proposer.get(s)
                if prop is not None:
                    self.spec_proposed_by[prop] += v - 1
                    self.spec_accepted_by[prop] += len(toks) - 1
            n = len(toks)
            gp_useful += n
            gp_rejected += v - n
            self.spec_emitted_total += n
            self.pos[s] += n
            self.emit_idx[s] += n
            self.remaining[s] -= n
            self.last_token[s] = toks[-1]
            slot = self.slots[s]
            slot.emitted += n
            slot.history.extend(toks)
            emitted[s] = toks
            if self.remaining[s] <= 0:
                finished.append(s)
                self._release(s)
        self.goodput.account(useful=gp_useful, spec_rejected=gp_rejected,
                             pad_waste=S * K - gp_useful - gp_rejected)
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

    # ------------------------------------------------------ cost report
    @torch.no_grad()
    def decode_cost_report(self) -> dict:
        """What one greedy decode dispatch reads and computes: the
        weight bytes of the serving tree (all of it, and the matmul
        weights apart, as JAX's report counts them), the bytes a decode
        step moves (the weights plus every layer's K and V page view),
        and the FLOPs of one dispatch of `steps_per_dispatch` steps over
        every slot, counted by `torch.utils.flop_counter.FlopCounterMode`
        on the real decode walk (split into the weight matmuls and the
        attention over the pages). The walk runs on the garbage block,
        so no slot's pages or host state change."""
        from torch.utils.flop_counter import FlopCounterMode
        S, J, dev = self.n_slots, self.steps_per_dispatch, self.device
        params = self._params.params
        mm_keys = quant.quantized_weight_keys(self.net)
        mm_bytes = quant.weight_bytes(
            {lk: {pk: params[lk][pk] for pk in pks}
             for lk, pks in mm_keys.items()})
        bt = torch.full((S, self.max_blocks), GARBAGE_BLOCK,
                        dtype=torch.int64, device=dev)
        tok = torch.as_tensor(self.last_token, device=dev)
        pos = torch.as_tensor(self.pos, device=dev)
        with FlopCounterMode(display=False) as counter, self._weights():
            for _ in range(J):
                tok = torch.argmax(self._walk(self._plan, tok, pos, bt),
                                   dim=-1)
                pos = pos + 1
        # the weight matmuls are mm / addmm, the attention over the
        # pages bmm (its einsums)
        attn = sum(int(n) for op, n in
                   counter.get_flop_counts().get("Global", {}).items()
                   if "bmm" in str(op))
        # every layer gathers each slot's whole page view, K and V
        kv_bytes = 2 * sum(S * self.max_total_tokens * k[0, 0].numel()
                           * k.element_size() for k, _ in self.pool.kv)
        weight_bytes = quant.weight_bytes(params)
        return {
            "quantize": self.quantize,
            "weight_bytes": weight_bytes,
            "matmul_weight_bytes": mm_bytes,
            "decode_bytes_per_step": weight_bytes + kv_bytes,
            "decode_kv_bytes_per_step": kv_bytes,
            "decode_flops_per_dispatch": int(counter.get_total_flops()),
            "decode_flops_per_step": int(counter.get_total_flops()) // J,
            "decode_attention_flops_per_step": attn // J,
            "decode_matmul_flops_per_step": (
                int(counter.get_total_flops()) - attn) // J,
            "n_slots": S,
            "steps_per_dispatch": J,
        }

    # ----------------------------------------------------------- handoff
    @torch.no_grad()
    def export_handoff(self, slot: int) -> Tuple[dict, torch.Tensor]:
        """One live slot for a prefill-to-decode handoff: its host state
        as a header, and its granted K/V blocks gathered by value from
        every layer's pool and stacked ``[n_layers, 2, n_blocks,
        block_len, heads, head_dim]`` in the pool's dtype, on the host
        (shared and copy-on-write blocks are copied, so the adopting
        pool gets private blocks). `serving.wire.encode_handoff` puts
        both on the wire. This engine is left as it was: the caller
        evicts the slot once the handoff has landed."""
        s = self.slots[slot]
        if s is None:
            raise ValueError(f"slot {slot} is not in use")
        if not self.active[slot]:
            raise ValueError(
                f"slot {slot} already finished — nothing to hand off")
        idx = torch.as_tensor(s.blocks, dtype=torch.int64,
                              device=self.device)
        kv = torch.stack([torch.stack([k.index_select(0, idx),
                                       v.index_select(0, idx)])
                          for k, v in self.pool.kv]).cpu()
        header = {
            "request_id": s.request_id,
            "prompt_len": int(s.prompt_len),
            "n_tokens": int(s.n_tokens),
            "pos": int(self.pos[slot]),
            "remaining": int(self.remaining[slot]),
            "emitted": int(s.emitted),
            "emit_base": int(s.emit_base),
            "emit_idx": int(self.emit_idx[slot]),
            "last_token": int(self.last_token[slot]),
            "history": [int(t) for t in s.history],
            "keys": [int(x) for x in self.keys[slot]],
            "temperature": float(self.temp[slot]),
            "top_p": float(self.top_p[slot]),
            "block_len": int(self.block_len),
            "n_layers": len(self.pool.kv),
        }
        return header, kv

    @torch.no_grad()
    def adopt_handoff(self, header: dict, kv) -> int:
        """Adopt a handed-off slot (a numpy array or a tensor as
        `export_handoff` gives it, from either package): allocate
        private blocks, write the K/V into them and rebuild the slot's
        host state, so the next `step()` continues the stream as the
        exporting engine would have. Raises ValueError on a shape or
        dtype mismatch (a cast would break bit parity) and RuntimeError
        when no slot or blocks are free; either way nothing changes."""
        kv = torch.as_tensor(kv)
        L = len(self.pool.kv)
        k0 = self.pool.kv[0][0]
        if kv.ndim != 6 or kv.shape[0] != L or kv.shape[1] != 2:
            raise ValueError(
                f"handoff K/V shape {tuple(kv.shape)} does not match this "
                f"pool's {L} layers")
        if int(header["block_len"]) != self.block_len:
            raise ValueError(
                f"handoff block_len {header['block_len']} != engine "
                f"block_len {self.block_len}")
        if tuple(kv.shape[3:]) != tuple(k0.shape[1:]):
            raise ValueError(
                f"handoff block shape {tuple(kv.shape[3:])} != pool block "
                f"shape {tuple(k0.shape[1:])}")
        if kv.dtype != k0.dtype:
            raise ValueError(
                f"handoff dtype {kv.dtype} != pool compute dtype "
                f"{k0.dtype} — a silent cast would break bit-parity")
        slot = next((i for i, s in enumerate(self.slots) if s is None),
                    None)
        if slot is None:
            raise RuntimeError("no free slot to adopt the handoff")
        n_blocks = int(kv.shape[2])
        blocks = self._alloc_admit(n_blocks)
        if blocks is None:
            raise RuntimeError(
                f"pool cannot grant {n_blocks} blocks for the handoff "
                f"({self.pool.free_blocks} free)")
        bidx = torch.as_tensor(blocks, dtype=torch.int64, device=self.device)
        kv = kv.to(self.device)
        for l, (k, v) in enumerate(self.pool.kv):
            k[bidx] = kv[l, 0]
            v[bidx] = kv[l, 1]
        s = Slot(header.get("request_id"), blocks,
                 int(header["prompt_len"]), int(header["n_tokens"]),
                 emit_base=int(header.get("emit_base") or 0),
                 history=[int(t) for t in (header.get("history") or [])])
        s.emitted = int(header["emitted"])
        self.slots[slot] = s
        self.block_tables[slot] = GARBAGE_BLOCK
        self.block_tables[slot, :len(blocks)] = blocks
        self.pos[slot] = int(header["pos"])
        self.remaining[slot] = int(header["remaining"])
        self.emit_idx[slot] = int(
            header.get("emit_idx", s.emit_base + s.emitted))
        self.last_token[slot] = int(header["last_token"])
        self.keys[slot] = np.asarray(header.get("keys") or [0, 0], np.int64)
        self.temp[slot] = float(header.get("temperature") or 0.0)
        tp = header.get("top_p")
        self.top_p[slot] = 1.0 if tp is None else float(tp)
        self.active[slot] = int(header["remaining"]) > 0
        self.block_grants_total += n_blocks
        return slot
