"""DecodeEngine: the prefill/decode phase split, the port of
``distributed_pipeline_tpu/serving/engine.py``.

* ``prefill``  — one causal forward over a fixed-shape prompt batch that
  writes the prompts' K/V into the paged pool, picks each request's first
  token, and merges it into the decode state at the requests' target slots;
* ``decode``   — ``decode_span`` tokens for every decode slot: per-slot
  positions (each slot at its own depth), paged attention over each slot's
  live prefix, sampling, state out;
* ``verify``   — speculative decoding (``spec_tokens`` K > 0): ONE forward
  over each slot's chain ``[current, d_1..d_K]`` (the backbone's span
  branch) and the target's pick at every link, keyed per (slot, position)
  as ``decode`` keys it. The host owns rollback: it declares each round's
  (token, position) state, and ``set_decode_state`` pushes it to an engine
  that then decodes (the model draft).

The JAX engine compiles each phase once; PyTorch runs eagerly, so each phase
is a plain method (``decode_span`` steps are a Python loop per dispatch) and
the kernel launches are asynchronous on the current stream. State (the
paged KV pool, the token/position vectors, block tables, the active mask)
stays on the device; the pool is updated in place. ``kv_quant="int8"``
keeps int8 pages with a ``[P]`` f32 scale sidecar for K and for V per layer
(about half the bytes of a bf16 pool). CUDA graphs, the analogue of the
compile-once executables, are later work (ROADMAP A.4).
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from ..models.backbone import KV_QUANTS
from ..models.gpt2 import GPT2Model
from ..models.sampling import _truncate_logits

__all__ = ["DecodeEngine"]

_SEED_MIX = 0x9E3779B97F4A7C15  # odd 64-bit constant (golden ratio)


class _SlotPicker:
    """Per-slot token picker ``(logits [N, V], positions [N], slots [N]) ->
    int32 [N]``. Greedy at temperature <= 0; otherwise temperature, then
    :func:`_truncate_logits`, then a categorical pick (Gumbel-max) whose
    noise comes from a ``torch.Generator`` seeded per (seed, slot,
    position) — the JAX engine's per-(slot, position) key fold, so two slots
    at the same depth draw different noise and a request's stream is fixed
    from its first token on. ``positions``/``slots`` are host arrays: the
    engine mirrors positions on the host, so picking never waits for the
    device."""

    def __init__(self, temperature: float, top_k: int, top_p: float,
                 seed: int, device: torch.device) -> None:
        self.temperature = temperature
        self.top_k = top_k
        self.top_p = top_p
        self.seed = seed
        self.gen = (torch.Generator(device=device)
                    if temperature > 0.0 else None)

    def __call__(self, logits: torch.Tensor, positions: np.ndarray,
                 slots: np.ndarray) -> torch.Tensor:
        if self.gen is None:
            return torch.argmax(logits, dim=-1).to(torch.int32)
        l = _truncate_logits(logits.float() / self.temperature, self.top_k,
                             self.top_p)
        noise = torch.empty_like(l)
        for i, (s, p) in enumerate(zip(slots.tolist(), positions.tolist())):
            key = (((self.seed * _SEED_MIX + s) * _SEED_MIX + p)
                   % (2 ** 63))
            self.gen.manual_seed(key)
            noise[i].exponential_(generator=self.gen)
        # argmax(l - log(E)), E ~ Exp(1), is a categorical draw from
        # softmax(l) (the Gumbel-max trick)
        return torch.argmax(l - noise.log(), dim=-1).to(torch.int32)


class DecodeEngine:
    """Device half of the serving stack: paged-cache decode state plus the
    two phases that advance it.

    Parameters
    ----------
    model : the GPT-2 model, already on ``device`` with its weights.
    decode_slots : decode batch size S. Decode ALWAYS runs all S slots
        (inactive slots write to the trash page and their outputs are
        ignored).
    page_size, max_pages : paged KV pool geometry, per layer.
    max_prompt_len : prefill length (prompts pad up to it).
    max_len : longest prompt+generation a slot can hold (caps the block
        table width; <= the model's seq_len for position bounds).
    prefill_batch : prefill batch size (short admissions pad with dummy
        rows).
    decode_span : tokens generated per ``decode()`` call. Slots whose
        budget ends mid-span overshoot by up to ``decode_span - 1``
        positions: writes clamp into their own reserved pages or go to the
        trash page, the position embedding clamps to the table's last row,
        and outputs past budget are discarded at fetch.
    decode_impl : decode-step attention arm (``ops/flash_decode.py``).
    kv_quant : paged KV storage, "fp" (the model's dtype) or "int8" (int8
        pages with per-page f32 scales; ``serving/paged_kv.py``).
    spec_tokens : draft length K of :meth:`verify` (0 = no speculative
        decoding).
    """

    def __init__(self, model: GPT2Model, *, decode_slots: int,
                 page_size: int, max_pages: int, max_prompt_len: int,
                 max_len: int = 0, prefill_batch: int = 0,
                 decode_span: int = 1, temperature: float = 0.0,
                 top_k: int = 0, top_p: float = 0.0, seed: int = 0,
                 decode_impl: str = "auto", kv_quant: str = "fp",
                 spec_tokens: int = 0) -> None:
        if model.family != "gpt2":
            raise ValueError(f"the decode engine serves the gpt2 family, "
                             f"got {model.family!r}")
        max_len = max_len or model.seq_len
        if not 1 <= max_len <= model.seq_len:
            raise ValueError(f"max_len {max_len} must be in [1, seq_len="
                             f"{model.seq_len}] (position table bound)")
        if not 2 <= max_prompt_len <= max_len:
            # >= 2: a length-1 prefill is shape-ambiguous with a decode step
            raise ValueError(f"max_prompt_len {max_prompt_len} must be in "
                             f"[2, max_len={max_len}]")
        if decode_span < 1:
            raise ValueError(f"decode_span must be >= 1, got {decode_span}")
        if max_pages < 2:
            raise ValueError(f"max_pages must be >= 2 (page 0 is the trash "
                             f"page), got {max_pages}")
        if kv_quant not in KV_QUANTS:
            raise ValueError(f"kv_quant must be fp|int8, got {kv_quant!r}")
        if spec_tokens < 0:
            raise ValueError(f"spec_tokens must be >= 0, got {spec_tokens}")
        self.model = model
        self.spec_tokens = spec_tokens
        self.device = model.pos_emb.device
        self.decode_slots = decode_slots
        self.page_size = page_size
        self.max_pages = max_pages
        self.max_prompt_len = max_prompt_len
        self.max_len = max_len
        self.pages_per_slot = -(-max_len // page_size)
        self.prefill_batch = prefill_batch or min(decode_slots, 8)
        self.decode_span = decode_span
        self.decode_impl = decode_impl
        self.kv_quant = kv_quant
        self._pick = _SlotPicker(temperature, top_k, top_p, seed,
                                 self.device)

        s, dev = decode_slots, self.device
        H = model.num_heads
        dh = model.hidden_size // H
        shape = (max_pages, page_size, H, dh)
        pool_dtype = torch.int8 if kv_quant == "int8" else model.dtype
        # per layer (pages_k, pages_v), and (scales_k, scales_v) for an int8
        # pool
        self.kv_cache: List[tuple] = []
        for _ in range(model.num_layers):
            entry = [torch.zeros(shape, dtype=pool_dtype, device=dev)
                     for _ in range(2)]
            if kv_quant == "int8":
                entry += [torch.zeros((max_pages,), dtype=torch.float32,
                                      device=dev) for _ in range(2)]
            self.kv_cache.append(tuple(entry))
        self.tokens = torch.zeros((s,), dtype=torch.int32, device=dev)
        self.positions = torch.zeros((s,), dtype=torch.int32, device=dev)
        self.block_table = torch.zeros((s, self.pages_per_slot),
                                       dtype=torch.int32, device=dev)
        self.active = torch.zeros((s,), dtype=torch.int32, device=dev)
        # host mirrors of the positions and the active mask: the sampler
        # keys its noise by position without reading the device
        self._positions_host = np.zeros((s,), np.int64)
        self._active_host = np.zeros((s,), bool)

    def _put(self, x: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(x, np.int32)).to(
            self.device)

    def kv_pool_bytes(self) -> int:
        """Device bytes the paged KV pool holds: pages and scale sidecars,
        every layer. An int8 pool is at most 0.55x an fp pool of the same
        geometry (the JAX package's bar)."""
        return int(sum(t.numel() * t.element_size()
                       for entry in self.kv_cache for t in entry))

    def set_block_tables(self, table: np.ndarray) -> None:
        """Refresh the device block table (admission/free changed the host
        copy). Shape stays [S, pages_per_slot]."""
        self.block_table = self._put(table)

    def set_active(self, active: np.ndarray) -> None:
        self._active_host = np.asarray(active) > 0
        self.active = self._put(active)

    def set_decode_state(self, tokens: np.ndarray,
                         positions: np.ndarray) -> None:
        """Push the full [S] (token, position) state from the host: the
        speculative scheduler's rollback primitive, declaring the
        post-acceptance state before a round's dispatches."""
        self.tokens = self._put(tokens)
        self.positions = self._put(positions)
        self._positions_host = np.asarray(positions, np.int64).copy()

    @torch.inference_mode()
    def prefill(self, ids: np.ndarray, prompt_lens: np.ndarray,
                slot_map: np.ndarray, slot_tables: np.ndarray
                ) -> torch.Tensor:
        """One admission batch. ``ids`` [Bp, Lp] zero-padded prompts;
        ``slot_map`` [Bp] target decode slot (-1 = dummy padding row);
        ``slot_tables`` [Bp, pages_per_slot] the target slots' block-table
        rows (all-trash for dummies). Returns the post-merge tokens vector
        (a fresh device tensor that later calls do not modify)."""
        lens_np = np.asarray(prompt_lens, np.int64)
        smap = np.asarray(slot_map, np.int64)
        lens = self._put(lens_np)
        ids_t = self._put(ids)
        pad = (torch.arange(ids_t.shape[1], device=self.device)[None, :]
               < lens[:, None]).to(torch.int32)
        logits = self.model(ids_t, pad, block_table=self._put(slot_tables),
                            kv_cache=self.kv_cache,
                            decode_impl=self.decode_impl,
                            kv_quant=self.kv_quant)
        last_idx = torch.clamp(lens - 1, min=0).long()
        rows = torch.arange(ids_t.shape[0], device=self.device)
        last = logits[rows, last_idx]                            # [Bp, V]
        # the first token sits at position prompt_len of its target slot
        # (dummies fold as slot 0: picked, then dropped)
        first = self._pick(last, lens_np, np.maximum(smap, 0))
        real = np.nonzero(smap >= 0)[0]
        targets = torch.from_numpy(smap[real]).to(self.device)
        src = torch.from_numpy(real).to(self.device)
        tokens = self.tokens.clone()
        positions = self.positions.clone()
        tokens[targets] = first[src]
        positions[targets] = lens[src]
        self.tokens, self.positions = tokens, positions
        self._positions_host[smap[real]] = lens_np[real]
        return self.tokens

    @torch.inference_mode()
    def decode(self) -> torch.Tensor:
        """Advance every slot by ``decode_span`` token(s). Each step feeds
        each slot's current token at its own position, writes its K/V page
        entry, attends over its live prefix and picks the next token (keyed
        at the position it will occupy). Inactive slots write to trash and
        keep their state frozen. Returns the picked tokens, [S] at span 1
        and [span, S] above, as a fresh device tensor."""
        slots = np.arange(self.decode_slots)
        picked = []
        for _ in range(self.decode_span):
            logits = self.model(self.tokens[:, None], None,
                                cache_index=self.positions,
                                block_table=self.block_table,
                                kv_cache=self.kv_cache,
                                decode_impl=self.decode_impl,
                                kv_quant=self.kv_quant)
            nxt = self._pick(logits[:, 0], self._positions_host + 1, slots)
            live = self.active > 0
            self.tokens = torch.where(live, nxt, self.tokens)
            self.positions = torch.where(live, self.positions + 1,
                                         self.positions)
            self._positions_host += self._active_host
            picked.append(self.tokens)
        return picked[0] if self.decode_span == 1 else torch.stack(picked)

    @torch.inference_mode()
    def verify(self, draft: np.ndarray, tokens: np.ndarray,
               positions: np.ndarray) -> torch.Tensor:
        """Speculatively verify a [K, S] draft in one forward: each slot's
        chain ``[tokens[s], draft[:, s]]`` runs as a span at positions
        ``positions[s] ..``, every link's K/V is written before the span
        attention reads the live prefix plus the earlier links, and the
        target's pick at every link comes back as a [K + 1, S] device
        tensor (row j picks the token at ``positions + 1 + j``, keyed per
        (slot, position) exactly as :meth:`decode` keys it, so accepted
        tokens are the non-speculative path's, greedy or sampled). The
        engine's own state vectors are not advanced: the host walks
        acceptance and declares the next round's state. Rejected links'
        writes sit past the live position in the slot's own pages, masked
        until overwritten; inactive slots' picks are never read."""
        if self.spec_tokens <= 0:
            raise RuntimeError("engine built with spec_tokens=0")
        S, kp1 = self.decode_slots, self.spec_tokens + 1
        draft = np.asarray(draft, np.int32)
        if draft.shape != (kp1 - 1, S):
            raise ValueError(f"draft must be [{kp1 - 1}, {S}], got "
                             f"{draft.shape}")
        pos_h = np.asarray(positions, np.int64)
        chain = np.concatenate([np.asarray(tokens, np.int32)[:, None],
                                draft.T], axis=1)              # [S, K+1]
        logits = self.model(self._put(chain), None,
                            cache_index=self._put(pos_h),
                            block_table=self.block_table,
                            kv_cache=self.kv_cache,
                            decode_impl=self.decode_impl,
                            kv_quant=self.kv_quant)            # [S, K+1, V]
        # one flattened pick over all S*(K+1) rows, keyed per (slot,
        # position): row j of slot s picks what decode would there
        pos_f = pos_h[:, None] + 1 + np.arange(kp1)[None, :]
        slot_f = np.repeat(np.arange(S), kp1)
        seq = self._pick(logits.reshape(S * kp1, -1), pos_f.reshape(-1),
                         slot_f)
        return seq.reshape(S, kp1).T.contiguous()
