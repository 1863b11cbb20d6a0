"""Slot-based generation sessions — iteration-level (continuous) batching
over a persistent KV cache. Port of the dense, unsharded
``GenerationSession`` of paddle_tpu/inference/generation.py.

The session owns ONE cache ``[L, max_slots, H, S, hd]`` that lives
across calls, a slot table, and per-slot device state (position, active
flag, last logits). Requests admit into free slots; prefill writes only
their rows, in place, so live rows are untouched. Rows that emit
``eos_token_id`` or reach ``max_len`` freeze (their output is padded
with ``pad_token_id``) and are evicted, so new requests join mid-flight
while other rows keep decoding. Positions are per row, and the decode
attention masks per row, so a row's tokens equal what a solo
``generate()`` of its prompt produces.

Where the reference ran one compiled program per tick, the port runs
eager PyTorch: a decode tick is one ``decode_one_token`` over every slot
(dead rows write at their dump position, never read), and ``fused_tick``
is the chunk-prefill half followed by the decode half.

Quantized serving (``cfg.weight_quant="int8"/"int4"`` with params from
``quantization.quantize_gpt_params``, and/or ``cfg.kv_cache_dtype="int8"``
for the scaled-int8 cache) runs through the same calls: the session then
holds ``(codes, steps)`` cache pairs and keeps its byte accounting in
``quant_stats``. Paged KV, speculative decoding, meshes and prefix span
copies belong to later slices and raise ``NotImplementedError``.
"""
from __future__ import annotations

import itertools
import os
import time

import numpy as np
import torch

from ..device import resolve_device
from ..models.gpt import (GPTConfig, _wq_bits, check_params_device,
                          check_prefill_mode, decode_one_token, init_kv_cache,
                          pad_cache_len, prefill, prefill_suffix,
                          sample_logits)
from ..observability import ServingMetrics
from ..observability.quant import record_session_quant
from ..quantization.gpt_quant import kv_cache_quantized

_SESSION_SEQ = itertools.count()


class GenerationSession:
    """Iteration-level batched generation over persistent cache slots.

    >>> sess = GenerationSession(params, cfg, max_slots=8,
    ...                          max_prompt_len=64, eos_token_id=2)
    >>> slots = sess.admit(prompts, lengths)      # -> free slots, prefilled
    >>> while sess.any_active():
    ...     emitted = sess.step()                 # {slot: token} this tick
    >>> outs = [sess.evict(s) for s in slots]     # per-slot new tokens
    """

    def __init__(self, params, cfg: GPTConfig, max_slots: int,
                 max_prompt_len: int | None = None,
                 max_len: int | None = None, eos_token_id: int | None = None,
                 pad_token_id: int = 0, temperature: float = 0.0,
                 top_k: int = 0, top_p: float = 0.0, seed: int = 0,
                 prefill_mode: str | None = None, device=None, mesh=None,
                 spec_decode: int | None = None,
                 kv_paged: bool | None = None):
        # the reference also arms paging and speculation from the
        # environment; neither may be ignored silently
        env_paged = os.environ.get("PADDLE_TPU_KV_PAGED", "0").strip()
        env_spec = os.environ.get("PADDLE_TPU_SPEC_DECODE", "").strip()
        for what, armed, later in (
                ("mesh", mesh is not None, "multi-device serving"),
                ("spec_decode", (spec_decode or 0) > 1
                 or (spec_decode is None and env_spec not in ("", "0", "1")),
                 "speculative decoding"),
                ("kv_paged", kv_paged or (kv_paged is None and env_paged
                                          not in ("", "0", "false", "False")),
                 "paged KV cache")):
            if armed:
                raise NotImplementedError(
                    f"GenerationSession: {what} belongs to the {later} "
                    "slice of the port")
        self.device = resolve_device(device)
        check_params_device(params, self.device)
        self._mode = check_prefill_mode(
            prefill_mode or os.environ.get("PADDLE_TPU_PREFILL_MODE", "full"))
        self.cfg = cfg
        self.max_slots = int(max_slots)
        self.max_len = int(max_len or cfg.max_seq)
        if self.max_len > cfg.max_seq:
            raise ValueError(
                f"max_len ({self.max_len}) exceeds cfg.max_seq "
                f"({cfg.max_seq}) — positions past max_seq have no "
                "positional embedding")
        self.max_prompt_len = int(max_prompt_len or self.max_len)
        if self.max_prompt_len > self.max_len:
            raise ValueError(
                f"max_prompt_len ({self.max_prompt_len}) exceeds the "
                f"cache length ({self.max_len})")
        self.eos_token_id = eos_token_id
        self.pad_token_id = int(pad_token_id)
        self._sampling = (float(temperature), int(top_k), float(top_p))
        self._params = params

        # ---- device state (slot-major) ----
        # the cache length rounds up to a decode_block multiple; rows
        # still FREEZE at max_len (the logical limit)
        self._phys_len = pad_cache_len(self.max_len, cfg.decode_block)
        self._kc, self._vc = init_kv_cache(cfg, self.max_slots,
                                           self._phys_len, self.device)
        dev = self.device
        self._pos = torch.zeros((self.max_slots,), dtype=torch.long,
                                device=dev)
        self._activ = torch.zeros((self.max_slots,), dtype=torch.bool,
                                  device=dev)
        self._logits = torch.zeros((self.max_slots, cfg.vocab_size),
                                   dtype=torch.float32, device=dev)
        self._gen = torch.Generator(device=dev).manual_seed(int(seed))

        # ---- host mirrors (no device sync per step) ----
        self._occupied = [False] * self.max_slots
        self._host_active = [False] * self.max_slots
        self._host_pos = [0] * self.max_slots
        self._new: list[list[int]] = [[] for _ in range(self.max_slots)]
        # per-slot write position of a DEAD row on a decode tick: 0 for
        # free/finished slots, the next chunk offset for rows mid-way
        # through a chunked prefill (never the resident prefix)
        self._dump = np.zeros((self.max_slots,), np.int64)
        self._dump_dev = torch.zeros((self.max_slots,), dtype=torch.long,
                                     device=dev)
        self._dump_dirty = False

        self._telemetry = ServingMetrics(f"session{next(_SESSION_SEQ)}",
                                         self.max_slots)
        self._admit_t = [0.0] * self.max_slots
        self._await_first = [False] * self.max_slots
        # quant byte accounting: weight bytes saved, KV bytes per row
        self._quant_stats = None
        if cfg.weight_quant or kv_cache_quantized(cfg):
            if cfg.weight_quant:
                _wq_bits(cfg)    # an unknown mode fails here, explained
            self._quant_stats = record_session_quant(
                cfg, self._params, (self._kc, self._vc), self.max_slots)

    # ------------------------------------------------------------- admission
    def free_slots(self) -> list[int]:
        return [i for i in range(self.max_slots) if not self._occupied[i]]

    @torch.no_grad()
    def admit(self, prompts, lengths=None, arrival_ts=None) -> list[int]:
        """Admit right-padded [n, p] prompts (true lengths in ``lengths``;
        None = all p) into free slots with ONE batched prefill over
        their rows. Returns the slot ids. ``arrival_ts`` (a
        ``time.perf_counter()`` stamp) feeds the admission-wait metric."""
        t_admit = time.perf_counter()
        prompts = np.asarray(prompts, np.int64)
        if prompts.ndim != 2:
            raise ValueError(f"prompts must be [n, p], got {prompts.shape}")
        n, p = prompts.shape
        if n == 0:
            return []
        if p > self.max_prompt_len:
            raise ValueError(
                f"prompt length {p} exceeds max_prompt_len "
                f"({self.max_prompt_len})")
        lengths = (np.full((n,), p, np.int64) if lengths is None
                   else np.asarray(lengths, np.int64))
        if lengths.shape != (n,) or (lengths < 1).any() or \
                (lengths > p).any():
            raise ValueError(f"lengths must be [n] in [1, {p}]")
        free = self.free_slots()
        if n > len(free):
            self._telemetry.rejected(n)
            raise ValueError(
                f"{n} prompts but only {len(free)} free slots — evict "
                "finished slots first")
        slots = free[:n]
        dev = self.device
        rows = torch.as_tensor(slots, device=dev)
        lens = torch.as_tensor(lengths, device=dev)
        logits, _, _ = prefill(self._params, self.cfg,
                               torch.as_tensor(prompts, device=dev),
                               self._kc, self._vc, lengths=lens,
                               mode=self._mode, rows=rows)
        self._pos[rows] = lens
        self._activ[rows] = True
        self._logits[rows] = logits
        now = time.perf_counter()
        for j, s in enumerate(slots):
            self._occupied[s] = True
            self._host_active[s] = True
            self._host_pos[s] = int(lengths[j])
            self._new[s] = []
            self._admit_t[s] = t_admit
            self._await_first[s] = True
        self._telemetry.admitted(
            n, prefill_s=now - t_admit, occupied=sum(self._occupied),
            queue_wait_s=max(0.0, t_admit - arrival_ts)
            if arrival_ts is not None else 0.0)
        return slots

    def try_admit(self, prompts, lengths=None, arrival_ts=None):
        """``admit()`` that returns None instead of raising when free
        slots are short (no reject is counted: the caller is probing
        capacity). Malformed prompts still raise."""
        prompts = np.asarray(prompts, np.int64)
        if prompts.ndim == 2 and prompts.shape[0] > len(self.free_slots()):
            return None
        return self.admit(prompts, lengths, arrival_ts)

    # ------------------------------------------------ scheduler primitives
    @property
    def quant_stats(self) -> dict | None:
        """The quantized session's byte accounting
        (``observability.quant.record_session_quant``); None when neither
        the weights nor the cache are quantized."""
        return self._quant_stats

    @property
    def telemetry(self) -> ServingMetrics:
        """The session's ServingMetrics, shared with the serving engine."""
        return self._telemetry

    def alloc_slot(self) -> int | None:
        """Reserve a free slot WITHOUT prefilling (the chunked admission
        path). It stays inactive — decode ticks skip it — until a
        finalizing :meth:`prefill_chunks` call. None when no slot is
        free."""
        free = self.free_slots()
        if not free:
            return None
        s = free[0]
        self._occupied[s] = True
        self._host_active[s] = False
        self._host_pos[s] = 0
        self._new[s] = []
        return s

    def release_slot(self, slot: int) -> None:
        """Free a reserved-but-never-activated slot."""
        if not self._occupied[slot]:
            raise ValueError(f"slot {slot} is not occupied")
        if self._host_active[slot]:
            raise ValueError(f"slot {slot} is active — evict() it")
        self._occupied[slot] = False
        self._set_dump(slot, 0)

    def _set_dump(self, slot: int, pos: int) -> None:
        if self._dump[slot] != pos:
            self._dump[slot] = pos
            self._dump_dirty = True

    def is_active(self, slot: int) -> bool:
        """Whether the slot is still decoding."""
        return self._host_active[slot]

    def generated_count(self, slot: int) -> int:
        """How many tokens the slot has emitted since admission."""
        return len(self._new[slot])

    def copy_prefix_into(self, slot: int, blocks) -> int:
        raise NotImplementedError(
            "prefix KV span copies belong to the prefix-cache slice")

    def read_prefix_block(self, slot: int, start: int, block: int):
        raise NotImplementedError(
            "prefix KV span reads belong to the prefix-cache slice")

    def prefill_chunks(self, chunks, width: int, arrivals=None,
                       queue_waits=None) -> None:
        """Advance in-progress chunked prefills by ONE chunk each, in one
        batched suffix prefill over their rows. ``chunks``: list of
        ``(slot, tokens, offset, finalize)`` — ``tokens`` (1..width ints)
        land at cache positions [offset, offset + len); ``finalize``
        marks the prompt's last chunk, after which the row decodes.
        ``arrivals``/``queue_waits``: {slot: perf_counter stamp} /
        {slot: seconds} for the TTFT and wait metrics."""
        if not chunks:
            return
        t0 = time.perf_counter()
        self._run_chunks(chunks, width)
        self._telemetry.prefill_tick(time.perf_counter() - t0)
        self._finalize_chunks(chunks, arrivals, queue_waits, t0)

    def fused_tick(self, chunks, width: int, arrivals=None,
                   queue_waits=None) -> dict[int, int]:
        """Both halves of a serving tick: every chunk prefill advances one
        chunk, then every live row decodes one token; rows finalized by
        the chunk half emit their first token in the SAME tick. Returns
        the :meth:`step`-style {slot: token} dict."""
        if not chunks:
            return self.step()
        t0 = time.perf_counter()
        self._run_chunks(chunks, width)
        # the chunk half's wall is charged once, to the decode tick
        self._telemetry.prefill_tick(0.0)
        self._finalize_chunks(chunks, arrivals, queue_waits, t0)
        was = list(self._host_active)
        return self._process_emitted(self._decode(), was, t0)

    @torch.no_grad()
    def _run_chunks(self, chunks, width: int) -> None:
        if width > self._phys_len:
            raise ValueError(
                f"chunk width {width} exceeds the physical cache "
                f"length {self._phys_len} — no window can fit it")
        n = len(chunks)
        toks = np.full((n, width), self.pad_token_id, np.int64)
        lens = np.zeros((n,), np.int64)
        offs = np.zeros((n,), np.int64)
        rows = np.zeros((n,), np.int64)
        fin = np.zeros((n,), bool)
        for i, (slot, tk, off, fz) in enumerate(chunks):
            tk = np.asarray(tk, np.int64)
            if tk.ndim != 1 or not (0 < tk.shape[0] <= width):
                raise ValueError(
                    f"chunk for slot {slot} must be 1-D with 1..{width} "
                    f"tokens, got shape {tk.shape}")
            if not self._occupied[slot] or self._host_active[slot]:
                raise ValueError(
                    f"slot {slot} must be reserved (alloc_slot) and "
                    "inactive to take prefill chunks")
            if off + tk.shape[0] > self.max_len:
                raise ValueError(
                    f"chunk for slot {slot} ends at {off + tk.shape[0]}, "
                    f"past the cache length ({self.max_len})")
            toks[i, :tk.shape[0]] = tk
            lens[i], offs[i], rows[i], fin[i] = tk.shape[0], off, slot, fz
        dev = self.device
        lens_d = torch.as_tensor(lens, device=dev)
        offs_d = torch.as_tensor(offs, device=dev)
        rows_d = torch.as_tensor(rows, device=dev)
        logits, _, _ = prefill_suffix(
            self._params, self.cfg, torch.as_tensor(toks, device=dev),
            self._kc, self._vc, offsets=offs_d, lengths=lens_d, rows=rows_d)
        if fin.any():
            f = torch.as_tensor(fin, device=dev)
            self._pos[rows_d[f]] = (offs_d + lens_d)[f]
            self._activ[rows_d[f]] = True
            self._logits[rows_d[f]] = logits[f]

    def _finalize_chunks(self, chunks, arrivals, queue_waits,
                         t0: float) -> None:
        for slot, tk, off, fz in chunks:
            n = np.asarray(tk).shape[0]
            if not fz:
                # an interleaved decode tick's dead-row write must land
                # where the NEXT chunk rewrites it anyway
                self._set_dump(slot, off + n)
                continue
            self._host_active[slot] = True
            self._host_pos[slot] = int(off + n)
            self._set_dump(slot, 0)
            self._admit_t[slot] = (arrivals or {}).get(slot, t0)
            self._await_first[slot] = True
            self._telemetry.admitted(
                1, prefill_s=0.0, occupied=sum(self._occupied),
                queue_wait_s=(queue_waits or {}).get(slot, 0.0))

    # ---------------------------------------------------------------- decode
    def any_active(self) -> bool:
        return any(self._host_active)

    def step(self) -> dict[int, int]:
        """ONE decode tick across every live slot. Returns {slot: token};
        rows that emit eos (or fill the cache) freeze."""
        t0 = time.perf_counter()
        was = list(self._host_active)
        return self._process_emitted(self._decode(), was, t0)

    @torch.no_grad()
    def _decode(self) -> np.ndarray:
        """The decode tick on the device; returns the sampled tokens."""
        if self._dump_dirty:
            self._dump_dev = torch.as_tensor(self._dump, device=self.device)
            self._dump_dirty = False
        # rows at the LOGICAL cache limit freeze like eos rows
        can = self._activ & (self._pos < self.max_len)
        temperature, top_k, top_p = self._sampling
        tok = sample_logits(self._logits, self._gen, temperature, top_k,
                            top_p)
        tok = torch.where(can, tok, torch.full_like(tok, self.pad_token_id))
        still = can
        if self.eos_token_id is not None:
            still = can & (tok != self.eos_token_id)
        # dead slots write at their DUMP position, not their stale pos:
        # never over a resident prefix, and never inflating how far the
        # batch's attention has to read
        pos_step = torch.where(can, self._pos, self._dump_dev)
        new_logits, _, _ = decode_one_token(self._params, self.cfg, tok,
                                            pos_step, self._kc, self._vc)
        self._pos = torch.where(still, self._pos + 1, self._pos)
        self._activ = still
        self._logits = torch.where(still[:, None], new_logits, self._logits)
        return tok.cpu().numpy()   # device sync: the tick really ran

    def _process_emitted(self, toks, was, t0: float) -> dict[int, int]:
        emitted = {}
        for s in range(self.max_slots):
            if not was[s]:
                continue
            if self._host_pos[s] >= self.max_len:
                # cache full: the device froze this row (it emitted pad)
                self._host_active[s] = False
                continue
            t = int(toks[s])
            self._new[s].append(t)
            emitted[s] = t
            if self._await_first[s]:
                self._await_first[s] = False
                self._telemetry.first_token(self._admit_t[s])
            if self.eos_token_id is not None and t == self.eos_token_id:
                self._host_active[s] = False
            else:
                self._host_pos[s] += 1
        self._telemetry.tick(time.perf_counter() - t0, len(emitted))
        return emitted

    def freeze(self, slots) -> None:
        """Stop decoding the given slots without freeing them."""
        slots = list(slots)
        for s in slots:
            self._host_active[s] = False
        if slots:
            self._activ[torch.as_tensor(slots, device=self.device)] = False

    def evict(self, slot: int) -> list[int]:
        """Free a slot; returns its generated tokens (the cache needs no
        clearing: admission rewrites [0, len) and attention never reads
        past a row's live position)."""
        if not self._occupied[slot]:
            raise ValueError(f"slot {slot} is not occupied")
        if self._host_active[slot]:
            self.freeze([slot])
        self._occupied[slot] = False
        out, self._new[slot] = self._new[slot], []
        self._telemetry.evicted(sum(self._occupied))
        return out

    def reset_metrics(self) -> None:
        """Zero the serving accumulators (e.g. after a warm-up wave)."""
        self._telemetry.reset()

    def metrics(self) -> dict:
        """Serving metrics snapshot: TTFT, per-token decode latency and
        tok/s over live rows, occupancy, admission wait, evictions."""
        out = self._telemetry.metrics()
        out["slots_occupied"] = sum(self._occupied)
        out["slot_occupancy"] = round(out["slots_occupied"]
                                      / self.max_slots, 4)
        out["slots_active"] = sum(self._host_active)
        return dict(sorted(out.items()))

    # ----------------------------------------------------------- convenience
    def generate(self, prompts, lengths=None, max_new_tokens: int = 32):
        """Admit, decode until every admitted row finished (eos) or hit
        ``max_new_tokens``, evict. Returns [n, max_new_tokens] int64 —
        rows that stopped early are padded with pad_token_id. Other
        in-flight slots advance underneath."""
        slots = self.admit(prompts, lengths)
        mine = set(slots)
        while any(self._host_active[s] for s in mine):
            self.step()
            done = [s for s in mine if self._host_active[s]
                    and len(self._new[s]) >= max_new_tokens]
            if done:
                self.freeze(done)
        out = np.full((len(slots), max_new_tokens), self.pad_token_id,
                      np.int64)
        for j, s in enumerate(slots):
            toks = self.evict(s)[:max_new_tokens]
            out[j, :len(toks)] = toks
        return out
