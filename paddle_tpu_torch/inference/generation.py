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

Where the reference ran one compiled program per tick, the port
replays one captured CUDA graph per tick shape on the card
(``framework.cuda_graph``): a decode tick is one ``decode_one_token``
over every slot (dead rows write at their dump position, never read);
a chunk tick (``prefill_chunks``, and the chunk half of ``fused_tick``
and ``spec_tick``) is one suffix prefill over the whole slot batch at the
tick's width bucket, admitted rows masked in (the reference's
``chunk_body``), so each (kind, width) replays one graph. The tick's
state lives in device tensors whose storage never changes (positions,
active flags, last logits, the session's threefry key, the dump
positions, the page tables, the stochastic lane, the chunk batch), so
the device body of a tick reads and writes only that storage and the
caches; the host reads the emitted tokens (and a spec tick's counts and
flags) once after it. A decode tick copies host state in only when it
changed (an admission, a page grant); a chunk tick copies in ONE packed
batch: the chunk tokens, lengths, offsets, admit and finalize masks, the
dump positions, and the finalizing rows' sampling lanes, which the body
merges with ``torch.where`` (the reference's ``lane_prog``).
:meth:`prewarm_programs` captures a session's graphs before traffic
without changing any stream. :func:`eager_ticks` runs the same bodies op
by op (the CPU always does).

Quantized serving (``cfg.weight_quant="int8"/"int4"`` with params from
``quantization.quantize_gpt_params``, and/or ``cfg.kv_cache_dtype="int8"``
for the scaled-int8 cache) runs through the same calls: the session then
holds ``(codes, steps)`` cache pairs and keeps its byte accounting in
``quant_stats``.

Paged KV (``kv_paged=True`` or ``PADDLE_TPU_KV_PAGED=1``): the cache is
ONE page pool ``[L, kv_pages, H, page_size, hd]`` (page size =
``cfg.decode_block``) and each slot an int32 page table. Whole-prompt
``admit`` grants a full row of pages, ``alloc_slot(need_tokens=...)`` only
the pages a request can touch; page exhaustion backpressures like slot
exhaustion. Page 0 is the scratch page that takes dead rows' writes.
Pages are refcounted: ``read_prefix_block`` hands the prefix pool a
by-reference :class:`~..serving.prefix_cache.PageSpan` (zero bytes
moved), ``copy_prefix_into`` aliases pooled pages into a row's table, and
a page returns to the free list only when its last reader (a row or a
pooled entry, ``release_pooled_entry``) lets go. Paging changes where
K/V lives, never the numbers: paged streams equal dense ones.

Speculative decoding (``spec_decode=k``, 2 <= k <= 8, or
``PADDLE_TPU_SPEC_DECODE=k``): :meth:`spec_step` / :meth:`spec_tick` run a
draft that proposes a window of k tokens a row, ONE k-wide target
forward (``verify_tokens``, the decode kernels at Q = k) and the
acceptance on the device, and emit up to k tokens a row a tick. The
draft is the target's first ``spec_draft_layers`` layers (default half;
its caches are the target's first layer caches) or a separate model
``spec_draft=(params, cfg)`` with a cache of its own (a pool sharing the
target's page table when paged). Greedy acceptance emits exactly the
spec-off stream. ``spec_sample`` (on by itself when ``temperature > 0``)
arms the stochastic lane: per-row temperature and seed (``admit(
temperatures=, seeds=)``, :meth:`set_sampling`), every draw keyed by
(seed, absolute position, lane), the Leviathan ratio test and the residual
resample, pending into the next tick's window row 0. The physical cache
keeps ``spec_k`` positions of headroom past ``max_len`` for the window.

Meshes and the fleet's span export/import belong to later slices and
raise ``NotImplementedError``.
"""
from __future__ import annotations

import itertools
import os
import time

import numpy as np
import torch

from ..device import resolve_device
from ..framework import prng
from ..framework.cuda_graph import TickGraph, eager_ticks, graphed
from ..models.gpt import (SPEC_LANE_DRAFT, GPTConfig, _kv_index, _wq_bits,
                          check_draft_compat, check_params_device,
                          check_prefill_mode, decode_one_token,
                          early_exit_draft, greedy_acceptance, init_kv_cache,
                          kv_data, pad_cache_len, prefill, prefill_suffix,
                          sample_logits, spec_draft_sample, spec_sample_key,
                          stochastic_acceptance, verify_tokens)
from ..observability import ServingMetrics
from ..observability.quant import record_session_quant
from ..ops.kernels.decode_attention import MAX_Q
from ..quantization.gpt_quant import kv_cache_quantized
from ..serving.prefix_cache import PageSpan, span_concat

_SESSION_SEQ = itertools.count()

__all__ = ["GenerationSession", "eager_ticks"]


def _leaves(cache):
    """The tensors of a cache or span: itself, or a scaled-int8 pair's
    codes and steps."""
    return cache if isinstance(cache, tuple) else (cache,)


class GenerationSession:
    """Iteration-level batched generation over persistent cache slots.

    >>> sess = GenerationSession(params, cfg, max_slots=8,
    ...                          max_prompt_len=64, eos_token_id=2)
    >>> slots = sess.admit(prompts, lengths)      # -> free slots, prefilled
    >>> while sess.any_active():
    ...     emitted = sess.step()                 # {slot: token} this tick
    >>> outs = [sess.evict(s) for s in slots]     # per-slot new tokens

    With ``spec_decode=k`` the loop calls :meth:`spec_step`, which
    returns ``{slot: [tokens]}``.
    """

    def __init__(self, params, cfg: GPTConfig, max_slots: int,
                 max_prompt_len: int | None = None,
                 max_len: int | None = None, eos_token_id: int | None = None,
                 pad_token_id: int = 0, temperature: float = 0.0,
                 top_k: int = 0, top_p: float = 0.0, seed: int = 0,
                 prefill_mode: str | None = None, device=None, mesh=None,
                 spec_decode: int | None = None,
                 spec_draft_layers: int | None = None,
                 spec_draft: tuple | None = None,
                 spec_sample: bool | None = None,
                 kv_paged: bool | None = None, kv_pages: int | None = None):
        if mesh is not None:
            raise NotImplementedError(
                "GenerationSession: mesh belongs to the multi-device "
                "serving slice of the port")
        env_paged = os.environ.get("PADDLE_TPU_KV_PAGED", "0").strip()
        self.kv_paged = (bool(kv_paged) if kv_paged is not None
                         else env_paged not in ("", "0", "false", "False"))
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
        self._init_spec(spec_decode, spec_draft_layers, spec_draft,
                        spec_sample, float(temperature))

        # ---- device state (slot-major) ----
        # the cache length rounds up to a decode_block multiple; rows
        # still FREEZE at max_len (the logical limit). A spec session keeps
        # spec_k positions of headroom past max_len: a window (or a dead
        # row's dump window) starting at max_len - 1 or below always fits
        self._phys_len = pad_cache_len(self.max_len + self.spec_k,
                                       cfg.decode_block)
        if self.kv_paged:
            # page size = decode_block, the prefix pool's block; the row
            # length rounds UP to whole pages (a partial page has no
            # table entry), and page 0 is the scratch page
            self._page_size = int(cfg.decode_block)
            if self._page_size < 1:
                raise ValueError(
                    f"kv_paged needs decode_block >= 1 (the page size), "
                    f"got {cfg.decode_block}")
            self._phys_len = -(-self._phys_len // self._page_size) \
                * self._page_size
            self._pages_per_row = self._phys_len // self._page_size
            self._n_pages = (int(kv_pages) if kv_pages
                             else 1 + self.max_slots * self._pages_per_row)
            if self._n_pages < 1 + self._pages_per_row:
                raise ValueError(
                    f"kv_pages={self._n_pages} cannot host even one full "
                    f"row ({self._pages_per_row} pages) plus the scratch "
                    "page — raise kv_pages or shrink max_len")
            self._kc, self._vc = init_kv_cache(cfg, self._n_pages,
                                               self._page_size, self.device)
        else:
            if kv_pages is not None:
                raise ValueError(
                    "kv_pages only applies to paged sessions — pass "
                    "kv_paged=True (or PADDLE_TPU_KV_PAGED=1)")
            self._kc, self._vc = init_kv_cache(cfg, self.max_slots,
                                               self._phys_len, self.device)
        dev = self.device
        # a separate draft owns a cache of the target's geometry (paged: a
        # pool SHARING the target's page table, so one grant covers both)
        self._dkc = self._dvc = None
        if self._draft_mode:
            self._dkc, self._dvc = init_kv_cache(
                self._dcfg, self._n_pages if self.kv_paged else self.max_slots,
                self._page_size if self.kv_paged else self._phys_len, dev)
        self._pos = torch.zeros((self.max_slots,), dtype=torch.long,
                                device=dev)
        self._activ = torch.zeros((self.max_slots,), dtype=torch.bool,
                                  device=dev)
        self._logits = torch.zeros((self.max_slots, cfg.vocab_size),
                                   dtype=torch.float32, device=dev)
        # one threefry key for the session, split once a sampled decode
        # tick, on the device (a tensor key, updated in place)
        self._key = torch.tensor(prng.PRNGKey(int(seed)), dtype=torch.int64,
                                 device=dev)
        self._seed_base = int(seed)
        if self.spec_sample:
            # the stochastic lane's per-row device state: temperature,
            # request seed (every draw keys off (seed, position, lane)),
            # the last cache-resident token (the draft's entry point), the
            # pending residual resample (+ flag) and the prompt length. The
            # staged (temperature, seed) wait on the host between
            # alloc_slot and the row's activation
            B = self.max_slots
            self._temp_dev = torch.full((B,), self.default_temperature,
                                        dtype=torch.float32, device=dev)
            self._seed_dev = torch.zeros((B,), dtype=torch.long, device=dev)
            self._last_dev = torch.zeros((B,), dtype=torch.long, device=dev)
            self._pend_tok = torch.zeros((B,), dtype=torch.long, device=dev)
            self._pend_val = torch.zeros((B,), dtype=torch.bool, device=dev)
            self._plen = torch.zeros((B,), dtype=torch.long, device=dev)
            self._stage_temp = np.full((B,), self.default_temperature,
                                       np.float32)
            self._stage_seed = np.arange(B, dtype=np.int64) + self._seed_base

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
        # the chunk batch of a chunk tick, one packed int64 copy: per row
        # 5 columns (length, offset, admit, finalize, the dump position
        # after the tick; on the stochastic lane 4 more: the finalizing
        # row's temperature bits, seed, last token and prompt length),
        # then the width bucket's tokens. A width-W batch is the first
        # max_slots * (columns + W) elements of one flat buffer
        self._chunk_cols = 9 if self.spec_sample else 5
        n = self.max_slots * (self._chunk_cols + self._phys_len)
        self._chunk_dev = torch.zeros((n,), dtype=torch.long, device=dev)
        self._chunk_host = np.zeros((n,), np.int64)
        # the captured tick of each kind on the card: "plain", "spec", and
        # ("chunk" | "fused" | "spec_fused", width) per width bucket. They
        # share one memory pool: ticks never overlap and each output is
        # read before the next replay, and private pools would hold every
        # bucket's temporaries at once (2198 MiB for gpt3_1p3b's
        # whole-prompt session of 8 slots x 512 positions, widths 64-384,
        # on an H100)
        self._graphs: dict = {}
        self._graph_pool = None

        # ---- paged pool host state ----
        # _ptab mirrors the device page table (re-sent only when dirty);
        # _page_ref counts readers per page (a row holding it, plus the
        # prefix pool per pooled entry); _free_pg pops ascending first and
        # LIFO after, so identical replays build identical tables;
        # _row_pages is each row's held pages, aliased ones included
        if self.kv_paged:
            self._ptab = np.zeros((self.max_slots, self._pages_per_row),
                                  np.int32)
            self._ptab_dev = torch.zeros(self._ptab.shape,
                                         dtype=torch.int32, device=dev)
            self._ptab_dirty = False
            self._page_ref = np.zeros((self._n_pages,), np.int32)
            self._free_pg = list(range(self._n_pages - 1, 0, -1))
            self._row_pages: list[list[int]] = [
                [] for _ in range(self.max_slots)]

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
                self._telemetry.name, cfg, self._params,
                (self._kc, self._vc), self.max_slots)
        if self.kv_paged:
            self._telemetry.kv_pages(*self.kv_page_stats())

    def _init_spec(self, spec_decode, draft_layers, draft, sample,
                   temperature: float) -> None:
        """The speculative lane's configuration (the reference's checks,
        plus the decode kernel's window bound)."""
        cfg = self.cfg
        env_k = os.environ.get("PADDLE_TPU_SPEC_DECODE", "").strip()
        k = (int(spec_decode) if spec_decode is not None
             else int(env_k) if env_k else 0)
        if k < 0:
            raise ValueError(f"spec_decode must be >= 0, got {k}")
        if k > MAX_Q:
            raise ValueError(
                f"spec_decode={k}: the verify window runs through the "
                f"decode attention kernel, which takes at most MAX_Q = "
                f"{MAX_Q} query rows — use spec_decode <= {MAX_Q}")
        self.spec_k = k if k > 1 else 0
        if sample is None:
            self.spec_sample = bool(self.spec_k) and temperature != 0.0
        else:
            self.spec_sample = bool(sample)
            if self.spec_sample and not self.spec_k:
                raise ValueError(
                    "spec_sample needs a speculative window — pass "
                    "spec_decode >= 2 (or PADDLE_TPU_SPEC_DECODE)")
        # the temperature a row takes when its caller names none
        self.default_temperature = temperature
        self._draft_mode = False
        self._spec_cut = None
        self._draft_params = self._dcfg = None
        if not self.spec_k:
            return
        if temperature != 0.0 and not self.spec_sample:
            raise ValueError(
                "spec_sample=False pins the speculative lane to greedy "
                "argmax acceptance, which has no exact rule at "
                f"temperature={temperature} — drop spec_sample=False "
                "(stochastic acceptance arms itself) or set temperature=0")
        if draft is not None:
            d_params, d_cfg = draft
            check_draft_compat(cfg, d_cfg)
            check_params_device(d_params, self.device)
            self._draft_mode = True
            self._draft_params, self._dcfg = d_params, d_cfg
            return
        cut = int(draft_layers or max(1, cfg.n_layers // 2))
        if not 1 <= cut <= cfg.n_layers:
            raise ValueError(
                f"spec_draft_layers={cut} must be in [1, {cfg.n_layers}] "
                "(the target's layer count)")
        self._spec_cut = cut
        self._draft_params, self._dcfg = early_exit_draft(self._params, cfg,
                                                          cut)

    # ------------------------------------------------------------- admission
    def free_slots(self) -> list[int]:
        return [i for i in range(self.max_slots) if not self._occupied[i]]

    @torch.no_grad()
    def admit(self, prompts, lengths=None, arrival_ts=None,
              temperatures=None, seeds=None) -> list[int]:
        """Admit right-padded [n, p] prompts (true lengths in ``lengths``;
        None = all p) into free slots with ONE batched prefill over
        their rows. Returns the slot ids. ``arrival_ts`` (a
        ``time.perf_counter()`` stamp) feeds the admission-wait metric.
        On a session with the stochastic lane, ``temperatures``/``seeds``
        ([n] each) set the rows' lanes; None keeps the defaults (the
        session's temperature, ``seed + slot``)."""
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
        if self.kv_paged:
            # whole-prompt admission has no budget hint: each row gets a
            # FULL page table (alloc_slot grants need-sized tables)
            need = n * self._pages_per_row
            if need > len(self._free_pg):
                self._telemetry.rejected(n)
                raise ValueError(
                    f"{n} prompts need {need} KV pages but only "
                    f"{len(self._free_pg)} are free — evict finished "
                    "slots first")
            for s in slots:
                self._grant_pages(s, self._pages_per_row)
        dev = self.device
        rows = torch.as_tensor(slots, device=dev)
        lens = torch.as_tensor(lengths, device=dev)
        toks = torch.as_tensor(prompts, device=dev)
        logits, _, _ = prefill(self._params, self.cfg, toks, self._kc,
                               self._vc, lengths=lens, mode=self._mode,
                               rows=rows, page_table=self._ptab_of(rows))
        if self._draft_mode:
            # the separate draft shadows the admission so its cache holds
            # the prompt (positions past a row's length are never read)
            prefill(self._draft_params, self._dcfg, toks, self._dkc,
                    self._dvc, lengths=lens, rows=rows,
                    page_table=self._ptab_of(rows))
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
        if self.spec_sample:
            for j, s in enumerate(slots):
                self._stage_temp[s] = (float(temperatures[j])
                                       if temperatures is not None
                                       else self.default_temperature)
                self._stage_seed[s] = (int(seeds[j]) if seeds is not None
                                       else self._seed_base + s)
            self._lane_merge([(s, int(prompts[j, lengths[j] - 1]),
                               int(lengths[j]))
                              for j, s in enumerate(slots)])
        self._telemetry.admitted(
            n, prefill_s=now - t_admit, occupied=sum(self._occupied),
            queue_wait_s=max(0.0, t_admit - arrival_ts)
            if arrival_ts is not None else 0.0)
        return slots

    def try_admit(self, prompts, lengths=None, arrival_ts=None):
        """``admit()`` that returns None instead of raising when free
        slots or KV pages are short (no reject is counted: the caller is
        probing capacity). Malformed prompts still raise."""
        prompts = np.asarray(prompts, np.int64)
        if prompts.ndim == 2 and prompts.shape[0] > len(self.free_slots()):
            return None
        if self.kv_paged and prompts.ndim == 2 and \
                prompts.shape[0] * self._pages_per_row > len(self._free_pg):
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

    def kv_row_pages_total(self) -> int:
        """Page grants summed over rows: an aliased (prefix-shared) page
        counts once per row that holds it, unlike :meth:`kv_page_stats`,
        which counts physical pages. 0 on a dense session."""
        if not self.kv_paged:
            return 0
        return sum(len(r) for r in self._row_pages)

    def kv_bytes_per_token(self) -> int:
        """K+V bytes one resident token position costs across layers (the
        byte value of a prefix-cache hit)."""
        leaves = [t for c in (self._kc, self._vc)
                  for t in (c if isinstance(c, tuple) else (c,))]
        total = sum(t.numel() * t.element_size() for t in leaves)
        positions = (self._n_pages * self._page_size if self.kv_paged
                     else self.max_slots * self._phys_len)
        return int(total // max(1, positions))

    def alloc_slot(self, need_tokens: int | None = None) -> int | None:
        """Reserve a free slot WITHOUT prefilling (the chunked admission
        path). It stays inactive — decode ticks skip it — until a
        finalizing :meth:`prefill_chunks` call. None when no slot is
        free. On a paged session the row's pages are granted here:
        ``need_tokens`` (prompt + budget) sizes the grant, None grants a
        full row; None is returned when the pool cannot cover it."""
        free = self.free_slots()
        if not free:
            return None
        s = free[0]
        if self.kv_paged:
            n = self._pages_for(need_tokens)
            if n > len(self._free_pg):
                return None
            self._grant_pages(s, n)
        self._occupied[s] = True
        self._host_active[s] = False
        self._host_pos[s] = 0
        self._new[s] = []
        if self.spec_sample:
            # a previous occupant's lane never leaks into the next request:
            # set_sampling overrides before the finalizing chunk merges it
            self._stage_temp[s] = self.default_temperature
            self._stage_seed[s] = self._seed_base + s
        return s

    def release_slot(self, slot: int) -> None:
        """Free a reserved-but-never-activated slot."""
        if not self._occupied[slot]:
            raise ValueError(f"slot {slot} is not occupied")
        if self._host_active[slot]:
            raise ValueError(f"slot {slot} is active — evict() it")
        self._occupied[slot] = False
        if self.kv_paged:
            self._release_row_pages(slot)
        self._set_dump(slot, 0)

    def _set_dump(self, slot: int, pos: int) -> None:
        if self._dump[slot] != pos:
            self._dump[slot] = pos
            self._dump_dirty = True

    # ------------------------------------------------------- sampling lane
    def set_sampling(self, slot: int, temperature: float = 0.0,
                     seed: int = 0) -> None:
        """Stage one slot's sampling lane (a request's temperature and
        seed) on a session with the stochastic lane, between
        :meth:`alloc_slot` and the finalizing prefill chunk, whose
        activation moves it to the device. The seed is all the sampling
        state a request carries: every draw derives from (seed, absolute
        position, lane). Without the lane a non-zero temperature raises
        (decoding it greedily would misreport the distribution)."""
        if not self.spec_sample:
            if temperature != 0.0:
                raise ValueError(
                    f"temperature={temperature} on a session without the "
                    "stochastic sampling lane — construct the session with "
                    "spec_sample=True (or a non-zero session temperature + "
                    "spec_decode)")
            return
        self._stage_temp[slot] = float(temperature)
        self._stage_seed[slot] = int(seed)

    def _lane_merge(self, rows) -> None:
        """Move freshly activated rows' staged (temperature, seed), their
        last resident token (the draft's entry point) and their prompt
        length into the device lane state, and clear their pending
        resample. ``rows``: ``[(slot, last_token, prompt_len)]``."""
        if not self.spec_sample or not rows:
            return
        slots = [r[0] for r in rows]
        dev = self.device
        idx = torch.as_tensor(slots, device=dev)
        self._temp_dev[idx] = torch.as_tensor(self._stage_temp[slots],
                                              device=dev)
        ints = torch.as_tensor(np.array(
            [self._stage_seed[slots], [r[1] for r in rows],
             [r[2] for r in rows]], np.int64), device=dev)
        self._seed_dev[idx], self._last_dev[idx], self._plen[idx] = ints
        self._pend_tok[idx] = 0
        self._pend_val[idx] = False

    def is_active(self, slot: int) -> bool:
        """Whether the slot is still decoding."""
        return self._host_active[slot]

    def generated_count(self, slot: int) -> int:
        """How many tokens the slot has emitted since admission."""
        return len(self._new[slot])

    # ----------------------------------------------------- paged KV pool
    def _pages_for(self, need_tokens: int | None) -> int:
        """Pages a row needs to hold ``need_tokens`` positions plus the
        spec window's headroom; None = a full row's worth."""
        if need_tokens is None:
            return self._pages_per_row
        need = min(int(need_tokens), self.max_len) + self.spec_k
        n = -(-need // self._page_size)
        return max(1, min(n, self._pages_per_row))

    def _grant_pages(self, slot: int, n: int) -> None:
        """Grant ``n`` fresh pages to a row's table (callers check the
        pool first). Unused entries stay 0, the scratch page, so writes
        past the grant land harmlessly."""
        if n > len(self._free_pg):
            raise RuntimeError(f"slot {slot} needs {n} KV pages but only "
                               f"{len(self._free_pg)} are free")
        row = [self._free_pg.pop() for _ in range(n)]
        self._page_ref[row] = 1
        self._ptab[slot, :n] = row
        self._ptab[slot, n:] = 0
        self._row_pages[slot] = row
        self._ptab_dirty = True
        self._page_note("page_alloc", slot=int(slot), pages=n)

    def _unref_page(self, pid: int) -> bool:
        """Drop one reader of a page; at zero it goes back to the free list
        (LIFO). Returns True when the page was freed."""
        self._page_ref[pid] -= 1
        if self._page_ref[pid] < 0:
            raise AssertionError(f"KV page {pid} refcount went negative")
        if self._page_ref[pid] == 0:
            self._free_pg.append(pid)
            return True
        return False

    def _release_row_pages(self, slot: int) -> None:
        """Every page the row holds drops one reader; pages shared with the
        prefix pool or other rows survive until their last reader goes."""
        row = self._row_pages[slot]
        if not row:
            return
        freed = sum(self._unref_page(pid) for pid in row)
        self._row_pages[slot] = []
        self._ptab[slot, :] = 0
        self._ptab_dirty = True
        self._page_note("page_free", slot=int(slot), pages=int(freed))

    def kv_page_stats(self) -> tuple[int, int, int]:
        """(total, free, shared) over the allocatable pool — page 0, the
        scratch page, is bookkeeping, not capacity; shared counts pages
        with more than one reader."""
        return (self._n_pages - 1, len(self._free_pg),
                int((self._page_ref[1:] > 1).sum()))

    def _page_note(self, kind: str, **kw) -> None:
        self._telemetry.kv_pages(*self.kv_page_stats(), event=kind, **kw)

    def _sync_ptab(self) -> None:
        """Copy the page tables into their device storage when they
        changed."""
        if self._ptab_dirty:
            self._ptab_dev.copy_(torch.from_numpy(self._ptab))
            self._ptab_dirty = False

    def _ptab_of(self, rows):
        """The device page tables of ``rows``; None on a dense session."""
        if not self.kv_paged:
            return None
        self._sync_ptab()
        return self._ptab_dev[rows]

    # ------------------------------------------------------- prefix spans
    def copy_prefix_into(self, slot: int, blocks) -> int:
        """Prefix KV reuse: land already-computed prefix blocks in a
        reserved slot, so those positions never rerun prefill. ``blocks``:
        [(k, v)] pairs from :meth:`read_prefix_block` ([L, H, block, hd]
        arrays or scaled-int8 pairs; :class:`PageSpan` pairs on a paged
        session). Returns the prefix length now resident; follow with a
        suffix :meth:`prefill_chunks` from that offset."""
        if not self._occupied[slot] or self._host_active[slot]:
            raise ValueError(
                f"slot {slot} must be reserved (alloc_slot) and "
                "inactive to take a prefix copy")
        blocks = list(blocks)
        if not blocks:
            return 0
        if self.kv_paged:
            return self._copy_prefix_paged(slot, blocks)
        kb = span_concat([b[0] for b in blocks])
        vb = span_concat([b[1] for b in blocks])
        n = int(kv_data(kb).shape[2])
        if n > self.max_len:
            raise ValueError(f"prefix ({n} tokens) exceeds the cache "
                             f"length ({self.max_len})")
        for cache, span in ((self._kc, kb), (self._vc, vb)):
            for c, b in zip(_leaves(cache), _leaves(span)):
                c[:, slot, :, :n] = b.to(c.dtype)
        # decode ticks before the next chunk dump their dead-row write
        # PAST the copied prefix, not over it
        self._set_dump(slot, n)
        return n

    def _copy_prefix_paged(self, slot: int, blocks) -> int:
        """Paged prefix landing: :class:`PageSpan` blocks ALIAS their pooled
        pages into the row's table (refcount up, the row's own granted
        page goes back to the pool — zero bytes moved); array blocks copy
        into the row's own granted pages."""
        ps = self._page_size
        runs: list[tuple[bool, list]] = []   # consecutive blocks of a kind
        for kb, vb in blocks:
            by_ref = isinstance(kb, PageSpan)
            if runs and runs[-1][0] == by_ref:
                runs[-1][1].append((kb, vb))
            else:
                runs.append((by_ref, [(kb, vb)]))
        o = 0
        for by_ref, run in runs:
            if by_ref:
                for kb, vb in run:
                    if kb.pages != vb.pages:
                        raise ValueError(
                            "PageSpan K/V page lists must agree (one "
                            "physical page holds both planes' rows)")
                    for pid in kb.pages:
                        if o % ps:
                            raise ValueError(
                                f"PageSpan block lands at token {o}, not a "
                                f"page boundary ({ps})")
                        idx = o // ps
                        if idx >= self._pages_per_row:
                            raise ValueError(
                                f"prefix overruns the row's page table "
                                f"({self._pages_per_row} pages)")
                        old = int(self._ptab[slot, idx])
                        if old == 0:
                            raise ValueError(
                                f"slot {slot} page index {idx} was never "
                                "granted — alloc_slot with a need covering "
                                "the prefix first")
                        if old != pid:
                            self._page_ref[pid] += 1
                            self._ptab[slot, idx] = pid
                            self._row_pages[slot][idx] = pid
                            self._unref_page(old)
                            self._ptab_dirty = True
                        o += ps
                self._page_note("page_share", slot=int(slot),
                                pages=sum(len(kb.pages) for kb, _ in run))
                continue
            kb = span_concat([b[0] for b in run])
            vb = span_concat([b[1] for b in run])
            n = int(kv_data(kb).shape[2])
            if o % ps or n % ps:
                raise ValueError(f"paged prefix copies must be page-aligned: "
                                 f"[{o}, {o + n}) vs page size {ps}")
            pages = [int(p) for p in self._ptab[slot, o // ps:(o + n) // ps]]
            if len(pages) != n // ps or 0 in pages:
                raise ValueError(
                    f"slot {slot} holds no granted pages for [{o}, {o + n}) "
                    "— alloc_slot with a need covering the prefix first")
            idx = torch.as_tensor(pages, device=self.device)
            for cache, span in ((self._kc, kb), (self._vc, vb)):
                for c, b in zip(_leaves(cache), _leaves(span)):
                    # [L, H, n(, hd)] -> [L, pages, H, ps(, hd)]
                    v = b.reshape(b.shape[:2] + (n // ps, ps) + b.shape[3:])
                    c[:, idx] = v.movedim(2, 1).to(c.dtype)
            o += n
        if o > self.max_len:
            raise ValueError(f"prefix ({o} tokens) exceeds the cache "
                             f"length ({self.max_len})")
        self._set_dump(slot, o)
        return o

    def read_prefix_block(self, slot: int, start: int, block: int):
        """One ``block``-sized K/V span of a slot's cache, [L, H, block,
        hd] each (scaled-int8: codes and steps) — the pool-insertion side
        of prefix reuse; a copy, so later writes to the slot leave it be.
        On a paged session it moves ZERO bytes: the result is a
        (:class:`PageSpan`, :class:`PageSpan`) pair naming the row's
        pages, each page's refcount bumped once for the pool's hold
        (released through :meth:`release_pooled_entry`)."""
        if not self._occupied[slot]:
            raise ValueError(f"slot {slot} is not occupied")
        if self.kv_paged:
            ps = self._page_size
            if start % ps or block % ps or block <= 0:
                raise ValueError(
                    f"paged prefix blocks must be page-aligned: "
                    f"[{start}, {start + block}) vs page size {ps}")
            n = block // ps
            pages = [int(p) for p in self._ptab[slot, start // ps:
                                                start // ps + n]]
            if len(pages) != n or 0 in pages:
                raise ValueError(f"slot {slot} holds no pages for "
                                 f"[{start}, {start + block})")
            self._page_ref[pages] += 1
            self._page_note("page_share", slot=int(slot), pages=n)
            return PageSpan(pages, ps), PageSpan(pages, ps)
        if start + block > self._phys_len:
            raise ValueError(
                f"block [{start}, {start + block}) runs past the physical "
                f"cache length ({self._phys_len})")
        win = slice(start, start + block)
        read = lambda c: (tuple(t[:, slot, :, win].clone() for t in c)
                          if isinstance(c, tuple)
                          else c[:, slot, :, win].clone())
        return read(self._kc), read(self._vc)

    def release_pooled_entry(self, entry) -> None:
        """``PrefixCache(on_release=...)`` hook: a pooled entry fell to LRU
        eviction — drop the pool's reader on each page of a by-reference
        (PageSpan) entry, so its pages return to the free list once no
        row aliases them. Array entries hold no pages."""
        if not self.kv_paged:
            return
        k = entry[0] if isinstance(entry, tuple) else entry
        if not isinstance(k, PageSpan):
            return
        freed = sum(self._unref_page(pid) for pid in k.pages)
        self._page_note("page_free", pool=True, pages=int(freed))

    def export_kv_span(self, slot: int, length: int, start: int = 0):
        raise NotImplementedError(
            "KV span export (prefill->decode handoff) belongs to the fleet "
            "slice of the port")

    def import_kv_span(self, slot: int, k=None, v=None, blocks=None):
        raise NotImplementedError(
            "KV span import (prefill->decode handoff) belongs to the fleet "
            "slice of the port")

    def materialize_span(self, k, v=None):
        raise NotImplementedError(
            "materializing a by-reference span for transport belongs to "
            "the fleet slice of the port")

    def prefill_chunks(self, chunks, width: int, arrivals=None,
                       queue_waits=None) -> None:
        """Advance in-progress chunked prefills by ONE chunk each, in one
        suffix prefill over the whole slot batch at ``width`` (the
        engine's width bucket: one captured graph per width), the
        chunks' rows masked in. ``chunks``: list of ``(slot, tokens,
        offset, finalize)`` — ``tokens`` (1..width ints) land at cache
        positions [offset, offset + len); ``finalize`` marks the prompt's
        last chunk, after which the row decodes.
        ``arrivals``/``queue_waits``: {slot: perf_counter stamp} /
        {slot: seconds} for the TTFT and wait metrics."""
        if not chunks:
            return
        t0 = time.perf_counter()
        self._assemble_chunks(chunks, width)
        self._tick("chunk", self._chunk_body, width)
        self._telemetry.prefill_tick(time.perf_counter() - t0,
                                     rows=len(chunks))
        self._finalize_chunks(chunks, arrivals, queue_waits, t0)

    def fused_tick(self, chunks, width: int, arrivals=None,
                   queue_waits=None) -> dict[int, int]:
        """Both halves of a serving tick in one body (one graph per
        width): every chunk prefill advances one chunk, then every live
        row decodes one token; rows finalized by the chunk half emit
        their first token in the SAME tick. Returns the :meth:`step`-style
        {slot: token} dict."""
        if not chunks:
            return self.step()
        t0 = time.perf_counter()
        self._assemble_chunks(chunks, width)
        toks = self._tick("fused", self._fused_body, width)
        # the chunk half's wall is charged once, to the decode tick
        self._telemetry.prefill_tick(0.0, rows=len(chunks))
        self._finalize_chunks(chunks, arrivals, queue_waits, t0)
        was = list(self._host_active)
        return self._process_emitted(toks, was, t0)

    def _assemble_chunks(self, chunks, width: int) -> None:
        """Check a chunk batch and copy it into the device chunk storage
        of ``width``: the one host-to-device copy of a chunk tick (the
        page tables ride apart, when an admission changed them). The
        dump positions it carries are the host mirror after the tick: a
        row still mid-prefill dumps at its next chunk's offset, which
        that chunk rewrites anyway, a finalizing row at 0."""
        if width > self._phys_len:
            raise ValueError(
                f"chunk width {width} exceeds the physical cache "
                f"length {self._phys_len} — no window can fit it")
        nc = self._chunk_cols
        n = self.max_slots * (nc + width)
        batch = self._chunk_host[:n].reshape(self.max_slots, nc + width)
        batch[:] = 0
        batch[:, 4] = self._dump
        batch[:, nc:] = self.pad_token_id
        for slot, tk, off, fz in chunks:
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
            end = off + tk.shape[0]
            batch[slot, :5] = (tk.shape[0], off, 1, fz, 0 if fz else end)
            batch[slot, nc:nc + tk.shape[0]] = tk
            if fz and self.spec_sample:
                batch[slot, 5:9] = (
                    np.float32(self._stage_temp[slot]).view(np.int32),
                    self._stage_seed[slot], tk[-1], end)
        self._chunk_dev[:n].copy_(torch.from_numpy(self._chunk_host[:n]))
        self._dump[:] = batch[:, 4]
        self._dump_dirty = False

    def _chunk_view(self, width: int) -> torch.Tensor:
        """The device chunk batch of ``width``: [max_slots, meta + W]."""
        nc = self._chunk_cols
        return self._chunk_dev[:self.max_slots * (nc + width)].view(
            self.max_slots, nc + width)

    def _chunk_half(self, width: int) -> None:
        """The chunk half of a tick (the reference's ``chunk_body``): one
        suffix prefill over every slot at ``width``, only admitted rows
        writing their caches (a separate draft shadows it); finalizing
        rows take their position, logits, activation and sampling lane;
        every row its dump position. Reads and writes only fixed
        storage and the caches."""
        batch = self._chunk_view(width)
        lens, offs, dump = batch[:, 0], batch[:, 1], batch[:, 4]
        admit, fin = batch[:, 2] != 0, batch[:, 3] != 0
        toks = batch[:, self._chunk_cols:]
        paged = dict(page_table=self._ptab_dev) if self.kv_paged else {}
        logits, _, _ = prefill_suffix(
            self._params, self.cfg, toks, self._kc, self._vc, offsets=offs,
            lengths=lens, valid=admit, **paged)
        if self._draft_mode:
            # the draft shadows every chunk; a dense prefix copy has no
            # draft side, so the draft stays cold over a reused span (its
            # proposals get worse there, never the output)
            prefill_suffix(self._draft_params, self._dcfg, toks, self._dkc,
                           self._dvc, offsets=offs, lengths=lens,
                           valid=admit, **paged)
        self._pos.copy_(torch.where(fin, offs + lens, self._pos))
        self._activ.copy_(self._activ | fin)
        self._logits.copy_(torch.where(fin[:, None], logits, self._logits))
        self._dump_dev.copy_(dump)
        if self.spec_sample:
            temp = batch[:, 5].to(torch.int32).view(torch.float32)
            self._temp_dev.copy_(torch.where(fin, temp, self._temp_dev))
            for dst, col in ((self._seed_dev, 6), (self._last_dev, 7),
                             (self._plen, 8)):
                dst.copy_(torch.where(fin, batch[:, col], dst))
            self._pend_tok.masked_fill_(fin, 0)
            self._pend_val.copy_(self._pend_val & ~fin)

    def _chunk_body(self, width: int) -> torch.Tensor:
        """:meth:`prefill_chunks`'s device body; returns the finalize
        mask (read back only to close the tick)."""
        self._chunk_half(width)
        return self._chunk_view(width)[:, 3] != 0

    def _fused_body(self, width: int) -> torch.Tensor:
        """:meth:`fused_tick`'s device body: the chunk half, then the
        decode tick over every row (rows still mid-prefill dump at their
        next chunk's offset, the reference's ``dump_eff``)."""
        self._chunk_half(width)
        return self._decode_body()

    def _spec_fused_body(self, width: int) -> torch.Tensor:
        """:meth:`spec_tick`'s device body: the chunk half, then the spec
        tick."""
        self._chunk_half(width)
        return self._spec_body()

    def _finalize_chunks(self, chunks, arrivals, queue_waits,
                         t0: float) -> None:
        for slot, tk, off, fz in chunks:
            if not fz:
                continue
            self._host_active[slot] = True
            self._host_pos[slot] = int(off + np.asarray(tk).shape[0])
            self._admit_t[slot] = (arrivals or {}).get(slot, t0)
            self._await_first[slot] = True
            self._telemetry.admitted(
                1, prefill_s=0.0, occupied=sum(self._occupied),
                queue_wait_s=(queue_waits or {}).get(slot, 0.0))

    def prewarm_programs(self, widths=(), blocks=()) -> dict:
        """Bring the session's tick graphs up before traffic: the decode
        (or spec) tick, and for each width bucket the chunk tick and the
        fused (or, on a spec session, the fused spec) tick. Each warms up
        and is captured without changing any stream: every tensor of
        :meth:`_tick_state` is saved before and restored after (a
        warm-up is a real tick). ``blocks`` names the prefix block sizes
        the reference compiles copy and read programs for; the port
        copies spans eagerly, so there is nothing to warm. Off the card
        (and inside :func:`eager_ticks`) nothing is captured. Returns
        ``{"programs": graphs prepared, "loaded": 0}`` (no program
        store)."""
        kinds = [("spec" if self.spec_k else "plain",)]
        for w in dict.fromkeys(int(w) for w in widths):
            if w > self._phys_len:
                raise ValueError(
                    f"width bucket {w} exceeds the physical cache length "
                    f"{self._phys_len}")
            kinds += [("chunk", w), ("spec_fused" if self.spec_k
                                     else "fused", w)]
        if not graphed(self.device):
            return {"programs": len(kinds), "loaded": 0}
        bodies = {"plain": self._decode_body, "spec": self._spec_body,
                  "chunk": self._chunk_body, "fused": self._fused_body,
                  "spec_fused": self._spec_fused_body}
        todo = [g for g in (self._graph(kind, bodies[kind], *w)
                            for kind, *w in kinds) if not g.captured]
        if todo:
            with torch.no_grad():
                saved = {n: t.clone() for n, t in self._tick_state().items()}
                try:
                    for graph in todo:
                        graph.prepare()
                finally:
                    for n, t in self._tick_state().items():
                        t.copy_(saved[n])
        return {"programs": len(kinds), "loaded": 0}

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
    def _tick(self, kind: str, body, *args) -> np.ndarray:
        """Run one tick body — replaying its captured graph on the card,
        eagerly on the CPU and inside :func:`eager_ticks` — after copying
        in the host state that changed, and read its result on the host:
        the tick's one device-to-host copy. ``args``: a chunk tick's
        width bucket (one graph each)."""
        if self._dump_dirty:
            self._dump_dev.copy_(torch.from_numpy(self._dump))
            self._dump_dirty = False
        if self.kv_paged:
            self._sync_ptab()
        if graphed(self.device):
            out = self._graph(kind, body, *args)()
        else:
            out = body(*args)
        return out.cpu().numpy()

    def _graph(self, kind: str, body, *args) -> TickGraph:
        """The captured tick of ``kind`` (at a width bucket), made on first
        use."""
        key = (kind, *args) if args else kind
        graph = self._graphs.get(key)
        if graph is None:
            if self._graph_pool is None and self.device.type == "cuda":
                self._graph_pool = torch.cuda.graph_pool_handle()
            graph = self._graphs[key] = TickGraph(body, self.device, args,
                                                  pool=self._graph_pool)
        return graph

    def _tick_state(self) -> dict[str, torch.Tensor]:
        """The tensors a tick body reads and writes besides the weights:
        the tick state and every cache leaf (the draft's too). Allocated
        once; a captured tick keeps their addresses."""
        out = {n: getattr(self, n) for n in (
            "_pos", "_activ", "_logits", "_key", "_dump_dev", "_ptab_dev",
            "_temp_dev", "_seed_dev", "_last_dev", "_pend_tok", "_pend_val",
            "_plen", "_chunk_dev") if hasattr(self, n)}
        for name in ("_kc", "_vc", "_dkc", "_dvc"):
            cache = getattr(self, name)
            if cache is not None:
                for i, t in enumerate(_leaves(cache)):
                    out[f"{name}{i}"] = t
        return out

    def _decode(self) -> np.ndarray:
        """The decode tick; returns the sampled tokens."""
        return self._tick("plain", self._decode_body)

    def _decode_body(self) -> torch.Tensor:
        """The decode tick's device body: reads and writes only the tick
        state's fixed storage and the caches; returns the tokens [B]."""
        # rows at the LOGICAL cache limit freeze like eos rows
        can = self._activ & (self._pos < self.max_len)
        temperature, top_k, top_p = self._sampling
        sub = None
        if temperature != 0.0:
            key_sub = prng.split(self._key)
            self._key.copy_(key_sub[0])
            sub = key_sub[1]
        tok = sample_logits(self._logits, sub, temperature, top_k, top_p)
        tok = torch.where(can, tok, torch.full_like(tok, self.pad_token_id))
        still = can
        if self.eos_token_id is not None:
            still = can & (tok != self.eos_token_id)
        # dead slots write at their DUMP position, not their stale pos:
        # never over a resident prefix, and never inflating how far the
        # batch's attention has to read
        pos_step = torch.where(can, self._pos, self._dump_dev)
        # paged: dead rows' writes go to the scratch page (valid = can),
        # never to a page a live row or the prefix pool shares
        paged = dict(page_table=self._ptab_dev, valid=can) \
            if self.kv_paged else {}
        new_logits, _, _ = decode_one_token(self._params, self.cfg, tok,
                                            pos_step, self._kc, self._vc,
                                            **paged)
        self._pos.copy_(torch.where(still, self._pos + 1, self._pos))
        self._activ.copy_(still)
        self._logits.copy_(torch.where(still[:, None], new_logits,
                                       self._logits))
        return tok

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

    # ------------------------------------------------- speculative decode
    def _need_spec(self, plain: str) -> None:
        if not self.spec_k:
            raise RuntimeError(
                "session built without speculative decoding — construct "
                "with spec_decode=k >= 2 (or PADDLE_TPU_SPEC_DECODE=k), or "
                f"use {plain}()")

    def spec_step(self) -> dict[int, list[int]]:
        """ONE speculative tick across every live slot: the draft proposes
        a window, the target verifies it in one k-wide forward, and each
        row emits its accepted prefix. Greedy rows emit 1..spec_k tokens,
        exactly the stream of repeated :meth:`step` calls; on the
        stochastic lane a row may emit 0 (a fresh rejection leaves its
        resample pending) and its stream follows the target's sampling
        distribution. Returns ``{slot: [tokens]}``; eos and the cache
        limit freeze rows as the plain tick does."""
        self._need_spec("step")
        t0 = time.perf_counter()
        was = list(self._host_active)
        return self._process_spec_emitted(self._spec_decode(), was, t0)

    def spec_tick(self, chunks, width: int, arrivals=None,
                  queue_waits=None) -> dict[int, list[int]]:
        """The speculative :meth:`fused_tick` (one body, one graph per
        width): every chunk prefill advances one chunk, then one spec tick
        runs over every live row; rows the chunk half finalizes join its
        window. Returns the :meth:`spec_step` dict."""
        self._need_spec("fused_tick")
        if not chunks:
            return self.spec_step()
        t0 = time.perf_counter()
        self._assemble_chunks(chunks, width)
        out = self._tick("spec_fused", self._spec_fused_body, width)
        # the chunk half's wall is charged once, to the spec tick
        self._telemetry.prefill_tick(0.0, rows=len(chunks))
        self._finalize_chunks(chunks, arrivals, queue_waits, t0)
        was = list(self._host_active)
        return self._process_spec_emitted(out, was, t0)

    def _draft(self):
        """(params, cfg, k cache, v cache) of the draft: the separate
        model's own, or the target's first layers and their caches (views:
        the early-exit draft writes the target's layer caches in place)."""
        if self._draft_mode:
            return self._draft_params, self._dcfg, self._dkc, self._dvc
        cut = slice(0, self._spec_cut)
        return (self._draft_params, self._dcfg, _kv_index(self._kc, cut),
                _kv_index(self._vc, cut))

    def _spec_decode(self) -> np.ndarray:
        """The spec tick. Returns ONE host array [B, k + 1] (the window's
        emitted tokens, pad where not accepted, then the counts), and on
        the stochastic lane two more columns: the rows that entered with a
        pending resample, and those that drew one."""
        return self._tick("spec", self._spec_body)

    def _spec_body(self) -> torch.Tensor:
        """The spec tick's device body (greedy, or :meth:`_sspec_body` on
        the stochastic lane); reads and writes only the tick state's fixed
        storage and the caches.

        The target's cache changes only inside each row's window [pos,
        pos + k): the greedy early-exit draft writes pos .. pos + k - 2 of
        the first layers, which verify then rewrites; dead rows write at
        their dump window (paged: the scratch page)."""
        k, pad = self.spec_k, self.pad_token_id
        can = self._activ & (self._pos < self.max_len)
        pos_step = torch.where(can, self._pos, self._dump_dev)
        ptab = self._ptab_dev if self.kv_paged else None
        paged = dict(page_table=ptab, valid=can) if self.kv_paged else {}
        if self.spec_sample:
            return self._sspec_body(can, pos_step, ptab, paged)
        d_params, d_cfg, dkc, dvc = self._draft()
        # window row 0 is the target's own greedy token, the plain tick's
        t1 = torch.where(can, self._logits.argmax(-1),
                         torch.full_like(self._pos, pad))
        props, tok, p = [t1], t1, pos_step
        # a separate draft takes one more step: it consumes the last
        # proposal, so its cache covers the whole window on total accept
        for _ in range(k if self._draft_mode else k - 1):
            dlg, _, _ = decode_one_token(d_params, d_cfg, tok, p, dkc, dvc,
                                         **paged)
            tok, p = dlg.argmax(-1), p + 1
            props.append(tok)
        props = torch.stack(props[:k], 1)
        vlogits, _, _ = verify_tokens(self._params, self.cfg, props,
                                      pos_step, self._kc, self._vc, **paged)
        accept, counts, n_adv, new_logits, last_tok = greedy_acceptance(
            props, vlogits, self._pos, can, self.max_len, self.eos_token_id)
        self._advance(can, n_adv, new_logits, last_tok)
        toks = torch.where(accept, props, torch.full_like(props, pad))
        return torch.cat([toks, counts[:, None]], 1)

    def _advance(self, can, n_adv, new_logits, last_tok) -> None:
        still = can
        if self.eos_token_id is not None:
            still = can & (last_tok != self.eos_token_id)
        self._pos.copy_(torch.where(can, self._pos + n_adv, self._pos))
        self._activ.copy_(still)
        self._logits.copy_(torch.where(can[:, None], new_logits,
                                       self._logits))

    def _sspec_body(self, can, pos_step, ptab, paged) -> torch.Tensor:
        """The stochastic tick: the draft samples all k window tokens,
        entering at ``pos - 1`` with the last emitted token (a pending
        resample replaces its first proposal), then one verify and
        :func:`stochastic_acceptance`."""
        k, pad = self.spec_k, self.pad_token_id
        _, top_k, top_p = self._sampling
        d_params, d_cfg, dkc, dvc = self._draft()
        temp, seeds = self._temp_dev, self._seed_dev
        pend_in = self._pend_val & can
        p = (pos_step - 1).clamp_min(0)
        keys = spec_sample_key(
            seeds[:, None],
            p[:, None] + 1 + torch.arange(k, device=p.device)[None, :],
            SPEC_LANE_DRAFT)
        # step 0 re-consumes the token at pos - 1 and keeps the cache there
        # as it is: the early-exit draft's caches are the target's (that
        # position may lie on a page shared with the prefix pool); a
        # separate draft writes its own cache there only past the prompt
        # (a hole after a fully accepted window), never over a prompt page
        valid0 = (can & (p >= self._plen) if self._draft_mode
                  else torch.zeros_like(can))
        tok = self._last_dev
        props, qs = [], []
        for j in range(k):
            valid = valid0 if j == 0 else paged.get("valid")
            dlg, _, _ = decode_one_token(d_params, d_cfg, tok, p, dkc, dvc,
                                         page_table=ptab, valid=valid)
            tok, q = spec_draft_sample(dlg, temp, seeds, p + 1, top_k, top_p,
                                       keys=keys[:, j])
            if j == 0:
                tok = torch.where(pend_in, self._pend_tok, tok)
            props.append(tok)
            qs.append(q)
            p = p + 1
        props = torch.stack(props, 1)
        vlogits, _, _ = verify_tokens(self._params, self.cfg, props,
                                      pos_step, self._kc, self._vc, **paged)
        (accept, counts, n_adv, new_logits, new_last, pend_tok,
         pend_val) = stochastic_acceptance(
            props, torch.stack(qs, 1), vlogits, self._logits, temp, seeds,
            self._pos, can, self.max_len, pend_in, self._last_dev, top_k,
            top_p, self.eos_token_id)
        self._advance(can, n_adv, new_logits, new_last)
        self._last_dev.copy_(new_last)
        self._pend_tok.copy_(pend_tok)
        self._pend_val.copy_(pend_val)
        toks = torch.where(accept, props, torch.full_like(props, pad))
        return torch.cat([toks, counts[:, None], pend_in[:, None].long(),
                          pend_val[:, None].long()], 1)

    def _process_spec_emitted(self, out, was, t0: float
                              ) -> dict[int, list[int]]:
        """Host half of a spec tick: fold each row's accepted prefix into
        the output mirrors token by token, freezing at eos and the cache
        limit as the device did, and feed the spec counters. ``out``: the
        :meth:`_spec_decode` array, [B, k + 1] (the accepted window and its
        count), or in the stochastic lane [B, k + 3] (also the pending flag
        the row entered with and the one it leaves with)."""
        k, sampled = self.spec_k, self.spec_sample
        emitted: dict[int, list[int]] = {}
        total = rows = prop = acc = res = 0
        for s in range(self.max_slots):
            if not was[s]:
                continue
            if self._host_pos[s] >= self.max_len:
                # cache full: the device froze this row on the tick
                self._host_active[s] = False
                continue
            rows += 1
            row = []
            for j in range(int(out[s, k])):
                if self._host_pos[s] >= self.max_len:
                    self._host_active[s] = False
                    break
                t = int(out[s, j])
                self._new[s].append(t)
                row.append(t)
                if self._await_first[s]:
                    self._await_first[s] = False
                    self._telemetry.first_token(self._admit_t[s])
                if self.eos_token_id is not None and t == self.eos_token_id:
                    self._host_active[s] = False
                    break
                self._host_pos[s] += 1
            if row:
                emitted[s] = row
                total += len(row)
            if sampled:
                # a pending row's window token 0 was accepted LAST tick:
                # this tick it is neither a proposal nor an accept
                pend = int(out[s, k + 1])
                prop += k - pend
                acc += max(0, len(row) - pend)
                res += int(out[s, k + 2])
        self._telemetry.tick(time.perf_counter() - t0, total)
        if sampled:
            self._telemetry.spec(proposed=prop, accepted=acc, rows=rows,
                                 emitted=total, resampled=res,
                                 mode="stochastic")
        else:
            # every live row proposes k - 1 draft tokens; what it emitted
            # past its guaranteed first token was an accepted proposal
            self._telemetry.spec(proposed=(k - 1) * rows,
                                 accepted=max(0, total - rows), rows=rows)
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
        if self.kv_paged:
            self._release_row_pages(slot)
        out, self._new[slot] = self._new[slot], []
        self._telemetry.evicted(sum(self._occupied))
        return out

    def reset_metrics(self) -> None:
        """Zero the serving accumulators (e.g. after a warm-up wave)."""
        self._telemetry.reset()

    def close(self) -> None:
        """Retire the session's telemetry gauges (:meth:`metrics` keeps
        working on the host counters); called when the session is
        collected, so session churn does not grow the stat registry."""
        self._telemetry.close()

    def __del__(self):
        try:
            self.close()
        except Exception:  # noqa: BLE001 — interpreter teardown
            pass

    def metrics(self) -> dict:
        """Serving metrics snapshot: TTFT, per-token decode latency and
        tok/s over live rows, occupancy, admission wait, evictions."""
        out = self._telemetry.metrics()
        out["slots_occupied"] = sum(self._occupied)
        out["slot_occupancy"] = round(out["slots_occupied"]
                                      / self.max_slots, 4)
        out["slots_active"] = sum(self._host_active)
        if self.kv_paged:
            out["kv_pages_total"], out["kv_pages_free"], \
                out["kv_pages_shared"] = self.kv_page_stats()
            out["kv_page_size"] = self._page_size
        return dict(sorted(out.items()))

    # ----------------------------------------------------------- convenience
    def generate(self, prompts, lengths=None, max_new_tokens: int = 32,
                 temperatures=None, seeds=None):
        """Admit, decode until every admitted row finished (eos) or hit
        ``max_new_tokens``, evict. Returns [n, max_new_tokens] int64 —
        rows that stopped early are padded with pad_token_id. Other
        in-flight slots advance underneath. A spec session drains through
        :meth:`spec_step` (a row may pass its budget inside a tick; the
        output is cut to it); ``temperatures``/``seeds`` set the rows'
        lanes as in :meth:`admit`."""
        slots = self.admit(prompts, lengths, temperatures=temperatures,
                           seeds=seeds)
        mine = set(slots)
        while any(self._host_active[s] for s in mine):
            self.spec_step() if self.spec_k else self.step()
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
