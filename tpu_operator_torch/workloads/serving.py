"""Continuous-batching decode engine (port of ``tpu_operator/workloads/serving.py``).

The TPUServing data plane in PyTorch: one :class:`DecodeEngine` runs a
single-layer transformer decode loop over a paged KV pool, with
continuous batching, chunked prefill interleaved with decode, session
retention, a page-aligned prefix cache and paged-KV export/import for
disaggregated prefill. The bookkeeping (:class:`PagedKVPool`, admission,
eviction) is the reference's, line for line. The device steps are the
reference's compiled ones: on the card the decode and each prefill offset
run as one CUDA graph replay each (``kernels/graph.GraphedCall``), as the
reference runs them under ``jax.jit``; on the CPU they run eagerly.

Kernels: chunked prefill attention runs the flash forward
(``flash_attention_with_lse`` with the global offset ``q_start``), which
on the card is the hand-written general CUDA kernel, when
``use_flash_prefill`` is set. The MLP runs weight-only int8 matmuls with
int32 accumulation (``torch._int_mm`` on the card, an exact integer
matmul on the CPU).

Unlike the reference's functional updates, the KV pools are written in
place (the graphs hold their addresses, so they are never reallocated).
Writes of inactive lanes and padded prefill rows land on the scratch page,
which no live position ever reads unmasked, so the warm-up writes there
too.
"""

from __future__ import annotations

import dataclasses
import functools
import math
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from tpu_operator_torch.device import DeviceLike, resolve_device
from tpu_operator_torch.workloads.telemetry import StepTimeRecorder, _percentile


@dataclasses.dataclass
class ServingModelConfig:
    """The decode model + pool geometry (the reference's defaults)."""

    d_model: int = 32
    n_heads: int = 2
    head_dim: int = 16
    d_ff: int = 64
    vocab: int = 128
    page_tokens: int = 8      # KV page granularity (tokens per page)
    max_pages: int = 64       # shared pool capacity, in pages
    max_batch: int = 8        # decode slots (the in-flight batch)
    max_seq: int = 64         # per-request context cap (prompt + decoded)
    prefill_chunk: int = 8    # prompt tokens ingested per step per request
    use_flash_prefill: bool = False  # flash kernel for prefill attention
    int8_mlp: bool = True     # int8 path for the MLP matmuls

    @property
    def pages_per_slot(self) -> int:
        return -(-self.max_seq // self.page_tokens)


@dataclasses.dataclass
class ServingRequest:
    """One inference request: a prompt to ingest and a decode budget.
    TTFT timestamps are stamped by the engine. ``session`` tags a
    multi-turn conversation (see ``DecodeEngine.retain_sessions``)."""

    rid: str
    prompt: np.ndarray          # (prompt_len,) int32 token ids
    decode_tokens: int
    arrived_s: float = 0.0      # wall clock at submit()
    first_token_s: Optional[float] = None
    done_s: Optional[float] = None
    output: List[int] = dataclasses.field(default_factory=list)
    session: str = ""           # conversation id ("" = single-shot)

    @property
    def ttft_s(self) -> Optional[float]:
        if self.first_token_s is None:
            return None
        return self.first_token_s - self.arrived_s


class PagedKVPool:
    """Page-table bookkeeping over the shared KV pool: slots hold
    page-id lists into one (max_pages + 1) page array (the extra page is
    the scratch row inactive lanes write to). Pure python/numpy — the
    device tensors live in the engine; this owns WHO holds WHICH page."""

    def __init__(self, cfg: ServingModelConfig):
        self.cfg = cfg
        self.scratch = cfg.max_pages  # the dump row for masked lanes
        self._free_pages = list(range(cfg.max_pages - 1, -1, -1))  # pop() = lowest last
        self._free_slots = list(range(cfg.max_batch - 1, -1, -1))
        # slot -> page ids (dense prefix of pages_per_slot entries)
        self.pages: Dict[int, List[int]] = {}
        self.table = np.full(
            (cfg.max_batch, cfg.pages_per_slot), self.scratch, dtype=np.int32
        )

    @property
    def free_pages(self) -> int:
        return len(self._free_pages)

    @property
    def free_slots(self) -> int:
        return len(self._free_slots)

    def alloc_slot(self) -> Optional[int]:
        if not self._free_slots:
            return None
        slot = self._free_slots.pop()
        self.pages[slot] = []
        self.table[slot, :] = self.scratch
        return slot

    def ensure(self, slot: int, tokens: int) -> bool:
        """Grow ``slot`` to hold ``tokens`` total tokens; allocates pages
        lazily. False = pool exhausted (caller pauses the request for
        this step — nobody is evicted)."""
        need = -(-tokens // self.cfg.page_tokens)
        held = self.pages[slot]
        while len(held) < need:
            if not self._free_pages:
                return False
            page = self._free_pages.pop()
            self.table[slot, len(held)] = page
            held.append(page)
        return True

    def free_slot(self, slot: int) -> None:
        for page in self.pages.pop(slot, []):
            self._free_pages.append(page)
        self._free_pages.sort(reverse=True)
        self.table[slot, :] = self.scratch
        self._free_slots.append(slot)
        self._free_slots.sort(reverse=True)


class _SlotState:
    """Engine-side per-slot request state."""

    def __init__(self, request: ServingRequest, slot: int, seq: int = 0):
        self.request = request
        self.slot = slot
        self.seq = seq                # admission order (eviction picks youngest)
        self.prefilled = 0            # prompt tokens already ingested
        self.length = 0               # KV length (prompt + decoded so far)
        self.decoded = 0
        self.last_token = 0           # next decode input
        self.paused = False           # page-starved this step

    @property
    def prompt_len(self) -> int:
        return int(self.request.prompt.shape[0])

    @property
    def prefilling(self) -> bool:
        return self.prefilled < self.prompt_len

    @property
    def done(self) -> bool:
        return (not self.prefilling) and self.decoded >= self.request.decode_tokens


def _build_params(cfg: ServingModelConfig, seed: int, device) -> Dict[str, torch.Tensor]:
    """Seeded model weights, drawn with the reference's numpy generator so
    they are bit-identical to its weights; the MLP mats ship pre-quantized
    to int8 with per-tensor scales when ``int8_mlp``, laid out once as
    ``torch._int_mm``'s second operand (:func:`int8_weight`)."""
    rng = np.random.default_rng(seed)
    d, h, hd, f = cfg.d_model, cfg.n_heads, cfg.head_dim, cfg.d_ff

    def mat(*shape, scale=0.3):
        return (rng.standard_normal(shape) * scale / np.sqrt(shape[0])).astype(np.float32)

    arrays = {
        "embed": mat(cfg.vocab, d, scale=1.0),
        "wq": mat(d, h * hd),
        "wk": mat(d, h * hd),
        "wv": mat(d, h * hd),
        "wo": mat(h * hd, d),
    }
    w1 = mat(d, f)
    w2 = mat(f, d)
    if cfg.int8_mlp:
        s1 = float(np.max(np.abs(w1))) / 127.0 or 1.0
        s2 = float(np.max(np.abs(w2))) / 127.0 or 1.0
        arrays["w1_q"] = np.clip(np.round(w1 / s1), -127, 127).astype(np.int8)
        arrays["w2_q"] = np.clip(np.round(w2 / s2), -127, 127).astype(np.int8)
        arrays["w1_s"] = np.float32(s1)
        arrays["w2_s"] = np.float32(s2)
    else:
        arrays["w1"] = w1
        arrays["w2"] = w2
    params = {name: torch.as_tensor(arr).to(device) for name, arr in arrays.items()}
    return int8_weights(params)


def _up8(n: int) -> int:
    return -(-n // 8) * 8


def int8_weight(w: torch.Tensor) -> torch.Tensor:
    """An int8 (K, N) weight laid out as ``torch._int_mm``'s fast second
    operand: column-major, in storage zero-padded to (K, N) rounded up to
    multiples of 8 (padded only where a dimension is not one), returned as
    the (K, N) view of it, so the logical shape is kept and
    :func:`_int_matmul` pads only its first operand."""
    k, n = w.shape
    store = torch.zeros((_up8(n), _up8(k)), dtype=torch.int8, device=w.device)
    store[:n, :k] = w.t()
    return store.t()[:k, :n]


def int8_weights(params: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """``params`` with the int8 MLP weights (``w1_q``, ``w2_q``), where
    present, laid out by :func:`int8_weight`."""
    return {name: int8_weight(t) if name in ("w1_q", "w2_q") else t
            for name, t in params.items()}


def _int_mm_operand(b: torch.Tensor, kp: int, np_: int) -> torch.Tensor:
    """``b`` (K, N) as ``torch._int_mm``'s second operand of (kp, np_): a
    column-major ``b`` whose storage already holds (kp, np_) at its stride
    (an :func:`int8_weight`) is viewed at that size with no copy; any
    other is zero-padded where it needs it and passed column-major if it
    lies so, else contiguous. What the
    storage holds past b's logical shape meets only the zero padding of
    the first operand or output columns that are sliced off, so the
    product stays exact whatever it is."""
    k, n = b.shape
    if b.stride() == (1, kp) and b.storage_offset() + kp * np_ <= b.untyped_storage().nbytes():
        return b.as_strided((kp, np_), (1, kp))
    if (kp, np_) != (k, n):
        b = torch.nn.functional.pad(b, (0, np_ - n, 0, kp - k))
    return b if b.t().is_contiguous() else b.contiguous()


def _int_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """int8 (M, K) x int8 (K, N) -> int32 (M, N), exact. On the card
    ``torch._int_mm``, which takes M > 16 and K, N multiples of 8: ``a``
    is zero-padded up to that, ``b`` too unless it is an
    :func:`int8_weight` (:func:`_int_mm_operand`), and the product sliced
    back. A column-major ``b`` is passed as it is: ``_int_mm`` is several
    times faster with it than with a row-major one (``chip_smoke.py``
    phase 7 times both)."""
    if not a.is_cuda:
        return a.to(torch.int32) @ b.to(torch.int32)
    m, k = a.shape
    n = b.shape[1]
    mp, kp, np_ = max(32, _up8(m)), _up8(k), _up8(n)
    if (mp, kp) != (m, k):
        a = torch.nn.functional.pad(a, (0, kp - k, 0, mp - m))
    return torch._int_mm(a.contiguous(), _int_mm_operand(b, kp, np_))[:m, :n]


def _int8_matmul(x, w_q, w_scale):
    """Weight-only-quantized matmul: dynamic per-tensor activation
    quantization (the scale covers every row of ``x`` as given, inactive
    decode lanes included — before any padding), int8 x int8 -> int32
    accumulation, dequantized by the two scales. Rounds half to even, as
    the reference does."""
    a_scale = torch.clamp(x.abs().max() / 127.0, min=1e-8)
    x_q = torch.clamp(torch.round(x / a_scale), -127, 127).to(torch.int8)
    acc = _int_matmul(x_q.reshape(-1, x.shape[-1]), w_q)
    return acc.reshape(*x.shape[:-1], w_q.shape[1]).float() * (a_scale * w_scale)


def _mlp(cfg: ServingModelConfig, params, x):
    if cfg.int8_mlp:
        hidden = torch.clamp(_int8_matmul(x, params["w1_q"], params["w1_s"]), min=0.0)
        return _int8_matmul(hidden, params["w2_q"], params["w2_s"])
    hidden = torch.clamp(x @ params["w1"], min=0.0)
    return hidden @ params["w2"]


@dataclasses.dataclass(frozen=True)
class StepState:
    """What the engine's device steps read and write: the config, the
    weights, the paged KV pools (written in place) and the flash blocks.
    The steps take it rather than the engine, so that a graph holding a
    step holds no engine (a graph in a reference cycle would be destroyed
    by the collector at any moment, even during another capture)."""

    cfg: ServingModelConfig
    params: Dict[str, torch.Tensor]
    pool_k: torch.Tensor
    pool_v: torch.Tensor
    flash_blocks: Tuple[int, int]


def _decode_step(st: StepState, table, lengths, active, tokens):
    """One token for every lane, padded to max_batch; writes this
    token's K/V at position ``length`` of each active lane's paged
    context (inactive lanes write the scratch page). Returns the next
    token of every lane."""
    cfg = st.cfg
    P, T = cfg.page_tokens, cfg.max_seq
    params = st.params
    x = params["embed"][tokens]                          # (B, d)
    q = (x @ params["wq"]).reshape(-1, cfg.n_heads, cfg.head_dim)
    k = (x @ params["wk"]).reshape(-1, cfg.n_heads, cfg.head_dim)
    v = (x @ params["wv"]).reshape(-1, cfg.n_heads, cfg.head_dim)
    page = table.gather(1, (lengths // P)[:, None])[:, 0]
    page = torch.where(active, page, cfg.max_pages).long()
    off = (lengths % P).long()
    st.pool_k[page, off] = k
    st.pool_v[page, off] = v
    ctx_k = st.pool_k[table.long()].reshape(-1, T, cfg.n_heads, cfg.head_dim)
    ctx_v = st.pool_v[table.long()].reshape(-1, T, cfg.n_heads, cfg.head_dim)
    pos = torch.arange(T, device=st.pool_k.device)[None, :]
    mask = pos <= lengths[:, None]                       # incl. this token
    scores = torch.einsum("bhd,bthd->bht", q, ctx_k) / math.sqrt(cfg.head_dim)
    scores = torch.where(mask[:, None, :], scores, -1e30)
    attn = torch.softmax(scores, dim=-1)
    ctx = torch.einsum("bht,bthd->bhd", attn, ctx_v).reshape(
        -1, cfg.n_heads * cfg.head_dim
    )
    y = x + ctx @ params["wo"]
    y = y + _mlp(cfg, params, y)
    logits = y @ params["embed"].T
    return torch.argmax(logits, dim=-1).to(torch.int32)


def _prefill_step(st: StepState, prefix: int, table_row, tokens, valid):
    """The chunked-prefill step at prompt offset ``prefix``: ingest up
    to ``prefill_chunk`` prompt tokens (K/V into the lane's pages) and
    return the argmax token of the chunk's last real row — the first
    decoded token when the chunk completes the prompt. ``valid`` (1,)
    is how many rows are real, a tensor so that a graph reads it."""
    cfg = st.cfg
    C, P, T = cfg.prefill_chunk, cfg.page_tokens, cfg.max_seq
    params = st.params
    x = params["embed"][tokens]                          # (C, d)
    q = (x @ params["wq"]).reshape(C, cfg.n_heads, cfg.head_dim)
    k = (x @ params["wk"]).reshape(C, cfg.n_heads, cfg.head_dim)
    v = (x @ params["wv"]).reshape(C, cfg.n_heads, cfg.head_dim)
    idx = torch.arange(C, device=st.pool_k.device)
    pos = prefix + idx
    # padded rows past the table's end go to scratch (the reference's
    # gather clamps the index; torch indexing would fault on it)
    row_page = table_row[torch.clamp(pos // P, max=cfg.pages_per_slot - 1)]
    page = torch.where(idx < valid, row_page, cfg.max_pages).long()
    st.pool_k[page, pos % P] = k
    st.pool_v[page, pos % P] = v
    ctx_k = st.pool_k[table_row.long()].reshape(T, cfg.n_heads, cfg.head_dim)
    ctx_v = st.pool_v[table_row.long()].reshape(T, cfg.n_heads, cfg.head_dim)
    if cfg.use_flash_prefill:
        # causal masking against the global offset q_start covers both
        # the real prefix and the padded tail
        from tpu_operator_torch.workloads.flashattention import flash_attention_with_lse

        block_q, block_k = st.flash_blocks
        out, _ = flash_attention_with_lse(
            q[None], ctx_k[None], ctx_v[None], causal=True,
            block_q=block_q, block_k=block_k, q_start=prefix,
        )
        ctx = out[0]                                     # (C, h, hd)
    else:
        kpos = torch.arange(T, device=st.pool_k.device)[None, :]
        mask = kpos <= pos[:, None]
        scores = torch.einsum("chd,thd->cht", q, ctx_k) / math.sqrt(cfg.head_dim)
        scores = torch.where(mask[:, None, :], scores, -1e30)
        attn = torch.softmax(scores, dim=-1)
        ctx = torch.einsum("cht,thd->chd", attn, ctx_v)
    last = valid - 1
    y = x.index_select(0, last)[0] + ctx.reshape(C, -1).index_select(0, last)[0] @ params["wo"]
    y = y + _mlp(cfg, params, y)
    logits = y @ params["embed"].T
    return torch.argmax(logits, dim=-1).to(torch.int32)


def over_static_inputs(body, inputs, device, wrap):
    """``body`` over static input tensors of the given (shape, dtype)s:
    ``wrap`` of a call of it on them (on the card a ``GraphedCall``), run
    after each call has copied its arguments into them."""
    static = [torch.zeros(shape, dtype=dtype, device=device) for shape, dtype in inputs]
    run = wrap(lambda: body(*static))

    def call(*args):
        for buf, arg in zip(static, args):
            buf.copy_(arg)
        return run()
    return call


class DecodeEngine:
    """The continuous-batching decode loop (or, with ``static_batch=True``,
    the drain-before-refill baseline). Drive it with :meth:`submit` +
    :meth:`step`; every step is recorded by a :class:`StepTimeRecorder`.
    Runs on the card unless ``device="cpu"`` is passed."""

    def __init__(
        self,
        cfg: Optional[ServingModelConfig] = None,
        seed: int = 0,
        static_batch: bool = False,
        retain_sessions: bool = False,
        prefill_only: bool = False,
        prefix_cache_limit: int = 8,
        device: DeviceLike = None,
    ):
        self.device = resolve_device(device)
        self.cfg = cfg or ServingModelConfig()
        self.static_batch = static_batch
        # session-KV retention: a completed session's slot (and pages)
        # stay resident so a follow-up turn delta-prefills from the held
        # context instead of re-ingesting the whole conversation
        self.retain_sessions = retain_sessions
        # prefill pool mode (disaggregation): finish at the first token,
        # export the paged KV for a decode engine to import
        self.prefill_only = prefill_only
        self.params = _build_params(self.cfg, seed, self.device)
        self.pool = PagedKVPool(self.cfg)
        c = self.cfg
        kv_shape = (c.max_pages + 1, c.page_tokens, c.n_heads, c.head_dim)
        self._pool_k = torch.zeros(kv_shape, dtype=torch.float32, device=self.device)
        self._pool_v = torch.zeros(kv_shape, dtype=torch.float32, device=self.device)
        self.queue: List[ServingRequest] = []
        self.slots: Dict[int, _SlotState] = {}
        self.completed: List[ServingRequest] = []
        self.recorder = StepTimeRecorder()
        # the warm-up step gets its OWN recorder series, out of the
        # step-time percentiles above
        self.warmup_recorder = StepTimeRecorder()
        self.steps = 0
        self.decoded_tokens = 0
        self.evictions = 0
        self._admit_seq = 0
        self._starved = False  # a lane was page-starved last step
        self._occupancy: List[float] = []
        # retained completed sessions (insertion order = LRU eviction)
        self._sessions: Dict[str, _SlotState] = {}
        self.session_hits = 0
        self.session_misses = 0
        self.session_evictions = 0
        # cache of page-aligned prompt prefixes (shared system prompts):
        # prefix tokens -> K/V page tensors
        self._prefix_cache: Dict[tuple, dict] = {}
        self._prefix_cache_limit = prefix_cache_limit
        self.prefix_hits = 0
        # prefill->decode paged-KV handoff accounting
        self.handoff_bytes = 0      # exported by this (prefill) engine
        self.imported_bytes = 0     # imported by this (decode) engine
        self.prefilled_done: List[dict] = []   # prefill_only completions
        self._handoff_queue: List[Tuple[ServingRequest, dict]] = []
        # kernel configs resolve through the autotune winners path
        # (TPU_AUTOTUNE_JSON), as burn-in's do
        from tpu_operator_torch.workloads.autotune import tuned_flash_blocks

        self.flash_blocks = tuned_flash_blocks(c.max_seq, heads=c.n_heads,
                                               head_dim=c.head_dim)
        self._state = StepState(c, self.params, self._pool_k, self._pool_v, self.flash_blocks)
        self._decode_fn = None
        self._prefill_fns: Dict[int, object] = {}  # static prefix -> its step
        self._chips = 1  # the one device the engine runs on

    def _tensor(self, array) -> torch.Tensor:
        return torch.as_tensor(array).to(self.device)

    # -- compiled steps ------------------------------------------------------

    def _compiled(self, body, *inputs: Tuple[tuple, torch.dtype]):
        """``body`` as the engine runs it: on the card one CUDA graph over
        static inputs of the given (shape, dtype) (``GraphedCall``: the
        first call eager, then captured and replayed), whose output is valid
        until its next call; on the CPU ``body`` itself, eager on the
        arguments."""
        if self.device.type != "cuda":
            return body
        from tpu_operator_torch.kernels.graph import GraphedCall

        return over_static_inputs(body, inputs, self.device, GraphedCall)

    def _decode(self, table, lengths, active, tokens):
        """One token for every lane (``_decode_step``), compiled once per
        engine at its lane count and page-table width. The arguments may be
        host tensors."""
        if self._decode_fn is None:
            b = self.cfg.max_batch
            self._decode_fn = self._compiled(
                functools.partial(_decode_step, self._state),
                ((b, self.cfg.pages_per_slot), torch.int32),
                ((b,), torch.int64), ((b,), torch.bool), ((b,), torch.int64))
        return self._decode_fn(table, lengths, active, tokens)

    def _prefill_fn(self, prefix: int):
        """The chunked-prefill step at the static prompt offset ``prefix``
        (``_prefill_step``), compiled once per prefix as the reference
        jits one function per prefix (bounded by max_seq / prefill_chunk)."""
        fn = self._prefill_fns.get(prefix)
        if fn is None:
            c = self.cfg
            fn = self._compiled(functools.partial(_prefill_step, self._state, prefix),
                                ((c.pages_per_slot,), torch.int32),
                                ((c.prefill_chunk,), torch.int64), ((1,), torch.int64))
            self._prefill_fns[prefix] = fn
        return fn

    def _prefill(self, prefix: int, table_row, tokens, valid: int):
        """Ingest up to ``prefill_chunk`` prompt tokens at offset ``prefix``,
        ``valid`` of them real; returns the argmax token of the chunk's last
        real row. The arguments may be host tensors."""
        return self._prefill_fn(prefix)(table_row, tokens, torch.tensor([valid]))

    # -- admission -----------------------------------------------------------

    def submit(self, request: ServingRequest) -> None:
        if request.prompt.shape[0] + request.decode_tokens > self.cfg.max_seq:
            raise ValueError(
                f"request {request.rid}: prompt + decode budget exceeds "
                f"max_seq {self.cfg.max_seq}"
            )
        request.arrived_s = time.perf_counter()
        self.queue.append(request)

    def _admit(self) -> None:
        """Step-boundary admission. Continuous batching admits whenever
        a slot AND a first page are free; the static baseline only
        refills an EMPTY engine. Session follow-ups resume their retained
        slot; retained sessions are the FIRST thing evicted when
        admission starves."""
        if self.static_batch and self.slots:
            return
        if self._starved:
            # a lane is waiting on a page: freed pages must reach the
            # in-flight batch first, or a re-admitted request steals
            # them back and the pool livelocks
            return
        self._admit_handoffs()
        while self.queue:
            request = self.queue[0]
            state = self._pop_session(request)
            if state is not None:
                # warm resume: the held KV covers prompt[:length]; only
                # the new turn's delta needs prefilling
                self.queue.pop(0)
                self._admit_seq += 1
                request.output = []
                state.request = request
                state.seq = self._admit_seq
                state.prefilled = state.length
                state.decoded = 0
                state.paused = False
                self.slots[state.slot] = state
                self.session_hits += 1
                continue
            if not (self.pool.free_slots and self.pool.free_pages):
                if self._evict_session():
                    continue  # a retained session's slot/pages freed
                break
            slot = self.pool.alloc_slot()
            if slot is None:
                break
            self._admit_seq += 1
            request = self.queue.pop(0)
            request.output = []  # a re-admitted evictee regenerates
            state = _SlotState(request, slot, seq=self._admit_seq)
            entry = self._match_prefix(request.prompt)
            if entry is not None and self.pool.ensure(slot, entry["tokens"]):
                # shared-prefix hit: import the cached pages and prefill
                # only past them
                self._import_pages(slot, entry)
                state.prefilled = state.length = entry["tokens"]
                self.prefix_hits += 1
            self.slots[slot] = state
            if self.static_batch and self.pool.free_slots == 0:
                break

    def _pop_session(self, request: ServingRequest) -> Optional[_SlotState]:
        """The retained slot a session follow-up resumes, or None (a
        counted miss when the session is unknown or its held context does
        not strictly prefix the new prompt)."""
        if not request.session:
            return None
        state = self._sessions.get(request.session)
        if state is None:
            self.session_misses += 1
            return None
        if int(request.prompt.shape[0]) <= state.length:
            # nothing left to prefill (no chunk would emit the first
            # token) — treat as a miss and recycle the stale slot
            del self._sessions[request.session]
            self.pool.free_slot(state.slot)
            self.session_misses += 1
            return None
        del self._sessions[request.session]
        return state

    def _evict_session(self) -> bool:
        """Free the least-recently-used retained session's slot+pages.
        True when something was reclaimed."""
        if not self._sessions:
            return False
        session = next(iter(self._sessions))
        state = self._sessions.pop(session)
        self.pool.free_slot(state.slot)
        self.session_evictions += 1
        return True

    # -- one engine step -----------------------------------------------------

    def step(self) -> dict:
        """One step boundary: admit, chunk-prefill every ingesting lane,
        one batched decode for every decoding lane, retire completions."""
        with self.recorder.step():
            report = self._step_body()
        self.steps += 1
        return report

    def _step_body(self) -> dict:
        cfg = self.cfg
        self._admit()
        now_first: List[_SlotState] = []
        prefilled = 0
        for state in self.slots.values():
            state.paused = False
            if not state.prefilling:
                continue
            take = min(cfg.prefill_chunk, state.prompt_len - state.prefilled)
            if not self.pool.ensure(state.slot, state.prefilled + take):
                state.paused = True  # page-starved: peers keep going
                continue
            chunk = np.zeros((cfg.prefill_chunk,), dtype=np.int64)
            chunk[:take] = state.request.prompt[
                state.prefilled:state.prefilled + take
            ]
            first = self._prefill(
                state.prefilled, torch.from_numpy(self.pool.table[state.slot]),
                torch.from_numpy(chunk), take,
            )
            state.prefilled += take
            state.length += take
            prefilled += take
            if not state.prefilling:
                # prompt complete: this chunk's final row IS the first
                # decoded token (prefill emits it; decode continues)
                self._record_token(state, int(first))
                now_first.append(state)
        if self.prefill_only and now_first:
            # disaggregation: the prompt's KV (and the first token) is
            # this engine's whole job — export the pages for a decode
            # replica and retire the lane
            for state in now_first:
                self.prefilled_done.append(
                    {"request": state.request, "kv": self.export_kv(state)}
                )
                state.request.done_s = time.perf_counter()
                del self.slots[state.slot]
                self.pool.free_slot(state.slot)
                self.completed.append(state.request)
            now_first = []
        decoding = [
            s for s in self.slots.values()
            if not s.prefilling and not s.done and not s.paused
            and s not in now_first
        ]
        # lanes whose context crosses a page boundary need a page now
        ready: List[_SlotState] = []
        for state in decoding:
            if self.pool.ensure(state.slot, state.length + 1):
                ready.append(state)
            else:
                state.paused = True
        if ready:
            tokens = np.zeros((cfg.max_batch,), dtype=np.int64)
            lengths = np.zeros((cfg.max_batch,), dtype=np.int64)
            active = np.zeros((cfg.max_batch,), dtype=bool)
            for state in ready:
                tokens[state.slot] = state.last_token
                lengths[state.slot] = state.length
                active[state.slot] = True
            nxt = self._decode(
                torch.from_numpy(self.pool.table), torch.from_numpy(lengths),
                torch.from_numpy(active), torch.from_numpy(tokens),
            ).cpu().numpy()
            for state in ready:
                state.length += 1
                self._record_token(state, int(nxt[state.slot]))
        progressed = bool(ready) or bool(now_first) or prefilled > 0
        if not progressed and self.slots and all(
            s.paused for s in self.slots.values()
        ):
            # pool deadlock: every lane needs a page and nobody can ever
            # free one. Retained sessions are reclaimed first; only then
            # is the YOUNGEST lane evicted to the queue front
            # (preempt-by-recompute): its pages return, the oldest lanes
            # run to completion, and the evictee re-prefills on
            # re-admission, regenerating the identical tokens; its
            # first-token stamp is kept.
            if not self._evict_session():
                victim = max(self.slots.values(), key=lambda s: s.seq)
                self.decoded_tokens -= victim.decoded  # will be re-counted
                self.pool.free_slot(victim.slot)
                del self.slots[victim.slot]
                self.queue.insert(0, victim.request)
                self.evictions += 1
        in_flight = len(self.slots)
        self._occupancy.append(in_flight / cfg.max_batch)
        self._starved = any(s.paused for s in self.slots.values())
        for slot in [s for s, st in self.slots.items() if st.done]:
            state = self.slots.pop(slot)
            state.request.done_s = time.perf_counter()
            self._maybe_cache_prefix(state)
            self.completed.append(state.request)
            if self.retain_sessions and state.request.session:
                # keep the slot+pages resident for the next turn; the
                # admission path reclaims it under pressure
                self._sessions[state.request.session] = state
            else:
                self.pool.free_slot(slot)
        return {
            "in_flight": in_flight,
            "queued": len(self.queue),
            "prefilled_tokens": prefilled,
            "decoded_tokens": len(ready) + len(now_first),
            "paused": sum(1 for s in self.slots.values() if s.paused),
        }

    def _record_token(self, state: _SlotState, token: int) -> None:
        if state.request.first_token_s is None:
            state.request.first_token_s = time.perf_counter()
        state.request.output.append(token)
        state.last_token = token
        state.decoded += 1
        self.decoded_tokens += 1

    # -- paged-KV handoff + prefix cache -------------------------------------

    def _lane_pages(self, slot: int, tokens: int) -> torch.Tensor:
        npages = -(-tokens // self.cfg.page_tokens)
        return self._tensor(np.asarray(self.pool.pages[slot][:npages], dtype=np.int64))

    def export_kv(self, state: _SlotState) -> dict:
        """Host copy of one lane's paged KV (the prefill->decode handoff
        payload). Bytes are metered."""
        pages = self._lane_pages(state.slot, state.length)
        k = self._pool_k[pages].cpu().numpy()
        v = self._pool_v[pages].cpu().numpy()
        self.handoff_bytes += k.nbytes + v.nbytes
        return {
            "k": k,
            "v": v,
            "length": state.length,
            "last_token": state.last_token,
        }

    def submit_prefilled(self, request: ServingRequest, kv: dict) -> None:
        """Decode-side entry for a prefill replica's handoff: the request
        arrives with its prompt KV (and first token) already computed;
        this engine allocates a slot, imports the pages, and decodes the
        rest. The first-token stamp set prefill-side is kept."""
        self._handoff_queue.append((request, kv))

    def _admit_handoffs(self) -> None:
        while self._handoff_queue and self.pool.free_slots:
            request, kv = self._handoff_queue[0]
            slot = self.pool.alloc_slot()
            if slot is None:
                break
            if not self.pool.ensure(slot, kv["length"]):
                self.pool.free_slot(slot)
                if self._evict_session():
                    continue
                break  # pool full: the handoff waits at the boundary
            self._handoff_queue.pop(0)
            self._import_pages(slot, kv)
            self._admit_seq += 1
            state = _SlotState(request, slot, seq=self._admit_seq)
            state.prefilled = state.prompt_len
            state.length = kv["length"]
            state.last_token = kv["last_token"]
            state.decoded = len(request.output)
            if state.done:
                # decode budget was 1: the prefill-side first token was
                # the whole answer
                request.done_s = time.perf_counter()
                self.pool.free_slot(slot)
                self.completed.append(request)
                continue
            self.slots[slot] = state

    def _import_pages(self, slot: int, entry: dict) -> None:
        """Write exported K/V page arrays into this engine's pool at the
        slot's freshly-allocated pages (the inverse of export_kv)."""
        pages = self._lane_pages(slot, entry.get("tokens", entry.get("length", 0)))
        k, v = self._tensor(entry["k"]), self._tensor(entry["v"])
        self._pool_k[pages] = k
        self._pool_v[pages] = v
        self.imported_bytes += k.numel() * k.element_size() + v.numel() * v.element_size()

    def _maybe_cache_prefix(self, state: _SlotState) -> None:
        """Cache the page-aligned prefix of a completed prompt (shared
        system prompts recur; a later request matching the prefix imports
        the pages instead of re-prefilling them). The pages stay device
        tensors."""
        if self.prefill_only or self._prefix_cache_limit <= 0:
            return
        if len(self._prefix_cache) >= self._prefix_cache_limit:
            return
        P = self.cfg.page_tokens
        aligned = (state.prompt_len // P) * P
        if aligned < P:
            return
        key = tuple(int(t) for t in state.request.prompt[:aligned])
        if key in self._prefix_cache:
            return
        pages = self._lane_pages(state.slot, aligned)
        self._prefix_cache[key] = {
            "k": self._pool_k[pages],
            "v": self._pool_v[pages],
            "tokens": aligned,
        }

    def _match_prefix(self, prompt: np.ndarray) -> Optional[dict]:
        """Longest cached prefix STRICTLY shorter than the prompt (the
        final chunk must still run to emit the first token)."""
        best: Optional[dict] = None
        plen = int(prompt.shape[0])
        for key, entry in self._prefix_cache.items():
            n = entry["tokens"]
            if n >= plen or (best is not None and n <= best["tokens"]):
                continue
            if tuple(int(t) for t in prompt[:n]) == key:
                best = entry
        return best

    # -- router-facing state -------------------------------------------------

    def has_session(self, session: str) -> bool:
        """True when this engine holds the session's KV — retained after
        completion OR still in flight."""
        if session in self._sessions:
            return True
        return any(s.request.session == session for s in self.slots.values())

    def cached_prefix_tokens(self, prompt: np.ndarray) -> int:
        """Tokens of the longest cached prefix of ``prompt``."""
        entry = self._match_prefix(prompt)
        return entry["tokens"] if entry else 0

    @property
    def prefilling_lanes(self) -> int:
        """Lanes still ingesting prompt."""
        return sum(1 for s in self.slots.values() if s.prefilling)

    # -- warmup --------------------------------------------------------------

    def warmup(self, prompt_len: int) -> None:
        """Run the decode and every prefill offset outside the timed loop,
        all lanes masked (every write lands on the scratch page): builds
        the CUDA kernels and warms the library handles, and on the card runs
        each twice, so that its graph is captured here. Recorded on
        ``warmup_recorder``."""
        with self.warmup_recorder.step():
            self._warmup_body(prompt_len)

    def _warmup_body(self, prompt_len: int) -> None:
        c = self.cfg
        zeros = torch.zeros((c.max_batch,), dtype=torch.int64, device=self.device)
        row = torch.full((c.pages_per_slot,), c.max_pages, dtype=torch.int64, device=self.device)
        chunk = torch.zeros((c.prefill_chunk,), dtype=torch.int64, device=self.device)
        for _ in range(2 if self.device.type == "cuda" else 1):
            out = self._decode(self._tensor(self.pool.table), zeros,
                               torch.zeros((c.max_batch,), dtype=torch.bool, device=self.device),
                               zeros)
            for prefix in range(0, min(prompt_len, c.max_seq), c.prefill_chunk):
                take = min(c.prefill_chunk, prompt_len - prefix)
                out = self._prefill(prefix, row, chunk, take)
        out.cpu()  # wait for the device

    @property
    def warmup_seconds(self) -> Optional[float]:
        """Total measured warm-up time, None before warmup."""
        durations = self.warmup_recorder._durations
        return sum(durations) if durations else None

    # -- draining ------------------------------------------------------------

    @property
    def idle(self) -> bool:
        return not self.queue and not self.slots and not self._handoff_queue

    def run_until_drained(self, max_steps: int = 10000) -> int:
        steps = 0
        while not self.idle and steps < max_steps:
            self.step()
            steps += 1
        return steps

    # -- reporting -----------------------------------------------------------

    def report(self) -> dict:
        """Throughput per chip, batch occupancy, TTFT percentiles over
        completed requests, and the step-time recorder's percentiles —
        the reference's keys."""
        elapsed = sum(self.recorder._durations)
        ttfts = sorted(
            r.ttft_s for r in self.completed if r.ttft_s is not None
        )
        out = {
            "mode": "static" if self.static_batch else "continuous",
            "steps": self.steps,
            "requests_completed": len(self.completed),
            "decoded_tokens": self.decoded_tokens,
            "elapsed_s": round(elapsed, 4),
            "tokens_per_s": round(self.decoded_tokens / elapsed, 2) if elapsed else 0.0,
            "tokens_per_s_chip": (
                round(self.decoded_tokens / elapsed / self._chips, 2) if elapsed else 0.0
            ),
            "occupancy_mean": (
                round(sum(self._occupancy) / len(self._occupancy), 3)
                if self._occupancy else 0.0
            ),
            "ttft_p50_s": round(_percentile(ttfts, 0.50), 4),
            "ttft_p99_s": round(_percentile(ttfts, 0.99), 4),
            "flash_blocks": list(self.flash_blocks),
            "int8_mlp": self.cfg.int8_mlp,
            "flash_prefill": self.cfg.use_flash_prefill,
            "session_hits": self.session_hits,
            "session_misses": self.session_misses,
            "prefix_hits": self.prefix_hits,
            "sessions_held": len(self._sessions),
            "handoff_bytes": self.handoff_bytes,
            "imported_bytes": self.imported_bytes,
        }
        if self.warmup_seconds is not None:
            out["warmup_s"] = round(self.warmup_seconds, 4)
        if self.steps >= 2:
            rec = self.recorder.report()
            out["step_p50_s"] = rec.step_p50_s
            out["step_p99_s"] = rec.step_p99_s
        return out


# ---------------------------------------------------------------------------
# the continuous-vs-static bench
# ---------------------------------------------------------------------------


def make_requests(
    count: int,
    seed: int = 0,
    prompt_len: int = 8,
    decode_min: int = 6,
    decode_max: int = 32,
    long_fraction: float = 0.25,
    vocab: int = 128,
) -> List[ServingRequest]:
    """A seeded request mix with skewed (bimodal) decode lengths — most
    requests are short, a tail runs to ``decode_max`` (the reference's
    generator, so both engines see the same requests)."""
    rng = np.random.default_rng(seed)
    short_max = decode_min + max(1, (decode_max - decode_min) // 4)
    out = []
    for i in range(count):
        if rng.random() < long_fraction:
            decode = decode_max
        else:
            decode = int(rng.integers(decode_min, short_max + 1))
        out.append(ServingRequest(
            rid=f"req-{i}",
            prompt=rng.integers(0, vocab, size=prompt_len).astype(np.int32),
            decode_tokens=decode,
        ))
    return out


def serving_decode_bench(
    cfg: Optional[ServingModelConfig] = None,
    seed: int = 20260818,
    requests: int = 24,
    arrival_ticks: int = 6,
    trials: int = 3,
    device: DeviceLike = None,
) -> dict:
    """Continuous vs static batching under the same arrival curve: both
    engines run the identical model and requests; the delta is pure
    batching policy. The median-speedup trial of ``trials`` is reported."""
    cfg = cfg or ServingModelConfig()
    prompt_len = min(cfg.prefill_chunk, cfg.max_seq // 4)
    base = make_requests(requests, seed=seed, vocab=cfg.vocab,
                         prompt_len=prompt_len,
                         decode_max=min(32, cfg.max_seq // 2))
    # arrival schedule: which step boundary each request lands at
    rng = np.random.default_rng(seed + 1)
    arrival_at = sorted(int(rng.integers(0, arrival_ticks)) for _ in base)

    def one_trial() -> dict:
        results = {}
        for static in (False, True):
            engine = DecodeEngine(cfg, seed=seed, static_batch=static, device=device)
            engine.warmup(prompt_len)
            batch = [dataclasses.replace(
                r, prompt=r.prompt.copy(), output=[],
                arrived_s=0.0, first_token_s=None, done_s=None,
            ) for r in base]
            tick = 0
            pending = list(zip(arrival_at, batch))
            while pending or not engine.idle:
                while pending and pending[0][0] <= tick:
                    engine.submit(pending.pop(0)[1])
                engine.step()
                tick += 1
            results["static" if static else "continuous"] = engine.report()
        cont, stat = results["continuous"], results["static"]
        results["speedup"] = (
            cont["tokens_per_s_chip"] / stat["tokens_per_s_chip"]
            if stat["tokens_per_s_chip"] else 0.0
        )
        return results

    runs = sorted((one_trial() for _ in range(max(1, trials))),
                  key=lambda r: r["speedup"])
    picked = runs[len(runs) // 2]  # the median-speedup trial, whole
    cont, stat = picked["continuous"], picked["static"]
    return {
        "seed": seed,
        "requests": requests,
        "continuous": cont,
        "static": stat,
        "continuous_vs_static_speedup": round(picked["speedup"], 3),
        "speedup_trials": [round(r["speedup"], 3) for r in runs],
        "occupancy_gain": round(
            cont["occupancy_mean"] / stat["occupancy_mean"], 3
        ) if stat["occupancy_mean"] else 0.0,
    }
