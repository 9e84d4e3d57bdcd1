"""Continuous batching: slot-based online decode serving.

Port of ``numpy_quant_tpu/utils/serving.py::ContinuousBatcher`` over the
port's KV-cache step graphs (``models/gpt.py::gpt_decode_step``,
``models/llama.py::llama_decode_step``, ``models/t5.py::t5_decode_step``,
``models/seq2seq.py::bart_decode_step``,
``models/whisper.py::whisper_decode_step``). ``utils.generate.generate_kv``
runs one batch lockstep; this engine gives each of the step graph's B rows
(slots) its own request, position, prompt length and budget, so a finished
request's slot takes the next queued one at once.

* One step graph for all B slots. Each step gathers per-row inputs on the
  device -- the token embedding, the additive mask ``[B, 1, 1, L+1]`` (cache
  lanes below the row's position live), for RoPE graphs the row's
  ``cos``/``sin`` ``[B, 1, 1, D]`` and for T5 the row's score-bias row
  ``[B, H, 1, L+1]`` of the ``[L, H, L+1]`` table -- and writes each row's
  present at the row's own position. The step graphs declare batch-1 mask,
  RoPE and bias inputs; the executor broadcasts the per-row forms.
* Seq2seq step graphs (``has_memory=True``) read one ``[B, S, d]`` encoder
  memory buffer placed at construction; each admitted request's
  ``memory_row`` [S, d] is copied into its slot's rows in place, between
  steps, as the captured step reads the buffer where it lies.
* Prompts are teacher forced one token per step, or admitted in one call
  of a prefill graph (``prefill_model=``: ``gpt_prefill``/``llama_prefill``)
  whose presents fill the slot's cache rows.
* ``kv_cache_dtype="int8"`` stores the caches as int8 (each present
  quantized with its cache input's calibrated params, as generate_kv does).
* ``paged_kv=(block_size, n_blocks)``: all slots share one block pool
  ``[n_blocks, H, block_size, D]`` per cache plus a per-slot block table;
  block 0 is the null sink of inactive rows. Each step gathers every
  slot's blocks into a contiguous view (``index_select``) and scatters the
  new rows into the pool. Blocks are allocated on demand and released at
  retirement; when the pool runs dry the youngest request is preempted and
  re-queued with its tokens so far as its prompt (recompute), which
  replays greedy decoding exactly.
* Per-slot sampling: greedy where the slot's temperature is 0, else the
  argmax of ``logits / temperature + Gumbel noise``. The noise of absolute
  step s comes from a generator seeded from ``(seed, s)``, so
  ``steps_per_sync=k`` samples the tokens ``k=1`` does.
* ``steps_per_sync=k`` runs k steps with no host read between them; a slot
  that finishes inside the chunk freezes. The host reads the done mask once
  per chunk (plus ``pos`` where a slot finishes, and on paged engines
  before each chunk, to allocate blocks).
* ``state_carry=True`` serves an SSM step graph
  (``models/mamba.py::mamba_decode_step``): x_step plus a (conv window,
  SSM state) pair per layer, no mask, no positions. The carry is one
  placed buffer pair per layer, read in place by the captured step; each
  step's new states are copied into it wholesale (inactive rows evolve
  garbage), and admission zeroes the admitted slot's rows between steps.
  ``max_len`` bounds the ids and the budgets.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .generate import (_as_device, _cache_quantizer, _cache_start, _divide,
                       _gumbel, _kv_layout, _mamba_state_shapes,
                       _placed_table)

_PREFILL_STREAM = 1_000_000  # noise stream offset of sampled prefill tokens


@dataclass
class _Request:
    req_id: int
    prompt: np.ndarray          # [plen] int32
    max_new_tokens: int
    temperature: float = 0.0    # 0 = greedy
    memory_row: np.ndarray = None  # [S, d] encoder rows (seq2seq)


@dataclass
class _SlotInfo:
    req_id: int
    plen: int
    max_new: int
    req: _Request = None        # the original request (preemption rebuilds)


def _stream_seed(seed: int, stream: int) -> int:
    """A 64-bit generator seed for noise stream ``stream`` of ``seed``."""
    state = np.random.SeedSequence([int(seed), int(stream)])
    return int(state.generate_state(1, np.uint64)[0])


def _slot_noise(seed: int, stream: int, shape: tuple,
                device: torch.device) -> torch.Tensor:
    """Gumbel noise of ``shape`` for absolute step ``stream`` (or a prefill's
    stream), from a generator seeded from ``(seed, stream)``."""
    gen = torch.Generator(device=device).manual_seed(_stream_seed(seed,
                                                                  stream))
    return _gumbel(shape, gen)


class ContinuousBatcher:
    """Online serving engine over a KV-cache decode-step model.

    ``step_model`` is a decode-step graph (gpt_decode_step,
    llama_decode_step, mixtral_decode_step, t5_decode_step,
    bart_decode_step, whisper_decode_step) built with ``batch_size`` slots
    and cache length ``max_len``, or with ``state_carry=True`` an SSM step
    graph (mamba_decode_step) and the ids' length ``max_len``;
    ``wte``/``wpe``/``rope``/``score_bias``/``kv_cache_dtype`` mirror
    :func:`generate_kv`'s layout arguments, and ``has_memory`` marks
    a seq2seq step graph, whose requests each bring their ``memory_row``.
    ``eos_id`` retires a slot early when generated. ``prefill_model``
    (gpt_prefill/llama_prefill, batch 1; not with the score-bias or memory
    layouts) admits each request whose prompt fits its length in one call;
    longer prompts are teacher forced. ``seed`` seeds the sampling noise;
    a JAX PRNG ``key`` is not taken.

    :meth:`submit` enqueues requests, :meth:`step` admits queued requests
    into free slots and advances every active slot ``steps_per_sync``
    tokens, :meth:`run` drains a workload. Results are token rows
    including the prompt (and the EOS, when hit), what generate_kv returns
    for the same prompt and budget.
    """

    @torch.inference_mode()
    def __init__(self, step_model, wte: np.ndarray, wpe: np.ndarray = None,
                 rope=None, score_bias: np.ndarray = None,
                 has_memory: bool = False, eos_id: int = None,
                 kv_cache_dtype: str = None, prefill_model=None,
                 state_carry: bool = False, max_len: int = None,
                 paged_kv: tuple = None, key=None, steps_per_sync: int = 1,
                 seed: int = 0):
        if key is not None:
            raise NotImplementedError(
                "jax.random keys are not taken: pass seed= (an int) for "
                "the sampling noise")
        self.model = step_model
        self.eos_id = eos_id
        self.seed = int(seed)
        self._chunk = max(1, int(steps_per_sync))
        self._state_carry = bool(state_carry)
        if state_carry:
            if (wpe is not None or rope is not None
                    or score_bias is not None or has_memory
                    or kv_cache_dtype is not None
                    or prefill_model is not None):
                raise ValueError("state_carry engines take none of "
                                 "wpe/rope/score_bias/memory/"
                                 "kv_cache_dtype/prefill_model")
            if max_len is None:
                raise ValueError("state_carry engines need max_len= "
                                 "(there is no cache to infer it from)")
            if paged_kv is not None:
                raise ValueError("paged_kv applies to KV-cache engines "
                                 "only (state_carry caches are already "
                                 "constant-size)")
            shapes = _mamba_state_shapes(step_model)
            self.n_slots, self.max_len = int(shapes[0][0][0]), int(max_len)
            cache_start = 1
        else:
            cache_start = _cache_start(step_model, rope,
                                       score_bias is not None, has_memory)
            n_layer, b, nh, length, hd = _kv_layout(step_model, cache_start)
            self.n_slots, self.max_len = int(b), int(length)
            self._layout = (n_layer, int(nh), int(hd))
        self.device = dev = step_model.device
        self._wte = _placed_table(step_model, "wte", wte)
        self._wpe = _placed_table(step_model, "wpe", wpe)
        if rope is not None:
            self._cos = _placed_table(step_model, "rope_cos", rope[0])[0, 0]
            self._sin = _placed_table(step_model, "rope_sin", rope[1])[0, 0]
        else:
            self._cos = self._sin = None
        self._bias = _placed_table(step_model, "score_bias", score_bias)
        self._memory = None
        if has_memory:
            hint = step_model.inputs[cache_start - 1].shape_hint
            self._memory = torch.zeros(tuple(int(d) for d in hint),
                                       dtype=torch.float32, device=dev)
        self._q_cache, cache_dtype = _cache_quantizer(
            step_model, kv_cache_dtype, cache_start)

        # device-resident engine state
        B, L = self.n_slots, self.max_len
        self._ids = torch.zeros((B, L + 1), dtype=torch.int64, device=dev)
        self._pos = torch.zeros((B,), dtype=torch.int64, device=dev)
        self._plen = torch.zeros((B,), dtype=torch.int64, device=dev)
        self._tmax = torch.zeros((B,), dtype=torch.int64, device=dev)
        self._active = torch.zeros((B,), dtype=torch.bool, device=dev)
        self._temp = torch.zeros((B,), dtype=torch.float32, device=dev)
        self._rows = torch.arange(B, device=dev)
        self._lanes = torch.arange(L, device=dev)
        self._zero = torch.zeros((), dtype=torch.float32, device=dev)
        self._neg = torch.full((), -1e9, dtype=torch.float32, device=dev)
        self._paged = None
        if paged_kv is not None:
            blk, n_blocks = int(paged_kv[0]), int(paged_kv[1])
            if blk < 1 or n_blocks < 2:
                raise ValueError("paged_kv needs block_size >= 1 and "
                                 "n_blocks >= 2 (block 0 is the null "
                                 "sink for inactive rows)")
            nbt = -(-L // blk)  # table entries per slot
            self._paged = (blk, n_blocks, nbt)
            # block 0 is never allocated: unallocated table entries and
            # inactive slots read and write it, masked out of attention
            self._table = torch.zeros((B, nbt), dtype=torch.int64,
                                      device=dev)
            self._free = list(range(n_blocks - 1, 0, -1))
            self._owned: list[list[int]] = [[] for _ in range(B)]
            shape = (n_blocks, nh, blk, hd)
        elif not state_carry:
            shape = (B, nh, L, hd)
        if state_carry:
            self._caches = [torch.zeros(s, dtype=torch.float32, device=dev)
                            for pair in shapes for s in pair]
        else:
            # one zeros tensor per cache (the identity quantizer returns
            # its input); int8 caches start at quantize(0.0), the zero
            # point
            self._caches = [q(torch.zeros(shape, dtype=torch.float32,
                                          device=dev)).to(cache_dtype)
                            for q in self._q_cache]
        # the captured step graph reads the memory and dense caches where
        # they lie; paged views are gathered anew each step, so they are
        # copied in
        self._inplace = (() if self._memory is None else (cache_start - 1,)) \
            + (() if self._paged is not None else tuple(
                range(cache_start, cache_start + len(self._caches))))

        self._prefill = prefill_model
        if prefill_model is not None:
            if score_bias is not None or has_memory:
                raise ValueError("prefill_model supports the plain and RoPE "
                                 "decode layouts only")
            pb, plen_hint, _ = prefill_model.inputs[0].shape_hint
            if int(pb) != 1:
                raise ValueError("prefill graphs admit one request at a "
                                 "time (batch 1)")
            self.prefill_len = int(plen_hint)
            if self.prefill_len > L:
                raise ValueError(f"prefill length {self.prefill_len} "
                                 f"exceeds the cache length {L}")
        else:
            self.prefill_len = 0

        # host-side bookkeeping
        self._queue: list[_Request] = []
        self._slots: list[_SlotInfo | None] = [None] * B
        self._next_id = 0
        self._early: list[tuple[int, np.ndarray]] = []
        self.stats = {"steps": 0, "slot_steps": 0, "prefills": 0,
                      "completed": 0, "tokens_out": 0, "preemptions": 0}

    # ---------------------------------------------------------- the step

    def _pick(self, row: torch.Tensor, step: int,
              sampling: bool) -> torch.Tensor:
        """Per-slot next token: argmax where the slot's temperature is 0,
        else the argmax of row / temperature + Gumbel noise of ``step``."""
        greedy = torch.argmax(row, dim=-1)
        if not sampling:
            return greedy
        scaled = row / self._temp.clamp_min(float(np.float32(1e-6)))[:, None]
        noise = _slot_noise(self.seed, step, tuple(row.shape), row.device)
        sampled = torch.argmax(scaled + noise, dim=-1)
        return torch.where(self._temp > 0, sampled, greedy)

    def _views(self) -> list[torch.Tensor]:
        """The caches the step graph reads: the dense caches, or each
        pool's blocks gathered by the table into [B, H, L, D]."""
        if self._paged is None:
            return self._caches
        blk, _, nbt = self._paged
        B, L = self.n_slots, self.max_len
        _, nh, hd = self._layout
        flat = self._table.reshape(-1)
        views = []
        for pool in self._caches:
            g = pool.index_select(0, flat).reshape(B, nbt, nh, blk, hd)
            g = g.transpose(1, 2).reshape(B, nh, nbt * blk, hd)
            views.append(g if nbt * blk == L else g[:, :, :L].contiguous())
        return views

    def _advance(self, active: torch.Tensor, step: int,
                 sampling: bool) -> torch.Tensor:
        """One decode step of every slot in ``active`` (a [B] bool device
        tensor); returns the [B] done mask. Rows outside ``active`` run
        too (static shapes) but keep their ids and positions."""
        B, L = self.n_slots, self.max_len
        rows, pos = self._rows, self._pos
        tok = self._ids[rows, pos]
        x = self._wte[tok]
        if self._wpe is not None:
            x = x + self._wpe[pos.clamp(max=self._wpe.shape[0] - 1)]
        x = x[:, None, :]
        if self._state_carry:
            # the SSM carry swaps in wholesale, every row
            outs = self.model([x] + self._caches, as_numpy=False,
                              inplace=self._inplace)
            for buf, new in zip(self._caches, outs[1:]):
                buf.copy_(new)
            return self._emit(self._pick(outs[0][:, 0, :], step, sampling),
                              active)
        # per-row additive mask: cache lane j live iff j < pos_b, plus the
        # always-live self lane
        valid = self._lanes[None, :] < pos[:, None]
        mask = torch.where(valid, self._zero, self._neg)
        mask = torch.cat([mask, self._zero.expand(B, 1)], dim=1)
        extra = []
        if self._cos is not None:
            rpos = pos.clamp(max=self._cos.shape[0] - 1)
            extra = [self._cos[rpos][:, None, None, :],
                     self._sin[rpos][:, None, None, :]]
        if self._bias is not None:
            # [L, H, L+1] table -> the rows' [B, H, 1, L+1] bias
            extra.append(self._bias[pos.clamp(max=L - 1)][:, :, None, :])
        if self._memory is not None:
            extra.append(self._memory)
        outs = self.model([x, mask[:, None, None, :]] + extra
                          + self._views(), as_numpy=False,
                          inplace=self._inplace)
        nxt = self._pick(outs[0][:, 0, :], step, sampling)
        if self._paged is not None:
            # each row's new K/V row into its current block (inactive
            # slots' tables point at the null block 0)
            blk, _, nbt = self._paged
            wblk = self._table[rows, (pos // blk).clamp(max=nbt - 1)]
            off = pos % blk
            for pool, present, q in zip(self._caches, outs[1:],
                                        self._q_cache):
                pool[wblk, :, off] = q(present).to(pool.dtype)[:, :, 0, :]
        else:
            wpos = pos.clamp(max=L - 1)
            for cache, present, q in zip(self._caches, outs[1:],
                                         self._q_cache):
                cache[rows, :, wpos] = q(present).to(cache.dtype)[:, :, 0, :]
        return self._emit(nxt, active)

    def _emit(self, nxt: torch.Tensor, active: torch.Tensor) -> torch.Tensor:
        """Write each active row's next token ``nxt`` (teacher forced inside
        the prompt), advance its position; returns the [B] done mask."""
        rows, pos, L = self._rows, self._pos, self.max_len
        # teacher forcing: inside the prompt the next token is given
        in_prompt = pos + 1 < self._plen
        col = (pos + 1).clamp(max=L)
        write = active & ~in_prompt
        self._ids[rows, col] = torch.where(write, nxt, self._ids[rows, col])
        new_pos = torch.where(active, pos + 1, pos)
        self._pos = new_pos
        done = active & (new_pos + 1 >= self._tmax)
        if self.eos_id is not None:
            emitted = self._ids[rows, new_pos]
            done = done | (write & (emitted == self.eos_id))
        return done

    # ------------------------------------------------- paged block pool

    def _alloc_upto(self, slot: int, n_entries: int) -> bool:
        """Ensure the slot's first ``n_entries`` block-table entries are
        allocated; False when the free list cannot cover them."""
        need = n_entries - len(self._owned[slot])
        if need <= 0:
            return True
        if len(self._free) < need:
            return False
        for _ in range(need):
            b = self._free.pop()
            idx = len(self._owned[slot])
            self._owned[slot].append(b)
            self._table[slot, idx] = b
        return True

    def _release_blocks(self, slot: int) -> None:
        if self._paged is None or not self._owned[slot]:
            return
        self._free.extend(reversed(self._owned[slot]))
        self._owned[slot] = []
        self._table[slot] = 0

    def _preempt_youngest(self) -> None:
        """Recompute preemption: re-queue the youngest active request with
        its tokens so far as the prompt, at the head of the queue, and free
        its blocks. Greedy decoding replays to the same tokens."""
        cand = [s for s in range(self.n_slots) if self._slots[s] is not None]
        if not cand:
            raise RuntimeError("paged KV pool exhausted with nothing "
                               "to preempt")
        slot = max(cand, key=lambda s: self._slots[s].req_id)
        info = self._slots[slot]
        pos_h = int(self._pos[slot])
        known = max(info.plen, pos_h + 1)   # prompt + generated so far
        toks = self._ids[slot, :known].cpu().numpy().astype(np.int32)
        tmax = info.plen + info.max_new
        self._queue.insert(0, _Request(info.req_id, toks, tmax - known,
                                       info.req.temperature,
                                       info.req.memory_row))
        self._release_blocks(slot)
        self._slots[slot] = None
        self._active[slot] = False
        self.stats["preemptions"] += 1

    def _ensure_blocks(self) -> None:
        """Before a chunk, every active slot must own the blocks its next
        ``steps_per_sync`` write positions land in; preempt the youngest
        request until the pool covers the rest."""
        blk = self._paged[0]
        while True:
            pos_h = self._pos.cpu().numpy()
            ok = True
            for slot in range(self.n_slots):
                if self._slots[slot] is None:
                    continue
                last = int(pos_h[slot]) + self._chunk - 1
                if not self._alloc_upto(slot, last // blk + 1):
                    ok = False
                    break
            if ok:
                return
            self._preempt_youngest()

    # ------------------------------------------------------ public API

    @torch.inference_mode()
    def reset(self) -> None:
        """Drop all queued and in-flight requests. Slot caches need no
        clearing: a mask only validates positions its request wrote."""
        self._queue = []
        self._early = []
        self._slots = [None] * self.n_slots
        self._active.zero_()
        if self._paged is not None:
            for slot in range(self.n_slots):
                self._release_blocks(slot)
        self.stats = {k: 0 for k in self.stats}

    def submit(self, prompt_ids, max_new_tokens: int,
               memory_row: np.ndarray = None,
               temperature: float = None) -> int:
        """Enqueue a request; returns its id. ``prompt_ids`` is a 1-D
        token array; ``memory_row`` ([S, d]) is the request's encoder
        output, given exactly when the step model takes encoder memory;
        ``temperature`` switches this request to sampling (greedy when
        None or 0)."""
        if (memory_row is None) != (self._memory is None):
            raise ValueError("memory_row must be passed iff the step "
                             "model takes encoder memory")
        prompt = np.asarray(prompt_ids, np.int32).reshape(-1)
        if prompt.size < 1:
            raise ValueError("empty prompt")
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if prompt.size + max_new_tokens > self.max_len + 1:
            raise ValueError(
                f"prompt {prompt.size} + {max_new_tokens} new tokens "
                f"exceeds the engine's cache length {self.max_len}")
        if self._paged is not None:
            blk, n_blocks, _ = self._paged
            need = -(-(prompt.size + max_new_tokens - 1) // blk)
            if need > n_blocks - 1:
                raise ValueError(
                    f"request needs {need} KV blocks but the pool has "
                    f"{n_blocks - 1} allocatable (block_size {blk})")
        req = _Request(self._next_id, prompt, int(max_new_tokens),
                       float(temperature or 0.0), memory_row)
        self._next_id += 1
        self._queue.append(req)
        return req.req_id

    @property
    def n_active(self) -> int:
        return sum(s is not None for s in self._slots)

    @property
    def n_queued(self) -> int:
        return len(self._queue)

    def _admit(self) -> None:
        for slot in range(self.n_slots):
            while self._slots[slot] is None and self._queue:
                if not self._admit_one(slot):
                    return

    def _prefill_into(self, slot: int, req: _Request) -> int:
        """One prefill call over the request's prompt: its presents fill
        the slot's cache rows (quantized for an int8 cache) and row
        plen-1's logits give the first token, which is returned."""
        plen, P = req.prompt.size, self.prefill_len
        dev = self.device
        emb = torch.zeros((1, P, self._wte.shape[1]), dtype=torch.float32,
                          device=dev)
        emb[0, :plen] = self._wte[torch.from_numpy(
            req.prompt.astype(np.int64)).to(dev)]
        outs = self._prefill([emb], as_numpy=False)
        row = outs[0][0, plen - 1]
        if req.temperature > 0:
            noise = _slot_noise(self.seed,
                                _PREFILL_STREAM + self.stats["prefills"],
                                tuple(row.shape), row.device)
            tok = int(torch.argmax(_divide(row, req.temperature) + noise))
        else:
            tok = int(torch.argmax(row))
        presents = [q(p).to(c.dtype)[0]
                    for c, p, q in zip(self._caches, outs[1:], self._q_cache)]
        if self._paged is not None:
            blk = self._paged[0]
            nb = -(-plen // blk)
            blks = torch.tensor(self._owned[slot][:nb], dtype=torch.int64,
                                device=dev)
            tgt = nb * blk
            for pool, rows in zip(self._caches, presents):  # rows [H, P, D]
                if tgt <= rows.shape[1]:
                    rows = rows[:, :tgt]
                else:
                    rows = torch.nn.functional.pad(
                        rows, (0, 0, 0, tgt - rows.shape[1]))
                rows = rows.reshape(rows.shape[0], nb, blk, -1)
                pool[blks] = rows.transpose(0, 1)
        else:
            for cache, rows in zip(self._caches, presents):
                cache[slot, :, :P] = rows
        return tok

    def _admit_one(self, slot: int) -> bool:
        req = self._queue.pop(0)
        plen = req.prompt.size
        use_prefill = self._prefill is not None and plen <= self.prefill_len
        if self._paged is not None:
            # the rows written at admission must have blocks: the whole
            # prompt under prefill, just row 0 teacher forced
            blk = self._paged[0]
            entries = -(-plen // blk) if use_prefill else 1
            if not self._alloc_upto(slot, entries):
                self._queue.insert(0, req)   # pool dry: wait
                return False
        row = np.zeros(self.max_len + 1, np.int64)
        row[:plen] = req.prompt
        pos0 = 0
        if use_prefill:
            tok = self._prefill_into(slot, req)
            row[plen] = tok
            pos0 = plen
            self.stats["prefills"] += 1
            if req.max_new_tokens <= 1 or (self.eos_id is not None
                                           and tok == self.eos_id):
                # finished at admission: never takes the slot
                self._release_blocks(slot)
                self._early.append((req.req_id,
                                    row[:plen + 1].astype(np.int32)))
                self.stats["completed"] += 1
                self.stats["tokens_out"] += 1
                return True
        if self._state_carry:
            # a new request's recurrent state restarts from zero (KV caches
            # need no clearing: their masks hide stale rows); in place, as
            # the captured step reads the buffers where they lie
            for buf in self._caches:
                buf[slot].zero_()
        self._ids[slot] = torch.from_numpy(row).to(self.device)
        self._pos[slot] = pos0
        self._plen[slot] = plen
        self._tmax[slot] = plen + req.max_new_tokens
        self._active[slot] = True
        self._temp[slot] = req.temperature
        if req.memory_row is not None:
            # in place: the captured step holds the buffer's address
            self._memory[slot].copy_(_as_device(req.memory_row, self.device)
                                     .reshape(self._memory.shape[1:]))
        self._slots[slot] = _SlotInfo(req.req_id, plen, req.max_new_tokens,
                                      req)
        return True

    @torch.inference_mode()
    def step(self) -> list[tuple[int, np.ndarray]]:
        """Admit queued requests into free slots, advance every active
        slot ``steps_per_sync`` tokens, and return the requests that
        finished as ``(req_id, tokens)`` -- tokens include the prompt and
        the EOS when one was generated."""
        self._admit()
        early, self._early = self._early, []
        if self.n_active == 0:
            return sorted(early, key=lambda t: t[0])
        if self._paged is not None:
            self._ensure_blocks()
        sampling = any(s is not None and s.req.temperature > 0
                       for s in self._slots)
        step0 = self.stats["steps"]
        if self._chunk == 1:
            done = self._advance(self._active, step0, sampling)
            done_h = done.cpu().numpy()
            n_slot_steps = self.n_active
        else:
            act = self._active.clone()
            done = torch.zeros_like(act)
            nact = torch.zeros((), dtype=torch.int64, device=self.device)
            for i in range(self._chunk):
                nact = nact + act.sum()
                d = self._advance(act, step0 + i, sampling)
                act = act & ~d
                done = done | d
            host = torch.cat([done.to(torch.int64), nact[None]]).cpu()
            done_h = host[:-1].numpy().astype(bool)
            n_slot_steps = int(host[-1])
        self.stats["steps"] += self._chunk
        self.stats["slot_steps"] += n_slot_steps
        finished = early
        if done_h.any():
            ids_h = self._ids.cpu().numpy()
            pos_h = self._pos.cpu().numpy()
            for slot in np.flatnonzero(done_h):
                info = self._slots[slot]
                end = int(pos_h[slot]) + 1
                finished.append((info.req_id,
                                 ids_h[slot, :end].astype(np.int32)))
                self.stats["completed"] += 1
                self.stats["tokens_out"] += end - info.plen
                self._release_blocks(slot)
                self._slots[slot] = None
                self._active[slot] = False
        finished.sort(key=lambda t: t[0])
        return finished

    def run(self, requests) -> dict[int, np.ndarray]:
        """Drain a workload: submit every ``(prompt_ids, max_new_tokens)``
        or ``(prompt_ids, max_new_tokens, memory_row)`` tuple (the
        positional arguments of :meth:`submit`), then step until all
        requests finish. Returns {req_id: tokens}."""
        out: dict[int, np.ndarray] = {}
        for req in requests:
            self.submit(*req)
        while self._queue or self.n_active:
            for req_id, tokens in self.step():
                out[req_id] = tokens
        return out
