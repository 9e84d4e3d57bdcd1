"""Requests through a continuous-batching engine. The mix's ``load``:
``open`` sends every request on its due time (an open loop at the
arrival process's rate; every request due in the window runs to its end,
at most ``drain_s`` past the close); ``closed`` keeps ``queue`` requests
waiting all window, refilled as requests finish."""
import time
from collections import deque

import numpy as np

from benchmark.common import drive, stats, traffic
from benchmark.common.harness import Record
from benchmark.common.trace import Tracer


class Book:
    """The benchmark's own books on the requests it sent: the engine
    admits in FIFO order, so the requests that left its queue in a step()
    call are the oldest ``n_queued`` before minus after."""

    def __init__(self, reqs, work):
        n = len(reqs)
        self.reqs = reqs
        self.work = work
        self.rid = {}
        self.fifo = deque()
        self.sent = [None] * n
        self.admit = [None] * n
        self.finish = [None] * n
        self.tokens = [None] * n
        self.live = {}       # request index -> decode tokens so far

    def submit(self, engine, i, now):
        r = self.reqs[i]
        self.rid[engine.submit(r.prompt, r.max_new)] = i
        self.fifo.append(i)
        self.sent[i] = now

    def step(self, engine, t0):
        """One engine step; returns (start, seconds, flops of the step's
        tokens as the model counts them over live context)."""
        q0 = engine.n_queued
        ts = time.perf_counter()
        finished = engine.step()
        te = time.perf_counter()
        flops = 0.0
        for _ in range(q0 - engine.n_queued):
            i = self.fifo.popleft()
            self.admit[i] = te - t0
            self.live[i] = 0
            flops += self.work.prefill_flops(self.reqs[i].prompt.size)
        for i, j in self.live.items():
            # decode token j of request i attends to plen + j + 1 keys
            flops += self.work.decode_flops(self.reqs[i].prompt.size + j + 1)
            self.live[i] = j + 1
        for rid, toks in finished:
            i = self.rid.pop(rid)
            self.finish[i] = te - t0
            self.tokens[i] = toks
            self.live.pop(i, None)
        return ts - t0, te - ts, flops


def warm(system, cell, seed, seconds):
    reqs = traffic.requests(cell.mix, seed, system.vocab, seconds,
                            cell.bench)
    eng = system.engine
    for r in reqs[:2]:
        eng.submit(r.prompt, 3)
    while eng.n_queued or eng.n_active:
        eng.step()
    eng.reset()
    drive.sync(system.device)
    return {"reqs": reqs, "seed": seed}


def window(system, cell, state, seconds, profile_s):
    mix = cell.mix
    eng, reqs = system.engine, state["reqs"]
    book = Book(reqs, system.work)
    open_loop = mix["load"] == "open"
    untraced = seconds - profile_s
    tracer = Tracer(drive.TRACE_PATH) if profile_s > 0 else None
    traced_from = None
    steps = []                # (start, seconds, flops)
    queue = []                # (seconds, requests waiting) per step
    s0 = dict(eng.stats)
    nxt = 0
    t0 = time.perf_counter()
    end_of_window = None
    while True:
        now = time.perf_counter() - t0
        if open_loop:
            while nxt < len(reqs) and reqs[nxt].due <= now:
                book.submit(eng, nxt, now)
                nxt += 1
            if eng.n_queued == 0 and eng.n_active == 0:
                if nxt >= len(reqs):
                    break
                time.sleep(min(0.0005, max(0.0, reqs[nxt].due - now)))
                continue
        else:
            while eng.n_queued < int(mix["queue"]):
                if nxt >= len(reqs):
                    raise RuntimeError("the backlog's pool of "
                                       f"{len(reqs)} requests ran out")
                book.submit(eng, nxt, now)
                nxt += 1
        if tracer is not None and traced_from is None \
                and now >= untraced and end_of_window is None:
            traced_from = (len(steps), dict(eng.stats))
            tracer.start()
        steps.append(book.step(eng, t0))
        done = time.perf_counter() - t0
        queue.append((done, eng.n_queued))
        if end_of_window is None and done >= seconds:
            end_of_window = (len(steps), dict(eng.stats), done)
            if traced_from is not None:
                n0, st = traced_from
                record_trace = tracer.stop({
                    "decode_step": len(steps) - n0,
                    "prefill": eng.stats["prefills"] - st["prefills"]})
            if not open_loop:
                break
        if open_loop and done > seconds + float(mix["drain_s"]):
            break
    record = Record()
    n_win, s1, window_s = end_of_window
    record.window_s = window_s
    if traced_from is not None:
        record.trace = record_trace
    # the untraced stretch: the steps begun before the profiler
    n_un = traced_from[0] if traced_from is not None else n_win
    un = steps[:n_un]
    stretch_s = (un[-1][0] + un[-1][1]) if un else 0.0
    record.stretch = {
        "step_ms": 1e3 * sum(s[1] for s in un) / max(1, len(un)),
        "flops": sum(s[2] for s in un), "seconds": stretch_s,
        "queue": queue}
    if open_loop:
        ttft, tpot, failed = [], [], 0
        for i, r in enumerate(reqs):
            if book.finish[i] is None:
                failed += 1
                ttft.append(float("inf"))
                tpot.append(float("inf"))
                continue
            ttft.append(book.admit[i] - r.due)
            tpot.append((book.finish[i] - book.admit[i])
                        / max(1, r.max_new - 1))
        record.attempted, record.failed = len(reqs), failed
        record.e2e["ttft_p95_ms"] = 1e3 * stats.percentile(ttft, 95)
        record.e2e["ttft_p50_ms"] = 1e3 * stats.percentile(ttft, 50)
        record.e2e["tpot_p95_ms"] = 1e3 * stats.percentile(tpot, 95)
        record.e2e["requests_late_s"] = max(
            (book.sent[i] - r.due for i, r in enumerate(reqs)),
            default=0.0)
    else:
        tokens = (s1["slot_steps"] - s0["slot_steps"]
                  + s1["prefills"] - s0["prefills"])
        record.attempted = s1["completed"] - s0["completed"]
        record.e2e["output_tokens_per_s"] = stats.rate(tokens, window_s)
    # the check's sample: the longest request finished in the window
    # and others drawn from the seed, to ``check_tokens`` served tokens
    cut = window_s if not open_loop else float("inf")
    done_ix = [i for i in range(len(reqs)) if book.finish[i] is not None
               and book.finish[i] <= cut]
    rng = np.random.default_rng(traffic.stream_seed(state["seed"],
                                                    "check"))
    order = sorted(done_ix, key=lambda i: -reqs[i].max_new)[:1] \
        + [done_ix[k] for k in rng.permutation(len(done_ix))]
    sample, served, seen = [], 0, set()
    for i in order:
        if i in seen:
            continue
        seen.add(i)
        sample.append((reqs[i].prompt, book.tokens[i]))
        served += reqs[i].max_new
        if served >= int(mix["check_tokens"]):
            break
    record.sample = {"requests": sample}
    return record
