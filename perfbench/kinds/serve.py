"""Serve traffic: one client in a closed loop of batched requests to a
served model.

A request is ``batch`` prompts (the configuration's: the sequences the
card serves together) of one length: one prefill (the first greedy token
of each sequence), then greedy decode steps, each feeding every
sequence's last token back, until each sequence has its output length.
The lengths follow the traffic's distributions: ``classes`` quantiles of
a lognormal prompt length and of a lognormal output length
(:func:`lengths`), each class served once a cycle, the prompt and output
classes in bit-reversed order from their own offsets (:func:`schedule`),
so that any run of requests from the start spreads over the whole
distribution.  Every seed serves the same lengths in the same order; the
seed draws the token ids and the weights.

Set-up makes the model's weights from the seed on the device
(``perfbench/model_weights.py``) and one cycle of requests (uniform token
ids), hands the weights to the system, and serves the longest prompt and
the shortest, two steps each, so that every kernel is built before the
window.  The window sends request after request, starting at a request and
ending at the first decode-step boundary past ``--seconds`` (the first
request always runs whole); the client waits for each request's tokens
before it sends the next.  Each prefill and each step is timed by CUDA
events around it: the prefill from its issue to its first token (time to
first token), a step from the previous token to its own; the untraced
ones' model FLOPs, times and tokens are the counters of the per-layer
shares of the peak (``step_mfu.*``) and of the per-layer rate and tail
(``*.unbounded``: where a cell reads its decode per layer).  The times to
first token are reported over the prompt tokens they served, all
requests' summed over all their prompts', since the window's requests are
of many lengths and a median would jump with their number.  The cycle
collector is off in the window.  A traced run traces the window's first
``trace_requests`` requests (and reads the trace inside the window, which
goes on after it).

The check (after the window, the decode state freed): ``judged_sequences``
sequences of the requests the window finished, one of the request with the
most output tokens and the rest drawn from the seed, each prompt with its
served tokens run once through the configuration's plain reference in
float32.  At each served position it reads the reference's best logit less
the served token's, in units of the reference logits' standard deviation
there (:func:`token_gaps`): ``token_gap_mean_sd`` is their mean over every
position, and is always compared; ``token_gap_sd`` the widest.  The
configuration's ``limits`` give each compared number its limit.  The
control (``perfbench/control.py``) judges instead the tokens that the
reference computed in float8 puts first at the same positions.
"""
from __future__ import annotations

import contextlib
import gc
import math
import random
import statistics
import sys

import numpy as np
import torch

from perfbench import model_cost, model_weights
from perfbench.kinds.common import Window, seed_for

#: the limit of each number the check compares: set by each configuration
#: (its ``limits``), since how far a sound bfloat16 decode strays from the
#: float32 reference depends on the model
LIMITS = {}
#: the numbers every served cell compares, whatever its configuration
COMPARED = ("token_gap_mean_sd",)

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
_OFF = contextlib.nullcontext()


def _no_span(name: str):
    return _OFF


def lengths(dist: dict, classes: int, round_to: int = 1) -> list:
    """The ``classes`` quantiles at (i + 1/2) / classes of a lognormal of
    median ``dist["median"]`` and log-sd ``dist["sigma"]``, each rounded up
    to a multiple of ``round_to`` (at least ``round_to``)."""
    z = statistics.NormalDist()
    out = []
    for i in range(classes):
        x = dist["median"] * math.exp(dist["sigma"]
                                      * z.inv_cdf((i + 0.5) / classes))
        out.append(max(round_to, round_to * math.ceil(x / round_to)))
    return out


def bit_reversed(k: int, n: int) -> int:
    """``k`` with its log2(n) low bits reversed (``n`` a power of two)."""
    bits = n.bit_length() - 1
    return int(f"{k % n:0{bits}b}"[::-1], 2) if bits else 0


def schedule(t: dict) -> list:
    """One cycle of requests: (prompt tokens, output tokens) each."""
    n = t["classes"]
    if n & (n - 1):
        raise ValueError(f"classes {n}: a power of two")
    prompts = lengths(t["prompt_tokens"], n, t["prompt_round"])
    outputs = lengths(t["output_tokens"], n)
    return [(prompts[bit_reversed(k + t["prompt_offset"], n)],
             outputs[bit_reversed(k + t["output_offset"], n)])
            for k in range(n)]


def prepare(env) -> dict:
    t, m, B = env.traffic, env.config["model"], env.config["batch"]
    g = torch.Generator(device=env.device)
    g.manual_seed(seed_for(env.seed, "prompts"))
    cycle = schedule(t)
    pool = [torch.randint(0, m["vocab_size"], (B, S), generator=g,
                          device=env.device) for S, _ in cycle]
    return {"cycle": cycle, "pool": pool, "served": []}


def _request(server, prompts, s_cap: int, steps: int, events: list, span,
             deadline, clock) -> list:
    """One request; returns its tokens, each (B,) int32: the prefill's and
    one a step, the last step the first past ``deadline`` (None: all)."""
    events[0].record()
    with span("bench.prefill"):
        tok, state = server.prefill(prompts, s_cap)
    events[1].record()
    toks = [tok]
    for i in range(steps):
        with span("bench.decode_step"):
            tok, state = server.step(state, tok)
        events[i + 2].record()
        toks.append(tok)
        if deadline is not None and clock() >= deadline:
            break
    events[len(toks)].synchronize()
    return toks


def start(env, st: dict) -> None:
    t = env.traffic
    weights = model_weights.make(env.config["model"],
                                 seed_for(env.seed, "weights"), env.device,
                                 DTYPES[t["dtype"]])
    server = env.system.build(env.config, env.device)
    server.load(weights, t)
    cycle = st["cycle"]
    gmax = max(G for _, G in cycle)
    events = [env.dev.event() for _ in range(4)]
    for k in {max(range(len(cycle)), key=lambda k: cycle[k][0]),
              min(range(len(cycle)), key=lambda k: cycle[k][0])}:
        _request(server, st["pool"][k], cycle[k][0] + gmax, 2, events,
                 _no_span, None, env.clock)
    st.update(weights=weights, server=server, gmax=gmax)


def window(env, st: dict) -> Window:
    m, B = env.config["model"], env.config["batch"]
    server, pool, cycle = st["server"], st["pool"], st["cycle"]
    events = [env.dev.event() for _ in range(st["gmax"] + 1)]
    ttft, step_ms = [], []
    n_req = n_tokens = prompt_tokens = 0
    # model FLOPs, CUDA-event milliseconds and tokens of the untraced
    # prefills and steps, and each untraced step's milliseconds, for the
    # per-layer shares of the peak and the per-layer rate and tail
    work = dict.fromkeys(("prefill_flops", "prefill_ms", "decode_flops",
                          "decode_ms", "tokens"), 0)
    untraced_steps = []
    view, traced = None, []
    tracer = env.tracer() if env.trace else None
    gc.collect()
    gc.disable()
    if tracer:
        tracer.start()
    span = env.span if tracer else _no_span
    t0 = env.clock()
    deadline = t0 + env.seconds
    while True:
        k = n_req % len(cycle)
        S, G = cycle[k]
        # the first request runs whole, so that the check has one to judge
        toks = _request(server, pool[k], S + st["gmax"], G - 1, events,
                        span, deadline if n_req else None, env.clock)
        done = len(toks) - 1
        ttft.append(events[0].elapsed_time(events[1]))
        steps = [events[i + 1].elapsed_time(events[i + 2])
                 for i in range(done)]
        step_ms += steps
        if not tracer:
            work["prefill_flops"] += model_cost.prefill_flops(m, B, S)
            work["prefill_ms"] += ttft[-1]
            work["decode_flops"] += sum(model_cost.decode_flops(m, B, S + i)
                                        for i in range(done))
            work["decode_ms"] += sum(steps)
            work["tokens"] += B * len(toks)
            untraced_steps += steps
        n_req += 1
        prompt_tokens += S
        n_tokens += B * len(toks)
        if done == G - 1:
            st["served"].append((k, torch.stack(toks, dim=1)))
        if tracer:
            traced.append([B, S, done])
            if n_req >= env.traffic["trace_requests"]:
                view, tracer, span = tracer.stop(), None, _no_span
        if env.clock() >= deadline:
            break
    window_s = env.clock() - t0
    gc.enable()
    print("requests (prompt x output tokens: time to first token, ms): "
          + ", ".join(f"{cycle[i % len(cycle)][0]}x{cycle[i % len(cycle)][1]}"
                      f": {v:.2f}" for i, v in enumerate(ttft)),
          file=sys.stderr, flush=True)
    if step_ms:
        q = statistics.quantiles(step_ms, n=4) if len(step_ms) > 1 \
            else step_ms * 3
        print(f"decode steps: {len(step_ms)}, quartiles (ms) "
              f"{q[0]:.3f} {q[1]:.3f} {q[2]:.3f}, max {max(step_ms):.3f}, "
              f"window {window_s:.3f} s, prefills {sum(ttft) / 1e3:.3f} s",
              file=sys.stderr, flush=True)
    end_to_end = {"serve_tokens_per_s": n_tokens / window_s,
                  "ttft_ms_per_1k_prompt_tokens":
                  1e3 * sum(ttft) / prompt_tokens}
    if step_ms:
        end_to_end["decode_step_p95_ms"] = float(np.percentile(step_ms, 95))
    return Window(attempted=n_req, failed=0, end_to_end=end_to_end,
                  counters=dict(work, step_ms=untraced_steps,
                                traced_requests=traced if view else []),
                  trace=view)


def judged(env, st: dict) -> list:
    """The (cycle index, sequence, served tokens) the check judges: one
    sequence of the finished request with the most output tokens, the rest
    drawn from the seed among the finished requests' sequences."""
    seqs = [(k, b, toks[b]) for k, toks in st["served"]
            for b in range(toks.shape[0])]
    rng = random.Random(seed_for(env.seed, "judge"))
    first = max(range(len(seqs)), key=lambda i: (seqs[i][2].numel(),
                                                 -seqs[i][0]))
    first = rng.choice([i for i in range(len(seqs))
                        if seqs[i][0] == seqs[first][0]])
    rest = [s for i, s in enumerate(seqs) if i != first]
    n = min(env.traffic["judged_sequences"], len(seqs)) - 1
    return [seqs[first]] + rng.sample(rest, n)


def token_gaps(ref_logits: torch.Tensor, tokens: torch.Tensor):
    """(n, P, V) reference logits, (n, P) judged tokens -> (n, P) gaps in
    standard deviations of each position's logits."""
    best = ref_logits.amax(dim=-1)
    got = ref_logits.gather(-1, tokens.long()[..., None])[..., 0]
    return (best - got) / ref_logits.std(dim=-1)


def _gaps(env, st, picks, precision=None) -> torch.Tensor:
    """The judged sequences' gaps, every position's, flat; ``precision``:
    judge the tokens the reference in that precision puts first instead
    of the served ones."""
    gaps = []
    for k, b, served in picks:
        prompt = st["pool"][k][b]
        S = prompt.numel()
        fed = torch.cat([prompt, served[:-1].to(prompt.dtype)])[None]
        ref = env.reference.logits(st["weights"], env.config, fed, S, S - 1)
        got = served[None]
        if precision:
            got = env.reference.logits(st["weights"], env.config, fed, S,
                                       S - 1, precision=precision).argmax(-1)
        gaps.append(token_gaps(ref, got)[0])
        del ref
    return torch.cat(gaps)


def check(env, st: dict) -> tuple:
    server = st.pop("server")
    control = getattr(server, "control_precision", None)
    server.close()
    del server
    gc.collect()
    if env.device.type == "cuda":
        torch.cuda.empty_cache()
    picks = judged(env, st)
    gaps = _gaps(env, st, picks)
    numbers = gap_numbers(gaps)
    log("served", numbers, gaps)
    if control:
        gaps = _gaps(env, st, picks, control)
        numbers = gap_numbers(gaps)
        log(f"the {control} control", numbers, gaps)
    wanted = set(COMPARED) | set(env.config["limits"])
    return ({k: numbers[k] for k in sorted(wanted)},
            sum(s.numel() for _, _, s in picks))


def gap_numbers(gaps: torch.Tensor) -> dict:
    """The numbers the check can compare: the widest gap and the mean."""
    return {"token_gap_sd": float(gaps.max()),
            "token_gap_mean_sd": float(gaps.mean())}


def log(what: str, numbers: dict, gaps: torch.Tensor) -> None:
    """Every number the check can compare, and the share of the positions
    whose judged token is not the reference's best."""
    off = float((gaps > 0).float().mean())
    print(f"{what}: " + ", ".join(f"{k} {v}" for k, v in numbers.items())
          + f", positions off the best {off} of {gaps.numel()}",
          file=sys.stderr, flush=True)
