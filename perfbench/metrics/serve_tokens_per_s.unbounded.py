"""``serve_tokens_per_s`` read per layer, for a cell that has it with no
bound: tokens a second of the window's untraced requests, their tokens
(the prefill's and one a step, a sequence) over their summed CUDA-event
times (the prefills' times to first token and the steps').  The host's
gaps between requests, and the traced request, are left out."""


def read(ctx):
    c = ctx.counters
    ms = c.get("prefill_ms", 0) + c.get("decode_ms", 0)
    if not c.get("tokens") or ms <= 0:
        return None
    return c["tokens"] / (ms * 1e-3)
