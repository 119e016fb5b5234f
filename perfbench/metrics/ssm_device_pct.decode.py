"""Share (%) of the decode steps' device time that the SSM mixers take: the
device operations launched inside the program's ``repro_torch.ssm`` spans
(``models/ssm.py``) within ``bench.decode_step``, over all those launched
within ``bench.decode_step``, in the traced requests."""

STEP, SPAN = "bench.decode_step", "repro_torch.ssm"


def read(ctx):
    t = ctx.trace
    if t is None:
        return None
    total = t.launched_seconds(STEP)
    part = t.launched_seconds(STEP, SPAN)
    if total <= 0 or part <= 0:
        return None
    return 100.0 * part / total
