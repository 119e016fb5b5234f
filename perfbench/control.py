"""The control of the check, run through the rest of a benchmark run,
whose ``correct`` has to come out false.

An index cell's control is the plain reference put in the program's place
with one of the configuration's guarantees broken: read-your-writes.  The
stand-in answers from a map that never takes in the newest insert batch,
as a shortcut view served without its version gate would after a replay
was dropped.  Everything else is the reference's own exact answer.

A served model's control is the reference computed a precision below the
configuration's (bfloat16): float8.  It need not decode: the program serves
as usual, and the check judges, at each position of the same prompts and
served tokens, the token that the float8 reference puts first
(:class:`LowPrecision`).  ``--fault`` instead plants a wrong decode in the
program (:data:`FAULTS`): a decode step that hands its state back
unchanged, the rotary position off by one, the SSM state zeroed, the top-k
weights left un-renormalized.

The benchmark's runs never use this; it runs as

    python3 perfbench/control.py --workload <name> --seconds <s> \\
        --seeds <n> [<n> ...] [--fault <name>]

which prints one result line per seed (the numbers compared under
``checks``) and exits 0 only if every seed's ``correct`` is false.
"""
import os
import sys
import time

T_START = time.perf_counter()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:1] = [os.path.join(ROOT, "src"), ROOT]


class StaleMap:
    """Answers from every insert batch but the newest."""

    def __init__(self, reference):
        self.reference = reference
        self.batches = []
        self.map = None

    def insert(self, keys, values) -> None:
        self.batches.append((keys, values))
        self.map = None

    def lookup(self, keys):
        import torch
        if self.map is None:
            old = self.batches[:-1]
            empty = keys[:0]
            self.map = self.reference.KVMap(
                torch.cat([k for k, _ in old]) if old else empty,
                torch.cat([v for _, v in old]) if old else empty)
        return self.map.lookup(keys).view(torch.uint32)

    def wait_in_sync(self, timeout: float) -> bool:
        return True

    def counters(self) -> dict:
        return {"routed_shortcut": 0, "routed_traditional": 0,
                "slots_remapped": 0}

    def route_traditional(self) -> None:
        pass

    def close(self) -> None:
        self.batches, self.map = [], None


class StaleSystem:
    """A ``systems/<name>.py`` stand-in: ``build`` makes a ``StaleMap``."""

    def __init__(self, reference):
        self.reference = reference

    def build(self, config: dict, device) -> StaleMap:
        return StaleMap(self.reference)


class LowPrecision:
    """A ``systems/<name>.py`` stand-in for a served model: the system's own
    server, whose check judges the tokens the reference computed in
    ``precision`` puts first."""

    def __init__(self, system, precision: str = "fp8"):
        self.system, self.precision = system, precision

    def build(self, config: dict, device):
        server = self.system.build(config, device)
        server.control_precision = self.precision
        return server


def _state_unchanged():
    """The serving step's token, but its state handed back as it came in:
    no new K/V row, the SSM conv window and state as they were."""
    import torch
    from repro_torch.runtime import serve as rt
    make = rt.make_serve_step

    def made(cfg):
        step = make(cfg)

        def wrong(params, state, token):
            b = torch.arange(token.shape[0], device=token.device)
            at = state.ctx_len.long()
            views = [v for v in (state.view_k, state.view_v)
                     if isinstance(v, torch.Tensor)]
            rows = [v[:, b, :, at].clone() for v in views]
            ssm = [m for m in (state.ssm_conv, state.ssm_state)
                   if isinstance(m, torch.Tensor)]
            old = [m.clone() for m in ssm]
            tok, _ = step(params, state, token)
            for v, r in zip(views, rows):
                v[:, b, :, at] = r
            for m, o in zip(ssm, old):
                m.copy_(o)
            return tok, state
        return wrong
    return rt, "make_serve_step", made


def _rope_off_by_one():
    from repro_torch.models import model as M
    decode = M.decode_step

    def wrong(params, cfg, token, ctx, ctx_len, positions=None):
        return decode(params, cfg, token, ctx, ctx_len, positions=ctx_len)
    return M, "decode_step", wrong


def _ssm_state_zeroed():
    import torch
    from repro_torch.models import ssm
    step = ssm.ssm_decode

    def wrong(p, x, cache, cfg):
        return step(p, x, cache._replace(state=torch.zeros_like(cache.state)),
                    cfg)
    return ssm, "ssm_decode", wrong


def _topk_not_renormalized():
    from repro_torch.models import moe
    route = moe.route

    def wrong(p, x, cfg):
        probs, _, top_i = route(p, x, cfg)
        return probs, probs.gather(-1, top_i), top_i
    return moe, "route", wrong


#: wrong decodes planted in the program: name -> () -> (module, attribute,
#: replacement)
FAULTS = {"state_unchanged": _state_unchanged,
          "rope_off_by_one": _rope_off_by_one,
          "ssm_state_zeroed": _ssm_state_zeroed,
          "topk_not_renormalized": _topk_not_renormalized}


class planted:
    """Context manager: the program with the fault ``name`` in place."""

    def __init__(self, name: str):
        self.module, self.attr, self.wrong = FAULTS[name]()

    def __enter__(self):
        self.orig = getattr(self.module, self.attr)
        setattr(self.module, self.attr, self.wrong)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.attr, self.orig)


def main(argv) -> int:
    import argparse
    import io
    import contextlib
    import json
    from pathlib import Path

    from perfbench import harness, spec
    p = argparse.ArgumentParser(description="run the check's control")
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", default="5")
    p.add_argument("--seeds", nargs="+", required=True)
    p.add_argument("--fault", choices=sorted(FAULTS),
                   help="a served model's wrong decode, in place of the "
                   "float8 control")
    args = p.parse_args(argv)
    root = Path(ROOT)
    cell = spec.resolve(spec.load_spec(root), args.workload,
                        root / "perfbench")
    serve = cell.traffic["kind"] == "serve"
    if args.fault and not serve:
        p.error("--fault plants a wrong decode: a served model's cell only")
    system = None
    if not serve:
        system = StaleSystem(cell.reference)
    elif not args.fault:
        system = LowPrecision(cell.system)
    failed_all = True
    for seed in args.seeds:
        out = io.StringIO()
        fault = planted(args.fault) if args.fault else contextlib.nullcontext()
        with contextlib.redirect_stdout(out), fault:
            rc = harness.main(
                ["--workload", args.workload, "--seed", seed, "--seconds",
                 args.seconds, "--trace", "0"], root=root,
                t_start=time.perf_counter(), system=system)
        lines = out.getvalue().strip().splitlines()
        res = json.loads(lines[-1]) if rc == 0 and lines else None
        print(json.dumps({"workload": args.workload, "seed": seed, "rc": rc,
                          "control": args.fault or
                          ("float8" if serve else "stale map"),
                          "correct": None if res is None else res["correct"],
                          "checks": None if res is None else res["checks"]}),
              flush=True)
        failed_all &= res is None or not res["correct"]
    return 0 if failed_all else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
