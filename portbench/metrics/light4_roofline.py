"""kernels: kernel 4's (csrc/light_fused.cu `light_kernel`, the temporal
lighting) share of its bound over the profiled span: the sum of each
call's bound (portbench/bounds/light4.py; the call's validation and
tracking from its template arguments <VALIDATION, TRACK_DE, TRACK_IND>)
over the sum of the calls' device times."""

import re

from portbench.bounds import light4

NAME = re.compile(r"light_kernel<\s*(true|false)\s*,\s*(true|false)\s*,"
                  r"\s*(true|false)\s*>")


def read(ctx):
    f = ctx.facts
    bound, ns = 0.0, 0
    for a in ctx.device:
        m = NAME.search(a.name) if a.kind == "kernel" else None
        if m is None:
            continue
        v, de, ind = (g == "true" for g in m.groups())
        ms, _ = light4.call_bound_ms(
            ctx.domains["render"], f["n_tri"], f["n_em_tri"], f["has_sun"],
            f["n_em"], f["bounces"],
            (v and f["has_sun"], v and f["n_em"] > 0), de, ind)
        bound += ms
        ns += a.end - a.start
    if ns <= 0:
        return None
    return 100.0 * bound / (ns / 1e6)
