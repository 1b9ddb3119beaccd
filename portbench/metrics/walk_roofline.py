"""kernels: kernel 13's (csrc/trace_bvh.cu `bvh_kernel`) share of its
bytes bound over the profiled span: the sum of the bounds of the calls the
profiled frames make (the configuration's table, portbench/bounds/
walk_calls/<config>.json) over the sum of the kernel's device times. A
lower estimate: the bound leaves out the walk's operations
(portbench/bounds/walk.py). Where the traced launches are not the calls
the table gives, the table no longer describes the program: the reader
raises rather than bound calls that did not run."""

from portbench.bounds import walk


def read(ctx):
    calls = walk.calls_of(ctx.config["name"])
    launches = [a for a in ctx.device
                if a.kind == "kernel" and "bvh_kernel" in a.name]
    if calls is None or not launches:
        return None
    planned = [c for f in ctx.frames
               for c in walk.frame_calls(calls, f, *ctx.intervals,
                                         ctx.domains)]
    if len(planned) != len(launches):
        raise ValueError(
            f"kernel 13: {len(launches)} launches traced over frames "
            f"{ctx.frames[0]}..{ctx.frames[-1]}, but the call table of "
            f"{ctx.config['name']!r} gives {len(planned)}")
    bound = sum(walk.call_bound_ms(mode, rays, ctx.table_words)
                for mode, rays in planned)
    ns = sum(a.end - a.start for a in launches)
    return 100.0 * bound / (ns / 1e6)
