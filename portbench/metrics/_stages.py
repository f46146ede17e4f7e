"""Shared by the stage readers: the window requests' ``stage_times`` (a
traced closed-loop run passes the dict to ``pipeline.generate``)."""


def stage_values(ctx, name):
    out = []
    for r in ctx.requests:
        v = (r.get("stages") or {}).get(name)
        if v is not None:
            out.extend(v if isinstance(v, list) else [v])
    return out


def mean_ms(ctx, name):
    vals = stage_values(ctx, name)
    return 1e3 * sum(vals) / len(vals) if vals else None
