"""Seconds a proof in the PCS open outside the FRI spans it holds: the
span prove/open less fri/commit-phase, fri/grind, fri/path-prefetch and
fri/queries (the opened values and the reduced opening)."""


def read(ctx):
    total = ctx.span_s_per_proof("prove/open")
    inner = ctx.span_s_per_proof("fri/commit-phase", "fri/grind", "fri/path-prefetch", "fri/queries")
    if total is None or inner is None:
        return None
    return total - inner
