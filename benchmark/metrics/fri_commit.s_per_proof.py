"""Seconds a proof in the FRI commit phase (the port's span
fri/commit-phase: every layer's commit, fold and transcript step)."""


def read(ctx):
    return ctx.span_s_per_proof("fri/commit-phase")
