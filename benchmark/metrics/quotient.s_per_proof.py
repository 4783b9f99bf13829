"""Seconds a proof in the constraint quotient (the port's span
prove/quotient-values: the generated quotient segments)."""


def read(ctx):
    return ctx.span_s_per_proof("prove/quotient-values")
