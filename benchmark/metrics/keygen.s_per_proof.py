"""Seconds a proof of host Winternitz keygen (the port's span
tcs/assign-keygen, in every commit: trace, quotient and FRI layers)."""


def read(ctx):
    return ctx.span_s_per_proof("tcs/assign-keygen")
