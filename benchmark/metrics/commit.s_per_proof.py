"""Seconds a proof in the trace and quotient commits (the port's spans
prove/commit-trace and prove/commit-quotient: coset LDE, Winternitz keygen,
the device taptree commit)."""


def read(ctx):
    return ctx.span_s_per_proof("prove/commit-trace", "prove/commit-quotient")
