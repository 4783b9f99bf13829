"""The coset LDEs' share of their roofline: the least time of every LDE the
window's proves ran (each call's height, width and blowup,
`yardstick.bounds.lde_least_ms`) over the device time of the kernels
launched inside the benchmark's range around `TwoAdicFriPcs._lde`."""

from benchmark.yardstick.bounds import lde_least_ms


def read(ctx):
    device_s = ctx.range_kernel_s("bench/lde")
    if not device_s or not ctx.calls["lde"]:
        return None
    least_s = sum(lde_least_ms(*call) for call in ctx.calls["lde"]) * 1e-3
    return 100.0 * least_s / device_s
