"""The device taptree commits' share of their roofline: the least time of
every SHA-256 compression and TapBranch node of the window's device
commits (leaves, repetitions and shards of each call,
`yardstick.bounds.commit_least_ms`) over the device time of the kernels
launched inside the benchmark's range around `TCS._commit_device`."""

from benchmark.yardstick.bounds import commit_least_ms


def read(ctx):
    device_s = ctx.range_kernel_s("bench/commit")
    if not device_s or not ctx.calls["commit"]:
        return None
    least_s = sum(commit_least_ms(*call) for call in ctx.calls["commit"]) * 1e-3
    return 100.0 * least_s / device_s
