"""The trace reduction: busy time as a union, kernels by their launching
range, idle gaps named by the innermost host range."""

import json

from benchmark.yardstick.trace import summarize


def test_summary_of_a_small_trace(tmp_path):
    ev = [
        {"ph": "X", "cat": "user_annotation", "name": "bench/window", "ts": 0, "dur": 100, "tid": 1},
        {"ph": "X", "cat": "user_annotation", "name": "bench/lde", "ts": 10, "dur": 10, "tid": 1},
        {"ph": "X", "cat": "user_annotation", "name": "tcs/dev-trees", "ts": 40, "dur": 40, "tid": 1},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 12, "dur": 1, "tid": 1,
         "args": {"correlation": 7}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 45, "dur": 1, "tid": 1,
         "args": {"correlation": 8}},
        {"ph": "X", "cat": "kernel", "name": "k1", "ts": 14, "dur": 20, "tid": 7, "args": {"correlation": 7}},
        {"ph": "X", "cat": "kernel", "name": "k2", "ts": 30, "dur": 10, "tid": 8, "args": {"correlation": 8}},
        {"ph": "X", "cat": "gpu_memcpy", "name": "copy", "ts": 90, "dur": 20, "tid": 7},
    ]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    s = summarize(str(path), ("bench/lde", "bench/commit"))
    assert abs(s.window_s - 100e-6) < 1e-12 and s.kernels == 2
    assert abs(s.busy_s - (26 + 10) * 1e-6) < 1e-12  # [14, 40) and [90, 100)
    assert abs(s.range_kernel_s["bench/lde"] - 20e-6) < 1e-12 and s.range_kernel_s["bench/commit"] == 0
    gaps = s.idle_by_host
    assert abs(gaps["tcs/dev-trees"] - 50e-6) < 1e-12 and abs(gaps["bench/window"] - 14e-6) < 1e-12
    assert s.breakdown()["device_ops"][0][0] == "k1"
