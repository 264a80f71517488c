"""token_gap_p95_ms: the 95th percentile of the gaps between consecutive
served tokens of a request, over the window's steps before the profiled
slice (host clock; the profiler holds the host once it starts)."""

from perfbench import trace


def read(layer):
    if layer.get("kind") != "serve" or not layer["gaps"]:
        return None
    return 1e3 * trace.percentile(layer["gaps"], 95)
