"""serve_mfu: model FLOPs of the engine's steps over their host-clock time,
as a share of the card's bf16 peak (the steps before the profiled slice)."""

from perfbench import cost


def read(layer):
    if layer.get("kind") != "serve" or not layer["step_s"] \
            or layer["device_kind"] not in cost.PEAKS:
        return None
    c, slots = layer["config"], layer["slots"]
    flops = sum(cost.serve_step_flops(c, slots, n) for n in layer["step_len"])
    peak = cost.peak(layer["device_kind"])["bf16_flops"]
    return 100.0 * flops / sum(layer["step_s"]) / peak
