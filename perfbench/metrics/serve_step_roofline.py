"""serve_step_roofline: the engine step's least time on the card (the larger
of its model FLOPs over the bf16 peak and its bytes over the memory rate)
over its host-clock time (the steps before the profiled slice)."""

from perfbench import cost


def read(layer):
    if layer.get("kind") != "serve" or not layer["step_s"] \
            or layer["device_kind"] not in cost.PEAKS:
        return None
    c, slots, kind = layer["config"], layer["slots"], layer["device_kind"]
    bound = sum(cost.bound_s(cost.serve_step_flops(c, slots, n),
                             cost.serve_step_bytes(c, slots, n), kind)
                for n in layer["step_len"])
    return 100.0 * bound / sum(layer["step_s"])
