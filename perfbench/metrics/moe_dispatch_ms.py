"""moe_dispatch_ms: the device ms per profiled engine step of what was
launched inside the program's ``moe`` spans and outside their
``moe.experts`` spans (route, sort, gather, combine; device trace)."""

from perfbench import spans


def read(layer):
    return spans.per_step_ms(layer, "serve", "moe", "self_device_s")
