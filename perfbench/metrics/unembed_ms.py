"""unembed_ms: the device ms per profiled engine step of what was launched
inside the program's ``unembed`` spans (the f32 cast and GEMM; device
trace)."""

from perfbench import spans


def read(layer):
    return spans.per_step_ms(layer, "serve", "unembed")
