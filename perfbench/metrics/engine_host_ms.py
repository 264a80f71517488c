"""engine_host_ms: the mean, over the window's steps before the profiled
slice, of the host ms of ``engine.admit``, ``engine.upload`` and
``engine.emit`` (the program's spans, host clock): the engine's own
bookkeeping, through which the card waits."""

from perfbench import spans


def read(layer):
    if layer.get("kind") != "serve" or not layer.get("spans"):
        return None
    return spans.child_ms(layer["spans"], spans.steps_before(layer, None),
                          ("engine.admit", "engine.upload", "engine.emit"))
