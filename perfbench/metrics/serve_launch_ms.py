"""serve_launch_ms: the mean ``engine.forward`` duration over the window's
steps before the profiled slice (the program's span, host clock): the host
time spent issuing the forward's launches."""

from perfbench import spans


def read(layer):
    if layer.get("kind") != "serve" or not layer.get("spans"):
        return None
    return spans.child_ms(layer["spans"], spans.steps_before(layer, None),
                          ("engine.forward",))
