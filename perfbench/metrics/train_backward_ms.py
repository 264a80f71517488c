"""train_backward_ms: the device ms per profiled train step of what was
launched inside the program's ``train.backward`` spans (``autograd.grad``:
the remat recompute and the backward; device trace)."""

from perfbench import spans


def read(layer):
    return spans.per_step_ms(layer, "train", "train.backward")
