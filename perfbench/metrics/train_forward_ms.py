"""train_forward_ms: the device ms per profiled train step of what was
launched inside the program's ``train.forward`` spans (``train_loss``,
the forward; device trace)."""

from perfbench import spans


def read(layer):
    return spans.per_step_ms(layer, "train", "train.forward")
