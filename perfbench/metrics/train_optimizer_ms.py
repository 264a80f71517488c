"""train_optimizer_ms: the device ms per profiled train step of what was
launched inside the program's ``train.optimizer`` spans (``adamw_update``;
device trace)."""

from perfbench import spans


def read(layer):
    return spans.per_step_ms(layer, "train", "train.optimizer")
