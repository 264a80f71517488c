"""device_idle_share.train: the share of the profiled train steps in which
no kernel, copy or fill ran on the card."""


def read(layer):
    if layer.get("kind") != "train" or not layer.get("window_s"):
        return None
    if layer["device_kind"] == "cpu":
        return None
    return 100.0 * (1.0 - layer["busy_s"] / layer["window_s"])
