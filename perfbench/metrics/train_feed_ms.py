"""train_feed_ms: per step of the window, its wall time less the step's
compute (``StepStats.compute_s``): what the loader, the device feed and
the loop add between steps; the window's steps outside the profiled
ones."""


def read(layer):
    if layer.get("kind") != "train" or not layer["compute_s"]:
        return None
    n = len(layer["compute_s"])
    return 1e3 * (sum(layer["wall_s"]) - sum(layer["compute_s"])) / n
