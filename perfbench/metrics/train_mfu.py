"""train_mfu: model FLOPs of a train step (nothing recomputed counted)
over the mean step compute time (``StepStats.compute_s``, host clock
around the synchronised step), as a share of the card's bf16 peak; the
window's steps outside the profiled ones."""

from perfbench import cost


def read(layer):
    if layer.get("kind") != "train" or not layer["compute_s"] \
            or layer["device_kind"] not in cost.PEAKS:
        return None
    flops = cost.train_step_flops(layer["config"], layer["rows"],
                                  layer["seq"])
    mean = sum(layer["compute_s"]) / len(layer["compute_s"])
    return 100.0 * flops / mean / cost.peak(layer["device_kind"])["bf16_flops"]
