"""gmm_roofline: each grouped-matmul call's least time by its shapes (the
frozen ``cost.gmm_work``) over the device time of everything launched
inside the call, summed over the profiled slice."""

from perfbench import cost


def read(layer):
    calls = layer.get("gmm")
    if not calls or layer["device_kind"] not in cost.PEAKS:
        return None
    kind = layer["device_kind"]
    bound = sum(cost.bound_s(*cost.gmm_work(E, C, d, f, el), kind)
                for ((E, C, d), f, el), _ in calls)
    device = sum(s for _, s in calls)
    return 100.0 * bound / device if device > 0 else None
