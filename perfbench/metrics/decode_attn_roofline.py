"""decode_attn_roofline: each flash-decode call's least time by its shapes
and cached length (the frozen ``cost.decode_work``) over the device time
of everything launched inside the call, summed over the profiled slice."""

from perfbench import cost


def read(layer):
    calls = layer.get("decode")
    if not calls or layer["device_kind"] not in cost.PEAKS:
        return None
    kind, T = layer["device_kind"], layer["config"]["max_seq"]
    bound = 0.0
    for ((B, K, G, D), el, pos), _ in calls:
        bound += cost.bound_s(*cost.decode_work([min(pos + 1, T)] * B, K, G,
                                                D, el), kind)
    device = sum(s for _, s in calls)
    return 100.0 * bound / device if device > 0 else None
