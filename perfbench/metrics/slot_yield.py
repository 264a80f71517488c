"""slot_yield: the engine's ``tokens_out`` over its ``slot_steps`` through
the window (the program's counters), as a share: the slot-steps that
served a token."""


def read(layer):
    c = layer.get("counters")
    if layer.get("kind") != "serve" or not c or not c.get("slot_steps"):
        return None
    return 100.0 * c["tokens_out"] / c["slot_steps"]
