"""``device_idle_pct.dmc``: the share of the traced DMC blocks in which no
kernel, copy or set ran on the card, from the trace's own timeline:
100 (1 - union of the device's intervals / the traced span)."""


def read(trace, cell):
    if trace["window_s"] <= 0 or trace["launches"] == 0:
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])
