"""``launches_per_step.dmc``: the kernels, copies and sets the card ran in
the traced DMC blocks, per step."""


def read(trace, cell):
    if trace["steps"] <= 0 or trace["launches"] == 0:
        return None
    return trace["launches"] / trace["steps"]
