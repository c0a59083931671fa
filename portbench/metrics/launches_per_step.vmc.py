"""``launches_per_step.vmc``: the kernels, copies and sets the card ran in
the traced VMC blocks, per step."""


def read(trace, cell):
    if trace["steps"] <= 0 or trace["launches"] == 0:
        return None
    return trace["launches"] / trace["steps"]
