"""launches_per_step (launcher and executor: host dispatch): device
operations (kernels, copies, fills) in the traced sub-window over its
steps."""


def read(rec):
    if not rec["kernels"]:
        return None
    return rec["launches"] / rec["steps"]
