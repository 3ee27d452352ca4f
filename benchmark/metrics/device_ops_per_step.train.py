"""Device operations (kernels, copies, sets) per training step in the
traced window: a count, the launches the host pays for."""


def read(record: dict):
    return record["device_ops"] / record["steps"]
