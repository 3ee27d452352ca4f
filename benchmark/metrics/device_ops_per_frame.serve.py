"""Device operations (kernels, copies, sets) per served frame in the
traced window: a count, the launches the host pays for."""


def read(record: dict):
    return record["device_ops"] / record["frames"]
