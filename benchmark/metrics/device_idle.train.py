"""The device's idle share of a training step, in %: 1 - (the device's
busy seconds per step in the traced window) / (the wall seconds per step
of the same run's untraced window)."""


def read(record: dict):
    return 100.0 * (1.0 - record["busy_s"] / record["steps"]
                    / record["step_s"])
