"""Device events (kernels, copies, sets) of the traced slice a train step."""


def read(info: dict):
    t, steps = info["trace"], info["counts"].get("steps")
    if t is None or not steps:
        return None
    return t["device_events"] / steps
