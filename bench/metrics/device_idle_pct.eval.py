"""Device, eval cells: the share of the window in which no operation ran on
the card (the union of device intervals of every stream), in %."""


def read(records: dict):
    dev = records.get("device")
    if records.get("kind") != "eval" or not dev:
        return None
    return 100.0 * (1.0 - dev["busy_s"] / dev["window_s"])
