"""The share of the traced window in which nothing ran on the card, in %."""


def read(record, params):
    if not record.get("window_s"):
        return None
    return 100.0 * (1.0 - record["busy_s"] / record["window_s"])
