"""The mean of a span's durations over the window (``params["span"]``),
times ``params["scale"]`` (1000 for ms)."""


def read(record, params):
    values = record["spans"].get(params["span"]) or []
    if not values:
        return None
    return params.get("scale", 1.0) * sum(values) / len(values)
