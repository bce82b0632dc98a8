"""One reader a kind of per-layer metric (``readers/<reader>.py``), named by
a metric's manifest ``metrics/<metric>.json`` together with its parameters.
``read(record, params)`` takes a traced run's record (``spans``,
``counters``, ``launches``, and the trace's ``window_s``, ``busy_s`` and
``kernels``) and returns the metric's value, or None where the run holds
nothing for it to read (then the metric is left out of the result)."""
