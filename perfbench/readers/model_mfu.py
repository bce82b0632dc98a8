"""The whole step's share of the card's bf16 peak: the model FLOPs the
driver counted over the window (``yardstick/model_flops.py``) over the
traced window's seconds times 989e12, in %."""
from perfbench.yardstick import peaks


def read(record, params):
    flops = record["counters"].get("model_flops")
    if not flops or not record.get("window_s"):
        return None
    return 100.0 * flops / (record["window_s"] * peaks.BF16_FLOPS)
