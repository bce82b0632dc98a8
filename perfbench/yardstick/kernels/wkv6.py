"""The WKV6 recurrence, forward and backward (``csrc/wkv6.cu``,
``csrc/wkv6_bwd.cu``), in float32 outside the tensor cores.

A launch is ``{"pass", "batch", "seq", "heads", "head_dim",
"bytes_per_value"}``.  Forward: each token and head updates the hd x hd
state (S = w o S + k v^T) and reads it out (y = r^T (S + u k v^T)): 4 hd^2
FLOPs; reads r, k, v (in the launch's dtype), log_w and u (float32); writes
y (the launch's dtype) and the final state (float32).  Backward: the three
walks for dr, dk and dv, 12 hd^2 FLOPs a token and head; reads r, k, v, dy
(the launch's dtype), log_w and u (float32); writes dr, dk, dv (the
launch's dtype), dlog_w and du (float32).

Launches: a prefill runs one forward an RWKV6 layer; a decode step none
(one token's step is plain torch); a training step one forward (two under
remat) and one backward a layer."""
from perfbench.yardstick import kernels, peaks

NAMES = ("wkv6_kernel", "wkv6_bwd")
COUNTERS = {"fwd": "repro_torch.kernels.rwkv6.kernel:LAUNCHES",
            "bwd": "repro_torch.kernels.rwkv6.kernel:BWD_LAUNCHES"}
PEAK_FLOPS = peaks.FP32_FLOPS
KINDS = ("rwkv6",)


def work(launch):
    b, s, h, hd = launch["batch"], launch["seq"], launch["heads"], \
        launch["head_dim"]
    e = launch["bytes_per_value"]
    vals = b * s * h * hd
    if launch["pass"] == "fwd":
        flops = 4.0 * vals * hd
        nbytes = 3 * e * vals + 4 * vals + 4 * h * hd + e * vals \
            + 4 * b * h * hd * hd
    elif launch["pass"] == "bwd":
        flops = 12.0 * vals * hd
        nbytes = 4 * e * vals + 4 * vals + 4 * h * hd + 3 * e * vals \
            + 4 * vals + 4 * h * hd
    else:
        raise ValueError(launch["pass"])
    return flops, float(nbytes)


def launches(m, work_done, counts):
    n = kernels.layers(m, KINDS)
    hd = m.get("rwkv_head_dim", m["head_dim"])

    def launch(w, pass_):
        return dict(batch=w["batch"], seq=w["seq"], heads=m["d_model"] // hd,
                    head_dim=hd, bytes_per_value=w["bytes_per_value"],
                    **{"pass": pass_})

    pre = kernels.phases(work_done, "prefill")
    train = kernels.phases(work_done, "train")
    out = [(n, launch(w, "fwd")) for w in pre] if n else []
    if train and n:
        per = kernels.passes_per_call(counts.get("fwd", 0) - n * len(pre),
                                      n * len(train), "wkv6 fwd in training")
        for w in train:
            out.append((n * per, launch(w, "fwd")))
            out.append((n, launch(w, "bwd")))
    want = {p: sum(k for k, x in out if x["pass"] == p)
            for p in ("fwd", "bwd")}
    kernels.check(counts, want, "wkv6")
    return [(k, x) for k, x in out if k]
