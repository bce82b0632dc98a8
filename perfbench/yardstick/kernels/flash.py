"""Flash attention, forward and backward (``csrc/flash_attention*.cu``).

A launch is ``{"pass", "batch", "q_len", "kv_len", "heads", "kv_heads",
"head_dim", "causal", "lse", "bytes_per_value"}``.  Forward: scores and
weighted sums, 4 * H * hd a kept (query, key) pair; reads q, k, v, writes o
(and, with ``lse``, one float32 log-sum-exp a row).  Backward: the scores
again, dP, dV, dK and dQ, 10 * H * hd a pair, plus rowsum(dO o O); reads q,
k, v, o, dO and the log-sum-exp, writes dq, dk, dv.

Launches: a prefill runs one forward a full-attention layer (no
log-sum-exp); a decode step none (one query row over the cache is plain
torch); a training step one forward with the log-sum-exp, under remat a
second without it before, and one backward, a layer."""
from perfbench.yardstick import kernels, peaks

NAMES = ("flash_bf16_kernel", "flash_fwd_kernel", "bwd_delta_tc",
         "bwd_dkdv_tc", "bwd_dq_tc", "bwd_prep_kernel", "bwd_dkdv_kernel",
         "bwd_dq_kernel", "bwd_dkdv_sum256")
COUNTERS = {"fwd": "repro_torch.kernels.flash.kernel:LAUNCHES",
            "bwd": "repro_torch.kernels.flash.kernel:BWD_LAUNCHES"}
PEAK_FLOPS = peaks.BF16_FLOPS
#: block kinds with full causal attention
KINDS = ("attn", "moe")


def pairs(q_len: int, kv_len: int, causal: bool) -> int:
    if causal:
        if q_len != kv_len:
            raise ValueError("causal flash counted for Sq == Skv only")
        return q_len * (q_len + 1) // 2
    return q_len * kv_len


def work(launch):
    b, sq, skv = launch["batch"], launch["q_len"], launch["kv_len"]
    h, hkv, hd = launch["heads"], launch["kv_heads"], launch["head_dim"]
    e = launch["bytes_per_value"]
    n = b * h * hd * pairs(sq, skv, launch["causal"])
    q_vals = b * sq * h * hd
    kv_vals = 2 * b * skv * hkv * hd
    lse = 4 * b * h * sq
    if launch["pass"] == "fwd":
        flops = 4 * n
        nbytes = e * (2 * q_vals + kv_vals) + (lse if launch["lse"] else 0)
    else:
        flops = 10 * n + 2 * q_vals
        # read q, o, dO, k, v and the lse; write dq, dk, dv
        nbytes = e * (3 * q_vals + kv_vals) + lse + e * (q_vals + kv_vals)
    return float(flops), float(nbytes)


def launches(m, work_done, counts):
    if kernels.layers(m, ("local_attn",)):
        raise kernels.Mismatch("flash: windowed attention is not counted")
    n = kernels.layers(m, KINDS)

    def launch(w, pass_, lse):
        return dict(batch=w["batch"], q_len=w["seq"], kv_len=w["seq"],
                    heads=m["num_heads"], kv_heads=m["num_kv_heads"],
                    head_dim=m["head_dim"], causal=True, lse=lse,
                    bytes_per_value=w["bytes_per_value"], **{"pass": pass_})

    pre = kernels.phases(work_done, "prefill")
    train = kernels.phases(work_done, "train")
    out = [(n, launch(w, "fwd", False)) for w in pre] if n else []
    if train and n:
        per = kernels.passes_per_call(counts.get("fwd", 0) - n * len(pre),
                                      n * len(train), "flash fwd in training")
        for w in train:
            out.append((n, launch(w, "fwd", True)))
            out.append((n * (per - 1), launch(w, "fwd", False)))
            out.append((n, launch(w, "bwd", True)))
    want = {p: sum(k for k, x in out if x["pass"] == p)
            for p in ("fwd", "bwd")}
    kernels.check(counts, want, "flash")
    return [(k, x) for k, x in out if k]
