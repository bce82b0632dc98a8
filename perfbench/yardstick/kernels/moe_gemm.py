"""The expert GEMM, forward and backward (``csrc/moe_gemm.cu``).

A launch is ``{"pass", "kept", "experts", "d_in", "d_out",
"bytes_per_value"}``: ``kept`` the tokens all experts keep together (no
capacity padding), the products (E, C, d_in) x (E, d_in, d_out).  Forward:
2 * kept * d_in * d_out FLOPs; reads the kept rows and every expert's
weight, writes the kept rows' outputs.  A backward launch (``pass`` is
``"bwd_dx"`` or ``"bwd_dw"``) does as many FLOPs: dX reads dY and the
weights and writes dX; dW reads x and dY and writes dW.

Launches: a mixture-of-experts layer runs three forward products (gate, up,
down) a pass, and a training step dX and dW of each.  The kept tokens come
from the router, so only work that says how many each layer kept
(``"kept"``, a training step's) is counted; a prefill or decode step of a
mixture of experts is not, and raises."""
from perfbench.yardstick import kernels, peaks

NAMES = ("expert_gemm_tma_kernel", "expert_gemm_bf16_kernel",
         "expert_gemm_f32_kernel")
COUNTERS = {"fwd": "repro_torch.kernels.moe_gemm.kernel:LAUNCHES",
            "bwd": "repro_torch.kernels.moe_gemm.kernel:BWD_LAUNCHES"}
PEAK_FLOPS = peaks.BF16_FLOPS
KINDS = ("moe",)


def work(launch):
    kept, e = launch["kept"], launch["experts"]
    d_in, d_out = launch["d_in"], launch["d_out"]
    size = launch["bytes_per_value"]
    flops = 2.0 * kept * d_in * d_out
    rows_in, rows_out, weights = kept * d_in, kept * d_out, e * d_in * d_out
    if launch["pass"] == "fwd":
        nbytes = rows_in + weights + rows_out
    elif launch["pass"] == "bwd_dx":
        nbytes = rows_out + weights + rows_in
    elif launch["pass"] == "bwd_dw":
        nbytes = rows_in + rows_out + weights
    else:
        raise ValueError(launch["pass"])
    return flops, float(size * nbytes)


def launches(m, work_done, counts):
    n = kernels.layers(m, KINDS)
    if not n or not work_done:
        kernels.check(counts, {"fwd": 0, "bwd": 0}, "moe_gemm")
        return []
    if any(w["phase"] != "train" or "kept" not in w for w in work_done):
        raise kernels.Mismatch("moe_gemm: only training steps that say how "
                               "many tokens each layer kept are counted")
    per = kernels.passes_per_call(counts.get("fwd", 0), 3 * n * len(work_done),
                                  "moe_gemm fwd in training")
    d, f, e = m["d_model"], m["moe_d_ff"], m["num_experts"]
    out = []
    for w in work_done:
        for kept in w["kept"]:
            for d_in, d_out in ((d, f), (d, f), (f, d)):
                base = dict(kept=int(kept), experts=e, d_in=d_in, d_out=d_out,
                            bytes_per_value=w["bytes_per_value"])
                out.append((per, dict(base, **{"pass": "fwd"})))
                out.append((1, dict(base, **{"pass": "bwd_dx"})))
                out.append((1, dict(base, **{"pass": "bwd_dw"})))
    kernels.check(counts, {"fwd": sum(k for k, x in out if x["pass"] == "fwd"),
                           "bwd": sum(k for k, x in out if x["pass"] != "fwd")},
                  "moe_gemm")
    return out
