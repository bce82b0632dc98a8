"""Serving: static batches through ``launch.serve.serve_batch`` (a prefill,
then greedy decoding), closed loop, one batch in flight.

Set-up builds the model, draws the weights from the seed and the prompts
of every batch from the traffic's seed, and serves one batch at each
prompt length (every shape the window uses).  The window serves whole
cycles of the traffic's lengths, in the order drawn from the seed, until
``--seconds`` have passed: every window holds the same mix.  The first
time the window serves a prompt of the pool, the logits that the program's
prefill and decode steps return for its rows are copied to the host as
they come (no wait).  Afterwards a sample of the finished requests drawn
from the seed, one of the longest among them, is checked: the program is
freed, the plain reference runs over each prompt with its served tokens,
and two numbers are compared: the widest gap by which a served token's
logit lies below the reference's best at that position (``served_gap``),
and the widest gap between the program's log-probabilities and the
reference's over the whole vocabulary at each served position
(``logit_gap``)."""
from __future__ import annotations

import math
import time
from typing import Dict, List

import numpy as np
import torch

from perfbench import harness, seeds, traffic_gen, weights
from perfbench.drivers import (Cell, elapsed_s, free_cuda, launch_counts,
                               launches_since, peak_bytes, phase_done,
                               reset_peak, sync, timed_calls)
from perfbench.reference.common import as_float32
from perfbench.reference import precision
from perfbench.yardstick import model_flops


def _program():
    from repro_torch.launch import serve
    from repro_torch.models import model
    return serve, model


class _Logits:
    """Wraps the model's ``prefill_fn`` and ``decode_fn``: while ``slot`` is
    set, each call's last-position logits (every row) are copied into the
    host buffer ``buf[slot, call]`` as the card produces them."""

    def __init__(self, model, buf: torch.Tensor):
        self.buf, self.slot, self.call = buf, None, 0
        for attr in ("prefill_fn", "decode_fn"):
            self._wrap(model, attr)

    def _wrap(self, model, attr: str) -> None:
        inner = getattr(model, attr)

        def wrapped(*args, **kwargs):
            caches, logits = inner(*args, **kwargs)
            if self.slot is not None:
                last = logits[:, -1]
                self.buf[self.slot, self.call, :last.shape[0]].copy_(
                    last, non_blocking=True)
                self.call += 1
            return caches, logits

        setattr(model, attr, wrapped)

    def keep(self, slot) -> None:
        self.slot, self.call = slot, 0


def setup(cell: Cell) -> dict:
    serve, model_lib = _program()
    phase_done(cell, "imports")
    t, m, dev = cell.traffic, cell.model, cell.device
    dtype = getattr(torch, cell.config["program"]["dtype"])
    model = model_lib.build_model(cell.cfg, device=dev, dtype=dtype)
    layout = model_lib.abstract_params(cell.cfg, dtype)
    params = weights.draw(layout, seeds.sub_seed(cell.seed, "weights"), dev)
    n_lens = len(t["prompt_lens"])
    prompts = traffic_gen.serve_prompts(
        t, m["vocab_size"], seeds.sub_seed(cell.seed, "traffic"), dev,
        n_lens * (1 + int(t["pool_cycles"])))
    pool = prompts[n_lens:]
    # the logits of each pool prompt's first serving: the prefill's and
    # every decode step's, all rows, float32
    buf = torch.full((len(pool), 1 + int(t["max_new"]), int(t["batch"]),
                      m["vocab_size"]), float("nan"), dtype=torch.float32,
                     pin_memory=torch.device(dev).type == "cuda")
    sync(dev)
    phase_done(cell, "weights, prompts and the logits' buffer")
    for p in prompts[:n_lens]:
        serve.serve_batch(model, params, p, int(t["max_new"]))
        phase_done(cell, f"warm batch of {p.shape[1]}")
    sync(dev)
    return dict(model=model, params=params, layout=layout, prompts=pool,
                served=[], logits=buf,
                bytes_per_value=torch.empty((), dtype=dtype).element_size())


def measure(state: dict, cell: Cell, tracer) -> dict:
    serve, _ = _program()
    t, m, dev = cell.traffic, cell.model, cell.device
    model, params, prompts = state["model"], state["params"], state["prompts"]
    max_new, n_lens = int(t["max_new"]), len(t["prompt_lens"])
    keeper = _Logits(model, state["logits"])
    prefill_pairs: list = []
    decode_pairs: list = []
    if cell.trace:
        timed_calls(model, "prefill_fn", prefill_pairs, dev)
        timed_calls(model, "decode_fn", decode_pairs, dev)
    served: List[tuple] = state["served"]
    n_batches, tokens, flops, lens, work = 0, 0, 0, [], []
    e = state["bytes_per_value"]
    counts0 = launch_counts()
    sync(dev)
    reset_peak(dev)
    with tracer.window():
        t0 = time.perf_counter()
        while True:
            for _ in range(n_lens):
                i = n_batches % len(prompts)
                p = prompts[i]
                keeper.keep(i if n_batches < len(prompts) else None)
                with tracer.span("batch"):
                    out = serve.serve_batch(model, params, p, max_new)
                served.append((i, out))
                b, plen = p.shape
                tokens += b * (plen + max_new)
                flops += model_flops.serve_batch_flops(m, b, plen, max_new)
                lens.append(plen)
                work += [dict(phase="prefill", batch=b, seq=plen,
                              bytes_per_value=e),
                         dict(phase="decode", batch=b, pos=plen,
                              steps=max_new, bytes_per_value=e)]
                n_batches += 1
            if time.perf_counter() - t0 >= cell.seconds:
                break
        sync(dev)
        t1 = time.perf_counter()
    keeper.keep(None)
    peak = peak_bytes(dev)
    window = t1 - t0
    b = int(t["batch"])
    record = {"spans": {"prefill": elapsed_s(prefill_pairs),
                        "decode_step": elapsed_s(decode_pairs)},
              "counters": {"model_flops": flops},
              "model": m, "work": work,
              "launch_counts": launches_since(counts0)}
    bad = sum(int(((o < 0) | (o >= m["vocab_size"])).any(axis=1).sum())
              for _, o in served)
    print(f"serve window: {n_batches} batches of {b}, lengths {lens}, "
          f"{window} s", flush=True)
    return {
        "attempted": n_batches * b,
        "failed": bad,
        "end_to_end": {"serve_tokens_per_s": (tokens / window, "tokens/s"),
                       "peak_hbm_gb": (peak / 1e9, "GB")},
        "peak_bytes": peak,
        "record": record,
    }


def sample(state: dict, cell: Cell) -> List[tuple]:
    """(pool index, row) of the checked requests, among those of the
    prompts' first servings: one of the longest prompts, then others drawn
    uniformly from the seed, up to the traffic's ``checked_requests``."""
    rng = np.random.default_rng(seeds.sub_seed(cell.seed, "sample"))
    prompts = state["prompts"]
    first = {}
    for i, out in state["served"]:
        first.setdefault(i, out)
    done = sorted((i, r) for i, out in first.items()
                  for r in range(out.shape[0]))
    longest = max(prompts[i].shape[1] for i, _ in done)
    tops = [x for x in done if prompts[x[0]].shape[1] == longest]
    top = tops[int(rng.integers(len(tops)))]
    rest = [x for x in done if x != top]
    n = min(int(cell.traffic["checked_requests"]) - 1, len(rest))
    pick = rng.choice(len(rest), size=n, replace=False)
    return [top] + [rest[int(j)] for j in pick]


def _worse(a: float, b: float) -> float:
    """The larger of two gaps; a gap that is not a number (a row the
    program never produced) is infinite."""
    return max(a, b if math.isfinite(b) else math.inf)


def judge(state: dict, cell: Cell, prec_name: str = "fp32") -> dict:
    """Free the program, run the reference over the sampled requests;
    returns the compared numbers, ``served_gap`` and ``logit_gap``.  With
    ``prec_name`` "fp8", the control's: the reference in that precision
    put in the program's place, its first choices and its logits judged."""
    m, dev = cell.model, cell.device
    ref = harness.reference(cell.config)
    outs: Dict[int, np.ndarray] = {}
    for i, out in state["served"]:
        outs.setdefault(i, out)
    picked = sample(state, cell)
    prompts, kept = state["prompts"], state["logits"]
    for key in ("model", "params"):
        state.pop(key, None)
    free_cuda()
    precision.strict_float32()
    w = as_float32(weights.draw(
        state["layout"], seeds.sub_seed(cell.seed, "weights"), dev))
    free_cuda()
    groups: Dict[int, list] = {}
    for i, r in picked:
        groups.setdefault(prompts[i].shape[1], []).append((i, r))
    served_gap, logit_gap, n_tokens = 0.0, 0.0, 0
    for plen, reqs in sorted(groups.items()):
        served = np.stack([outs[i][r] for i, r in reqs]).astype(np.int64)
        prompt = np.stack([prompts[i][r] for i, r in reqs]).astype(np.int64)
        seq = torch.as_tensor(np.concatenate([prompt, served], 1), device=dev)
        logits = ref.logits_at(w, seq, plen - 1, m)      # (n, 1 + new, V)
        best = torch.log_softmax(logits, dim=-1)
        if prec_name == "fp32":
            judged = torch.stack([kept[i, :, r] for i, r in reqs]).to(dev)
            chosen = torch.as_tensor(served, device=dev)
        else:
            judged = ref.logits_at(w, seq, plen - 1, m,
                                   precision.Precision(prec_name))
            chosen = judged[:, :-1].argmax(-1)
        top = logits[:, :-1]
        gap = top.max(-1).values - top.gather(-1, chosen[..., None])[..., 0]
        diff = (torch.log_softmax(judged, dim=-1) - best).abs().amax()
        served_gap = _worse(served_gap, float(gap.max()))
        logit_gap = _worse(logit_gap, float(diff))
        n_tokens += served.size
        del logits, best, judged
    print(f"reference ({prec_name}): {len(picked)} requests, {n_tokens} "
          f"served tokens, lengths {sorted(groups)}", flush=True)
    return {"served_gap": served_gap, "logit_gap": logit_gap}


def control(state: dict, cell: Cell, prec_name: str = "fp8") -> dict:
    return judge(state, cell, prec_name)
