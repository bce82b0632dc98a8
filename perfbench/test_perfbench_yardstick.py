"""The frozen yardstick held to hand counts at small shapes."""
from __future__ import annotations

import pytest
import torch

from perfbench.yardstick import model_flops, peaks
from perfbench.yardstick.blocks import moe as moe_block
from perfbench.yardstick import kernels
from perfbench.yardstick.kernels import flash, moe_gemm, wkv6
from perfbench.yardstick.zipf import ZipfSampler

TINY_MOE = {"block_pattern": ["moe"], "num_layers": 2, "d_model": 8,
            "num_heads": 2, "num_kv_heads": 1, "head_dim": 4, "d_ff": 16,
            "vocab_size": 10, "num_experts": 4, "top_k": 2, "moe_d_ff": 3,
            "capacity_factor": 1.25}
TINY_RWKV = {"block_pattern": ["rwkv6"], "num_layers": 3, "d_model": 8,
             "head_dim": 4, "d_ff": 12, "vocab_size": 10, "mix_lora": 2,
             "decay_lora": 3}


def test_peaks_and_bound():
    assert peaks.BF16_FLOPS == 989e12 and peaks.HBM_BYTES_PER_S == 3.35e12
    assert peaks.bound_s(989e12, 0) == 1.0
    assert peaks.bound_s(0, 3.35e12) == 1.0
    assert peaks.bound_s(989e9, 3.35e12) == 1.0


def test_flash_counts_by_hand():
    # 1 sequence of 4, 2 q heads on 1 kv head of 8: 10 causal pairs
    base = dict(batch=1, q_len=4, kv_len=4, heads=2, kv_heads=1, head_dim=8,
                causal=True, bytes_per_value=2)
    f, b = flash.work(dict(base, lse=False, **{"pass": "fwd"}))
    assert f == 4 * 2 * 8 * 10                     # QK^T and PV, 2 FLOPs each
    assert b == 2 * (64 + 32 + 32 + 64)           # q, k, v read, o written
    f, b = flash.work(dict(base, lse=True, **{"pass": "fwd"}))
    assert b == 384 + 4 * 2 * 4                   # one float32 lse a row
    f, b = flash.work(dict(base, lse=True, **{"pass": "bwd"}))
    assert f == 10 * 2 * 8 * 10 + 2 * 64          # 5 products, rowsum(dO o O)
    assert b == 2 * (3 * 64 + 64) + 32 + 2 * (64 + 64)
    f, _ = flash.work(dict(base, causal=False, lse=False, **{"pass": "fwd"}))
    assert f == 4 * 2 * 8 * 16


def test_expert_gemm_counts_by_hand():
    launch = dict(kept=10, experts=2, d_in=4, d_out=3, bytes_per_value=2)
    assert moe_gemm.work(dict(launch, **{"pass": "fwd"})) == (
        240.0, 2.0 * (40 + 24 + 30))
    assert moe_gemm.work(dict(launch, **{"pass": "bwd_dx"})) == (
        240.0, 2.0 * (30 + 24 + 40))
    assert moe_gemm.work(dict(launch, **{"pass": "bwd_dw"})) == (
        240.0, 2.0 * (40 + 30 + 24))


def test_wkv6_counts_by_hand():
    f, b = wkv6.work(dict(batch=1, seq=2, heads=1, head_dim=2,
                          bytes_per_value=2, **{"pass": "fwd"}))
    assert f == 4 * 2 * 2 * 2
    # r, k, v (bf16), log_w (f32), u (f32), y (bf16), final state (f32)
    assert b == 3 * 2 * 4 + 4 * 4 + 4 * 2 + 2 * 4 + 4 * 4
    # the bound column's figures at (4, 512, 64, 64)
    assert wkv6.work(dict(batch=4, seq=512, heads=64, head_dim=64,
                          bytes_per_value=2, **{"pass": "fwd"})) == (
        2147483648.0, 104873984.0)


def test_moe_block_by_hand():
    # q 8x2x4, k and v 8x1x4 each, o 2x4x8; router 8x4; 2 experts x 3 x 8x3
    assert model_flops.block("moe").matmul_macs(TINY_MOE) == \
        64 + 64 + 64 + 32 + 2 * 3 * 24
    assert model_flops.block("moe").attention_macs(TINY_MOE, 3, 3) == \
        2 * 2 * 4 * 6
    assert moe_block.capacity(TINY_MOE, 16) == 16   # ceil8(11) = 16, at most T
    assert moe_block.capacity(TINY_MOE, 64) == 48   # ceil8(41)


def test_rwkv6_block_by_hand():
    time_mix = 5 * 64 + 8 * 10 + 10 * 8 + 8 * 3 + 3 * 8
    channel_mix = 8 * 12 + 12 * 8 + 64
    assert model_flops.block("rwkv6").matmul_macs(TINY_RWKV) == \
        time_mix + channel_mix
    assert model_flops.block("rwkv6").attention_macs(TINY_RWKV, 5, 5) == 0


def test_model_flops_by_hand():
    body = 2 * (64 * 3 + 32 + 144)
    head = 8 * 10
    attn = 2 * (2 * 2 * 4 * 10)                   # 2 layers, 4 positions
    assert model_flops.train_step_flops(TINY_MOE, 1, 4) == \
        6 * (body + head) * 4 + 3 * 2 * attn
    assert model_flops.prefill_flops(TINY_MOE, 1, 4) == \
        2 * body * 4 + 2 * head + 2 * attn
    # a decode step after 4 cached positions reads 5
    assert model_flops.decode_step_flops(TINY_MOE, 1, 4) == \
        2 * (body + head) + 2 * 2 * (2 * 2 * 4 * 5)
    assert model_flops.serve_batch_flops(TINY_MOE, 1, 4, 3) == (
        model_flops.prefill_flops(TINY_MOE, 1, 4)
        + model_flops.decode_step_flops(TINY_MOE, 1, 4)
        + model_flops.decode_step_flops(TINY_MOE, 1, 5))


def test_zipf_sampler_follows_the_law():
    gen = torch.Generator().manual_seed(5)
    z = ZipfSampler(50, 1.1, gen, "cpu")
    assert sorted(z.ids.tolist()) == list(range(50))
    ids = z.sample((200_000,))
    assert ids.min() >= 0 and ids.max() < 50
    counts = torch.bincount(ids, minlength=50).double()
    by_rank = counts[z.ids]
    p = torch.arange(1, 51, dtype=torch.float64) ** -1.1
    p = p / p.sum()
    assert torch.allclose(by_rank / by_rank.sum(), p, atol=3e-3)


def test_zipf_sampler_is_a_function_of_the_seed():
    def draw(seed):
        z = ZipfSampler(1000, 1.1, torch.Generator().manual_seed(seed), "cpu")
        return z.sample((4, 16))
    assert torch.equal(draw(2 ** 33 + 1), draw(2 ** 33 + 1))
    assert not torch.equal(draw(1), draw(2))


@pytest.mark.parametrize("bad", [(0, 1.1), (10, 0.0)])
def test_zipf_sampler_refuses_nonsense(bad):
    with pytest.raises(ValueError):
        ZipfSampler(*bad, torch.Generator(), "cpu")


def test_wkv6_backward_counts_by_hand():
    f, b = wkv6.work(dict(batch=1, seq=2, heads=1, head_dim=2,
                          bytes_per_value=2, **{"pass": "bwd"}))
    assert f == 12 * 2 * 2 * 2
    # r, k, v, dy read and dr, dk, dv written (bf16); log_w and u read,
    # dlog_w and du written (f32)
    assert b == 7 * 2 * 4 + 4 * 4 + 4 * 2 + 4 * 4 + 4 * 2
    # at (4, 512, 64, 64): 6.44 GFLOP and 184.6 MB, as the kernel table has
    vals = 4 * 512 * 64 * 64
    assert wkv6.work(dict(batch=4, seq=512, heads=64, head_dim=64,
                          bytes_per_value=2, **{"pass": "bwd"})) == (
        12.0 * vals * 64, 7.0 * 2 * vals + 8 * vals + 8 * 64 * 64)


def _prefill(batch, seq):
    return dict(phase="prefill", batch=batch, seq=seq, bytes_per_value=2)


def _decode(batch, pos, steps):
    return dict(phase="decode", batch=batch, pos=pos, steps=steps,
                bytes_per_value=2)


def _train(batch, seq, **kw):
    return dict(phase="train", batch=batch, seq=seq, bytes_per_value=2, **kw)


TINY_ATTN = dict(TINY_MOE, block_pattern=["attn"])


def test_families_are_found_by_name():
    assert kernels.families() == ["flash", "moe_gemm", "wkv6"]
    for name in kernels.families():
        fam = kernels.family(name)
        assert set(fam.COUNTERS) == {"fwd", "bwd"}
        assert fam.NAMES and fam.PEAK_FLOPS in (peaks.BF16_FLOPS,
                                                peaks.FP32_FLOPS)


def test_flash_launches_from_the_work():
    work = [_prefill(2, 5), _decode(2, 5, 4), _prefill(2, 3)]
    got = flash.launches(TINY_ATTN, work, {"fwd": 4, "bwd": 0})
    assert [(n, x["q_len"], x["pass"], x["lse"]) for n, x in got] == [
        (2, 5, "fwd", False), (2, 3, "fwd", False)]
    # training under remat: two forwards (one with the log-sum-exp) and a
    # backward a layer
    got = flash.launches(TINY_ATTN, [_train(1, 4)], {"fwd": 4, "bwd": 2})
    assert sorted((n, x["pass"], x["lse"]) for n, x in got) == [
        (2, "bwd", True), (2, "fwd", False), (2, "fwd", True)]
    for counts in ({"fwd": 3, "bwd": 0}, {"fwd": 4, "bwd": 1}):
        with pytest.raises(kernels.Mismatch):
            flash.launches(TINY_ATTN, work, counts)
    # a model without attention launches none
    assert flash.launches(TINY_RWKV, work, {"fwd": 0, "bwd": 0}) == []


def test_wkv6_launches_from_the_work():
    work = [_prefill(2, 7), _decode(2, 7, 3)]
    (n, x), = wkv6.launches(TINY_RWKV, work, {"fwd": 3, "bwd": 0})
    assert n == 3 and (x["batch"], x["seq"], x["heads"], x["head_dim"]) == (
        2, 7, 2, 4)
    got = wkv6.launches(TINY_RWKV, [_train(2, 8)], {"fwd": 3, "bwd": 3})
    assert sorted((n, x["pass"]) for n, x in got) == [(3, "bwd"), (3, "fwd")]
    with pytest.raises(kernels.Mismatch):
        wkv6.launches(TINY_RWKV, work, {"fwd": 0, "bwd": 0})


def test_moe_gemm_launches_need_the_kept_tokens():
    with pytest.raises(kernels.Mismatch):
        moe_gemm.launches(TINY_MOE, [_prefill(1, 4)], {"fwd": 6, "bwd": 0})
    got = moe_gemm.launches(TINY_MOE, [_train(1, 4, kept=[6, 7])],
                            {"fwd": 12, "bwd": 12})
    assert sum(n for n, x in got if x["pass"] == "fwd") == 12
    assert {x["kept"] for _, x in got} == {6, 7}
    assert moe_gemm.launches(TINY_RWKV, [_prefill(1, 4)],
                             {"fwd": 0, "bwd": 0}) == []


def test_kernel_roofline_reads_any_family_from_its_manifest_params():
    from perfbench.readers import kernel_roofline
    work = [_prefill(2, 5), _decode(2, 5, 4)]
    launched = flash.launches(TINY_ATTN, work, {"fwd": 2, "bwd": 0})
    bound = sum(n * peaks.bound_s(*flash.work(x)) for n, x in launched)
    record = {"model": TINY_ATTN, "work": work,
              "launch_counts": {"flash": {"fwd": 2, "bwd": 0}},
              "kernels": {"flash_bf16_kernel<128>": {"count": 2,
                                                     "seconds": 4 * bound},
                          "wkv6_kernel": {"count": 1, "seconds": 1.0}}}
    assert kernel_roofline.read(record, {"family": "flash"}) == \
        pytest.approx(25.0)
    record["launch_counts"]["flash"]["fwd"] = 3
    assert kernel_roofline.read(record, {"family": "flash"}) is None


def test_every_familys_counters_are_read():
    from perfbench.drivers import launch_counts, launches_since
    before = launch_counts()
    assert set(before) == set(kernels.families())
    assert all(set(v) == {"fwd", "bwd"} for v in before.values())
    assert launches_since(before) == {
        f: {"fwd": 0, "bwd": 0} for f in kernels.families()}
