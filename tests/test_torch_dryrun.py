"""Port parity, the dry-run: ``repro_torch.roofline`` against the JAX
package's ``roofline.py``, and the port's counts of a smoke cell against a
hand count from the shapes.

- ``model_flops`` equals the reference's bit for bit on every (arch x
  shape) cell; ``roofline_terms``, fed stats under the reference's keys and
  the reference module's own constants, equals the reference's dict.
- One subprocess (this file run as a script; the ``fake`` backend needs a
  process group of its own) counts ``qwen3-moe-smoke``'s prefill of 4 x 32
  tokens through ``launch.dryrun`` on the ``h100`` mesh and on a fake 2 x 2
  mesh, and one MoE layer on the 2 x 2 mesh alone.  The FLOPs equal the
  hand count of the layout, which splits the dense products over the model
  axis (M ranks): per layer the q and o products and the flash kernel's 4
  hd a visible pair over the rank's H / M heads, the k and v products over
  the kv heads those use, the router's product and the three expert
  products over the rank's E / M experts at the capacity of its T_loc
  tokens; the last position's unembedding over the rank's V / M
  vocabulary columns.  Its collectives by axis: on "data" one all-gather
  of every leaf's shard (FSDP) and the MoE counts' and aux loss's
  all-reduces; on "model" no leaf's gather, but the caches' kv heads and
  the last logits' vocabulary columns, and the all-reduces of the
  attention's and the embedding's (B_loc, S, d) bf16 partial sums and of
  the experts' (T_loc, d) float32 output.  The MoE layer's collectives are
  its schedule's: all-reduces of the (T_loc, d) float32 output over the
  model axis and of the counts (E,) and the aux loss over the data axis,
  and the data-axis all-gathers of the three expert shards.  A decode step
  on the 2 x 2 mesh keeps each rank's rows and quarter of the caches, and
  gathers over the model axis the caches' sequence at use, the new K/V
  row's kv heads and the logits' vocabulary columns, and no leaf.  rwkv6's and
  recurrentgemma's ``train_4k`` cells are counted at full size on
  ``h100``, each kernel's backward among the calls.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
B, S = 4, 32


def test_model_flops_match_reference_bit_for_bit():
    from repro import configs as r_configs
    from repro import roofline as r_roofline

    from repro_torch import configs, roofline
    cells = list(configs.cells())
    assert cells == list(r_configs.cells())
    for arch, shape_name in cells:
        got = roofline.model_flops(configs.get_config(arch),
                                   configs.get_shape(shape_name))
        want = r_roofline.model_flops(r_configs.get_config(arch),
                                      r_configs.get_shape(shape_name))
        assert got == want and type(got) is type(want), (arch, shape_name)


@pytest.mark.parametrize("n_chips", [1, 256, 512])
def test_roofline_terms_match_reference(n_chips):
    from repro import configs as r_configs
    from repro import roofline as r_roofline

    from repro_torch import configs, roofline
    rng = np.random.default_rng(n_chips)
    for arch, shape_name in list(configs.cells())[::3]:
        stats = {"flops": float(rng.uniform(1e12, 1e17)),
                 "bytes_accessed": float(rng.uniform(1e9, 1e14)),
                 "collective_bytes_total": int(rng.integers(0, 1e12))}
        want = r_roofline.roofline_terms(
            stats, r_configs.get_config(arch),
            r_configs.get_shape(shape_name), n_chips)
        got = roofline.roofline_terms(
            stats, configs.get_config(arch), configs.get_shape(shape_name),
            n_chips, peak=r_roofline.PEAK_FLOPS, hbm=r_roofline.HBM_BW,
            link=r_roofline.LINK_BW)
        assert got == want, (arch, shape_name)
    # the port's own constants are the H100's
    assert (roofline.PEAK_FLOPS, roofline.HBM_BW, roofline.LINK_BW) == (
        989e12, 3.35e12, 450e9)


def _count(out: str) -> None:
    import torch

    from repro_torch import configs, roofline, sharding
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.steps import lower_cell
    from repro_torch.models import moe

    cfg = configs.get_smoke_config("qwen3-moe-30b-a3b")
    shape = ShapeConfig("tiny_prefill", S, B, "prefill")
    res = {"h100": lower_cell(cfg, shape, dryrun.make_mesh("h100")).analyze()}
    dryrun.fake_world(4)
    mesh = make_local_mesh(2, 2, device="cpu")
    res["2x2"] = lower_cell(cfg, shape, mesh).analyze()
    # the bytes of every leaf's shard on the 2 x 2 mesh that has a data
    # entry (each gathered over the data axis once a prefill)
    from repro_torch.checkpoint import tree_leaves
    from repro_torch.launch.steps import tree_leaves_specs
    from repro_torch.models.model import abstract_params, param_specs
    specs = tree_leaves_specs(param_specs(cfg, mesh))
    res["data_leaf_bytes"] = sum(
        int(np.prod(sharding.local_shape(mesh, s, t.shape)))
        * t.element_size()
        for t, s in zip(tree_leaves(abstract_params(cfg)), specs,
                        strict=True) if "data" in s)
    # a decode step over a full cache on the 2 x 2 mesh: each rank's rows,
    # the cache's sequence gathered over the model axis at use
    lowered = lower_cell(cfg, ShapeConfig("tiny_decode", S, B, "decode"),
                         mesh)
    res["2x2_decode"] = dict(lowered.analyze(),
                             cache_bytes=lowered.memory["caches"])
    # one MoE layer on the 2 x 2 mesh, bf16 weights, no gradient
    axes = sharding.MeshAxes.for_mesh(mesh)
    full = moe.init_moe(None, cfg, device="meta")
    specs = {k: sharding.spec_for(mesh, axes, moe.moe_axes(cfg)[k],
                                  tuple(v.shape)) for k, v in full.items()}
    local = {k: torch.empty(sharding.local_shape(mesh, specs[k], v.shape),
                            dtype=v.dtype, device="meta")
             for k, v in full.items()}
    ctx = sharding.MeshCtx(mesh, axes, specs)
    x = torch.empty((B // 2, S, cfg.d_model), dtype=torch.bfloat16,
                    device="meta")
    with torch.no_grad(), roofline.Counter() as c:
        moe.moe_forward(dict(local, router=torch.empty(
            (cfg.d_model, cfg.num_experts), device="meta")), x, cfg, cfg.act,
            ctx=ctx, spec=specs)
    res["moe_layer"] = c.stats()
    res["expert_shard_bytes"] = sum(
        local[k].numel() * local[k].element_size()
        for k in moe.EXPERT_LEAVES)
    # the recurrent archs' train cells at full size on the card's mesh
    res["train_4k"] = {arch: dryrun.run_cell(arch, "train_4k", "h100")
                       for arch in ("rwkv6-7b", "recurrentgemma-9b")}
    Path(out).write_text(json.dumps(res))


@pytest.fixture(scope="module")
def counted(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun") / "counts.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, __file__, str(out)], env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(out.read_text())


def _hand_flops(cfg, data: int, model: int) -> int:
    """The prefill's FLOPs a rank: the dense products over its H / M
    heads (and the kv heads they use) and V / M vocabulary columns (qwen's
    smoke config divides both at M = 2)."""
    from repro_torch.models.moe import _capacity
    b = B // data
    t = b * S
    d, hd = cfg.d_model, cfg.head_dim
    h = cfg.num_heads // model
    hkv = max(1, h * cfg.num_kv_heads // cfg.num_heads)
    e_loc = cfg.num_experts // model
    pairs = S * (S + 1) // 2
    per_layer = (2 * t * d * h * hd + 2 * 2 * t * d * hkv * hd
                 + 4 * b * h * pairs * hd + 2 * t * h * hd * d
                 + 2 * t * d * cfg.num_experts
                 + 3 * 2 * e_loc * _capacity(cfg, t) * d * cfg.moe_d_ff)
    return cfg.num_layers * per_layer + 2 * b * d * cfg.vocab_size // model


@pytest.mark.parametrize("label,data,model", [("h100", 1, 1),
                                              ("2x2", 2, 2)])
def test_dryrun_flops_equal_hand_count(counted, label, data, model):
    from repro_torch import configs
    cfg = configs.get_smoke_config("qwen3-moe-30b-a3b")
    st = counted[label]
    assert st["flops"] == _hand_flops(cfg, data, model)
    assert st["kernel_calls"] == {"flash_fwd": cfg.num_layers,
                                  "expert_gemm_fwd": 3 * cfg.num_layers}
    if label == "h100":
        assert st["collective_bytes_total"] == 0
        return
    b, layers, d = B // data, cfg.num_layers, cfg.d_model
    kv_loc = cfg.num_kv_heads // model
    assert st["collective_bytes_by_axis"] == {
        "data": {"all-gather": counted["data_leaf_bytes"],
                 "all-reduce": layers * (cfg.num_experts * 4 + 4)},
        # no leaf is gathered over the model axis: the caches' kv heads
        # (bf16) and the last logits' vocabulary columns (float32) are;
        # the attention's and embedding's bf16 sums, the experts' float32
        "model": {"all-gather": layers * 2 * b * S * kv_loc
                  * cfg.head_dim * 2 + b * cfg.vocab_size // model * 4,
                  "all-reduce": layers * (b * S * d * 2 + b * S * d * 4)
                  + b * S * d * 2}}


def test_decode_cell_on_a_mesh_gathers_its_caches(counted):
    from repro_torch import configs
    cfg = configs.get_smoke_config("qwen3-moe-30b-a3b")
    st = counted["2x2_decode"]
    hkv, hd = cfg.num_kv_heads, cfg.head_dim
    # every layer's K and V: (B / 2) rows x (S / 2) positions a rank, bf16
    local = cfg.num_layers * 2 * (B // 2) * (S // 2) * hkv * hd * 2
    assert st["cache_bytes"] == local
    assert st["kernel_calls"] == {"expert_gemm_fwd": 3 * cfg.num_layers}
    # over the model axis: each rank's caches' sequence shard, the new K/V
    # row's kv head (one of two a rank) and the logits' vocabulary columns
    # (float32), and no leaf
    b = B // 2
    assert st["collective_bytes_by_axis"]["model"]["all-gather"] == (
        local + cfg.num_layers * 2 * b * 1 * (hkv // 2) * hd * 2
        + b * cfg.vocab_size // 2 * 4)


def test_moe_layer_collectives_follow_the_schedule(counted):
    from repro_torch import configs
    cfg = configs.get_smoke_config("qwen3-moe-30b-a3b")
    st = counted["moe_layer"]
    t_loc = (B // 2) * S
    assert st["collective_counts"]["all-reduce"] == 3
    assert st["collective_bytes"]["all-reduce"] == (
        t_loc * cfg.d_model * 4 + cfg.num_experts * 4 + 4)
    assert st["collective_counts"]["all-gather"] == 3
    assert st["collective_bytes"]["all-gather"] == \
        counted["expert_shard_bytes"]
    assert st["collective_counts"]["reduce-scatter"] == 0


@pytest.mark.parametrize("arch", ["rwkv6-7b", "recurrentgemma-9b"])
def test_recurrent_train_cells_are_counted_on_h100(counted, arch):
    """rwkv6's and recurrentgemma's ``train_4k`` cells are counted on the
    ``h100`` mesh (once recorded as skipped: their kernels had no
    backward): each recurrent kernel launched twice a layer in the forward
    (the remat's recompute; recurrentgemma's two tail layers once) and its
    backward once a layer, flash likewise on recurrentgemma's 12 local
    layers, and a backward's FLOPs in the step's count."""
    from repro_torch import configs
    rec = counted["train_4k"][arch]
    assert rec["ok"] and "skipped" not in rec
    cfg = configs.get_config(arch)
    calls = rec["stats"]["kernel_calls"]
    if arch == "rwkv6-7b":
        assert calls == {"wkv6": 2 * cfg.num_layers,
                         "wkv6_bwd": cfg.num_layers}
    else:
        n_rec = cfg.layer_kinds().count("rglru")
        periods = cfg.num_layers // cfg.pattern_period
        tail = cfg.num_layers - periods * cfg.pattern_period
        assert calls == {"rglru": 2 * n_rec - tail, "rglru_bwd": n_rec,
                         "flash_fwd": 2 * periods, "flash_bwd": periods}
    assert rec["stats"]["flops"] > 0 and rec["roofline"]["dominant"]


if __name__ == "__main__":
    _count(sys.argv[1])
