"""Model configuration dataclasses for the assigned architecture pool.

A copy of the JAX package's ``configs/base.py`` (pure data; the port keeps
its own so that it never imports the JAX package).  Every architecture in
the pool is expressed as a ``ModelConfig``;
``repro_torch.models.model.build_model`` dispatches on the per-layer
``block_pattern`` so that dense, MoE, SSM, hybrid, enc-dec and stub-frontend
archs share one transformer substrate.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

# Block kinds understood by build_model.  A layer stack is described by
# a repeating ``block_pattern`` (period P); layers beyond the last full period
# are unrolled (e.g. recurrentgemma's 38 = 12*(rec,rec,attn) + (rec,rec)).
BLOCK_ATTN = "attn"          # full-attention transformer block
BLOCK_LOCAL = "local_attn"   # sliding-window attention block
BLOCK_MOE = "moe"            # attention + MoE FFN block
BLOCK_RWKV = "rwkv6"         # RWKV6 time-mix + channel-mix block
BLOCK_REC = "rglru"          # Griffin RG-LRU recurrent block


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One assigned (input-shape) cell."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


TRAIN_4K = ShapeConfig("train_4k", 4096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524288, 1, "decode")

ALL_SHAPES = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)
SHAPES_BY_NAME = {s.name: s for s in ALL_SHAPES}


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0           # 0 -> d_model // num_heads

    # --- layer structure ---------------------------------------------------
    block_pattern: Tuple[str, ...] = (BLOCK_ATTN,)
    arch_type: str = "decoder"  # decoder | encdec
    num_decoder_layers: int = 0  # encdec only; 0 -> same as num_layers

    # --- attention ----------------------------------------------------------
    window_size: int = 4096     # for local_attn blocks
    logit_softcap: float = 0.0  # gemma2 attention-logit soft cap
    final_softcap: float = 0.0  # gemma2 final-logit soft cap
    rope_theta: float = 10000.0

    # --- MoE ----------------------------------------------------------------
    num_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0           # per-expert hidden dim
    num_shared_experts: int = 0
    capacity_factor: float = 1.25

    # --- recurrent families ---------------------------------------------------
    rwkv_head_dim: int = 64
    rglru_conv_width: int = 4
    rglru_c: float = 8.0        # Griffin's fixed constant c

    # --- frontends (stubs per the assignment) --------------------------------
    frontend: str = "none"      # none | audio | vision
    num_media_positions: int = 0  # vision: patch positions prepended to the sequence

    # --- numerics / misc ------------------------------------------------------
    act: str = "silu"
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    dtype: str = "bfloat16"

    # --- which assigned shape cells run (skips noted in DESIGN.md) ----------
    skip_shapes: Tuple[str, ...] = ()

    # --- distribution defaults (overridable by the launcher) -----------------
    remat: bool = True
    remat_policy: str = "full"   # full | dots (save matmul outputs) | none
    # Unroll the layer stack instead of lax.scan.  XLA's HloCostAnalysis
    # counts a while-loop body ONCE (verified: a scan of 10 matmuls reports
    # 1/10th of the flops), so the dry-run lowers with unroll_stack=True to
    # get exact per-cell flops/bytes/collective counts; production lowering
    # keeps the scan for O(1) HLO size.
    unroll_stack: bool = False

    # --- beyond-paper perf knobs (EXPERIMENTS.md §Perf) -----------------------
    ce_chunk: int = 0            # >0: cross-entropy in seq chunks (kills the
                                 # (B,S,V) f32 logits residency)
    attn_kv_chunk: int = 0       # >0: flash-style online-softmax attention
                                 # over KV chunks in the XLA path (kills the
                                 # (B,H,S,S) score residency)
    window_kv_cache: bool = False  # local_attn decode: ring cache of window
                                   # size instead of full seq length
    shard_rnn: bool = True       # shard recurrent width over 'model'; False
                                 # replicates the rnn block (trades 16x gate
                                 # compute for zero rnn-psum collectives)

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)
        if self.arch_type == "encdec" and self.num_decoder_layers == 0:
            object.__setattr__(self, "num_decoder_layers", self.num_layers)
        assert self.num_heads % max(self.num_kv_heads, 1) == 0, self.name

    # ------------------------------------------------------------------ utils
    @property
    def pattern_period(self) -> int:
        return len(self.block_pattern)

    def layer_kinds(self, num_layers: Optional[int] = None) -> Tuple[str, ...]:
        n = num_layers if num_layers is not None else self.num_layers
        p = self.block_pattern
        return tuple(p[i % len(p)] for i in range(n))

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    @property
    def attn_free(self) -> bool:
        return all(b in (BLOCK_RWKV, BLOCK_REC) for b in self.block_pattern)

    def shapes(self):
        return tuple(s for s in ALL_SHAPES if s.name not in self.skip_shapes)

    def param_count(self) -> int:
        """Analytic parameter count (used for 6ND model-FLOPs in roofline)."""
        d, v = self.d_model, self.vocab_size
        hd = self.head_dim
        total = v * d  # embeddings
        if not self.tie_embeddings:
            total += v * d
        kinds = self.layer_kinds()
        if self.arch_type == "encdec":
            kinds = kinds + self.layer_kinds(self.num_decoder_layers)
        for kind in kinds:
            total += 2 * d  # pre-norms (approximation: 2 norms / block)
            if kind in (BLOCK_ATTN, BLOCK_LOCAL, BLOCK_MOE):
                total += d * self.num_heads * hd + 2 * d * self.num_kv_heads * hd
                total += self.num_heads * hd * d
                if self.arch_type == "encdec":
                    # cross attention on decoder blocks (approx: count once per block)
                    total += d * self.num_heads * hd + 2 * d * self.num_kv_heads * hd
                    total += self.num_heads * hd * d
            if kind == BLOCK_MOE:
                total += d * self.num_experts  # router
                total += self.num_experts * 3 * d * self.moe_d_ff
                total += self.num_shared_experts * 3 * d * self.d_ff
            elif kind == BLOCK_RWKV:
                total += 4 * d * d + d * d  # r,k,v,g,o projections (approx)
                total += 3 * d * self.d_ff // 1  # channel mix (k,v,r)
            elif kind == BLOCK_REC:
                total += 2 * d * d  # in/out linear of recurrent block
                total += 3 * d * self.d_ff
            else:
                total += 3 * d * self.d_ff  # gated MLP
        return total

    def active_param_count(self) -> int:
        """Active params per token (MoE: only routed experts count)."""
        if not self.is_moe:
            return self.param_count()
        d = self.d_model
        total = self.param_count()
        n_moe = sum(1 for k in self.layer_kinds() if k == BLOCK_MOE)
        inactive = n_moe * (self.num_experts - self.top_k) * 3 * d * self.moe_d_ff
        return total - inactive
