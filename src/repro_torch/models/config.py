"""Model configuration for the assigned architecture pool.

One dataclass covers dense GQA transformers, MoE (incl. MLA), encoder-only,
VLM (stub frontend), hybrid SSM+attention, and attention-free (RWKV6)
architectures. Per-layer heterogeneity (zamba2) is expressed with
``block_pattern``; homogeneous stacks use scan-over-layers.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff_expert: int
    num_shared_experts: int = 0
    d_ff_shared: int = 0
    capacity_factor: float = 1.25
    group_size: int = 512  # dispatch group (tokens) — memory/locality knob
    first_dense_layers: int = 0  # deepseek: dense FFN in the first layer(s)
    d_ff_dense: int = 0


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    kind: str = "mamba2"  # mamba2 | rwkv6
    d_state: int = 64
    head_dim: int = 64
    expand: int = 2  # d_inner = expand * d_model
    conv_width: int = 4  # mamba2 causal conv
    chunk: int = 128  # chunked-scan block length (TPU-native formulation)
    # dry-run cost-extraction knob: python-loop the chunk scan so XLA's
    # cost analysis (which counts while bodies once) sees every chunk
    unroll_chunks: bool = False


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | audio | vlm | hybrid | ssm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // num_heads
    # attention flavor
    rope: str = "full"  # full | partial (rotate half dims; chatglm 2d) | none
    rope_theta: float = 10000.0
    qk_norm: bool = False
    causal: bool = True  # False: encoder-only (hubert)
    mlp: str = "swiglu"  # swiglu | gelu
    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    # submodule configs
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    # per-layer pattern for hybrids; entries: "attn" | "mamba2" | "rwkv6".
    # empty -> homogeneous ("attn" unless family == "ssm")
    block_pattern: tuple[str, ...] = ()
    # modality frontend stubs (assignment: frontends are precomputed)
    num_image_tokens: int = 0  # vlm: patch embeddings prepended
    input_mode: str = "tokens"  # tokens | frames (audio) | vlm
    # dtypes / numerics
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    # training
    max_seq_len: int = 8192
    # dry-run cost-extraction knob: python-loop the layer stack instead of
    # scan so per-layer cost is visible to XLA's while-body-once analysis
    force_unroll: bool = False
    # context-parallel attention (§Perf lever): shard the attention score /
    # output tensors over the `model` axis along the *query-sequence* dim.
    # For archs whose head counts don't divide the model axis (smollm: 9
    # heads vs 16-way TP) GSPMD otherwise replicates the whole S² attention
    # computation per model shard.
    cp_attn: bool = False
    # flash-style query-block chunking for full-sequence attention: peak
    # scores buffer (B,H,chunk,S) instead of (B,H,S,S). 0 disables.
    attn_q_chunk: int = 1024

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def pattern(self) -> tuple[str, ...]:
        if self.block_pattern:
            assert len(self.block_pattern) == self.num_layers
            return self.block_pattern
        if self.family == "ssm" and self.ssm is not None:
            return (self.ssm.kind,) * self.num_layers
        return ("attn",) * self.num_layers

    @property
    def uniform(self) -> bool:
        """True when all layers share one block type (→ scan-over-layers)."""
        return len(set(self.pattern)) == 1 and not self.force_unroll

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for the 500k-token long-context decode shape."""
        return self.family in ("ssm", "hybrid")

    @property
    def has_decode(self) -> bool:
        return self.causal  # encoder-only models have no decode step

    def param_count(self) -> int:
        """Analytic parameter count (for 6·N·D roofline bookkeeping)."""
        dm, dff, V = self.d_model, self.d_ff, self.vocab_size
        hd = self.resolved_head_dim
        n = V * dm  # embedding
        if not self.tie_embeddings:
            n += V * dm
        for kind in self.pattern:
            if kind == "attn":
                if self.mla is not None:
                    m = self.mla
                    qdim = self.num_heads * (m.qk_nope_head_dim + m.qk_rope_head_dim)
                    n += dm * qdim
                    n += dm * (m.kv_lora_rank + m.qk_rope_head_dim)
                    n += m.kv_lora_rank * self.num_heads * (m.qk_nope_head_dim + m.v_head_dim)
                    n += self.num_heads * m.v_head_dim * dm
                else:
                    n += dm * self.num_heads * hd  # q
                    n += 2 * dm * self.num_kv_heads * hd  # k, v
                    n += self.num_heads * hd * dm  # o
            elif kind in ("mamba2", "rwkv6"):
                s = self.ssm
                din = s.expand * dm
                if kind == "mamba2":
                    n += dm * (2 * din + 2 * s.d_state + din // s.head_dim)
                    n += din * dm
                    n += (din + 2 * s.d_state) * s.conv_width
                else:
                    n += dm * din * 5  # r k v g w projections
                    n += din * dm
            # ffn: attention blocks carry one; pure-SSM families use a
            # channel-mix FFN every layer; hybrid mamba blocks have none
            has_ffn = (kind == "attn") or (self.family == "ssm")
            if has_ffn:
                if self.moe is not None:
                    e = self.moe
                    n += dm * e.num_experts  # router
                    n += e.num_experts * 3 * dm * e.d_ff_expert
                    n += e.num_shared_experts * 3 * dm * e.d_ff_shared
                else:
                    mult = 3 if self.mlp == "swiglu" else 2
                    n += mult * dm * dff
            n += 2 * dm  # norms
        return n

    def active_param_count(self) -> int:
        """Active params per token (MoE: top-k of routed experts)."""
        if self.moe is None:
            return self.param_count()
        e = self.moe
        total = self.param_count()
        routed = len(self.pattern) * e.num_experts * 3 * self.d_model * e.d_ff_expert
        active = len(self.pattern) * e.top_k * 3 * self.d_model * e.d_ff_expert
        return total - routed + active
