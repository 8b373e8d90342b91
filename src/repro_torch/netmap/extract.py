"""Network-level workload extraction: ``ModelConfig`` -> per-layer einsums.

Walks a model configuration (``repro.configs``) and emits the ordered list
of einsums one forward pass executes, as :class:`LayerEinsum` records — one
record per (layer, operator) with a multiplicity ``count`` for operators
that repeat inside a layer (MoE experts).  Two serving shapes are supported:

  * ``prefill`` — ``batch x seq`` tokens flow through every projection and
    the attention einsums are full ``seq x seq`` score/context matmuls;
  * ``decode``  — one new token per sequence (``batch`` tokens total), with
    attention reading a KV cache of length ``seq``.

The extraction is a *cost-model* view, matching the einsum granularity of
``core/presets.gpt3_einsums`` (the paper's GPT-3 scheme): projections and
FFN matmuls per layer, per-head batched attention matmuls, and the LM head.
Elementwise work (norms, activations, RoPE) and embedding gathers are not
einsums and are omitted.  SSM (mamba2/SSD) layers are lowered to their
dense-equivalent matmuls: in/out projections plus per-chunk QK/AV-style
batched matmuls; hybrid (recurrentgemma-style) models follow their
``block_pattern``, with RG-LRU blocks contributing their gate/projection
matmuls and local-attention blocks a windowed KV length.  Encoder-decoder
(audio) models charge the encoder stack and the cross-attention K/V
projections at prefill only — at decode both are already cached — while
decoder layers carry self- plus cross-attention every step.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List

from ..core.einsum import (Einsum, EinsumGraph, TensorEdge,
                               batched_matmul, matmul)
from ..models.config import ModelConfig


@dataclass(frozen=True)
class LayerEinsum:
    """One operator instance of the network's forward pass."""

    layer: int  # 0-based layer index; -1 for network-level ops (LM head)
    op: str  # operator label ("q_proj", "qk", "ffn_up", "lm_head", ...)
    einsum: Einsum
    count: int = 1  # multiplicity within the layer (e.g. MoE experts)


@dataclass
class NetworkGraph:
    """The workload-graph view of one forward pass: the execution-ordered
    layer-op entries plus the producer->consumer tensor edges between their
    einsums (keyed by einsum name)."""

    entries: List[LayerEinsum]
    graph: EinsumGraph

    def entry(self, name: str) -> LayerEinsum:
        return self._by_name[name]

    def __post_init__(self):
        self._by_name: Dict[str, LayerEinsum] = {
            e.einsum.name: e for e in self.entries}


def _ffn_einsums(cfg: ModelConfig, layer: int, prefix: str, tokens: int,
                 ) -> List[LayerEinsum]:
    """Gated-FFN matmuls (up/gate/down), routed per expert for MoE."""
    if cfg.d_ff <= 0:
        return []
    if cfg.n_experts:
        # top-k routing: tokens*top_k expert-token pairs spread over the
        # experts; when pairs < n_experts only that many experts see work
        pairs = tokens * max(cfg.top_k, 1)
        count = min(cfg.n_experts, max(1, pairs))
        m = -(-pairs // count)  # ceil: model every expert-token pair
    else:
        m, count = tokens, 1
    mk = lambda op, M, K, N: LayerEinsum(
        layer, op, matmul(f"{prefix}.{op}", M, K, N), count)
    return [
        mk("ffn_up", m, cfg.d_model, cfg.d_ff),
        mk("ffn_gate", m, cfg.d_model, cfg.d_ff),
        mk("ffn_down", m, cfg.d_ff, cfg.d_model),
    ]


def _attention_einsums(cfg: ModelConfig, layer: int, prefix: str,
                       tokens: int, batch: int, m_attn: int, kv_len: int,
                       ) -> List[LayerEinsum]:
    """QKV/O projections + per-head score (QK) and context (AV) matmuls."""
    heads = batch * cfg.n_heads
    mk = lambda op, e: LayerEinsum(layer, op, e, 1)
    return [
        mk("q_proj", matmul(f"{prefix}.q_proj", tokens, cfg.d_model, cfg.q_dim)),
        mk("k_proj", matmul(f"{prefix}.k_proj", tokens, cfg.d_model, cfg.kv_dim)),
        mk("v_proj", matmul(f"{prefix}.v_proj", tokens, cfg.d_model, cfg.kv_dim)),
        mk("qk", batched_matmul(f"{prefix}.qk", heads, m_attn, cfg.d_head, kv_len)),
        mk("av", batched_matmul(f"{prefix}.av", heads, m_attn, kv_len, cfg.d_head)),
        mk("o_proj", matmul(f"{prefix}.o_proj", tokens, cfg.q_dim, cfg.d_model)),
    ]


def _ssm_einsums(cfg: ModelConfig, layer: int, prefix: str, tokens: int,
                 ) -> List[LayerEinsum]:
    """Mamba2/SSD layer as dense-equivalent matmuls.

    in_proj fans ``d_model`` out to the gated inner width ``2 * d_inner``;
    the SSD scan is dominated by its intra-chunk attention-like matmuls
    (C B^T scores over the state dim, then scores x values), batched over
    (chunks x ssm heads); out_proj contracts ``d_inner`` back.
    """
    d_inner = max(cfg.ssm_heads * cfg.ssm_head_dim, cfg.d_model)
    chunk = max(1, min(cfg.ssm_chunk or 1, tokens))
    n_chunks = -(-tokens // chunk)  # ceil: partial chunks still run
    bh = n_chunks * max(cfg.ssm_heads, 1)
    state = max(cfg.ssm_state, 1)
    mk = lambda op, e: LayerEinsum(layer, op, e, 1)
    return [
        mk("ssm_in_proj",
           matmul(f"{prefix}.ssm_in_proj", tokens, cfg.d_model, 2 * d_inner)),
        mk("ssd_qk",
           batched_matmul(f"{prefix}.ssd_qk", bh, chunk, state, chunk)),
        mk("ssd_av",
           batched_matmul(f"{prefix}.ssd_av", bh, chunk, chunk,
                          max(cfg.ssm_head_dim, 1))),
        mk("ssm_out_proj",
           matmul(f"{prefix}.ssm_out_proj", tokens, d_inner, cfg.d_model)),
    ]


def _cross_attention_einsums(cfg: ModelConfig, layer: int, prefix: str,
                             tokens: int, batch: int, m_attn: int,
                             enc_len: int, include_kv: bool,
                             ) -> List[LayerEinsum]:
    """Decoder cross-attention over the encoder output.

    The cross K/V projections run once over the encoder states (prefill
    only — at decode they are cached); the score/context matmuls attend the
    decoder tokens to all ``enc_len`` encoder positions every step.
    """
    heads = batch * cfg.n_heads
    mk = lambda op, e: LayerEinsum(layer, op, e, 1)
    out = [mk("xq_proj",
              matmul(f"{prefix}.xq_proj", tokens, cfg.d_model, cfg.q_dim))]
    if include_kv:
        enc_tokens = batch * enc_len
        out += [
            mk("xk_proj", matmul(f"{prefix}.xk_proj", enc_tokens,
                                 cfg.d_model, cfg.kv_dim)),
            mk("xv_proj", matmul(f"{prefix}.xv_proj", enc_tokens,
                                 cfg.d_model, cfg.kv_dim)),
        ]
    out += [
        mk("xqk", batched_matmul(f"{prefix}.xqk", heads, m_attn, cfg.d_head,
                                 enc_len)),
        mk("xav", batched_matmul(f"{prefix}.xav", heads, m_attn, enc_len,
                                 cfg.d_head)),
        mk("xo_proj",
           matmul(f"{prefix}.xo_proj", tokens, cfg.q_dim, cfg.d_model)),
    ]
    return out


def _rglru_einsums(cfg: ModelConfig, layer: int, prefix: str, tokens: int,
                   ) -> List[LayerEinsum]:
    """RG-LRU block (recurrentgemma-style): gated in/out projections."""
    width = cfg.rglru_dim or cfg.d_model
    mk = lambda op, e: LayerEinsum(layer, op, e, 1)
    return [
        mk("rg_in_proj",
           matmul(f"{prefix}.rg_in_proj", tokens, cfg.d_model, 2 * width)),
        mk("rg_out_proj",
           matmul(f"{prefix}.rg_out_proj", tokens, width, cfg.d_model)),
    ]


def _block_kind(cfg: ModelConfig, layer: int) -> str:
    """Which block occupies ``layer``: attn | rglru | ssm."""
    if cfg.block_pattern:
        kind = cfg.block_pattern[layer % len(cfg.block_pattern)]
        return "attn" if "attn" in kind else "rglru"  # "attn"/"wattn"/...
    # family decides before n_heads: smoke-scaled SSM configs gain token
    # attention dims from smoke_config but must stay on the SSD path
    if cfg.family == "ssm" or (cfg.ssm_state > 0 and cfg.n_heads == 0):
        return "ssm"
    return "attn"


def extract_einsums(cfg: ModelConfig, mode: str = "prefill",
                    batch: int = 1, seq: int = 1024) -> List[LayerEinsum]:
    """The einsums of one forward pass of ``cfg`` at the given shape.

    ``mode="prefill"`` processes ``batch * seq`` tokens; ``mode="decode"``
    processes ``batch`` tokens (one per sequence) against a KV cache of
    length ``seq``.  Returns records in execution order — dedup across
    repeated layers is the planner's job, not the extractor's.
    """
    if mode not in ("prefill", "decode"):
        raise ValueError(f"mode must be 'prefill' or 'decode', got {mode!r}")
    if batch < 1 or seq < 1:
        raise ValueError(f"batch/seq must be >= 1, got {batch}/{seq}")
    tokens = batch * seq if mode == "prefill" else batch
    m_attn = seq if mode == "prefill" else 1
    out: List[LayerEinsum] = []
    if cfg.is_encdec and cfg.enc_layers and cfg.dec_layers:
        # encoder runs ONCE over the source sequence: its layers are charged
        # at prefill and amortized away at decode; decoder layers carry
        # self-attention plus cross-attention over the encoder output
        if mode == "prefill":
            enc_tokens = batch * seq
            for layer in range(cfg.enc_layers):
                prefix = f"{cfg.name}.enc{layer}"
                out.extend(_attention_einsums(cfg, layer, prefix, enc_tokens,
                                              batch, seq, seq))
                out.extend(_ffn_einsums(cfg, layer, prefix, enc_tokens))
        for i in range(cfg.dec_layers):
            layer = cfg.enc_layers + i
            prefix = f"{cfg.name}.dec{i}"
            out.extend(_attention_einsums(cfg, layer, prefix, tokens, batch,
                                          m_attn, seq))
            out.extend(_cross_attention_einsums(
                cfg, layer, prefix, tokens, batch, m_attn, seq,
                include_kv=(mode == "prefill")))
            out.extend(_ffn_einsums(cfg, layer, prefix, tokens))
        out.append(LayerEinsum(
            -1, "lm_head",
            matmul(f"{cfg.name}.lm_head", tokens, cfg.d_model, cfg.vocab), 1))
        return out
    for layer in range(cfg.n_layers):
        prefix = f"{cfg.name}.L{layer}"
        kind = _block_kind(cfg, layer)
        if kind == "attn" and cfg.n_heads > 0:
            kv_len = min(cfg.window, seq) if cfg.window else seq
            out.extend(_attention_einsums(cfg, layer, prefix, tokens, batch,
                                          m_attn, kv_len))
        elif kind == "rglru":
            out.extend(_rglru_einsums(cfg, layer, prefix, tokens))
        elif kind == "ssm":
            out.extend(_ssm_einsums(cfg, layer, prefix, tokens))
        out.extend(_ffn_einsums(cfg, layer, prefix, tokens))
    out.append(LayerEinsum(
        -1, "lm_head",
        matmul(f"{cfg.name}.lm_head", tokens, cfg.d_model, cfg.vocab), 1))
    return out


# --------------------------------------------------------------------------
# Workload graph: producer -> consumer tensor edges per block type
# --------------------------------------------------------------------------

_RESHAPE = "per-head reshape between projection and attention"
_RESIDUAL = "residual/norm boundary between blocks"


def _block_edges(ops: Dict[str, LayerEinsum]) -> List[TensorEdge]:
    """Edges among one layer's ops (``ops``: op label -> entry).

    Emits the *real* dataflow of the cost-model einsums.  ``fusable`` marks
    edges whose intermediate could legally live on-chip under joint
    mapping; flows through per-head reshapes, token routing (MoE),
    recurrences (RG-LRU / SSD scan state), residual/norm boundaries or
    stage-cached encoder state are recorded but vetoed.
    """
    edges: List[TensorEdge] = []

    def add(po: str, co: str, tensor: str, consumer_tensor: str,
            fusable: bool = True, reason: str = "") -> None:
        if po in ops and co in ops:
            edges.append(TensorEdge(
                ops[po].einsum.name, ops[co].einsum.name, tensor,
                consumer_tensor, fusable, reason))

    # attention: the score matrix (logits) flows straight from QK into AV —
    # softmax is elementwise, so the producer/consumer co-tiling is legal
    add("q_proj", "qk", "Z", "A", False, _RESHAPE)
    add("k_proj", "qk", "Z", "B", False, _RESHAPE)
    add("v_proj", "av", "Z", "B", False, _RESHAPE)
    add("qk", "av", "Z", "A")
    add("av", "o_proj", "Z", "A", False, _RESHAPE)

    # cross-attention (decoder): scores attend *stage-cached* encoder
    # states whose lifetime spans decode steps — never fusable
    xstage = "cross-attention attends stage-cached encoder state"
    add("xq_proj", "xqk", "Z", "A", False, _RESHAPE)
    add("xk_proj", "xqk", "Z", "B", False, _RESHAPE)
    add("xv_proj", "xav", "Z", "B", False, _RESHAPE)
    add("xqk", "xav", "Z", "A", False, xstage)
    add("xav", "xo_proj", "Z", "A", False, _RESHAPE)

    # gated FFN: up and gate both feed down's contracted input (the gate is
    # elementwise).  MoE expert instances route tokens dynamically, so the
    # per-expert flows cannot be co-tiled from the cost-model view.
    moe = "ffn_up" in ops and ops["ffn_up"].count > 1
    routing = "MoE expert routing between FFN matmuls"
    add("ffn_up", "ffn_down", "Z", "A", not moe, routing if moe else "")
    add("ffn_gate", "ffn_down", "Z", "A", not moe, routing if moe else "")

    # SSD (mamba2): intra-chunk score/context matmuls chain like attention;
    # the projections are separated by the chunked-scan reshape
    add("ssm_in_proj", "ssd_qk", "Z", "A", False,
        "chunked-scan reshape between projection and SSD matmuls")
    add("ssd_qk", "ssd_av", "Z", "A")
    add("ssd_av", "ssm_out_proj", "Z", "A", False,
        "chunked-scan reshape between SSD matmuls and projection")

    # RG-LRU: the gated linear recurrence sits between the projections
    add("rg_in_proj", "rg_out_proj", "Z", "A", False,
        "RG-LRU recurrence between projections")

    # block outputs feed the next matmul through residual adds and norms
    for attn_out in ("o_proj", "ssm_out_proj", "rg_out_proj"):
        for ffn_in in ("ffn_up", "ffn_gate"):
            add(attn_out, ffn_in, "Z", "A", False, _RESIDUAL)
    return edges


def extract_graph(cfg: ModelConfig, mode: str = "prefill",
                  batch: int = 1, seq: int = 1024) -> NetworkGraph:
    """The workload graph of one forward pass: ``extract_einsums`` entries
    plus producer->consumer tensor edges for every block type (dense/GQA
    attention, gated/MoE FFN, SSD, RG-LRU, encoder-decoder cross-attention).

    Edges are intra-layer: flows across layer boundaries pass through
    residual adds and norms, which the einsum cost model does not carry, so
    they are represented by the (never-fusable) residual-boundary edges
    within each block.
    """
    entries = extract_einsums(cfg, mode=mode, batch=batch, seq=seq)
    per_layer: Dict[int, Dict[str, LayerEinsum]] = {}
    for e in entries:
        # MoE repeats collapse to one entry per op; layer+op is unique
        per_layer.setdefault(e.layer, {})[e.op] = e
    edges: List[TensorEdge] = []
    for layer in sorted(per_layer):
        edges.extend(_block_edges(per_layer[layer]))
    graph = EinsumGraph([e.einsum for e in entries], edges)
    return NetworkGraph(entries=entries, graph=graph)
