"""Model assembly on PyTorch: one functional API over every assigned family.

Port of ``repro.models.lm``:

  init(cfg, generator, device)         -> params
  param_specs(cfg)                     -> the params' logical-axis specs
  forward(cfg, params, tokens, ...)    -> (logits, caches, aux)
  loss_fn(cfg, params, batch)          -> (loss, parts)   (differentiable)
  init_cache(cfg, batch, max_len, device) -> cache
  prefill(cfg, params, batch, cache)   -> (last_logits, cache)
  decode_step(cfg, params, tok, cache) -> (logits, cache)

Parameters keep the reference's pytree layout, layer stacks included: a
group's parameters are stacked along a leading layer axis, so JAX weights
carry across leaf for leaf (``models.weights``).  The reference's
``lax.scan`` over a stack is a Python loop over that axis here.

The cache differs in layout: a group's cache is a list with one entry per
layer (a tuple over the group's kinds), not stacked arrays; the fill
index ``idx`` of an attention cache and the cache's ``pos`` are host
ints; and the steps update the cache in place (the reference donates it).

Families:
  dense  — qwen1.5-0.5b, minitron-8b, yi-34b, phi3-mini: GQA + SwiGLU
  moe    — phi3.5-moe, llama4-scout: dense attention + top-k expert MLP
  ssm    — mamba2-130m: attention-free SSD blocks
  hybrid — recurrentgemma-2b: RG-LRU blocks + local attention (1:2 pattern)
  vlm    — llava-next-34b: dense backbone; patch-embedding frontend stub
  audio  — seamless-m4t-medium: encoder-decoder; frame-embedding frontend
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, Iterator, List, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..distributed.sharding import (constrain, gather_last, is_dtensor,
                                    layer, map_specs, split_like)
from .config import ModelConfig
from .layers import (_init, _whole_seq, attention_block, attention_params,
                     cross_attention_cached, cross_kv, embedding_params, mlp,
                     mlp_params, moe, moe_params, rmsnorm, rmsnorm_params,
                     weak_scalar)
from .rglru import init_rglru_state, rglru_block, rglru_params
from .ssm import init_ssm_state, ssm_block, ssm_params

Params = Dict[str, Any]


def tree_map(fn: Callable, tree):
    """``fn`` on every leaf of nested dicts, lists and tuples (None stays
    None)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return None if tree is None else fn(tree)


def tree_zip(tree, *others) -> Iterator[tuple]:
    """(leaf, *the nodes of ``others`` at its place) for every leaf of
    ``tree`` in ``jax.tree.leaves``' order: dict keys sorted, lists and
    tuples in order, None skipped.  ``others`` share ``tree``'s structure
    down to its leaves and may hold a subtree where it holds a leaf."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_zip(tree[k], *(o[k] for o in others))
    elif isinstance(tree, (list, tuple)):
        for i, t in enumerate(tree):
            yield from tree_zip(t, *(o[i] for o in others))
    elif tree is not None:
        yield (tree, *others)


def tree_leaves(tree) -> List:
    """The leaves of ``tree`` in ``jax.tree.leaves``' order."""
    return [leaf for leaf, in tree_zip(tree)]


def tree_unflatten(like, leaves: List):
    """``like``'s structure holding ``leaves``, given in ``tree_leaves``'
    order (``jax.tree.unflatten``).  Raises ValueError unless the counts
    agree."""
    leaves, n = list(leaves), len(tree_leaves(like))
    if len(leaves) != n:
        raise ValueError(f"{len(leaves)} leaves for a tree of {n}")
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        if isinstance(t, (list, tuple)):
            return type(t)(build(x) for x in t)
        return None if t is None else next(it)

    return build(like)


# ---------------------------------------------------------------------------
# layer kinds: 'attn' (causal), 'enc' (non-causal), 'wattn' (local window),
# 'xattn' (causal self + cross), 'ssm', 'rglru'
# ---------------------------------------------------------------------------

def _layer_params(cfg: ModelConfig, kind: str, gen: torch.Generator):
    pdt = cfg.torch_param_dtype
    p: Params = {"ln1": rmsnorm_params(cfg.d_model, pdt, gen.device)}
    if kind in ("attn", "enc", "wattn", "xattn"):
        p["attn"] = attention_params(cfg, gen)
        if kind == "xattn":
            p["cross"] = attention_params(cfg, gen)
            p["ln_cross"] = rmsnorm_params(cfg.d_model, pdt, gen.device)
    elif kind == "ssm":
        p["ssm"] = ssm_params(cfg, gen)
    elif kind == "rglru":
        p["rglru"] = rglru_params(cfg, gen)
    else:
        raise ValueError(kind)
    if kind != "ssm":
        p["ln2"] = rmsnorm_params(cfg.d_model, pdt, gen.device)
        if cfg.n_experts and kind == "attn":
            p["moe"] = moe_params(cfg, gen)
        else:
            p["mlp"] = mlp_params(cfg, gen)
    return p


def _layer_apply(cfg: ModelConfig, kind: str, p: Params, x, positions,
                 cache=None, enc_out=None):
    """One block; returns (x, new_cache, aux)."""
    aux = 0.0
    x = constrain(x, ("batch", "act_seq", None))
    h = rmsnorm(p["ln1"], x, cfg.norm_eps)
    new_cache = cache
    if kind in ("attn", "enc", "wattn"):
        win = cfg.window if kind == "wattn" else 0
        a, nc = attention_block(
            cfg, p["attn"], h, positions,
            cache=None if cache is None else cache["attn"],
            causal=(kind != "enc"), window=win)
        if cache is not None:
            new_cache = dict(cache, attn=nc)
        x = x + a
    elif kind == "xattn":
        a, nc = attention_block(
            cfg, p["attn"], h, positions,
            cache=None if cache is None else cache["attn"], causal=True)
        x = x + a
        hc = rmsnorm(p["ln_cross"], x, cfg.norm_eps)
        if cache is not None and "xk" in cache:
            a2 = cross_attention_cached(cfg, p["cross"], hc,
                                        cache["xk"], cache["xv"])
        else:
            assert enc_out is not None
            a2, _ = attention_block(cfg, p["cross"], hc, positions,
                                    kv_from=enc_out)
        x = x + a2
        if cache is not None:
            new_cache = dict(cache, attn=nc)
    elif kind == "ssm":
        a, st = ssm_block(cfg, p["ssm"], h,
                          None if cache is None else cache["ssm"])
        if cache is not None:
            new_cache = dict(cache, ssm=st)
        return x + a, new_cache, aux
    elif kind == "rglru":
        a, st = rglru_block(cfg, p["rglru"], h,
                            None if cache is None else cache["rglru"])
        if cache is not None:
            new_cache = dict(cache, rglru=st)
        x = x + a
    else:
        raise ValueError(kind)

    x = constrain(x, ("batch", "act_seq", None))
    h = rmsnorm(p["ln2"], x, cfg.norm_eps)
    if "moe" in p:
        m, a_moe = moe(cfg, p["moe"], h)
        aux = aux + a_moe.float()
    else:
        m = mlp(cfg, p["mlp"], h)
    return constrain(x + m, ("batch", "act_seq", None)), new_cache, aux


# ---------------------------------------------------------------------------
# stacks
# ---------------------------------------------------------------------------

def layer_pattern(cfg: ModelConfig) -> Tuple[str, ...]:
    if cfg.family == "ssm":
        return ("ssm",) * cfg.n_layers
    if cfg.family == "hybrid":
        pat = cfg.block_pattern or ("rglru", "rglru", "wattn")
        full = pat * ((cfg.n_layers + len(pat) - 1) // len(pat))
        return full[:cfg.n_layers]
    if cfg.family == "audio":
        return ("enc",) * cfg.enc_layers + ("xattn",) * cfg.dec_layers
    return ("attn",) * cfg.n_layers


def _stack_groups(cfg: ModelConfig) -> List[Tuple[Tuple[str, ...], int]]:
    pat = layer_pattern(cfg)
    if cfg.family == "hybrid":
        base = cfg.block_pattern or ("rglru", "rglru", "wattn")
        n_groups = cfg.n_layers // len(base)
        out: List[Tuple[Tuple[str, ...], int]] = []
        if n_groups:
            out.append((tuple(base), n_groups))
        for kind in pat[n_groups * len(base):]:
            out.append(((kind,), 1))
        return out
    if cfg.family == "audio":
        return [(("enc",), cfg.enc_layers), (("xattn",), cfg.dec_layers)]
    return [((pat[0],), cfg.n_layers)]


_NORM = {"scale": ("embed",)}
_MLP = {"wg": ("embed", "mlp"), "wu": ("embed", "mlp"),
        "wd": ("mlp", "embed")}
_MOE = {"router": ("embed", "expert"), "wg": ("expert", "embed", "mlp"),
        "wu": ("expert", "embed", "mlp"), "wd": ("expert", "mlp", "embed")}
_SSM = {"w_in": ("embed", "mlp"), "conv": (None, "mlp"),
        "A_log": ("heads",), "D": ("heads",), "dt_bias": ("heads",),
        "w_out": ("mlp", "embed"), "norm_scale": ("mlp",)}
_RGLRU = {"w_x": ("embed", "mlp"), "w_y": ("mlp", "embed"),
          "conv": (None, "mlp"), "w_input_gate": ("mlp", "mlp2"),
          "w_a_gate": ("mlp", "mlp2"), "lam": ("mlp",)}


def _attention_specs(cfg: ModelConfig) -> Params:
    s = {"wq": ("embed", "heads"), "wk": ("embed", "kv"),
         "wv": ("embed", "kv"), "wo": ("heads", "embed")}
    if cfg.qkv_bias:
        s.update(bq=("heads",), bk=("kv",), bv=("kv",))
    return s


def _layer_specs(cfg: ModelConfig, kind: str) -> Params:
    """The logical axes of ``_layer_params``' leaves, as the reference's
    layer creators return them beside the parameters."""
    s: Params = {"ln1": dict(_NORM)}
    if kind in ("attn", "enc", "wattn", "xattn"):
        s["attn"] = _attention_specs(cfg)
        if kind == "xattn":
            s["cross"] = _attention_specs(cfg)
            s["ln_cross"] = dict(_NORM)
    elif kind == "ssm":
        s["ssm"] = dict(_SSM)
    elif kind == "rglru":
        s["rglru"] = dict(_RGLRU)
    else:
        raise ValueError(kind)
    if kind != "ssm":
        s["ln2"] = dict(_NORM)
        if cfg.n_experts and kind == "attn":
            s["moe"] = dict(_MOE)
        else:
            s["mlp"] = dict(_MLP)
    return s


def _stacked(specs: Params) -> Params:
    """Each spec of a layer with the stack's leading 'layers' axis."""
    return {k: _stacked(v) if isinstance(v, dict) else ("layers",) + v
            for k, v in specs.items()}


def param_specs(cfg: ModelConfig) -> Params:
    """The logical-axis spec of every parameter, in ``init``'s tree: the
    ``specs`` the reference's ``lm.init`` returns beside the parameters
    (tuples of logical axis names, ``distributed.sharding.RULES`` maps
    them to mesh axes).  Pure Python from ``cfg``: nothing is allocated."""
    specs: Params = {"embed": {"tok": ("vocab", "embed")},
                     "final_norm": dict(_NORM)}
    if not cfg.tie_embeddings:
        specs["lm_head"] = ("embed", "vocab")
    if cfg.frontend != "none":
        specs["frontend_proj"] = (None, "embed")
    specs["groups"] = [[_stacked(_layer_specs(cfg, kind)) for kind in kinds]
                       for kinds, _ in _stack_groups(cfg)]
    return specs


def init(cfg: ModelConfig, generator: torch.Generator, device,
         part=None) -> Params:
    """Random parameters in the reference's layout, drawn from
    ``generator`` on its own device, leaf by leaf and, in a stack, layer
    by layer, each moved to ``device`` as it is drawn: a CPU generator
    gives the same weights on every device.  (``jax.random`` cannot be
    reproduced; the parity tests carry JAX's weights across instead.)

    ``part(spec, shape)``, when given, says which part of each leaf of
    logical ``spec`` and whole ``shape`` to keep: (a tuple of slices of
    it, the function that turns the kept part into the tree's leaf).  Only
    those parts reach ``device``, and no more than one whole leaf or layer
    is held on the generator's device at a time; the values are the ones
    the whole tree holds there."""
    gen = generator
    pdt = cfg.torch_param_dtype
    specs = param_specs(cfg)
    if part is None:
        def part(spec, shape):
            return tuple(slice(0, n) for n in shape), lambda t: t

    def kept(spec, whole):
        index, wrap = part(spec, tuple(whole.shape))
        return wrap(whole[index].to(device, copy=True))

    params: Params = {"embed": map_specs(kept, specs["embed"],
                                         embedding_params(cfg, gen)),
                      "final_norm": map_specs(kept, specs["final_norm"],
                                              rmsnorm_params(cfg.d_model, pdt,
                                                             gen.device))}
    if not cfg.tie_embeddings:
        params["lm_head"] = kept(specs["lm_head"],
                                 _init(gen, (cfg.d_model, cfg.vocab), pdt))
    if cfg.frontend != "none":
        params["frontend_proj"] = kept(specs["frontend_proj"], _init(
            gen, (cfg.frontend_dim, cfg.d_model), pdt))
    params["groups"] = [
        [_stack_drawn(count, lambda: _layer_params(cfg, kind, gen),
                      gspecs[ki], part, device)
         for ki, kind in enumerate(kinds)]
        for (kinds, count), gspecs in zip(_stack_groups(cfg),
                                          specs["groups"])]
    return params


def _stack_drawn(count: int, draw: Callable[[], Params], specs: Params,
                 part, device) -> Params:
    """``count`` layers from ``draw()``, stacked along a new leading axis
    as ``torch.stack`` would: each leaf's kept part (``part``, by its
    stacked spec in ``specs``) is allocated on ``device`` and filled layer
    by layer, one drawn layer held at a time."""
    out, where = None, None
    for i in range(count):
        drawn = draw()
        if out is None:
            plan = map_specs(lambda spec, t: part(
                spec, (count,) + tuple(t.shape)), specs, drawn)
            where = map_specs(lambda spec, pw: pw[0], specs, plan)
            out = map_specs(lambda spec, t, idx: torch.empty(
                [s.stop - s.start for s in idx], dtype=t.dtype,
                device=device), specs, drawn, where)
        for buf, t, idx in tree_zip(out, drawn, where):
            if idx[0].start <= i < idx[0].stop:
                buf[i - idx[0].start].copy_(t[idx[1:]])
    return map_specs(lambda spec, buf, pw: pw[1](buf), specs, out, plan)


def _apply_group(cfg, kinds, count, group_params, x, positions,
                 caches=None, enc_out=None):
    """The group's ``count`` layers in order; ``caches`` is the group's
    list of per-layer caches.  Returns (x, new_caches, aux).

    Layer ``i``'s parameters are ``sharding.layer`` of each stack: an
    index, or over a mesh that splits the stack (``tp_fsdp``) a gather of
    that one layer from the rank that holds it.  With ``cfg.remat`` and
    gradients wanted, each layer's body, the gather included, runs under
    ``torch.utils.checkpoint`` (non-reentrant): its activations and its
    gathered parameters are dropped after the forward and made again in
    the backward, the reference's ``jax.checkpoint(..., nothing_saveable)``
    around the scan body."""

    def body(x, aux, group_params, i, layer_cache):
        layer_params = tree_map(lambda a: layer(a, i), group_params)
        ncs = []
        for ki, kind in enumerate(kinds):
            c = None if layer_cache is None else layer_cache[ki]
            x, nc, a = _layer_apply(cfg, kind, layer_params[ki], x,
                                    positions, cache=c, enc_out=enc_out)
            ncs.append(nc)
            aux = aux + a
        return x, aux, tuple(ncs)

    remat = cfg.remat and torch.is_grad_enabled()
    aux = 0.0
    new_caches = None if caches is None else []
    for i in range(count):
        layer_cache = None if caches is None else caches[i]
        if remat:
            x, aux, ncs = checkpoint(body, x, aux, group_params, i,
                                     layer_cache, use_reentrant=False)
        else:
            x, aux, ncs = body(x, aux, group_params, i, layer_cache)
        if caches is not None:
            new_caches.append(ncs)
    return x, new_caches, aux


def _table(params):
    """The embedding table with its 'embed' dim whole on every rank (under
    ``tp_fsdp`` it is split over 'data', as the batch is); its vocab
    keeps its split."""
    return constrain(params["embed"]["tok"], ("vocab", None))


def _embed(cfg, params, tokens):
    dt = cfg.torch_dtype
    # ``F.embedding``, not indexing: a vocab-sharded table is looked up
    # per rank and summed, never gathered
    e = F.embedding(tokens, _table(params)).to(dt)
    return constrain(e * weak_scalar(math.sqrt(cfg.d_model), dt),
                     ("batch", "act_seq", None))


def _head(cfg, params, x):
    # the norm and the head are gathered whole along 'embed' (split over
    # 'data' under ``tp_fsdp``): the batch keeps 'data', and the f32
    # logits keep their split
    norm = {"scale": constrain(params["final_norm"]["scale"], (None,))}
    x = _whole_seq(rmsnorm(norm, x, cfg.norm_eps))
    if cfg.tie_embeddings:
        w = _table(params).to(cfg.torch_dtype).T
    else:
        w = constrain(params["lm_head"], (None, "vocab")).to(cfg.torch_dtype)
    return constrain((x @ w).float(), ("batch", "act_seq", "vocab"))


def _frontend(cfg, params, feats):
    """The frontend's embeddings (B, T, d) of ``feats`` (B, T, f): the
    projection whole on every rank (its 'embed' is split over 'data'
    under ``tp_fsdp``, as the batch is), the result with its sequence
    whole, as every projection's (the first layer splits it), so the
    gradient back through the product arrives whole too."""
    dt = cfg.torch_dtype
    w = constrain(params["frontend_proj"], (None, None)).to(dt)
    return constrain(feats.to(dt) @ w, ("batch", None, None))


def _encoder_out(cfg, params, enc_frames):
    B = enc_frames.shape[0]
    fe = _frontend(cfg, params, enc_frames)
    pos = torch.arange(fe.shape[1], device=fe.device)[None, :].expand(B, -1)
    kinds, count = _stack_groups(cfg)[0]
    enc_x, _, _ = _apply_group(cfg, kinds, count, params["groups"][0],
                               fe, pos)
    return enc_x


def _trunk(cfg, params, tokens, embeds=None, enc_frames=None, caches=None,
           positions=None):
    """``forward`` up to the final norm: (hidden, new_caches, aux)."""
    x = _embed(cfg, params, tokens)
    B = x.shape[0]
    if cfg.family == "vlm" and embeds is not None:
        # joined with both sequences whole on every rank, then laid out
        # as the residual stream again
        fe = _frontend(cfg, params, embeds)
        x = constrain(torch.cat([fe, _whole_seq(x)], dim=1),
                      ("batch", "act_seq", None))
    S = x.shape[1]
    if positions is None:
        positions = torch.arange(S, device=x.device)[None, :].expand(B, -1)

    groups = _stack_groups(cfg)
    enc_out = None
    gidx = 0
    if cfg.family == "audio":
        gidx = 1
        if enc_frames is not None:
            enc_out = _encoder_out(cfg, params, enc_frames)
        # else: decoding — cross K/V come from the cache

    aux = 0.0
    new_caches = [None] * len(groups)
    for gi in range(gidx, len(groups)):
        kinds, count = groups[gi]
        cache_g = None if caches is None else caches["groups"][gi]
        x, nc, a = _apply_group(cfg, kinds, count, params["groups"][gi],
                                x, positions, caches=cache_g,
                                enc_out=enc_out)
        aux = aux + a
        new_caches[gi] = nc

    out_caches = None
    if caches is not None:
        out_caches = dict(caches)
        out_caches["groups"] = new_caches
        if gidx == 1:
            out_caches["groups"][0] = caches["groups"][0]
    aux = torch.as_tensor(aux, dtype=torch.float32, device=x.device)
    return x, out_caches, aux


def forward(cfg: ModelConfig, params: Params, tokens, *,
            embeds=None, enc_frames=None, caches=None, positions=None):
    """Returns (logits f32, new_caches, aux)."""
    x, caches, aux = _trunk(cfg, params, tokens, embeds=embeds,
                            enc_frames=enc_frames, caches=caches,
                            positions=positions)
    return _head(cfg, params, x), caches, aux


# ---------------------------------------------------------------------------
# training loss (differentiable: autograd, with the attention's manual
# backward and, under ``cfg.remat``, per-layer recomputation)
# ---------------------------------------------------------------------------

def loss_fn(cfg: ModelConfig, params: Params, batch) -> Tuple[torch.Tensor,
                                                               Dict]:
    """batch: dict(tokens=(B,S), labels=(B,S) [, embeds / enc_frames])."""
    logits, _, aux = forward(
        cfg, params, batch["tokens"],
        embeds=batch.get("embeds"), enc_frames=batch.get("enc_frames"))
    labels = batch["labels"]
    if logits.shape[1] != labels.shape[1]:  # vlm: loss on text tail only
        # the sequence whole first (``act_seq`` may split it over ranks),
        # and the vocabulary whole, as the text-only logits hold it
        logits = constrain(logits, ("batch", None, None))
        logits = logits[:, -labels.shape[1]:]
    # over a mesh, the labels split as the logits' rows are (the inputs
    # come split over ('pod', 'data') only; ``dp`` splits the rows over
    # 'model' too): a gather of other rows would take them all whole
    labels = split_like(labels, logits)
    lse = torch.logsumexp(logits, dim=-1)
    # a negative label is masked below; clamp it only to gather something
    gold = gather_last(logits, labels.clamp_min(0))
    mask = (labels >= 0).float()
    nll = (lse - gold) * mask
    loss = nll.sum() / torch.clamp_min(mask.sum(), 1.0)
    total = loss + 0.01 * aux
    return total, {"ce": loss, "aux": aux}


# ---------------------------------------------------------------------------
# serving: caches, prefill, decode
# ---------------------------------------------------------------------------

def _layer_cache(cfg: ModelConfig, kind: str, batch: int, max_len: int,
                 device):
    dt = cfg.torch_dtype

    def kv(length):
        return torch.zeros((batch, length, cfg.n_kv_heads, cfg.d_head),
                           dtype=dt, device=device)

    if kind in ("attn", "xattn"):
        c = {"attn": {"k": kv(max_len), "v": kv(max_len), "idx": 0}}
        if kind == "xattn":
            c["xk"] = kv(max_len)
            c["xv"] = kv(max_len)
        return c
    if kind == "wattn":
        w = min(cfg.window or max_len, max_len)
        return {"attn": {"k": kv(w), "v": kv(w), "idx": 0}}
    if kind == "ssm":
        return {"ssm": init_ssm_state(cfg, batch, device)}
    if kind == "rglru":
        return {"rglru": init_rglru_state(cfg, batch, device)}
    if kind == "enc":
        return None
    raise ValueError(kind)


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device):
    """{"groups": [per group: None, or a list over its layers of a tuple
    over its kinds], "pos": 0}."""
    groups = []
    for kinds, count in _stack_groups(cfg):
        if all(kind == "enc" for kind in kinds):  # no cache
            groups.append(None)
            continue
        groups.append([tuple(_layer_cache(cfg, kind, batch, max_len, device)
                             for kind in kinds) for _ in range(count)])
    return {"groups": groups, "pos": 0}


def prefill(cfg: ModelConfig, params: Params, batch, cache):
    """Returns (last_token_logits, cache).  The head runs on the last
    position only: the reference computes every position's logits and
    keeps the last, which at batch 8 x 1024 over qwen's vocabulary is 5 GB
    of f32."""
    tokens = batch["tokens"]
    if cfg.family == "audio":
        # encode once, cache cross-attention K/V, then prefill the decoder
        enc_out = _encoder_out(cfg, params, batch["enc_frames"])
        dec_group = 1
        _, count = _stack_groups(cfg)[dec_group]
        cross = params["groups"][dec_group][0]["cross"]
        layers = cache["groups"][dec_group]
        for i in range(count):
            xk, xv = cross_kv(cfg, tree_map(lambda a: layer(a, i), cross),
                              enc_out)
            c = layers[i][0]
            # over a mesh the memory's K/V take the placed buffers' layout
            layers[i] = (dict(c, xk=_like(xk, c["xk"]),
                              xv=_like(xv, c["xv"])),)
        # cross K/V are now cached; skip re-encoding inside forward
        x, cache, _ = _trunk(cfg, params, tokens, caches=cache)
    else:
        x, cache, _ = _trunk(cfg, params, tokens,
                             embeds=batch.get("embeds"), caches=cache)
    s_total = tokens.shape[1]
    if cfg.family == "vlm" and batch.get("embeds") is not None:
        s_total += batch["embeds"].shape[1]
    cache["pos"] = cache["pos"] + s_total
    return _head(cfg, params, x[:, -1:])[:, 0], cache


def _like(x, buf):
    """``x`` laid out as the placed buffer ``buf`` is (``x`` itself off a
    mesh)."""
    if not is_dtensor(buf):
        return x
    return x.redistribute(buf.device_mesh, buf.placements)


def decode_step(cfg: ModelConfig, params: Params, tok, cache):
    """tok: (B, 1) int.  Returns (logits (B, vocab), cache)."""
    pos = cache["pos"]
    positions = torch.full(tok.shape, pos, device=tok.device)
    logits, cache, _ = forward(cfg, params, tok, caches=cache,
                               positions=positions)
    cache["pos"] = pos + 1
    return logits[:, -1], cache
