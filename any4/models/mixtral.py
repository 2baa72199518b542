"""Functional JAX Mixtral (sparse MoE) decoder.

The reference evaluates Mixtral-8x7B through HF's dense eager path
(README.md:309-327); here the architecture is Llama attention + a top-k
routed expert FFN. Expert weights (w1/gate, w3/up, w2/down per expert) are
quantization targets like any other linear (keys registered in
quant.api.DEFAULT_LINEAR_KEYS), so ``quantize_model`` quantizes every
expert independently -- matching the reference, which quantizes each expert
nn.Linear it finds.

Routing is computed exactly (softmax over top-k logits, HF semantics).
Expert application has two modes: dense (every expert scores every token,
static shapes, used at prefill / under vmap) and sparse decode dispatch
(``lax.cond`` skips experts with no routed tokens, so device time scales
with top_k rather than num_experts -- see ``moe_ffn``).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, Optional

import jax
import jax.numpy as jnp

from ..ops import linear as lin
from . import llama


@dataclasses.dataclass(frozen=True)
class MixtralConfig(llama.LlamaConfig):
    num_local_experts: int = 8
    num_experts_per_tok: int = 2

    @classmethod
    def tiny(cls, vocab=256, layers=2):
        return cls(vocab_size=vocab, hidden_size=64, intermediate_size=96,
                   num_hidden_layers=layers, num_attention_heads=4,
                   num_key_value_heads=2, max_position_embeddings=512,
                   num_local_experts=4, num_experts_per_tok=2)


@functools.partial(jax.jit, static_argnums=(0,))
def init_params(cfg: MixtralConfig, key: jax.Array) -> Dict:
    params = llama.init_params(
        dataclasses.replace(cfg, intermediate_size=cfg.intermediate_size),
        key)
    keys = iter(jax.random.split(jax.random.fold_in(key, 1),
                                 cfg.num_hidden_layers *
                                 (1 + 3 * cfg.num_local_experts)))

    def dense(k, n_out, n_in):
        return (jax.random.normal(k, (n_out, n_in), jnp.float32) *
                (1.0 / jnp.sqrt(n_in))).astype(cfg.dtype)

    d, f = cfg.hidden_size, cfg.intermediate_size
    for layer in params["layers"]:
        for nm in ("gate_proj", "up_proj", "down_proj"):
            del layer[nm]
        layer["router"] = dense(next(keys), cfg.num_local_experts, d)
        layer["experts"] = [
            {"w1": dense(next(keys), f, d),    # gate
             "w3": dense(next(keys), f, d),    # up
             "w2": dense(next(keys), d, f)}    # down
            for _ in range(cfg.num_local_experts)]
    return params


# sparse (lax.cond-skip) dispatch pays only when most experts are
# expected UNROUTED: with T tokens and top-k routing over E experts the
# expected hit fraction is 1-(1-1/E)^(T*k), and each cond carries its own
# branch machinery (at 8 slots with top-2 over 8 experts ~88% of experts
# are hit anyway). Dispatch sparse only while T*k <= E/2 (expected hits
# < ~40%); a batched decode engine at 8 slots runs dense. The cut-off is
# not yet measured on the H100.
def _sparse_pays(tokens: int, top_k: int, n_experts: int) -> bool:
    return tokens * top_k <= max(n_experts // 2, 1)


def moe_ffn(layer: Dict, cfg: MixtralConfig, x: jax.Array,
            capture: Optional[dict] = None, prefix: str = "",
            psum_axis: Optional[str] = None,
            dispatch: str = "auto", **kw) -> jax.Array:
    """Top-k routed expert FFN (HF semantics: softmax over the top-k router
    logits).

    ``dispatch`` selects the expert-evaluation strategy:

    - ``"dense"``: evaluate every expert on every token and combine by
      routing weight (always exact; compile-friendliest).
    - ``"sparse"``: wrap each expert in ``lax.cond(any token routed here)``
      so UNTAKEN experts are skipped at runtime -- XLA conditionals execute
      one branch, so decode-shaped calls (T*top_k < E) run only the
      routed experts' GEMVs and device time scales with top_k instead of
      E. Numerics are IDENTICAL to dense: the taken
      branch computes exactly the dense expression, the untaken branch
      contributes the same zeros the dense path multiplies in.
    - ``"auto"``: sparse only while :func:`_sparse_pays` (expected
      routed-expert fraction < ~40%; measured cond overhead otherwise
      outweighs the skipped experts).

    Under tensor parallelism the router (and x) are replicated, each
    expert's w1/w3 are column-parallel and w2 row-parallel on the FFN dim,
    so every shard computes a partial of every expert's output; one psum
    after the routed combine reduces them all (psum is linear in the
    expert sum). The cond predicate depends only on the replicated router,
    so every shard takes the same branch."""
    b, t, d = x.shape
    router_logits = lin.linear(x, layer["router"])        # [b, t, E]
    topv, topi = jax.lax.top_k(router_logits.astype(jnp.float32),
                               cfg.num_experts_per_tok)
    gate = jax.nn.softmax(topv, axis=-1)                   # [b, t, k]

    if "moe_w13" in layer:  # stacked experts (models/fuse.stack_experts)
        E = cfg.num_local_experts
        gu = lin.linear(x, layer["moe_w13"], **kw)         # [b, t, E*2f]
        f = gu.shape[-1] // (2 * E)
        gu = gu.reshape(b, t, E, 2, f).astype(jnp.float32)
        h = jax.nn.silu(gu[..., 0, :]).astype(x.dtype) * \
            gu[..., 1, :].astype(x.dtype)                  # [b, t, E, f]
        # routing weight per expert folds into the w2 input segments
        wts = jnp.sum(
            jax.nn.one_hot(topi, E, dtype=jnp.float32) * gate[..., None],
            axis=-2)                                       # [b, t, E]
        hw = (h.astype(jnp.float32) * wts[..., None]).astype(x.dtype)
        y = lin.linear(hw.reshape(b, t, E * f), layer["moe_w2"], **kw)
        if psum_axis is not None:
            y = jax.lax.psum(y, psum_axis)
        return y.astype(x.dtype)

    if dispatch == "auto":
        dispatch = ("sparse" if _sparse_pays(b * t, cfg.num_experts_per_tok,
                                             cfg.num_local_experts)
                    else "dense")
    if capture is not None:  # shared w1/w3 input (AWQ calibration)
        llama._capture(capture, f"{prefix}moe", x)
        dispatch = "dense"   # calibration must capture every expert input

    def expert_apply(expert, e):
        def run(xi):
            if "w13" in expert:   # fused gate/up (models/fuse.py)
                gu = lin.linear(xi, expert["w13"], **kw)
                f2 = gu.shape[-1] // 2
                g, u = gu[..., :f2], gu[..., f2:]
            else:
                g = lin.linear(xi, expert["w1"], **kw)
                u = lin.linear(xi, expert["w3"], **kw)
            h = jax.nn.silu(g.astype(jnp.float32)).astype(x.dtype) * u
            if capture is not None:
                llama._capture(capture, f"{prefix}experts.{e}.w2", h)
            return lin.linear(h, expert["w2"], **kw).astype(jnp.float32)
        return run

    out = jnp.zeros_like(x, dtype=jnp.float32)
    for e, expert in enumerate(layer["experts"]):
        run = expert_apply(expert, e)
        if dispatch == "sparse":
            ye = jax.lax.cond(jnp.any(topi == e), run,
                              lambda xi: jnp.zeros(
                                  (b, t, d), jnp.float32), x)
        else:
            ye = run(x)
        weight = jnp.sum(jnp.where(topi == e, gate, 0.0), axis=-1)  # [b, t]
        out = out + ye * weight[..., None]
    if psum_axis is not None:  # tensor-parallel row-parallel reduction
        out = jax.lax.psum(out, psum_axis)
    return out.astype(x.dtype)


def forward(params: Dict, cfg: MixtralConfig, input_ids: jax.Array,
            positions: Optional[jax.Array] = None,
            kv_caches: Optional[list] = None,
            cache_pos=None, mask: Optional[jax.Array] = None,
            capture: Optional[dict] = None,
            psum_axis: Optional[str] = None, **kw):
    b, t = input_ids.shape
    if positions is None:
        positions = jnp.broadcast_to(jnp.arange(t)[None, :], (b, t))
    cos, sin = llama.rope_tables(cfg, positions)
    x = lin.embed(params["embed_tokens"], input_ids, cfg.dtype)

    if mask is None and kv_caches is None and t > 1:
        mask = jnp.where(jnp.tril(jnp.ones((t, t), jnp.bool_)), 0.0,
                         -1e9)[None, None].astype(jnp.float32)

    new_caches = []
    for i, layer in enumerate(params["layers"]):
        h = llama.rms_norm(x, layer["input_layernorm"], cfg.rms_norm_eps)
        attn_out, nc = llama.attention(
            layer, cfg, h, cos, sin,
            None if kv_caches is None else kv_caches[i],
            cache_pos, mask, capture=capture, prefix=f"layers.{i}.",
            psum_axis=psum_axis, **kw)
        x = x + attn_out
        h = llama.rms_norm(x, layer["post_attention_layernorm"],
                           cfg.rms_norm_eps)
        x = x + moe_ffn(layer, cfg, h, capture=capture,
                        prefix=f"layers.{i}.", psum_axis=psum_axis, **kw)
        new_caches.append(nc)

    x = llama.rms_norm(x, params["norm"], cfg.rms_norm_eps)
    if "lm_head" in params:
        logits = lin.linear(x, params["lm_head"], **kw)
    elif isinstance(params["embed_tokens"], lin.QuantizedTensor):
        logits = lin.linear(x, params["embed_tokens"], **kw)
    else:
        logits = x @ params["embed_tokens"].T.astype(x.dtype)
    return logits, (new_caches if kv_caches is not None else None)
