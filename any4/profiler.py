"""Per-component decode profiler (the reference's HookBasedProfiler,
benchmark.py:37-111, re-designed for JAX).

torch hooks time module boundaries inside one forward; under jit those
boundaries fuse away, so the equivalent here jits each component
(attention / MLP, per layer) standalone on decode-shaped inputs and times
it with the median wall clock. The split answers the same
question the reference's profiler does: where does a decode step spend its
time, attention or MLP, and in which layers.
"""
from __future__ import annotations

from typing import Dict, Optional

import jax
import jax.numpy as jnp

from .models import llama
from .utils import benchmark_in_ms


def profile_decode_components(params: Dict, cfg, batch: int = 1,
                              ctx: int = 256,
                              max_layers: Optional[int] = None,
                              iters: int = 20, warmup: int = 3) -> Dict:
    """Time attention vs MLP per layer at decode shapes (m = batch).

    Returns ``{"layers.N": {"attention_ms", "mlp_ms"}, ...,
    "totals": {...}}``; totals also report the attention share.
    """
    hd = cfg.head_dim_
    nkv = cfg.num_key_value_heads
    d = cfg.hidden_size
    pos = jnp.int32(ctx // 2)
    positions = jnp.full((batch, 1), ctx // 2, jnp.int32)
    cos, sin = llama.rope_tables(cfg, positions)
    mask = llama.decode_mask(ctx, pos)
    key = jax.random.PRNGKey(0)
    x = jax.random.normal(key, (batch, 1, d), jnp.float32).astype(cfg.dtype)
    kc = jnp.zeros((batch, ctx, nkv, hd), cfg.dtype)
    vc = jnp.zeros((batch, ctx, nkv, hd), cfg.dtype)

    @jax.jit
    def att_fn(layer, xx, kcc, vcc):
        out, _ = llama.attention(layer, cfg, xx, cos, sin, (kcc, vcc),
                                 pos, mask)
        return out

    @jax.jit
    def mlp_fn(layer, xx):
        return llama.mlp(layer, xx)

    results: Dict = {}
    t_att_total = t_mlp_total = 0.0
    layers = params["layers"]
    n = len(layers) if max_layers is None else min(max_layers, len(layers))
    for i in range(n):
        layer = layers[i]
        t_att = benchmark_in_ms(att_fn, layer, x, kc, vc,
                                warmup=warmup, iters=iters)
        t_mlp = benchmark_in_ms(mlp_fn, layer, x, warmup=warmup, iters=iters)
        results[f"layers.{i}"] = {"attention_ms": round(t_att, 4),
                                  "mlp_ms": round(t_mlp, 4)}
        t_att_total += t_att
        t_mlp_total += t_mlp
    scale = len(layers) / max(n, 1)  # extrapolate if truncated
    tot = (t_att_total + t_mlp_total) * scale
    results["totals"] = {
        "attention_ms": round(t_att_total * scale, 4),
        "mlp_ms": round(t_mlp_total * scale, 4),
        "attention_share": round(t_att_total / max(t_att_total + t_mlp_total,
                                                   1e-12), 4),
        "sum_ms": round(tot, 4),
        "layers_profiled": n,
    }
    return results
