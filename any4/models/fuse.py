"""Projection fusion: merge {q,k,v} and {gate,up} into single linears.

Decode launches one kernel per linear; fusing the three attention input
projections (shared input, shared k) and the two MLP input projections cuts
kernel launches per layer from 7 to 4 and gives each launch a larger output
block (more parallel work per launch, less dispatch overhead). Works on dense
weights and on QuantizedTensors (codes/scales/LUTs concatenate along the
output dim because all parts share the k axis and group geometry) -- so a
model can be quantized first and fused after, or vice versa.

The forward (models/llama.py attention/mlp) automatically uses
``qkv_proj``/``gateup_proj`` when present.
"""
from __future__ import annotations

from typing import Dict, List

import jax
import jax.numpy as jnp

from ..ops.linear import QuantizedTensor


def concat_quantized(parts: List[QuantizedTensor]) -> QuantizedTensor:
    """Concatenate quantized weights along the output (n) dimension."""
    from ..ops.linear import TRANSPOSED_FMTS
    first = parts[0]
    for p in parts[1:]:
        assert p.fmt == first.fmt and p.group_size == first.group_size, \
            "fused projections must share quantization format/group"
        assert p.shape[1] == first.shape[1], "fused projections must share k"
        assert p.row_shards == first.row_shards
    from ..ops.linear import _GROUPED_FMTS, _ROWSCALE_FMTS
    transposed = first.fmt in TRANSPOSED_FMTS
    # transposed packings carry output rows on AXIS 1 of packed/lut; the
    # XLA-dot layouts (grouped [G, n, 128] and rowscale [k, n]) likewise
    # carry n on axis 1
    packed = jnp.concatenate(
        [p.packed for p in parts],
        axis=1 if transposed or first.fmt in _GROUPED_FMTS
        or first.fmt in _ROWSCALE_FMTS else 0)
    scales = jnp.concatenate([p.scales for p in parts], axis=1)
    zeros = jnp.concatenate([p.zeros for p in parts], axis=1)
    row_lut = first.lut is not None and (
        first.lut.shape[1] == first.shape[0] if transposed
        else first.lut.shape[0] == first.shape[0])
    if first.lut is None:
        lut = None
    elif row_lut:  # per-row LUTs
        lut = jnp.concatenate([p.lut for p in parts],
                              axis=1 if transposed else 0)
    else:  # shared global table
        lut = first.lut
    n_total = sum(p.shape[0] for p in parts)
    return QuantizedTensor(packed, scales, zeros, lut, first.fmt,
                           first.group_size, (n_total, first.shape[1]),
                           first.dtype, first.row_shards)


def _concat(parts):
    if isinstance(parts[0], QuantizedTensor):
        return concat_quantized(parts)
    return jnp.concatenate(parts, axis=0)


def stack_experts(params: Dict) -> Dict:
    """Stack every MoE layer's experts into TWO dense weights so the
    whole routed FFN runs as two GEMVs per layer.

    ``moe_w13 = concat_e([w1_e; w3_e])  [E*2f, d]`` (output-dim stack)
    ``moe_w2  = concat_e(w2_e, axis=k)  [d, E*f]`` (input-dim stack)

    The routed combine ``y = sum_e gate_e * (h_e @ w2_e^T)`` is linear in
    the experts, so gating folds into the ``moe_w2`` input segments and
    the sum IS the single stacked matmul -- numerics identical to the
    dense dispatch up to f32 accumulation order. At serving batch sizes
    most experts are routed anyway (8 slots x top-2 over 8 experts hits
    ~88%), so the dense-all-experts compute costs the same weight reads
    while 2 launches replace 16 + per-expert branch machinery. Apply BEFORE quantization: group boundaries (128) align
    with the per-expert segments (f % 128 == 0), so uniform formats
    quantize identically to per-expert; any4's per-row w2 LUTs then span
    experts (one codebook per output row across all segments) -- a
    slightly different accuracy point, covered by tests.
    """
    from ..quant.api import _copy_tree
    out = _copy_tree(params)
    for layer in out.get("layers", []):
        experts = layer.pop("experts", None)
        if not experts:
            continue
        w13 = [jnp.concatenate([e["w13"]], axis=0) if "w13" in e else
               jnp.concatenate([e["w1"], e["w3"]], axis=0)
               for e in experts]
        layer["moe_w13"] = jnp.concatenate(w13, axis=0)
        layer["moe_w2"] = jnp.concatenate([e["w2"] for e in experts],
                                          axis=1)
    return out


def fuse_projections(params: Dict) -> Dict:
    """Return a new param tree with q/k/v -> qkv_proj and gate/up ->
    gateup_proj fused (llama-family layers only; layers without those keys
    are left untouched)."""
    from ..quant.api import _copy_tree
    out = _copy_tree(params)
    for layer in out.get("layers", []):
        if all(k in layer for k in ("q_proj", "k_proj", "v_proj")):
            parts = [layer.pop("q_proj"), layer.pop("k_proj"),
                     layer.pop("v_proj")]
            widths = [p.shape[0] for p in parts]
            layer["qkv_proj"] = _concat(parts)
            biases = [layer.pop(b, None)
                      for b in ("q_bias", "k_bias", "v_bias")]
            if any(b is not None for b in biases):
                # a partial bias set (e.g. k/v-only) fuses with zeros for
                # the missing constituents rather than silently dropping
                biases = [jnp.zeros((w,), dtype=next(
                              x.dtype for x in biases if x is not None))
                          if b is None else b
                          for b, w in zip(biases, widths)]
                layer["qkv_bias"] = jnp.concatenate(biases)
        if all(k in layer for k in ("gate_proj", "up_proj")):
            layer["gateup_proj"] = _concat(
                [layer.pop("gate_proj"), layer.pop("up_proj")])
        # MoE expert gate/up fusion (w1 + w3 -> w13): cuts per-expert
        # decode dispatches from 3 to 2; mixtral.moe_ffn splits halves
        for expert in layer.get("experts", []):
            if all(k in expert for k in ("w1", "w3")):
                expert["w13"] = _concat(
                    [expert.pop("w1"), expert.pop("w3")])
    return out
