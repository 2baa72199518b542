"""Tensor/data-parallel inference over a device mesh.

The reference has no first-class parallelism -- multi-GPU is HF `accelerate`
layer placement (eval.py:168-177; SURVEY.md section 2.3). Here: a
``jax.sharding.Mesh`` over the cards of a host with megatron-style tensor
parallelism expressed via ``shard_map``:

- q/k/v/gate/up projections are **column-parallel**: the weight's output dim
  (and so attention heads / FFN neurons) is split over the ``tp`` axis; for a
  QuantizedTensor that means sharding ``packed``/``lut`` on axis 0 and
  ``scales``/``zeros`` on axis 1 -- the packed codes *are* the sharded
  tensor.
- o/down projections are **row-parallel**: input dim split; each shard
  computes a partial product over its k-slice and a ``lax.psum`` over ``tp``
  combines them (hook in models/llama.py attention/mlp).
- the KV cache shards over heads (tp) and batch (dp); embeddings and norms
  are replicated.

Everything runs inside one ``shard_map`` so the Pallas kernel sees local
shards (GSPMD cannot partition a pallas_call on its own).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..models import llama
from ..ops import linear as lin

# column-parallel leaves: shard output dim; row-parallel: shard input dim.
# w1/w3/w2 are Mixtral per-expert gate/up/down (models/mixtral.py): every
# expert splits its FFN dim over tp like a dense MLP; the router stays
# replicated so routing decisions are shard-identical.
_COL_KEYS = ("q_proj", "k_proj", "v_proj", "gate_proj", "up_proj",
             "qkv_proj", "gateup_proj", "w1", "w3", "w13")
_ROW_KEYS = ("o_proj", "down_proj", "w2")
_REPL_KEYS = ("input_layernorm", "post_attention_layernorm", "norm",
              "embed_tokens", "lm_head", "router")


def make_mesh(dp: int = 1, tp: Optional[int] = None,
              devices=None) -> Mesh:
    """A ``(dp, tp)`` mesh as a plain reshape of ``devices``: the cards of
    one host reach each other all to all over NVLink at one rate, so any
    assignment of cards to mesh positions is as good as another."""
    devices = np.asarray(devices if devices is not None else jax.devices())
    if tp is None:
        tp = len(devices) // dp
    assert dp * tp == len(devices), \
        f"dp*tp={dp * tp} != device count {len(devices)}"
    return Mesh(devices.reshape(dp, tp), ("dp", "tp"))


def _qt_spec(kind: str, qt: lin.QuantizedTensor) -> lin.QuantizedTensor:
    """PartitionSpecs for the leaves of a QuantizedTensor (mirrors None-ness
    of optional leaves so the pytree structures match). The transposed
    any4t layout swaps the packed axes (codes are [kp/8, n], LUT [16, n]),
    so its n/k sharding axes swap accordingly."""
    transposed = qt.fmt in lin.TRANSPOSED_FMTS
    if qt.fmt in lin._GROUPED_FMTS:
        # grouped XLA layout: packed [G, n, 128] -- n on axis 1, k
        # (group) on axis 0
        if kind == "col":
            return lin.QuantizedTensor(
                packed=P(None, "tp", None), scales=P(None, "tp"),
                zeros=P(None, "tp"), lut=None, fmt=qt.fmt,
                group_size=qt.group_size, shape=qt.shape,
                dtype=qt.dtype, row_shards=qt.row_shards)
        return lin.QuantizedTensor(
            packed=P("tp", None, None), scales=P("tp", None),
            zeros=P("tp", None), lut=None, fmt=qt.fmt,
            group_size=qt.group_size, shape=qt.shape, dtype=qt.dtype,
            row_shards=qt.row_shards)
    if qt.fmt in lin._ROWSCALE_FMTS:
        # [k, n] int8 with per-row scales [1, n]: n-sharding splits
        # packed axis 1 + scales; k-sharding splits packed axis 0 only
        # (scales replicate, the rank-1 affine partials psum linearly)
        if kind == "col":
            return lin.QuantizedTensor(
                packed=P(None, "tp"), scales=P(None, "tp"),
                zeros=P(None, "tp"), lut=None, fmt=qt.fmt,
                group_size=qt.group_size, shape=qt.shape,
                dtype=qt.dtype, row_shards=qt.row_shards)
        return lin.QuantizedTensor(
            packed=P("tp", None), scales=P(None, None),
            zeros=P(None, None), lut=None, fmt=qt.fmt,
            group_size=qt.group_size, shape=qt.shape, dtype=qt.dtype,
            row_shards=qt.row_shards)
    has_row_lut = qt.lut is not None and (
        qt.lut.shape[1] == qt.shape[0] if transposed
        else qt.lut.shape[0] == qt.shape[0])
    if kind == "col":  # shard n (output) dim
        if qt.lut is None:
            lut = None
        elif not has_row_lut:
            lut = P(None, None)
        else:
            lut = P(None, "tp") if transposed else P("tp", None)
        return lin.QuantizedTensor(
            packed=P(None, "tp") if transposed else P("tp", None),
            scales=P(None, "tp"),
            zeros=P(None, "tp"), lut=lut,
            fmt=qt.fmt, group_size=qt.group_size, shape=qt.shape,
            dtype=qt.dtype, row_shards=qt.row_shards)
    else:               # row: shard k (input) dim
        lut = None if qt.lut is None else P(None, None)
        return lin.QuantizedTensor(
            packed=P("tp", None) if transposed else P(None, "tp"),
            scales=P("tp", None),
            zeros=P("tp", None), lut=lut,
            fmt=qt.fmt, group_size=qt.group_size, shape=qt.shape,
            dtype=qt.dtype, row_shards=qt.row_shards)


def _dense_spec(kind: str):
    return P("tp", None) if kind == "col" else P(None, "tp")


# biases of column-parallel projections shard with the output dim; a
# row-parallel projection's bias is replicated but must survive the psum
# over tp exactly once, so it is pre-divided by tp at shard time
_COL_BIAS_KEYS = ("q_bias", "k_bias", "v_bias", "qkv_bias", "gate_bias",
                  "up_bias", "gateup_bias")
_ROW_BIAS_KEYS = ("o_bias", "down_bias")


def param_specs(params: Dict) -> Dict:
    """Build a matching pytree of PartitionSpecs for a llama param tree."""

    def spec_for(name: str, leaf):
        last = name.split(".")[-1]
        if last in _COL_KEYS or last in _COL_BIAS_KEYS:
            kind = "col"
        elif last in _ROW_KEYS:
            kind = "row"
        else:
            kind = "repl"
        if isinstance(leaf, lin.QuantizedTensor):
            if kind == "repl":
                return lin.QuantizedTensor(
                    P(None, None), P(None, None), P(None, None),
                    None if leaf.lut is None else P(None, None),
                    fmt=leaf.fmt, group_size=leaf.group_size,
                    shape=leaf.shape, dtype=leaf.dtype,
                    row_shards=leaf.row_shards)
            return _qt_spec(kind, leaf)
        if getattr(leaf, "ndim", 1) == 1 and kind == "col":
            return P("tp")
        if kind == "repl" or leaf.ndim != 2:
            return P(*([None] * getattr(leaf, "ndim", 1)))
        return _dense_spec(kind)

    from ..quant.api import _walk, _copy_tree
    out = _copy_tree(params)
    for name, leaf, setter in _walk(out):
        setter(spec_for(name, leaf))
    return out


def _interleave_rows(leaf, sizes, tp: int):
    """Permute the output rows of a fused (concatenated) weight so each
    contiguous 1/tp chunk holds that shard's slice of EVERY constituent.

    A fused [q;k;v] weight sharded P('tp', ...) splits contiguously, which
    would give shard 0 only q rows; the local forward instead expects shard
    i to see (q_i; k_i; v_i). sizes are the constituent output dims.
    """
    order = []
    offs = np.cumsum([0] + list(sizes[:-1]))
    for i in range(tp):
        for off, sz in zip(offs, sizes):
            assert sz % tp == 0, f"fused part {sz} not divisible by tp={tp}"
            per = sz // tp
            order.extend(range(off + i * per, off + (i + 1) * per))
    order = np.asarray(order)
    if isinstance(leaf, lin.QuantizedTensor):
        if leaf.fmt in lin._GROUPED_FMTS or leaf.fmt in lin._ROWSCALE_FMTS:
            # XLA-dot layouts: output rows on axis 1 of packed
            # (grouped [G, n, 128] indexes axis 1 the same way as
            # rowscale [k, n])
            return dataclasses.replace(
                leaf, packed=leaf.packed[:, order],
                scales=leaf.scales[:, order], zeros=leaf.zeros[:, order])
        if leaf.fmt in lin.TRANSPOSED_FMTS:
            # transposed layout: output rows live on AXIS 1 of packed/lut
            lut = leaf.lut
            if lut is not None and lut.shape[1] == leaf.shape[0]:
                lut = lut[:, order]
            return dataclasses.replace(
                leaf, packed=leaf.packed[:, order],
                scales=leaf.scales[:, order],
                zeros=leaf.zeros[:, order], lut=lut)
        lut = leaf.lut
        if lut is not None and lut.shape[0] == leaf.shape[0]:
            lut = lut[order]
        packed_order = order
        if leaf.fmt in ("int4p", "int8p"):
            # pair-packed words hold TWO output rows: the permutation must
            # move word rows, which requires every chunk boundary even so
            # row pairs stay together
            assert (offs % 2 == 0).all() and \
                all((sz // tp) % 2 == 0 for sz in sizes), \
                "pair-packed fused reshard needs even per-shard chunks"
            packed_order = order[0::2] // 2
        elif leaf.fmt in ("w4a8", "w8a8q", "int8q", "any4q8"):
            # quad-packed words hold FOUR output rows
            assert (offs % 4 == 0).all() and \
                all((sz // tp) % 4 == 0 for sz in sizes), \
                "quad-packed fused reshard needs per-shard chunks % 4 == 0"
            packed_order = order[0::4] // 4
        return dataclasses.replace(
            leaf, packed=leaf.packed[packed_order],
            scales=leaf.scales[:, order],
            zeros=leaf.zeros[:, order], lut=lut)
    return leaf[order]


def _fused_part_sizes(key: str, cfg) -> Optional[list]:
    if cfg is None:
        return None
    hd = cfg.head_dim_
    if key == "qkv_proj" or key == "qkv_bias":
        return [cfg.num_attention_heads * hd,
                cfg.num_key_value_heads * hd,
                cfg.num_key_value_heads * hd]
    if key in ("gateup_proj", "gateup_bias", "w13"):
        return [cfg.intermediate_size, cfg.intermediate_size]
    return None


def reshard_fused(params: Dict, cfg, tp: int) -> Dict:
    """Interleave-reshard fused qkv/gateup weights for tp-way column
    parallelism (no-op for tp=1 or unfused trees)."""
    from ..quant.api import _walk, _copy_tree
    out = _copy_tree(params)
    if tp == 1:
        return out
    for name, leaf, setter in _walk(out):
        sizes = _fused_part_sizes(name.split(".")[-1], cfg)
        if sizes is not None and leaf is not None:
            setter(_interleave_rows(leaf, sizes, tp))
    return out


def shard_params(params: Dict, mesh: Mesh, cfg=None) -> Tuple[Dict, Dict]:
    """device_put the param tree with TP shardings. Returns (params, specs).

    ``cfg`` (a LlamaConfig) is REQUIRED when the tree contains fused
    qkv_proj/gateup_proj leaves: their rows must be interleave-resharded
    per shard (see :func:`_interleave_rows`) before a contiguous P('tp')
    split is correct.
    """
    tp = mesh.shape.get("tp", 1)
    has_fused = False
    from ..quant.api import _walk
    for name, leaf, _ in _walk(params):
        last = name.split(".")[-1]
        if last in ("qkv_proj", "gateup_proj", "w13"):
            has_fused = True
    if has_fused and tp > 1:
        if cfg is None:
            raise ValueError(
                "shard_params: fused qkv/gateup weights need cfg= to "
                "interleave-reshard rows for tp>1 (a contiguous P('tp') "
                "split of a fused weight is silently wrong)")
        params = reshard_fused(params, cfg, tp)
    if tp > 1:
        # a row-parallel projection's bias is added once per shard before
        # the psum: pre-divide so the sum reconstructs the bias exactly
        from ..quant.api import _copy_tree
        params = _copy_tree(params)
        for name, leaf, setter in _walk(params):
            if leaf is not None and name.split(".")[-1] in _ROW_BIAS_KEYS:
                setter(leaf / tp)
    specs = param_specs(params)

    def put(leaf, spec):
        return jax.device_put(leaf, NamedSharding(mesh, spec))

    shards = jax.tree_util.tree_map(
        put, params, specs,
        is_leaf=lambda x: isinstance(x, P))
    return shards, specs


def local_config(cfg: "llama.LlamaConfig", tp: int) -> "llama.LlamaConfig":
    """Per-shard head counts for column-parallel attention."""
    assert cfg.num_attention_heads % tp == 0, \
        f"{cfg.num_attention_heads} heads not divisible by tp={tp}"
    assert cfg.num_key_value_heads % tp == 0, \
        f"{cfg.num_key_value_heads} kv heads not divisible by tp={tp}"
    return dataclasses.replace(
        cfg,
        num_attention_heads=cfg.num_attention_heads // tp,
        num_key_value_heads=cfg.num_key_value_heads // tp,
        # pin head_dim BEFORE shrinking head counts: a derived
        # hidden_size // num_attention_heads would silently double
        head_dim=cfg.head_dim_)


def make_tp_forward(cfg: "llama.LlamaConfig", mesh: Mesh, param_spec,
                    with_cache: bool = False, forward_fn=None):
    """Build a jitted shard_map'd forward.

    Returns ``fn(params, input_ids[, kv_caches, cache_pos, mask])`` ->
    ``(logits, new_caches)``. Batch shards over ``dp``; heads/FFN over
    ``tp``; logits are replicated (psum'd partials after row-parallel
    layers happen inside). ``forward_fn`` defaults to ``llama.forward``;
    pass ``mixtral.forward`` (or any forward with the same signature) for
    other families.
    """
    fwd = llama.forward if forward_fn is None else forward_fn
    tp = mesh.shape["tp"]
    cfg_local = local_config(cfg, tp)
    cache_spec = P("dp", None, "tp", None)  # [b, t, heads, hd]

    if not with_cache:
        def local_fn(params, input_ids):
            logits, _ = fwd(params, cfg_local, input_ids,
                            psum_axis="tp")
            return logits

        fn = jax.shard_map(
            local_fn, mesh=mesh,
            in_specs=(param_spec, P("dp", None)),
            out_specs=P("dp", None, None),
            check_vma=False)
        return jax.jit(fn)

    def local_step(params, token, pos, kv_caches):
        max_len = kv_caches[0][0].shape[1]
        b = token.shape[0]
        positions = jnp.broadcast_to(pos, (b, 1))
        mask = llama.decode_mask(max_len, pos)
        logits, caches = fwd(
            params, cfg_local, token[:, None], positions=positions,
            kv_caches=kv_caches, cache_pos=pos, mask=mask, psum_axis="tp")
        return logits[:, -1, :], caches

    n_layers = cfg.num_hidden_layers
    caches_spec = [(cache_spec, cache_spec) for _ in range(n_layers)]
    fn = jax.shard_map(
        local_step, mesh=mesh,
        in_specs=(param_spec, P("dp"), P(), caches_spec),
        out_specs=(P("dp", None), caches_spec),
        check_vma=False)
    return jax.jit(fn)
