"""Model quantization driver: a functional pytree transform.

The reference walks ``model.named_modules()``, swapping each ``nn.Linear``
for a quantized module in place (quantize.py:32-85), with the lm_head
skipped by default (quantize.py:36) and optional per-layer online
calibration. Here a "model" is a parameter pytree; quantization maps
every targeted 2-D weight leaf to a
:class:`~any4.ops.linear.QuantizedTensor` (real quantization) or to its
dequantized reconstruction (pseudo-quantization, the accuracy-evaluation
path), leaving the forward function unchanged -- `ops.linear.linear`
dispatches on leaf type.

The ``quant_methods`` registry mirrors the reference's
(quantize.py:1015-1023): int4 / int8 / intq / any4 / anyq / nf4 / fp4, plus
mx4.
"""
from __future__ import annotations

import functools
from typing import Any, Callable, Dict, Optional, Sequence, Union

import jax
import jax.numpy as jnp

from ..ops import linear as lin

# parameter-tree keys that are linear weights in our model families
DEFAULT_LINEAR_KEYS = (
    "q_proj", "k_proj", "v_proj", "o_proj",
    "gate_proj", "up_proj", "down_proj",
    "qkv_proj", "gateup_proj",
    "fc1", "fc2", "out_proj", "lm_head",
    "w1", "w2", "w3", "w13", "moe_w13", "moe_w2", "wq", "wk", "wv", "wo",
)
DEFAULT_SKIP = ("lm_head",)  # reference skips the LM head by default

# leaves whose *input* (k) dim is sharded under tensor parallelism; with
# ``row_parallel_shards`` these pack k as independently-padded shards
ROW_PARALLEL_KEYS = ("o_proj", "down_proj", "fc2", "w2", "wo", "out_proj")


def _walk(tree: Any, prefix: str = ""):
    """Yield (name, leaf, setter) triples over nested dict/list pytrees."""
    if isinstance(tree, dict):
        for k in tree:
            name = f"{prefix}.{k}" if prefix else str(k)
            yield from _walk_child(tree, k, name)
    elif isinstance(tree, (list, tuple)):
        for i in range(len(tree)):
            name = f"{prefix}.{i}" if prefix else str(i)
            yield from _walk_child(tree, i, name)


def _walk_child(parent, key, name):
    child = parent[key]
    if isinstance(child, (dict, list)):
        yield from _walk(child, name)
    else:
        def setter(value, parent=parent, key=key):
            parent[key] = value
        yield name, child, setter


def _copy_tree(tree):
    if isinstance(tree, dict):
        return {k: _copy_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_copy_tree(v) for v in tree]
    if isinstance(tree, tuple):
        return tuple(_copy_tree(v) for v in tree)
    return tree


def default_layer_filter(name: str, leaf: Any) -> bool:
    import numpy as np
    if not isinstance(leaf, (jax.Array, np.ndarray)) or leaf.ndim != 2:
        return False
    last = name.split(".")[-1]
    return last in DEFAULT_LINEAR_KEYS


def quantize_model(
    params: Dict,
    fmt: str = "any4",
    group_size: int = 128,
    skip_modules: Union[str, Sequence[str]] = DEFAULT_SKIP,
    layer_filter: Callable[[str, Any], bool] = default_layer_filter,
    pseudo: bool = False,
    sample_weight: Union[None, Dict, Callable, jax.Array] = None,
    calibrate_fn: Optional[Callable] = None,
    progress: bool = False,
    row_parallel_shards: int = 1,
    quantize_embeddings: Union[bool, str, None] = None,
    **kwargs,
) -> Dict:
    """Quantize every targeted linear weight in a parameter pytree.

    - ``skip_modules``: leaf names (final path component or full dotted path)
      to leave dense; defaults to the LM head (reference quantize.py:36).
    - ``quantize_embeddings``: also quantize ``embed_tokens`` tables -- a
      format name, or True to reuse ``fmt``. Token lookup becomes a row
      gather + dequant (ops.linear.embedding_lookup) and a *tied* LM head
      runs the fused quantized kernel off the same packed table -- at
      decode the vocab matmul's HBM read drops 2x (w8a8) / ~4x (4-bit).
      No reference analog (its tinygemm only swaps nn.Linear modules);
      restricted to row-gatherable packings (ops.linear.EMBED_FMTS).
    - ``pseudo``: fake-quantization -- store the dequantized reconstruction
      as a dense array (reference ``pseudo=True`` path, quantize.py:838-870).
    - ``sample_weight``: a dict ``{layer_name: [k] activations}``, a single
      ``[k]`` array, or a callable ``f(name) -> [k]`` (the online-calibration
      hook; reference quantize.py:56-63 re-calibrates per layer with
      ``seed=index``).
    - extra kwargs flow to :func:`any4.ops.linear.quantize_tensor` (and
      onwards to the any4 learner: init, keep_outliers,
      scale_sample_weight, ...).
    """
    if isinstance(skip_modules, str):
        skip_modules = [s.strip() for s in skip_modules.split(",")]
    out = _copy_tree(params)
    targets = [(n, l, s) for n, l, s in _walk(out) if layer_filter(n, l)
               and n.split(".")[-1] not in skip_modules
               and n not in skip_modules]
    for index, (name, leaf, setter) in enumerate(targets):
        kw = dict(kwargs)
        sw = sample_weight
        if calibrate_fn is not None:
            sw = calibrate_fn(layers=[name], seed=index)
        if isinstance(sw, dict):
            sw = sw.get(name)
        elif callable(sw):
            sw = sw(name)
        if sw is not None:
            kw["sample_weight"] = jnp.asarray(sw)
        if fmt not in ("any4", "any4t", "any4q8", "any4q8g", "any4q8r",
                       "anyq"):
            # sample weights / kmeans options only apply to learned formats
            for k in ("sample_weight", "init", "keep_outliers",
                      "scale_sample_weight", "abs_weight_sample_weight",
                      "bias_pow", "kmeans_iters", "seed", "per_row",
                      "surrogate_cluster"):
                kw.pop(k, None)
        else:
            kw.setdefault("seed", index)
        f = "any4" if fmt == "anyq" else ("int4" if fmt == "intq" else fmt)
        shards = row_parallel_shards \
            if name.split(".")[-1] in ROW_PARALLEL_KEYS else 1
        try:
            qt = lin.quantize_tensor(leaf, f, group_size, row_shards=shards,
                                     **kw)
        except Exception as e:  # device OOM during clustering: the analog
            # of the reference's CUDA-OOM -> CPU re-cluster retry
            # (quantize.py:851-861); the vectorized k-means retries with a
            # much smaller row chunk (bounds peak [rows, k, 16] distance
            # memory). Only the clustering formats have that knob --
            # other formats re-raise rather than retrying identically.
            if ("RESOURCE_EXHAUSTED" not in str(e)
                    and "Out of memory" not in str(e)) \
                    or f not in ("any4", "any4t", "any4q8", "any4q8g", "any4q8r"):
                raise
            if progress:
                print(f"  OOM quantizing {name}; retrying with "
                      f"row_chunk=8")
            qt = lin.quantize_tensor(leaf, f, group_size, row_shards=shards,
                                     **{**kw, "row_chunk": 8})
        if progress:
            print(f"  quantized {name} {leaf.shape} -> {fmt}")
        if pseudo:
            setter(lin.dequantize_tensor(qt, dtype=leaf.dtype))
        else:
            setter(qt)
    if quantize_embeddings:
        efmt = fmt if quantize_embeddings is True else str(quantize_embeddings)
        if efmt == "anyq":
            efmt = "any4"
        elif efmt == "intq":
            efmt = "int4"
        assert efmt in lin.EMBED_FMTS, \
            f"quantize_embeddings needs a row-gatherable packing, one of " \
            f"{lin.EMBED_FMTS}; got {efmt!r}"
        for name, leaf, setter in _walk(out):
            if name.split(".")[-1] != "embed_tokens" \
                    or getattr(leaf, "ndim", 0) != 2:
                continue
            ekw = {}
            if efmt == "any4":
                ekw = {k: v for k, v in kwargs.items()
                       if k in ("kmeans_iters", "init", "keep_outliers",
                                "per_row", "row_chunk")}
            # embedding tables need the row-gatherable (row-major) packing;
            # the LUT formats otherwise default to the transposed layout
            qt = lin.quantize_tensor(leaf, efmt, group_size, layout="row",
                                     **ekw)
            if progress:
                print(f"  quantized {name} {leaf.shape} -> {efmt}")
            setter(lin.dequantize_tensor(qt, dtype=leaf.dtype)
                   if pseudo else qt)
    return out


def dequantize_model(params: Dict) -> Dict:
    """Replace every QuantizedTensor leaf with its dense reconstruction."""
    out = _copy_tree(params)
    for name, leaf, setter in _walk(out):
        if isinstance(leaf, lin.QuantizedTensor):
            setter(lin.dequantize_tensor(leaf))
    return out


def model_size_bytes(params: Dict) -> int:
    total = 0
    for leaf in jax.tree_util.tree_leaves(
            params, is_leaf=lambda x: isinstance(x, lin.QuantizedTensor)):
        if isinstance(leaf, lin.QuantizedTensor):
            total += leaf.nbytes
        elif isinstance(leaf, jax.Array):
            total += leaf.size * leaf.dtype.itemsize
    return total


quant_methods = {
    "int4": functools.partial(quantize_model, fmt="int4"),
    "int4p": functools.partial(quantize_model, fmt="int4p"),
    "int8": functools.partial(quantize_model, fmt="int8"),
    "int8p": functools.partial(quantize_model, fmt="int8p"),
    # int8-activation formats: int4/int8 weights with per-row int8
    # activations (no reference analog -- the reference's tinygemm is
    # weight-only)
    "w4a8": functools.partial(quantize_model, fmt="w4a8"),
    "w8a8": functools.partial(quantize_model, fmt="w8a8"),
    "intq": functools.partial(quantize_model, fmt="intq"),
    # any4 in the row-planar packing the lookup GEMV kernel reads;
    # "any4t" stores the same numbers in the transposed packing
    "any4": functools.partial(quantize_model, fmt="any4"),
    "any4t": functools.partial(quantize_model, fmt="any4t"),
    # any4 LUT snapped to an int8 grid, codes materialized int8 at pack
    # time: any4-class accuracy on the w8a8 int8-dot path (8 bits/weight)
    "any4q8": functools.partial(quantize_model, fmt="any4q8"),
    # per-ROW-scale variant: the any4 LUT learned on whole-row-normalized
    # weights, snapped to int8 -- runs as ONE plain XLA int8 dot + rank-1
    # affine
    "any4q8r": functools.partial(quantize_model, fmt="any4q8r"),
    # per-channel int8 on the plain XLA dot
    "w8a8r": functools.partial(quantize_model, fmt="w8a8r"),
    "int8r": functools.partial(quantize_model, fmt="int8r"),
    "anyq": functools.partial(quantize_model, fmt="anyq"),
    "nf4": functools.partial(quantize_model, fmt="nf4"),
    "nf4t": functools.partial(quantize_model, fmt="nf4t"),
    "fp4": functools.partial(quantize_model, fmt="fp4"),
    "fp4t": functools.partial(quantize_model, fmt="fp4t"),
    "mx4": functools.partial(quantize_model, fmt="mx4", group_size=32),
}
