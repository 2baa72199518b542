"""AWQ-style activation-aware pre-quantization (scale search + clipping).

A re-derivation of the reference's pre_process/awq pipeline:
``run_awq`` grid-searches, per decoder block, a per-input-channel scaling
``s = x_max^ratio`` (20 ratios) that minimizes the quantized block-output
MSE, folds the winning scales into the preceding layernorm/linear
(auto_scale.py:34-156), then grid-searches per-row weight clipping
(auto_clip.py:11-101). Scaling is mathematically neutral in fp
(``(x / s) @ (W * s)^T == x @ W^T``) but moves quantization error away from
channels with large activations.

Here the model is a functional param pytree, so "apply scale" is a pure
pytree edit and the searched objective uses the framework's own
pseudo-quantizers. Four scale groups per Llama block (mirroring the
reference's llama adapter, pre_process/awq/auto_scale.py llama branches):

  1. input_layernorm -> {q,k,v}_proj
  2. v_proj -> o_proj           (fold into v rows)
  3. post_attention_layernorm -> {gate,up}_proj
  4. up_proj -> down_proj       (fold into up rows)

Model-family coverage (a deliberate narrowing of the reference's
adapter table, pre_process/awq/pre_quant.py:25-83 + auto_scale.py): the
reference ships AWQ schemas for llama/opt/bloom/falcon/mpt/gptj/gptneox/
mixtral because it pre-processes arbitrary HF torch models; this
framework only has functional forwards for the llama family (incl.
Mistral/Qwen2/Gemma layouts), OPT, and Mixtral, so those are the three
AWQ schemas implemented (llama above; OPT fc1/fc2+attention;
Mixtral keeps the router in the scale group -- see run_awq's per-family
branches).
bloom/falcon/mpt/gptj have no forward here to calibrate against; adding
one of those families means adding its model module first, then a
4-line group schema in this file.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import quant
from . import kmeans as _kmeans


def pseudo_quantize(w: jax.Array, n_bit: int = 4, group_size: int = 128,
                    numeric_type: str = "int") -> jax.Array:
    """Fake-quantize a weight with the framework's quantizers — the AWQ
    search objective's inner quantizer, dispatched over numeric_type like
    the reference's ``pseudo_quantize_tensor`` (quantizer.py:157-176:
    {int, any, nf4, fp4}), so the scale/clip search optimizes the SAME
    format that will be deployed (AWQ+any4 is the combination the paper
    ships). All branches are jit-safe (they run inside the search scans).

    - ``int``: uniform grouped asymmetric (pseudo_int_quantize_tensor)
    - ``any4``/``any``: per-row k-means LUT in the group-normalized
      domain (pseudo_any_quantize_tensor, quantizer.py:276-323). Uses the
      deterministic linspace init with a short Lloyd run — the search
      only needs relative ordering of candidates; the final deployment
      quantization runs the full pipeline.
    - ``nf4``/``fp4``: absmax fixed-codebook rounding (nf4_round/
      fp4_round, quantizer.py:133-154).
    """
    if numeric_type == "int":
        codes, scales, zeros = quant.group_quantize(w, n_bit, group_size)
        return quant.group_dequantize(codes, scales, zeros, n_bit,
                                      group_size).astype(w.dtype)
    if numeric_type in ("any", "any4"):
        wg, scales, zeros = quant.group_codes_float(w, n_bit, group_size)
        lut, assign = _kmeans.kmeans_rows(
            wg, n_clusters=2 ** n_bit, init="int", iters=8,
            row_chunk=wg.shape[0])
        vals = jnp.take_along_axis(lut, assign, axis=1)
        vg = vals.reshape(w.shape[0], -1, group_size) - 2 ** (n_bit - 1)
        wdeq = vg * scales[..., None] + zeros[..., None]
        return wdeq.reshape(w.shape).astype(w.dtype)
    if numeric_type in ("nf4", "fp4"):
        codes, scales = quant.lut_quantize(w, fmt=numeric_type,
                                           group_size=group_size)
        return quant.lut_dequantize(codes, scales, fmt=numeric_type,
                                    group_size=group_size).astype(w.dtype)
    raise ValueError(f"unsupported numeric_type {numeric_type!r}")


def _group_output(x: jax.Array, ws: List[jax.Array]) -> jax.Array:
    return jnp.concatenate([x @ w.T.astype(x.dtype) for w in ws], axis=-1)


import functools


def _candidate_scale(x_max: jax.Array, ratio) -> jax.Array:
    s = jnp.power(x_max, ratio)
    s = s / jnp.sqrt(s.max() * s.min())
    return jnp.clip(s, 1e-4, 1e4)


@functools.partial(jax.jit, static_argnames=("n_grid", "n_bit",
                                             "group_size", "numeric_type"))
def _scale_search_mses(x, weights, x_max, n_grid, n_bit, group_size,
                       numeric_type):
    """One compiled program evaluates the WHOLE ratio grid with lax.scan
    (the reference loops candidates in Python with a device sync each,
    auto_scale.py:109-156 -- per-candidate dispatch would dominate at
    model scale)."""
    y_ref = _group_output(x, [w.astype(jnp.float32) for w in weights])

    def body(_, ratio):
        s = _candidate_scale(x_max, ratio)
        ws_q = [pseudo_quantize(w.astype(jnp.float32) * s[None, :],
                                n_bit, group_size, numeric_type)
                / s[None, :]
                for w in weights]
        y = _group_output(x, ws_q)
        return None, jnp.mean((y - y_ref) ** 2)

    ratios = jnp.arange(n_grid, dtype=jnp.float32) / n_grid
    _, mses = jax.lax.scan(body, None, ratios)
    return mses


def search_scale(x: jax.Array, weights: List[jax.Array], n_grid: int = 20,
                 n_bit: int = 4, group_size: int = 128,
                 numeric_type: str = "int") -> Tuple[jax.Array, float]:
    """Grid-search the best per-channel scale for a group of linears that
    share the input ``x`` [t, k]. Returns (scales [k], best_ratio).

    Candidate scales are ``x_max^ratio`` normalized to unit geometric mean
    (reference auto_scale.py:109-156). The grid runs as one jitted scan;
    only the winning ratio syncs to the host.
    """
    x = x.astype(jnp.float32)
    x_max = jnp.mean(jnp.abs(x), axis=tuple(range(x.ndim - 1))) + 1e-8
    mses = _scale_search_mses(x, tuple(weights), x_max, n_grid, n_bit,
                              group_size, numeric_type)
    best_i = int(jnp.argmin(mses))
    ratio = best_i / n_grid
    return _candidate_scale(x_max, ratio), ratio


@functools.partial(jax.jit, static_argnames=("n_grid", "min_ratio",
                                             "n_bit", "group_size",
                                             "numeric_type"))
def _clip_search_mses(x, w32, n_grid, min_ratio, n_bit, group_size,
                      numeric_type):
    y_ref = x @ w32.T
    absmax = jnp.abs(w32).max(axis=1, keepdims=True)

    def body(_, ratio):
        clipped = jnp.clip(w32, -absmax * ratio, absmax * ratio)
        wq = pseudo_quantize(clipped, n_bit, group_size, numeric_type)
        return None, jnp.mean((x @ wq.T - y_ref) ** 2)

    idx = jnp.arange(n_grid, dtype=jnp.float32)
    ratios = 1.0 - (1.0 - min_ratio) * idx / n_grid
    _, mses = jax.lax.scan(body, None, ratios)
    return mses


def search_clip(x: jax.Array, w: jax.Array, n_grid: int = 20,
                min_ratio: float = 0.5, n_bit: int = 4,
                group_size: int = 128,
                return_ratio: bool = False,
                numeric_type: str = "int"):
    """Grid-search per-row max-magnitude clipping minimizing output MSE
    (reference auto_clip.py:11-66), as one jitted scan. Returns the
    clipped weight (and the winning ratio when ``return_ratio``)."""
    x = x.astype(jnp.float32)
    w32 = w.astype(jnp.float32)
    mses = _clip_search_mses(x, w32, n_grid, min_ratio, n_bit, group_size,
                             numeric_type)
    best_i = int(jnp.argmin(mses))
    ratio = 1.0 - (1.0 - min_ratio) * best_i / n_grid
    absmax = jnp.abs(w32).max(axis=1, keepdims=True)
    clipped = jnp.clip(w32, -absmax * ratio, absmax * ratio).astype(w.dtype)
    if return_ratio:
        return clipped, ratio
    return clipped


def run_awq(params: Dict, cfg, input_ids: jax.Array, n_bit: int = 4,
            group_size: int = 128, n_grid: int = 20,
            do_clip: bool = True, calib_tokens: Optional[int] = None,
            progress: bool = False,
            numeric_type: str = "int") -> Tuple[Dict, Dict]:
    """Run the AWQ search over every decoder layer.

    Calibration inputs come from the model's own capture mechanism (one
    forward pass records per-linear mean-input statistics AND we re-run per
    layer to get actual activations via a second capture of raw inputs).
    Returns ``(awq_results, new_params)`` where awq_results records scales
    and clip ratios per layer (the reference's ``--dump_awq`` artifact).
    """
    from ..models import llama, mixtral as mx_mod, opt as opt_mod

    # capture each linear's input activations: rerun forward with a raw
    # store (memory-heavy for big models; calibration inputs are small)
    acts: Dict[str, list] = {}
    orig_capture = llama._capture

    def capture_raw(store, name, x):
        orig_capture(store, name, x)
        acts.setdefault(name, []).append(
            np.asarray(x.reshape(-1, x.shape[-1]), np.float32))

    is_opt = "fc1" in params["layers"][0]
    is_moe = "experts" in params["layers"][0]
    fwd = opt_mod.forward if is_opt else \
        (mx_mod.forward if is_moe else llama.forward)
    llama._capture = capture_raw
    try:
        fwd(params, cfg, input_ids, capture={})
    finally:
        llama._capture = orig_capture

    from .api import _copy_tree
    out = _copy_tree(params)
    results = {"scales": {}, "clip": {}}

    for i, layer in enumerate(out["layers"]):
        def act(nm):
            return jnp.asarray(np.concatenate(acts[f"layers.{i}.{nm}"]))

        if is_opt:
            # OPT schema (reference pre_quant.py opt adapter)
            groups = [
                ("self_attn_layer_norm", ("q_proj", "k_proj", "v_proj"),
                 "q_proj"),
                ("v_proj", ("out_proj",), "out_proj"),
                ("final_layer_norm", ("fc1",), "fc1"),
                ("fc1", ("fc2",), "fc2"),
            ]
            clip_targets = ("out_proj", "fc1", "fc2", "v_proj")
        elif is_moe:
            # Mixtral schema (reference auto_scale.py mixtral branch):
            # attention like llama; post-attn norm scales EVERY expert's
            # w1/w3 (shared input); per-expert w3 -> w2
            n_exp = len(layer["experts"])
            # the router consumes the same normed input as every expert's
            # w1/w3: it must join the scale group or the norm fold would
            # perturb routing (no reference analog -- the reference has no
            # MoE AWQ; this schema keeps the fold exactly output-neutral)
            w13 = tuple(f"experts.{e}.{w}" for e in range(n_exp)
                        for w in ("w1", "w3")) + ("router",)
            groups = [
                ("input_layernorm", ("q_proj", "k_proj", "v_proj"),
                 "q_proj"),
                ("v_proj", ("o_proj",), "o_proj"),
                ("post_attention_layernorm", w13, "moe"),
            ] + [
                (f"experts.{e}.w3", (f"experts.{e}.w2",),
                 f"experts.{e}.w2") for e in range(n_exp)
            ]
            clip_targets = ("o_proj", "v_proj") + tuple(
                f"experts.{e}.{w}" for e in range(n_exp)
                for w in ("w1", "w3", "w2"))
        else:
            groups = [
                ("input_layernorm", ("q_proj", "k_proj", "v_proj"),
                 "q_proj"),
                ("v_proj", ("o_proj",), "o_proj"),
                ("post_attention_layernorm", ("gate_proj", "up_proj"),
                 "gate_proj"),
                ("up_proj", ("down_proj",), "down_proj"),
            ]
            clip_targets = ("o_proj", "gate_proj", "up_proj", "down_proj",
                            "v_proj")
        for prev, targets, act_name in groups:
            x = act(act_name)
            s, ratio = search_scale(x, [_lget(layer, t) for t in targets],
                                    n_grid=n_grid, n_bit=n_bit,
                                    group_size=group_size,
                                    numeric_type=numeric_type)
            s_prev = s
            if prev == "v_proj" and not is_opt:
                # GQA: o_proj's input channels repeat each kv head `rep`
                # times, so an exact fold needs the scale shared within
                # each repeated-head block (geometric mean)
                hd = cfg.head_dim_
                rep = cfg.num_attention_heads // cfg.num_key_value_heads
                if rep > 1:
                    s_kv = jnp.exp(jnp.mean(
                        jnp.log(s.reshape(cfg.num_key_value_heads, rep,
                                          hd)), axis=1))
                    s = jnp.repeat(s_kv, rep, axis=0).reshape(-1)
                    s_prev = s_kv.reshape(-1)
            _apply_scale_group(layer, prev, targets, s, s_prev)
            results["scales"][f"layers.{i}.{prev}"] = {
                "ratio": ratio, "scales": np.asarray(s),
                "scales_prev": np.asarray(s_prev),
                "targets": list(targets)}
            if progress:
                print(f"  awq layer {i} {prev}->{targets}: ratio {ratio:.2f}")

        if do_clip:
            # clip non-qk weights (reference skips q/k, auto_clip usage)
            for nm in clip_targets:
                x = act("moe" if (is_moe and nm.endswith(("w1", "w3")))
                        else nm)
                clipped, cratio = search_clip(
                    x[:min(len(x), 512)], _lget(layer, nm),
                    n_grid=max(4, n_grid // 4), n_bit=n_bit,
                    group_size=group_size, return_ratio=True,
                    numeric_type=numeric_type)
                _lset(layer, nm, clipped)
                results["clip"][f"layers.{i}.{nm}"] = cratio
    return results, out


def _lget(layer: Dict, path: str):
    node = layer
    for p in path.split("."):
        node = node[int(p) if p.isdigit() else p]
    return node


def _lset(layer: Dict, path: str, value):
    parts = path.split(".")
    node = layer
    for p in parts[:-1]:
        node = node[int(p) if p.isdigit() else p]
    last = parts[-1]
    node[int(last) if last.isdigit() else last] = value


def _apply_scale_group(layer: Dict, prev: str, targets, s, s_prev):
    """Scale target weights up by s; fold 1/s_prev into the producer."""
    for t in targets:
        w = _lget(layer, t)
        _lset(layer, t,
              (w.astype(jnp.float32) * s[None, :]).astype(w.dtype))
    if prev.endswith(("layernorm", "layer_norm")):
        layer[prev] = _fold_norm(layer[prev], s_prev)
    else:  # fold into the producing linear's output rows
        w = _lget(layer, prev)
        _lset(layer, prev,
              (w.astype(jnp.float32) / s_prev[:, None]).astype(w.dtype))
        bkey = prev.replace("_proj", "_bias") \
            if prev.endswith("_proj") else prev + "_bias"
        if "." not in prev and bkey in layer:  # bias scales with its rows
            layer[bkey] = (layer[bkey].astype(jnp.float32)
                           / s_prev).astype(layer[bkey].dtype)


def _fold_norm(norm, s):
    """Fold 1/s into a normalization producer: rms weight (array) or
    LayerNorm dict {weight, bias} (both scale, since LN output is
    w*x_hat + b)."""
    if isinstance(norm, dict):
        return {"weight": (norm["weight"].astype(jnp.float32)
                           / s).astype(norm["weight"].dtype),
                "bias": (norm["bias"].astype(jnp.float32)
                         / s).astype(norm["bias"].dtype)}
    return (norm.astype(jnp.float32) / s).astype(norm.dtype)


_DEFAULT_GROUPS = {
    "input_layernorm": ("q_proj", "k_proj", "v_proj"),
    "v_proj": ("o_proj",),
    "post_attention_layernorm": ("gate_proj", "up_proj"),
    "up_proj": ("down_proj",),
    # OPT schema
    "self_attn_layer_norm": ("q_proj", "k_proj", "v_proj"),
    "final_layer_norm": ("fc1",),
    "fc1": ("fc2",),
}


def apply_awq(params: Dict, awq_results: Dict,
              do_clip: bool = True) -> Dict:
    """Re-apply previously-searched AWQ scales (and clip ratios) to a
    fresh model (the reference's ``--load_awq`` path,
    pre_process/pre_quant.py:44-55)."""
    from .api import _copy_tree
    out = _copy_tree(params)
    for key, info in awq_results.get("scales", {}).items():
        parts = key.split(".")
        layer = out["layers"][int(parts[1])]
        prev = ".".join(parts[2:])
        s = jnp.asarray(info["scales"])
        s_prev = jnp.asarray(info.get("scales_prev", info["scales"]))
        targets = info.get("targets")
        if targets is None:
            groups = dict(_DEFAULT_GROUPS)
            if "fc1" in out["layers"][0]:
                groups["v_proj"] = ("out_proj",)
            targets = groups[prev]
        _apply_scale_group(layer, prev, targets, s, s_prev)
    if do_clip:
        for key, ratio in awq_results.get("clip", {}).items():
            parts = key.split(".")
            layer = out["layers"][int(parts[1])]
            path = ".".join(parts[2:])
            w = _lget(layer, path).astype(jnp.float32)
            absmax = jnp.abs(w).max(axis=1, keepdims=True)
            _lset(layer, path,
                  jnp.clip(w, -absmax * float(ratio),
                           absmax * float(ratio)).astype(w.dtype))
    return out


def save_awq(path: str, awq_results: Dict):
    """Persist an AWQ search artifact (the reference's ``--dump_awq``,
    pre_process/pre_quant.py:34-42)."""
    flat = {}
    for key, info in awq_results.get("scales", {}).items():
        flat[f"s::{key}::scales"] = np.asarray(info["scales"])
        flat[f"s::{key}::scales_prev"] = np.asarray(info["scales_prev"])
        flat[f"s::{key}::ratio"] = np.float32(info["ratio"])
        flat[f"s::{key}::targets"] = np.asarray(info["targets"])
    for key, ratio in awq_results.get("clip", {}).items():
        flat[f"c::{key}"] = np.float32(ratio)
    np.savez(path, **flat)


def load_awq(path: str) -> Dict:
    """Inverse of :func:`save_awq`."""
    raw = np.load(path, allow_pickle=False)
    results: Dict = {"scales": {}, "clip": {}}
    for name in raw.files:
        if name.startswith("s::"):
            _, key, field = name.split("::")
            entry = results["scales"].setdefault(key, {})
            if field == "ratio":
                entry["ratio"] = float(raw[name])
            elif field == "targets":
                entry["targets"] = [str(t) for t in raw[name]]
            else:
                entry[field] = raw[name]
        elif name.startswith("c::"):
            results["clip"][name[3:]] = float(raw[name])
    return results


pre_quant_methods = {"awq": run_awq}
