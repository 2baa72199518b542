"""Functional JAX Llama-family decoder (Llama 1/2/3, Mistral, Qwen2-style).

The reference evaluates HF torch models as-is (eval.py loads
AutoModelForCausalLM); a JAX framework needs its own forward. This is
a pure-functional implementation: parameters are a nested dict pytree whose
linear-layer leaves may be dense ``[n, k]`` arrays **or**
:class:`~any4.ops.linear.QuantizedTensor` bundles -- the quantization
module swap (reference quantize.py:32-85) becomes a pytree transform
(:mod:`any4.quant.api`) and the forward dispatches through
:func:`any4.ops.linear.linear` either way.

Design is compiler-first: static shapes everywhere, `lax`-friendly control
flow, decode via a preallocated KV cache updated with `dynamic_update_slice`,
GQA attention as einsums, RoPE precomputed.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, Optional, Tuple

import jax
import jax.numpy as jnp

from ..ops import linear as lin


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 2048
    intermediate_size: int = 5632
    num_hidden_layers: int = 22
    num_attention_heads: int = 32
    num_key_value_heads: int = 4
    head_dim: Optional[int] = None
    max_position_embeddings: int = 4096
    rms_norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    tie_word_embeddings: bool = False
    attention_bias: bool = False
    # --- Gemma-family extensions (beyond the reference's model zoo) ---
    hidden_act: str = "silu"          # "silu" | "gelu_pytorch_tanh"
    rms_norm_offset: float = 0.0      # gemma: y = norm(x) * (offset + w)
    embed_scale: Optional[float] = None   # gemma: sqrt(hidden_size)
    query_pre_attn_scalar: Optional[float] = None  # gemma2 logit scale
    attn_logit_softcapping: Optional[float] = None   # gemma2
    final_logit_softcapping: Optional[float] = None  # gemma2
    sliding_window: Optional[int] = None             # gemma2 local layers
    layer_types: Optional[Tuple[str, ...]] = None    # per-layer attn kind
    sandwich_norms: bool = False      # gemma2 post-attn/pre+post-ffw norms
    dtype: Any = jnp.bfloat16

    def is_sliding(self, i: int) -> bool:
        """Does decoder layer ``i`` use sliding-window attention?"""
        if self.sliding_window is None:
            return False
        if self.layer_types is not None:
            return self.layer_types[i] == "sliding_attention"
        return i % 2 == 0  # gemma2 default: even layers are local

    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.hidden_size // self.num_attention_heads

    @classmethod
    def llama_3_2_1b(cls):
        return cls(vocab_size=128256, hidden_size=2048,
                   intermediate_size=8192, num_hidden_layers=16,
                   num_attention_heads=32, num_key_value_heads=8,
                   head_dim=64, rope_theta=500000.0,
                   max_position_embeddings=8192, tie_word_embeddings=True)

    @classmethod
    def llama_3_1_8b(cls):
        return cls(vocab_size=128256, hidden_size=4096,
                   intermediate_size=14336, num_hidden_layers=32,
                   num_attention_heads=32, num_key_value_heads=8,
                   rope_theta=500000.0, max_position_embeddings=8192)

    @classmethod
    def tiny(cls, vocab=256, layers=2):
        """A tiny config for tests."""
        return cls(vocab_size=vocab, hidden_size=64, intermediate_size=128,
                   num_hidden_layers=layers, num_attention_heads=4,
                   num_key_value_heads=2, max_position_embeddings=512)


@functools.partial(jax.jit, static_argnums=(1, 2))
def _dense_init(key, shape, dtype):
    return (jax.random.normal(key, shape, jnp.float32)
            * (1.0 / jnp.sqrt(shape[1]))).astype(dtype)


@functools.partial(jax.jit, static_argnums=(1, 2))
def _embed_init(key, shape, dtype):
    return jax.random.normal(key, shape, jnp.float32).astype(dtype) * 0.02


def init_params(cfg: LlamaConfig, key: jax.Array) -> Dict:
    """Random-initialized parameter pytree (HF loading lives in loader.py),
    generated on the device one weight at a time by a jitted generator
    that compiles once per distinct shape (a whole-model program compiles
    for minutes at 8B widths)."""
    d, f = cfg.hidden_size, cfg.intermediate_size
    hd = cfg.head_dim_
    nq, nkv = cfg.num_attention_heads, cfg.num_key_value_heads
    keys = iter(jax.random.split(key, 4 + cfg.num_hidden_layers * 7))

    def dense(k, n_out, n_in):
        return _dense_init(k, (n_out, n_in), cfg.dtype)

    params: Dict[str, Any] = {
        "embed_tokens": _embed_init(next(keys), (cfg.vocab_size, d),
                                    cfg.dtype),
        "layers": [],
    }
    # gemma stores norm weights as (w - offset); init at offset-neutral 1.0
    norm_w = (1.0 - cfg.rms_norm_offset) * jnp.ones((d,), cfg.dtype)
    params["norm"] = norm_w
    for _ in range(cfg.num_hidden_layers):
        extra = ({"pre_feedforward_layernorm": norm_w,
                  "post_feedforward_layernorm": norm_w}
                 if cfg.sandwich_norms else {})
        params["layers"].append({
            **extra,
            "input_layernorm": norm_w,
            "post_attention_layernorm": norm_w,
            "q_proj": dense(next(keys), nq * hd, d),
            "k_proj": dense(next(keys), nkv * hd, d),
            "v_proj": dense(next(keys), nkv * hd, d),
            "o_proj": dense(next(keys), d, nq * hd),
            "gate_proj": dense(next(keys), f, d),
            "up_proj": dense(next(keys), f, d),
            "down_proj": dense(next(keys), d, f),
        })
    if not cfg.tie_word_embeddings:
        params["lm_head"] = dense(next(keys), cfg.vocab_size, d)
    return params


def rms_norm(x: jax.Array, w: jax.Array, eps: float,
             offset: float = 0.0) -> jax.Array:
    """RMSNorm; ``offset`` supports gemma's ``(1 + w)`` convention (the HF
    checkpoint stores ``w - 1`` and the forward adds the 1 back, in f32)."""
    dt = x.dtype
    x = x.astype(jnp.float32)
    x = x * jax.lax.rsqrt(jnp.mean(x * x, axis=-1, keepdims=True) + eps)
    return (x * (offset + w.astype(jnp.float32))).astype(dt)


def rope_tables(cfg: LlamaConfig, positions: jax.Array):
    """cos/sin tables [..., head_dim/2] for given positions."""
    hd = cfg.head_dim_
    inv = 1.0 / (cfg.rope_theta ** (jnp.arange(0, hd, 2,
                                               dtype=jnp.float32) / hd))
    ang = positions.astype(jnp.float32)[..., None] * inv  # [..., hd/2]
    return jnp.cos(ang), jnp.sin(ang)


def apply_rope(x: jax.Array, cos: jax.Array, sin: jax.Array) -> jax.Array:
    """x: [b, t, heads, hd]; cos/sin: [b, t, hd/2] (HF half-split rotate)."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    c = cos[:, :, None, :]
    s = sin[:, :, None, :]
    return jnp.concatenate(
        [x1 * c - x2 * s, x2 * c + x1 * s], axis=-1).astype(x.dtype)


def _linearize(x, w, bias=None, **kw):
    return lin.linear(x, w, bias, **kw)


def attention(layer: Dict, cfg: LlamaConfig, x: jax.Array,
              cos: jax.Array, sin: jax.Array,
              kv_cache: Optional[Tuple[jax.Array, jax.Array]],
              cache_pos: Optional[jax.Array],
              mask: Optional[jax.Array],
              capture: Optional[dict] = None, prefix: str = "",
              psum_axis: Optional[str] = None, **kw):
    """GQA attention. Returns (out, new_kv_cache).

    kv_cache: (k_cache, v_cache) each [b, max_len, n_kv, hd]; cache_pos is
    the scalar write offset (decode step) or None (prefill fills [0, t)).
    """
    b, t, d = x.shape
    hd = cfg.head_dim_
    nq, nkv = cfg.num_attention_heads, cfg.num_key_value_heads

    if capture is not None:
        for nm in ("q_proj", "k_proj", "v_proj"):
            _capture(capture, f"{prefix}{nm}", x)
    if "qkv_proj" in layer:  # fused projections (models/fuse.py)
        qkv = _linearize(x, layer["qkv_proj"], layer.get("qkv_bias"), **kw)
        q = qkv[..., :nq * hd]
        k = qkv[..., nq * hd:(nq + nkv) * hd]
        v = qkv[..., (nq + nkv) * hd:]
    else:
        q = _linearize(x, layer["q_proj"], layer.get("q_bias"), **kw)
        k = _linearize(x, layer["k_proj"], layer.get("k_bias"), **kw)
        v = _linearize(x, layer["v_proj"], layer.get("v_bias"), **kw)
    q = q.reshape(b, t, nq, hd)
    k = k.reshape(b, t, nkv, hd)
    v = v.reshape(b, t, nkv, hd)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)

    if kv_cache is not None:
        kc, vc = kv_cache
        if cache_pos is None:
            kc = jax.lax.dynamic_update_slice(kc, k.astype(kc.dtype),
                                              (0, 0, 0, 0))
            vc = jax.lax.dynamic_update_slice(vc, v.astype(vc.dtype),
                                              (0, 0, 0, 0))
        else:
            kc = jax.lax.dynamic_update_slice(
                kc, k.astype(kc.dtype), (0, cache_pos, 0, 0))
            vc = jax.lax.dynamic_update_slice(
                vc, v.astype(vc.dtype), (0, cache_pos, 0, 0))
        k_all, v_all = kc, vc
        new_cache = (kc, vc)
    else:
        k_all, v_all = k, v
        new_cache = None

    # repeat kv heads for GQA
    rep = nq // nkv
    kx = jnp.repeat(k_all, rep, axis=2)
    vx = jnp.repeat(v_all, rep, axis=2)

    if cfg.query_pre_attn_scalar is not None:  # gemma2
        scale = cfg.query_pre_attn_scalar ** -0.5
    else:
        scale = 1.0 / jnp.sqrt(hd).astype(jnp.float32)
    logits = jnp.einsum("bthd,bshd->bhts", q.astype(jnp.float32),
                        kx.astype(jnp.float32)) * scale
    if cfg.attn_logit_softcapping is not None:  # gemma2, before the mask
        cap = cfg.attn_logit_softcapping
        logits = cap * jnp.tanh(logits / cap)
    if mask is not None:
        logits = logits + mask  # mask: [b, 1|h, t, s] additive
    probs = jax.nn.softmax(logits, axis=-1).astype(x.dtype)
    out = jnp.einsum("bhts,bshd->bthd", probs, vx.astype(x.dtype))
    out = out.reshape(b, t, nq * hd)
    if capture is not None:
        _capture(capture, f"{prefix}o_proj", out)
    out = _linearize(out, layer["o_proj"], layer.get("o_bias"), **kw)
    if psum_axis is not None:  # tensor-parallel row-parallel reduction
        out = jax.lax.psum(out, psum_axis)
    return out, new_cache


def _act(h: jax.Array, act: str) -> jax.Array:
    if act == "silu":
        return jax.nn.silu(h)
    if act in ("gelu_pytorch_tanh", "gelu"):  # gemma
        return jax.nn.gelu(h, approximate=True)
    raise ValueError(f"unsupported hidden_act {act!r}")


def mlp(layer: Dict, x: jax.Array,
        capture: Optional[dict] = None, prefix: str = "",
        psum_axis: Optional[str] = None, act: str = "silu",
        **kw) -> jax.Array:
    if capture is not None:
        _capture(capture, f"{prefix}gate_proj", x)
        _capture(capture, f"{prefix}up_proj", x)
    if "gateup_proj" in layer:  # fused projections (models/fuse.py)
        gu = _linearize(x, layer["gateup_proj"], **kw)
        f2 = gu.shape[-1] // 2
        g, u = gu[..., :f2], gu[..., f2:]
    else:
        g = _linearize(x, layer["gate_proj"], **kw)
        u = _linearize(x, layer["up_proj"], **kw)
    h = _act(g.astype(jnp.float32), act).astype(x.dtype) * u
    if capture is not None:
        _capture(capture, f"{prefix}down_proj", h)
    out = _linearize(h, layer["down_proj"], **kw)
    if psum_axis is not None:  # tensor-parallel row-parallel reduction
        out = jax.lax.psum(out, psum_axis)
    return out


def forward(params: Dict, cfg: LlamaConfig, input_ids: jax.Array,
            positions: Optional[jax.Array] = None,
            kv_caches: Optional[list] = None,
            cache_pos: Optional[jax.Array] = None,
            mask: Optional[jax.Array] = None,
            capture: Optional[dict] = None,
            psum_axis: Optional[str] = None, **kw):
    """Run the decoder. Returns (logits [b, t, vocab], new_kv_caches).

    ``capture``, if a dict, accumulates per-linear-input mean |x| for
    calibration (the analog of the reference's forward hooks,
    calibrate.py:41-66) -- only usable outside jit.
    """
    b, t = input_ids.shape
    if positions is None:
        positions = jnp.broadcast_to(jnp.arange(t)[None, :], (b, t))
    cos, sin = rope_tables(cfg, positions)
    x = lin.embed(params["embed_tokens"], input_ids, cfg.dtype)
    if cfg.embed_scale is not None:  # gemma scales embeddings, in dtype
        x = x * jnp.asarray(cfg.embed_scale, x.dtype)

    if mask is None and kv_caches is None and t > 1:
        mask = jnp.where(
            jnp.tril(jnp.ones((t, t), jnp.bool_)), 0.0, -1e9
        )[None, None].astype(jnp.float32)

    sl_mask = None
    if cfg.sliding_window is not None:
        # extra additive term for sliding layers: key allowed iff
        # q_pos - k_pos < window (HF sliding_window_overlay convention);
        # key positions are absolute slot indices in the linear KV cache
        s = kv_caches[0][0].shape[1] if kv_caches is not None else t
        dist = (positions[:, :, None]
                - jnp.arange(s)[None, None, :])          # [b, t, s]
        extra = jnp.where(dist < cfg.sliding_window, 0.0,
                          -1e9)[:, None].astype(jnp.float32)
        sl_mask = extra if mask is None else mask + extra

    eps, off = cfg.rms_norm_eps, cfg.rms_norm_offset
    new_caches = []
    for i, layer in enumerate(params["layers"]):
        h = rms_norm(x, layer["input_layernorm"], eps, off)
        attn_out, nc = attention(
            layer, cfg, h, cos, sin,
            None if kv_caches is None else kv_caches[i],
            cache_pos, sl_mask if cfg.is_sliding(i) else mask,
            capture=capture, prefix=f"layers.{i}.",
            psum_axis=psum_axis, **kw)
        if cfg.sandwich_norms:  # gemma2: norm the attn output, then add
            attn_out = rms_norm(attn_out,
                                layer["post_attention_layernorm"], eps, off)
            x = x + attn_out
            h = rms_norm(x, layer["pre_feedforward_layernorm"], eps, off)
            m = mlp(layer, h, capture=capture, prefix=f"layers.{i}.",
                    psum_axis=psum_axis, act=cfg.hidden_act, **kw)
            x = x + rms_norm(m, layer["post_feedforward_layernorm"],
                             eps, off)
        else:
            x = x + attn_out
            h = rms_norm(x, layer["post_attention_layernorm"], eps, off)
            x = x + mlp(layer, h, capture=capture, prefix=f"layers.{i}.",
                        psum_axis=psum_axis, act=cfg.hidden_act, **kw)
        new_caches.append(nc)

    x = rms_norm(x, params["norm"], eps, off)
    if "lm_head" in params:
        logits = lin.linear(x, params["lm_head"], **kw)
    elif isinstance(params["embed_tokens"], lin.QuantizedTensor):
        # tied quantized embeddings: the lm_head matmul runs the fused
        # quantized kernel off the same packed table the lookup gathers
        logits = lin.linear(x, params["embed_tokens"], **kw)
    else:  # tied embeddings
        logits = x @ params["embed_tokens"].T.astype(x.dtype)
    if cfg.final_logit_softcapping is not None:  # gemma2
        cap = cfg.final_logit_softcapping
        logits = (cap * jnp.tanh(logits.astype(jnp.float32) / cap)
                  ).astype(logits.dtype)
    return logits, (new_caches if kv_caches is not None else None)


def _capture(store: dict, name: str, x: jax.Array):
    """Accumulate per-channel activation statistics: (sum |x|, sum x,
    count). The reference's hooks support signed or absolute accumulation
    via an ``abs`` flag (calibrate.py:41-66); we record both and let the
    consumer choose."""
    xf = x.astype(jnp.float32)
    axes = tuple(range(x.ndim - 1))
    s_abs = jnp.sum(jnp.abs(xf), axis=axes)
    s_sgn = jnp.sum(xf, axis=axes)
    cnt = int(np_prod(x.shape[:-1]))
    if name in store:
        pa, psn, pc = store[name]
        store[name] = (pa + s_abs, psn + s_sgn, pc + cnt)
    else:
        store[name] = (s_abs, s_sgn, cnt)


def np_prod(shape) -> int:
    out = 1
    for s in shape:
        out *= int(s)
    return out


def init_kv_caches(cfg: LlamaConfig, batch: int, max_len: int,
                   dtype=None) -> list:
    dtype = dtype or cfg.dtype
    hd = cfg.head_dim_
    return [
        (jnp.zeros((batch, max_len, cfg.num_key_value_heads, hd), dtype),
         jnp.zeros((batch, max_len, cfg.num_key_value_heads, hd), dtype))
        for _ in range(cfg.num_hidden_layers)
    ]


def decode_mask(max_len: int, cache_pos: jax.Array) -> jax.Array:
    """Additive mask for single-token decode: attend to [0, cache_pos]."""
    idx = jnp.arange(max_len)
    return jnp.where(idx <= cache_pos, 0.0, -1e9)[None, None, None, :]
