"""Greedy / sampled autoregressive generation with a static KV cache.

Compiler-first decode: prefill is one jitted call over the padded prompt; each
decode step is a jitted single-token forward with `dynamic_update_slice` KV
writes -- static shapes throughout so XLA compiles exactly two programs.
"""
from __future__ import annotations

import functools
from typing import Dict, Optional

import jax
import jax.numpy as jnp

from . import llama



def _model_forward(params):
    """llama.forward, or mixtral.forward when the param tree carries MoE
    expert layers (key presence is static under jit)."""
    if params["layers"] and ("experts" in params["layers"][0]
                             or "moe_w13" in params["layers"][0]):
        from . import mixtral
        return mixtral.forward
    return llama.forward

def _prefill_mask(t: int, max_len: int) -> jax.Array:
    """Causal mask for prefill writing into a [max_len] cache."""
    q = jnp.arange(t)[:, None]
    s = jnp.arange(max_len)[None, :]
    return jnp.where(s <= q, 0.0, -1e9)[None, None].astype(jnp.float32)


@functools.partial(jax.jit, static_argnames=("cfg",))
def prefill(params: Dict, cfg: "llama.LlamaConfig", input_ids: jax.Array,
            kv_caches):
    b, t = input_ids.shape
    max_len = kv_caches[0][0].shape[1]
    logits, caches = _model_forward(params)(
        params, cfg, input_ids, kv_caches=kv_caches, cache_pos=None,
        mask=_prefill_mask(t, max_len))
    return logits[:, -1, :], caches


@functools.partial(jax.jit, static_argnames=("cfg",))
def decode_step(params: Dict, cfg: "llama.LlamaConfig", token: jax.Array,
                pos: jax.Array, kv_caches):
    """One decode step. token: [b], pos: scalar int32 (cache write index)."""
    b = token.shape[0]
    max_len = kv_caches[0][0].shape[1]
    positions = jnp.broadcast_to(pos, (b, 1))
    mask = llama.decode_mask(max_len, pos)
    logits, caches = _model_forward(params)(
        params, cfg, token[:, None], positions=positions,
        kv_caches=kv_caches, cache_pos=pos, mask=mask)
    return logits[:, -1, :], caches


@functools.partial(
    jax.jit, static_argnames=("cfg", "n_steps", "temperature", "eos_token_id"))
def decode_loop(params: Dict, cfg: "llama.LlamaConfig", token: jax.Array,
                pos: jax.Array, kv_caches, n_steps: int,
                temperature: float = 0.0,
                key: Optional[jax.Array] = None,
                done: Optional[jax.Array] = None,
                eos_token_id: Optional[int] = None):
    """``n_steps`` decode steps fused into ONE device program (lax.scan).

    Autoregressive decode dispatched step-by-step from Python pays a
    per-dispatch host cost that can exceed the device time of a small
    model's step. Scanning the step inside one jit produces identical
    tokens with a single dispatch per burst; weights stay resident as loop
    constants. This is the analog of CUDA-graph decode capture (the reference has no equivalent; its per-step Python
    loop is benchmark.py:162-198).

    Consumes ``token`` at cache position ``pos`` and returns
    ``(tokens [b, n_steps], last_logits, pos + n_steps, caches, done)`` —
    the tokens for positions ``pos+1 .. pos+n_steps``.
    """
    b = token.shape[0]
    if done is None:
        done = jnp.zeros((b,), jnp.bool_)
    if key is None:
        key = jax.random.PRNGKey(0)

    def body(carry, _):
        tok, p, caches, k, dn, _ = carry
        logits, caches = _model_forward(params)(
            params, cfg, tok[:, None],
            positions=jnp.broadcast_to(p, (b, 1)),
            kv_caches=caches, cache_pos=p,
            mask=llama.decode_mask(caches[0][0].shape[1], p))
        logits = logits[:, -1, :].astype(jnp.float32)
        if temperature > 0:
            k, sub = jax.random.split(k)
            nxt = jax.random.categorical(sub, logits / temperature, axis=-1)
        else:
            nxt = jnp.argmax(logits, axis=-1)
        nxt = nxt.astype(jnp.int32)
        if eos_token_id is not None:
            nxt = jnp.where(dn, eos_token_id, nxt)
            dn = dn | (nxt == eos_token_id)
        return (nxt, p + 1, caches, k, dn, logits), nxt

    zlog = jnp.zeros((b, cfg.vocab_size), jnp.float32)
    (tok, pos, kv_caches, key, done, logits), toks = jax.lax.scan(
        body, (token, pos, kv_caches, key, done, zlog), None, length=n_steps)
    return toks.T, logits, pos, kv_caches, done


def generate(params: Dict, cfg: "llama.LlamaConfig", prompt_ids: jax.Array,
             max_new_tokens: int = 32, temperature: float = 0.0,
             key: Optional[jax.Array] = None,
             eos_token_id: Optional[int] = None) -> jax.Array:
    """Generate greedily (or sample with ``temperature > 0``).

    prompt_ids: [b, t_prompt] int32. Returns [b, t_prompt + max_new_tokens].
    """
    b, tp = prompt_ids.shape
    max_len = tp + max_new_tokens
    caches = llama.init_kv_caches(cfg, b, max_len)
    logits, caches = prefill(params, cfg, prompt_ids, caches)

    if temperature > 0:
        key, sub = jax.random.split(key)
        tok = jax.random.categorical(
            sub, logits.astype(jnp.float32) / temperature, axis=-1)
    else:
        tok = jnp.argmax(logits, axis=-1)
    tok = tok.astype(jnp.int32)
    done = jnp.zeros((b,), jnp.bool_)
    if eos_token_id is not None:
        done = tok == eos_token_id
    tokens = [prompt_ids, tok[:, None]]
    if max_new_tokens > 1:
        toks, _, _, caches, done = decode_loop(
            params, cfg, tok, jnp.int32(tp), caches, max_new_tokens - 1,
            temperature=temperature, key=key, done=done,
            eos_token_id=eos_token_id)
        tokens.append(toks)
    return jnp.concatenate(tokens, axis=1)
