#!/usr/bin/env python
"""Time the repo's GPU kernels against XLA's plain formulations.

Four measurements, each with both arms in this one process, in turns
(a, b, b, a):

1. per linear: the 4-bit lookup kernel (``ops.linear.linear`` on the GPU)
   against dequantize-then-dot (the formulation ``linear`` runs without
   the kernel), at the Llama-3.1-8B projection shapes and m in {1, 16};
   each arm also checked against an f32 reference at
   ``precision="highest"``;
2. decode attention per call at 8B shapes: the dense gather
   (``kv_cache._dense_paged_attention``) against ``kv_cache.
   paged_attention``, which runs the JAX library's Triton paged-attention
   kernel on bf16 pages;
3. the 8B any4 engine's decode step at batch 8 and context 2048/4096
   with the library attention kernel on and off;
4. end-to-end greedy decode of the 8B any4 model at batch 1 with the
   lookup kernel on and off.

Every time is the median wall time of a jitted call that ends in
``block_until_ready``, divided by the calls it makes. One JSON line per
result on stdout. Run on the GPU:

    python tools/bench_kernels.py
"""
from __future__ import annotations

import contextlib
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from any4.ops import linear as lin  # noqa: E402
from any4.serving import kv_cache as kvc  # noqa: E402
from chip_smoke import build_model, card_line, random_any4  # noqa: E402

SHAPES_8B = [(4096, 4096), (6144, 4096), (28672, 4096), (4096, 14336),
             (128256, 4096)]


def emit(row: dict):
    print(json.dumps(row), flush=True)


def median_ms(f, *args, iters: int = 20) -> float:
    jax.block_until_ready(f(*args))
    ts = []
    for _ in range(iters):
        t0 = time.perf_counter()
        jax.block_until_ready(f(*args))
        ts.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(ts))


@contextlib.contextmanager
def patched(module, name: str, value):
    """``module.name = value`` while tracing one arm."""
    old = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, old)


def never(*_a, **_k) -> bool:
    return False


def bench_linears(shapes, ms, n_weights: int, iters: int) -> list:
    def kernel(x, w):
        return lin.linear(x, w)

    def xla(x, w):
        return jnp.einsum("...k,nk->...n", x,
                          lin.dequantize_tensor(w, dtype=x.dtype))

    rows = []
    for n, k in shapes:
        keys = jax.random.split(jax.random.PRNGKey(n + k), n_weights)
        ws = [random_any4(kk, n, k) for kk in keys]
        jax.block_until_ready(ws)
        wbytes = ws[0].nbytes
        for m in ms:
            x = jax.random.normal(jax.random.PRNGKey(m), (m, k),
                                  jnp.float32).astype(jnp.bfloat16)
            ref = jnp.einsum(
                "mk,nk->mn", x.astype(jnp.float32),
                lin.dequantize_tensor(ws[0], dtype=jnp.float32),
                precision="highest")
            row = {"n": n, "k": k, "m": m, "weight_bytes": wbytes,
                   "kernel_applies": lin.lut_kernel_applies(ws[0], m)}
            fns = {}
            for name, arm in (("kernel", kernel), ("xla", xla)):
                y = jax.jit(arm)(x, ws[0]).astype(jnp.float32)
                row[f"{name}_rel_l2"] = float(
                    jnp.linalg.norm(y - ref) / jnp.linalg.norm(ref))
                fns[name] = jax.jit(
                    lambda x, ws, arm=arm: [arm(x, w) for w in ws])
            times = {"kernel": [], "xla": []}
            for name in ("kernel", "xla", "xla", "kernel"):
                times[name].append(median_ms(fns[name], x, ws, iters=iters)
                                   / n_weights)
            for name in times:
                row[f"{name}_us"] = float(np.mean(times[name])) * 1e3
            emit(row)
            rows.append(row)
        del ws
    return rows


def bench_attention(batch: int, nq: int, nkv: int, hd: int, ctxs,
                    page_size: int, iters: int) -> list:
    rows = []
    for ctx in ctxs:
        pps = ctx // page_size
        P = batch * pps + 1
        kk = jax.random.split(jax.random.PRNGKey(ctx), 3)
        kp, vp = (jax.random.normal(kk[i], (nkv, P, page_size, hd),
                                    jnp.float32).astype(jnp.bfloat16)
                  for i in (0, 1))
        q = jax.random.normal(kk[2], (batch, nq, hd),
                              jnp.float32).astype(jnp.bfloat16)
        table = (1 + jnp.arange(batch * pps, dtype=jnp.int32)
                 ).reshape(batch, pps)
        lens = jnp.full((batch,), ctx, jnp.int32)
        args = (q, kp, vp, lens, table)
        arms = {"dense": jax.jit(kvc._dense_paged_attention),
                "library": jax.jit(kvc.paged_attention)}
        ys = {n: f(*args).astype(jnp.float32) for n, f in arms.items()}
        row = {"batch": batch, "ctx": ctx, "nq": nq, "nkv": nkv, "hd": hd,
               "library_applies": kvc.library_kernel_applies(kp),
               "max_abs_diff": float(jnp.max(jnp.abs(ys["library"]
                                                     - ys["dense"])))}
        for name in ("library", "dense", "dense", "library"):
            row.setdefault(f"{name}_us", []).append(
                median_ms(arms[name], *args, iters=iters) * 1e3)
        for name in arms:
            row[f"{name}_us"] = float(np.mean(row[f"{name}_us"]))
        emit(row)
        rows.append(row)
    return rows


def bench_engine_attention(qp, cfg, batch: int, ctxs, steps: int) -> list:
    """The engine's decode program for ``batch`` slots filled to about
    ``ctx`` tokens, traced once with the library attention kernel and
    once with the dense gather, then timed in turns."""
    from any4.serving import engine as eng
    rows = []
    for ctx in ctxs:
        e = eng.Engine(qp, cfg, max_slots=batch, max_ctx=ctx)
        rng = np.random.RandomState(ctx)
        for _ in range(batch):
            e.submit(rng.randint(0, cfg.vocab_size, ctx - 2 * steps - 2))
        e._admit()
        args = [e.params, jnp.asarray(e.tokens), jnp.asarray(e.seq_lens),
                e._ctx_table(2)]
        compiled = {}
        for name, applies in (("library", kvc.library_kernel_applies),
                              ("dense", never)):
            with patched(kvc, "library_kernel_applies", applies):
                jax.clear_caches()
                compiled[name] = jax.jit(
                    lambda p, t, s, tb, kp, vp: eng._decode_impl(
                        p, cfg, t, s, tb, kp, vp, e.page_size),
                    donate_argnums=(4, 5)).lower(
                        *args, e.cache.k_pages, e.cache.v_pages).compile()
        row = {"batch": batch, "ctx": ctx, "layers": cfg.num_hidden_layers,
               "table_tokens": int(args[3].shape[1]) * e.page_size}
        for name in ("library", "dense", "dense", "library"):
            f = compiled[name]
            kp, vp = e.cache.k_pages, e.cache.v_pages
            logits, kp, vp = f(*args, kp, vp)            # warm-up
            jax.block_until_ready(logits)
            t0 = time.perf_counter()
            for _ in range(steps):
                logits, kp, vp = f(*args, kp, vp)
            jax.block_until_ready(logits)
            e.cache.k_pages, e.cache.v_pages = kp, vp
            row.setdefault(f"{name}_step_ms", []).append(
                (time.perf_counter() - t0) * 1e3 / steps)
        for name in compiled:
            row[f"{name}_step_ms"] = float(np.mean(row[f"{name}_step_ms"]))
        emit(row)
        rows.append(row)
        del e
    return rows


def bench_decode(qp, cfg, prompt_len: int, new_tokens: int) -> dict:
    """Greedy decode at batch 1, compiled once with the lookup kernel and
    once without, then timed in turns."""
    from any4.models import generate, llama
    prompt = jax.random.randint(jax.random.PRNGKey(1), (1, prompt_len), 0,
                                cfg.vocab_size)
    caches = llama.init_kv_caches(cfg, 1, prompt_len + new_tokens)
    pos = jnp.int32(prompt_len)
    arms = {}
    for name, applies in (("kernel", lin.lut_kernel_applies),
                          ("xla", never)):
        with patched(lin, "lut_kernel_applies", applies):
            jax.clear_caches()
            pre = generate.prefill.lower(qp, cfg, prompt, caches).compile()
            logits, c = pre(qp, prompt, caches)
            tok = jnp.argmax(logits, -1).astype(jnp.int32)
            loop = generate.decode_loop.lower(
                qp, cfg, tok, pos, c, n_steps=new_tokens).compile()
            arms[name] = (loop, tok, c)
    out = {"layers": cfg.num_hidden_layers, "prompt_len": prompt_len,
           "new_tokens": new_tokens}
    toks = {}
    for name in ("kernel", "xla", "xla", "kernel"):
        loop, tok, c = arms[name]
        ms = median_ms(loop, qp, tok, pos, c, iters=3)
        out.setdefault(f"{name}_tok_s", []).append(new_tokens / ms * 1e3)
        toks[name] = np.asarray(loop(qp, tok, pos, c)[0]).tolist()
    for name in arms:
        out[f"{name}_tok_s"] = float(np.mean(out[f"{name}_tok_s"]))
    out["tokens_agree"] = toks["kernel"] == toks["xla"]
    emit(out)
    return out


def main():
    from any4.models import llama
    from any4.utils import setup_compile_cache
    setup_compile_cache()
    dev = jax.devices()[0]
    emit({"card": card_line(), "platform": dev.platform,
          "kind": dev.device_kind, "count": len(jax.devices())})
    cfg = llama.LlamaConfig.llama_3_1_8b()
    bench_linears(SHAPES_8B, (1, 16), n_weights=16, iters=20)
    bench_attention(8, cfg.num_attention_heads, cfg.num_key_value_heads,
                    cfg.head_dim_, (2048, 4096), 16, iters=20)
    qp = build_model(cfg, 0)
    bench_engine_attention(qp, cfg, 8, (2048, 4096), steps=16)
    bench_decode(qp, cfg, 64, 32)
    emit({"card": card_line()})


if __name__ == "__main__":
    main()
