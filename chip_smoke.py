#!/usr/bin/env python
"""Smoke test of the any4 main path on NVIDIA GPUs.

    python chip_smoke.py            # one card, every phase below
    python chip_smoke.py --four     # four cards: the tp=4 engine only

Random Llama-3.1-8B-shaped weights from ``--seed`` (full widths: 4096
hidden, 14336 FFN, 128256 vocab, untied head), quantized to any4 with
``group_size=128`` and fused qkv/gate-up projections. One card:

1. kernel check: the 4-bit lookup GEMV at the 8B projection shapes and
   m in {1, 16} against dequantize-to-f32 + dot at ``precision="highest"``,
   and the library paged-attention kernel the engine runs at 8B decode
   shapes against the dense gather in f32;
2. model agreement: the quantized forward's logits on a 64-token prompt,
   and one kernel-path decode step, against a layer-by-layer f32 reference
   of the same quantized weights;
3. decode: ``models.generate`` prefill + greedy tokens at batch 1;
4. serving: ``serving.engine.Engine`` answers 4 requests with the paged
   bf16 pool and with the contiguous int8 pool. Every greedy token of
   the engines and of phase 3 is scored by one teacher-forced forward of
   the same model (:func:`check_streams`).

``--four`` runs the same 8B any4 model at tp=4 through
``parallel.tp.shard_params`` + ``Engine(mesh=..., param_spec=...)``
beside the one-card engine in the same process, both scored the same
way.

One card runs all 32 layers; ``--four`` runs :data:`FOUR_CARD_LAYERS`
of them, every width full, and prints the cut. Exits non-zero, with no
result line, unless JAX's first device is a GPU.
The last line of standard output is the result as JSON.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

# relative L2 error allowed between a bf16-operand, f32-accumulating
# GEMV and its f32 reference: bf16 weights carry 2^-9 relative rounding
# each, which averages to ~3e-3 over a dot; a wrong code, table entry,
# scale or split-k partial gives O(1)
KERNEL_REL_L2 = 1e-2
# relative L2 error allowed between the quantized bf16 model's logits and
# the f32 reference of the same quantized weights: every op of every layer
# rounds activations to bf16 (2^-9 relative) and the residual stream
# carries that error through all layers; a wrong layer gives O(1)
LOGITS_REL_L2 = 5e-2
# relative L2 error allowed for bf16 decode attention against the same
# attention in f32: q and k are rounded to bf16 (2^-9 relative) before
# the dot, probabilities to bf16 before the PV dot
ATTN_REL_L2 = 1e-2
# largest amount by which the reference's top-1 logit may exceed its
# logit for the token a decoder picked, at any step: two bf16
# implementations of one model pick either side of a near-tie (the top
# logits of these random weights lie in [4, 8), where one bf16 step is
# 0.03125), never a token the model ranks clearly lower; int8 KV codes
# (rounded at 1/255 of each token's absmax) add their own noise
TIE_GAP = {"bf16": 0.125, "int8": 0.25}

PROMPT_LENS = (1024, 640, 384, 128)
NEW_TOKENS = 64
MAX_CTX = 2048
# the four-card phase compiles two engines (one card and tp=4); at all 32
# layers one engine takes about 150 s on one H100, mostly compilation
# (PERF.md), and every second on four cards costs four card-seconds
FOUR_CARD_LAYERS = 8


def card_line() -> str:
    """``nvidia-smi``'s name and power limit, read by a child process."""
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    return r.stdout.strip()


def log(msg: str):
    print(msg, flush=True)


def rel_l2(a, b) -> float:
    import jax.numpy as jnp
    a = jnp.asarray(a, jnp.float32)
    b = jnp.asarray(b, jnp.float32)
    return float(jnp.linalg.norm(a - b) / jnp.linalg.norm(b))


# ---------------------------------------------------------------- phase 1
def random_any4(key, n: int, k: int):
    """A random any4 weight [n, k]: codes, sorted per-row LUT, group
    scales and zeros drawn from ``key``."""
    import jax
    import jax.numpy as jnp
    from any4.ops import linear as lin
    from any4.ops import packing
    k1, k2, k3, k4 = jax.random.split(key, 4)
    codes = jax.random.randint(k1, (n, k), 0, 16).astype(jnp.uint8)
    packed = packing.pack_int4(codes)
    kp = packed.shape[1] * packing.PLANES
    scales = jax.random.uniform(k2, (kp // 128, n), jnp.float32,
                                0.5, 1.5) * 0.01
    zeros = jax.random.normal(k3, (kp // 128, n), jnp.float32) * 0.01
    lut = jnp.sort(jax.random.normal(k4, (n, 16), jnp.float32), axis=1) * 4
    return lin.QuantizedTensor(packed, scales, zeros, lut, "any4", 128,
                               (n, k), jnp.bfloat16, 1)


def check_kernels(shapes, ms, seed: int = 0, interpret: bool = False):
    """Phase 1: each (n, k) x m through ``linear`` (the kernel) against
    the f32 reference. Returns the rows it printed."""
    import jax
    import jax.numpy as jnp
    from any4.ops import linear as lin
    rows = []
    for n, k in shapes:
        w = random_any4(jax.random.PRNGKey(seed + n + k), n, k)
        wd = lin.dequantize_tensor(w, dtype=jnp.float32)
        for m in ms:
            assert lin.lut_kernel_applies(w, m, interpret), (n, k, m)
            x = jax.random.normal(jax.random.PRNGKey(seed + m), (m, k),
                                  jnp.float32).astype(jnp.bfloat16)
            f = jax.jit(lambda x, w: lin.linear(x, w, interpret=interpret))
            compiled = f.lower(x, w).compile()
            y = compiled(x, w)
            with jax.default_matmul_precision("highest"):
                ref = x.astype(jnp.float32) @ wd.T
            err = rel_l2(y, ref)
            row = {"n": n, "k": k, "m": m, "rel_l2": err,
                   "tol": KERNEL_REL_L2,
                   "finite": bool(jnp.isfinite(y).all())}
            log(f"kernel {json.dumps(row)}")
            log(f"  memory_analysis: {compiled.memory_analysis()}")
            assert row["finite"] and y.shape == (m, n), row
            assert err <= KERNEL_REL_L2, row
            rows.append(row)
    return rows


def check_attention(batch: int, nq: int, nkv: int, hd: int, ctx: int,
                    page_size: int = 16, seed: int = 0,
                    interpret: bool = False):
    """Phase 1: ``kv_cache.paged_attention`` on bf16 pages (the library
    kernel on the GPU) against the dense gather over the same pages in
    f32 at ``precision="highest"``."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from any4.serving import kv_cache as kvc
    pps = ctx // page_size
    P = batch * pps + 1
    ks = jax.random.split(jax.random.PRNGKey(seed), 3)
    kp = jax.random.normal(ks[0], (nkv, P, page_size, hd), jnp.float32)
    vp = jax.random.normal(ks[1], (nkv, P, page_size, hd), jnp.float32)
    q = jax.random.normal(ks[2], (batch, nq, hd), jnp.float32)
    kp, vp, q = (a.astype(jnp.bfloat16) for a in (kp, vp, q))
    assert kvc.library_kernel_applies(kp, None, interpret)
    table = jnp.asarray(1 + np.random.RandomState(seed).permutation(
        batch * pps).reshape(batch, pps), jnp.int32)
    lens = jnp.asarray(np.linspace(ctx // 8, ctx, batch).astype(np.int32))
    f = jax.jit(lambda *a: kvc.paged_attention(*a, interpret=interpret))
    compiled = f.lower(q, kp, vp, lens, table).compile()
    y = compiled(q, kp, vp, lens, table)
    with jax.default_matmul_precision("highest"):
        ref = kvc._dense_paged_attention(
            q.astype(jnp.float32), kp.astype(jnp.float32),
            vp.astype(jnp.float32), lens, table)
    row = {"batch": batch, "ctx": ctx, "nq": nq, "nkv": nkv, "hd": hd,
           "rel_l2": rel_l2(y, ref), "tol": ATTN_REL_L2}
    log(f"attention {json.dumps(row)}")
    log(f"  memory_analysis: {compiled.memory_analysis()}")
    assert y.shape == ref.shape and row["rel_l2"] <= ATTN_REL_L2, row
    return row


# ---------------------------------------------------------------- phase 2
def build_model(cfg, seed: int, kmeans_iters: int = 4,
                row_parallel_shards: int = 1, row_chunk: int = 512):
    """Random weights from ``seed``, quantized to any4 (g=128) and fused.
    ``row_chunk`` rows are clustered per k-means step (the default of 64
    leaves the card mostly idle between small launches)."""
    import jax
    from any4.models import fuse, llama
    from any4.quant import api
    params = llama.init_params(cfg, jax.random.PRNGKey(seed))
    qp = api.quantize_model(params, fmt="any4", group_size=128,
                            kmeans_iters=kmeans_iters,
                            row_parallel_shards=row_parallel_shards,
                            row_chunk=row_chunk)
    del params
    qp = fuse.fuse_projections(qp)
    jax.block_until_ready(qp)
    return qp


def reference_logits(qp, cfg, ids):
    """Logits of the same quantized weights, dequantized to f32 one layer
    at a time, in f32 at ``precision="highest"``."""
    import dataclasses
    import jax
    import jax.numpy as jnp
    from any4.models import llama
    from any4.ops import linear as lin
    cfg32 = dataclasses.replace(cfg, dtype=jnp.float32)
    eps, off = cfg.rms_norm_eps, cfg.rms_norm_offset

    def dense(tree):
        return jax.tree.map(
            lambda v: (lin.dequantize_tensor(v, dtype=jnp.float32)
                       if isinstance(v, lin.QuantizedTensor)
                       else v.astype(jnp.float32)),
            tree, is_leaf=lambda v: isinstance(v, lin.QuantizedTensor))

    @jax.jit
    def layer_fn(layer, x, cos, sin, mask):
        layer = dense(layer)
        h = llama.rms_norm(x, layer["input_layernorm"], eps, off)
        a, _ = llama.attention(layer, cfg32, h, cos, sin, None, None, mask)
        x = x + a
        h = llama.rms_norm(x, layer["post_attention_layernorm"], eps, off)
        return x + llama.mlp(layer, h, act=cfg.hidden_act)

    @jax.jit
    def head_fn(params, x):
        x = llama.rms_norm(x, params["norm"].astype(jnp.float32), eps, off)
        head = params.get("lm_head", params["embed_tokens"])
        if isinstance(head, lin.QuantizedTensor):
            head = lin.dequantize_tensor(head, dtype=jnp.float32)
        return x @ head.astype(jnp.float32).T

    with jax.default_matmul_precision("highest"):
        b, t = ids.shape
        x = lin.embed(qp["embed_tokens"], ids, jnp.float32)
        cos, sin = llama.rope_tables(cfg, jnp.arange(t)[None, :])
        mask = jnp.where(jnp.tril(jnp.ones((t, t), bool)), 0.0,
                         -1e9)[None, None].astype(jnp.float32)
        for layer in qp["layers"]:
            x = layer_fn(layer, x, cos, sin, mask)
        top = {k: v for k, v in qp.items() if k != "layers"}
        return head_fn(top, x)


def check_model(qp, cfg, seed: int, prompt_len: int = 64,
                interpret: bool = False):
    """Phase 2: prefill-path logits over the whole prompt and the
    kernel-path logits of one decode step, against the f32 reference."""
    import jax
    import jax.numpy as jnp
    from any4.models import generate, llama
    ids = jax.random.randint(jax.random.PRNGKey(seed + 7),
                             (1, prompt_len), 0, cfg.vocab_size)
    ref = reference_logits(qp, cfg, ids)[0]                    # [t, V]
    fwd = jax.jit(lambda p, i: llama.forward(p, cfg, i,
                                             interpret=interpret)[0])
    got = fwd(qp, ids)[0]
    caches = llama.init_kv_caches(cfg, 1, prompt_len)
    _, caches = generate.prefill(qp, cfg, ids[:, :-1], caches)
    step = jax.jit(lambda p, tok, pos, c: llama.forward(
        p, cfg, tok[:, None], positions=jnp.broadcast_to(pos, (1, 1)),
        kv_caches=c, cache_pos=pos,
        mask=llama.decode_mask(prompt_len, pos), interpret=interpret)[0])
    last = step(qp, ids[:, -1], jnp.int32(prompt_len - 1), caches)[0, -1]
    out = {"prompt_len": prompt_len, "layers": cfg.num_hidden_layers,
           "prefill_rel_l2": rel_l2(got, ref),
           "decode_step_rel_l2": rel_l2(last, ref[-1]),
           "top1_agree": float(jnp.mean(jnp.argmax(got, -1)
                                        == jnp.argmax(ref, -1))),
           "tol": LOGITS_REL_L2}
    log(f"model {json.dumps(out)}")
    assert bool(jnp.isfinite(got).all()) and got.shape == ref.shape, out
    assert out["prefill_rel_l2"] <= LOGITS_REL_L2, out
    assert out["decode_step_rel_l2"] <= LOGITS_REL_L2, out
    return out


# ---------------------------------------------------------------- phase 3
def make_prompts(cfg, seed: int, lens=PROMPT_LENS):
    import numpy as np
    rng = np.random.RandomState(seed)
    return [rng.randint(0, cfg.vocab_size, size=n).astype(np.int32)
            for n in lens]


def time_decode(qp, cfg, prompt, new_tokens: int):
    """Phase 3: ``generate.prefill`` then ``decode_loop`` for
    ``new_tokens`` greedy steps at batch 1, timed after a warm-up.
    Returns the timings and the greedy tokens (the prefill's and the
    loop's)."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from any4.models import generate, llama
    ids = jnp.asarray(prompt)[None]
    caches0 = llama.init_kv_caches(cfg, 1, len(prompt) + new_tokens)

    def run():
        t0 = time.perf_counter()
        logits, caches = generate.prefill(qp, cfg, ids, caches0)
        tok = jnp.argmax(logits, -1).astype(jnp.int32)
        jax.block_until_ready(tok)
        t1 = time.perf_counter()
        toks = generate.decode_loop(qp, cfg, tok, jnp.int32(len(prompt)),
                                    caches, new_tokens)[0]
        jax.block_until_ready(toks)
        return (t1 - t0, time.perf_counter() - t1,
                np.concatenate([np.asarray(tok), np.asarray(toks)[0]]))

    run()
    prefill_s, decode_s, toks = run()
    return {"prompt_len": len(prompt), "new_tokens": new_tokens,
            "prefill_ms": prefill_s * 1e3, "decode_tok_s":
            new_tokens / decode_s}, toks


# ---------------------------------------------------------------- phase 4
def run_engine(qp, cfg, prompts, new_tokens: int, kv: str,
               max_ctx: int = MAX_CTX, mesh=None, param_spec=None,
               **engine_kw):
    """Phase 4: one engine answers every prompt; returns its tokens."""
    from any4.serving.engine import Engine
    e = Engine(qp, cfg, max_slots=len(prompts), max_ctx=max_ctx,
               mesh=mesh, param_spec=param_spec, **engine_kw)
    uids = [e.submit(p, max_new_tokens=new_tokens) for p in prompts]
    t0 = time.perf_counter()
    done = {r.uid: r.out_tokens for r in e.run()}
    wall = time.perf_counter() - t0
    toks = [done[u] for u in uids]
    assert all(len(t) == new_tokens for t in toks), [len(t) for t in toks]
    row = {"kv": kv, **engine_kw, "tp": 1 if mesh is None else
           mesh.shape["tp"], "requests": len(toks), "wall_s": wall}
    log(f"engine {json.dumps(row)}")
    return toks


def check_streams(qp, cfg, rows, interpret: bool = False):
    """Score every greedy token of some decoders of ``qp``. ``rows`` holds
    (name, prompt, tokens, tie gap). One teacher-forced forward of the
    same model runs over each prompt followed by the decoder's own tokens;
    at every step the reference's top-1 logit may exceed its logit for
    the decoder's token by at most the tie gap. Returns one dict a row."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from any4.models import llama
    n = max(len(t) for _, _, t, _ in rows)
    T = max(len(p) + len(t) - 1 for _, p, t, _ in rows)
    ids = np.zeros((len(rows), T), np.int32)
    pos = np.zeros((len(rows), n), np.int32)
    toks = np.zeros((len(rows), n), np.int32)
    for r, (_, p, t, _) in enumerate(rows):
        t = np.asarray(t, np.int32)
        seq = np.concatenate([p, t[:-1]])
        ids[r, :len(seq)] = seq
        pos[r, :len(t)] = len(p) - 1 + np.arange(len(t))
        toks[r, :len(t)] = t

    @jax.jit
    def score(params, ids, pos, toks):
        lg = llama.forward(params, cfg, ids, interpret=interpret)[0]
        lg = lg[jnp.arange(lg.shape[0])[:, None], pos].astype(jnp.float32)
        top2 = jax.lax.top_k(lg, 2)[0]
        mine = jnp.take_along_axis(lg, toks[..., None], axis=-1)[..., 0]
        return top2[..., 0] - mine, top2[..., 0] - top2[..., 1]

    regret, gap = (np.asarray(a) for a in score(
        qp, jnp.asarray(ids), jnp.asarray(pos), jnp.asarray(toks)))
    out = []
    for r, (name, p, t, tol) in enumerate(rows):
        reg, g = regret[r, :len(t)], gap[r, :len(t)]
        off = np.nonzero(reg > 0)[0]
        row = {"decoder": name, "prompt_len": len(p), "steps": len(t),
               "top1": int((reg <= 0).sum()),
               "first_off_top1": int(off[0]) if off.size else None,
               "top2_gap_there": float(g[off[0]]) if off.size else None,
               "max_regret": float(reg.max()), "tol": tol}
        log(f"tokens {json.dumps(row)}")
        out.append(row)
    bad = [r for r in out if not r["max_regret"] <= r["tol"]]
    assert not bad, bad
    return out


def peak_bytes(device) -> int:
    stats = device.memory_stats() or {}
    return int(stats.get("peak_bytes_in_use", -1))


# ------------------------------------------------------------------- main
def one_card(cfg, seed: int):
    import jax
    t0 = time.perf_counter()
    hidden, ffn, vocab = cfg.hidden_size, cfg.intermediate_size, \
        cfg.vocab_size
    qkv = (cfg.num_attention_heads + 2 * cfg.num_key_value_heads) \
        * cfg.head_dim_
    check_kernels([(hidden, hidden), (qkv, hidden), (2 * ffn, hidden),
                   (hidden, ffn), (vocab, hidden)], (1, 16), seed)
    for ctx in (2048, 4096):
        check_attention(8, cfg.num_attention_heads, cfg.num_key_value_heads,
                        cfg.head_dim_, ctx, seed=seed)
    log(f"phase kernels ok ({time.perf_counter() - t0:.1f} s)")

    t0 = time.perf_counter()
    qp = build_model(cfg, seed)
    log(f"model built: any4 g=128, {cfg.num_hidden_layers} layers "
        f"({time.perf_counter() - t0:.1f} s)")
    check_model(qp, cfg, seed)
    log(f"phase model ok ({time.perf_counter() - t0:.1f} s)")

    t0 = time.perf_counter()
    prompts = make_prompts(cfg, seed)
    dec, gen = time_decode(qp, cfg, prompts[-1], 32)
    dev = jax.devices()[0]
    log(f"decode {json.dumps(dec)} peak_bytes_in_use={peak_bytes(dev)} "
        f"card={card_line()!r}")
    log(f"phase decode ok ({time.perf_counter() - t0:.1f} s)")

    t0 = time.perf_counter()
    bf16 = run_engine(qp, cfg, prompts, NEW_TOKENS, "bf16")
    int8 = run_engine(qp, cfg, prompts, NEW_TOKENS, "int8",
                      kv_layout="contig", kv_quantize=True)
    check_streams(qp, cfg, [("generate", prompts[-1], gen, TIE_GAP["bf16"])]
                  + [("engine bf16", p, t, TIE_GAP["bf16"])
                     for p, t in zip(prompts, bf16)]
                  + [("engine int8", p, t, TIE_GAP["int8"])
                     for p, t in zip(prompts, int8)])
    log(f"phase serving ok ({time.perf_counter() - t0:.1f} s) "
        f"peak_bytes_in_use={peak_bytes(dev)}")


def four_cards(cfg, seed: int, n_cards: int = 4, lens=PROMPT_LENS,
               new_tokens: int = NEW_TOKENS, max_ctx: int = MAX_CTX):
    """The tp=4 engine beside the one-card engine on the same weights and
    prompts, both scored by :func:`check_streams`."""
    import jax
    from any4.parallel import tp
    devices = jax.devices()[:n_cards]
    assert len(devices) == n_cards, f"need {n_cards} devices"
    t0 = time.perf_counter()
    qp = build_model(cfg, seed, row_parallel_shards=n_cards)
    mesh = tp.make_mesh(dp=1, tp=n_cards, devices=devices)
    sharded, specs = tp.shard_params(qp, mesh, cfg=cfg)
    jax.block_until_ready(sharded)
    for d in devices:
        log(f"device {d.id} bytes_in_use="
            f"{(d.memory_stats() or {}).get('bytes_in_use', -1)}")
    log(f"model built and sharded over {n_cards} cards "
        f"({time.perf_counter() - t0:.1f} s)")
    prompts = make_prompts(cfg, seed, lens)
    single = run_engine(qp, cfg, prompts, new_tokens, "bf16",
                        max_ctx=max_ctx)
    multi = run_engine(sharded, cfg, prompts, new_tokens, "bf16",
                       max_ctx=max_ctx, mesh=mesh, param_spec=specs)
    agree = [int(sum(a == b for a, b in zip(s, m)))
             for s, m in zip(single, multi)]
    log(f"tp={n_cards} tokens equal to the one-card engine's: {agree} "
        f"of {new_tokens}")
    check_streams(qp, cfg, [(f"engine tp={k}", p, t, TIE_GAP["bf16"])
                            for k, outs in ((1, single), (n_cards, multi))
                            for p, t in zip(prompts, outs)])
    log(f"phase tp={n_cards} ok ({time.perf_counter() - t0:.1f} s)")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--four", action="store_true",
                   help="run only the tp=4 engine phase on four cards")
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)

    import jax
    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"chip_smoke: needs a GPU, JAX found {devices[0].platform!r}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from any4.models import llama
    from any4.utils import setup_compile_cache
    setup_compile_cache()
    log(card_line())
    cfg = llama.LlamaConfig.llama_3_1_8b()
    t0 = time.perf_counter()
    if args.four:
        import dataclasses
        log(f"depth cut: {FOUR_CARD_LAYERS} of {cfg.num_hidden_layers} "
            f"layers of Llama-3.1-8B; all widths full")
        four_cards(dataclasses.replace(cfg, num_hidden_layers=FOUR_CARD_LAYERS),
                   args.seed)
    else:
        one_card(cfg, args.seed)
    log(f"total {time.perf_counter() - t0:.1f} s")
    log(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": len(devices)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
