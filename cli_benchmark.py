#!/usr/bin/env python
"""Model benchmark CLI (reference benchmark.py equivalent): end-to-end
decode throughput of the baseline model vs its quantized version, with a
per-component (attention vs MLP) breakdown.

  python cli_benchmark.py --tiny --quantize any4 --max-new-tokens 64
"""
import argparse
import json
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np


def decode_tokens_per_s(params, cfg, prompt, new_tokens, trials=3):
    from any4.models import generate, llama

    caches = llama.init_kv_caches(cfg, prompt.shape[0],
                                  prompt.shape[1] + new_tokens)
    logits, caches = generate.prefill(params, cfg, prompt, caches)
    tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
    pos = jnp.int32(prompt.shape[1])
    # warm the fused burst program (one dispatch per burst; see
    # generate.decode_loop)
    toks, *_ = generate.decode_loop(params, cfg, tok, pos, caches,
                                    new_tokens)
    jax.block_until_ready(toks)
    best = float("inf")
    for _ in range(trials):
        t0 = time.perf_counter()
        toks, *_ = generate.decode_loop(params, cfg, tok, pos, caches,
                                        new_tokens)
        int(np.asarray(jax.device_get(toks[0, -1])))  # force execution
        best = min(best, time.perf_counter() - t0)
    return new_tokens * prompt.shape[0] / best


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--model-dir")
    p.add_argument("--tiny", action="store_true")
    p.add_argument("--quantize", default="any4")
    p.add_argument("--group-size", type=int, default=128)
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--prompt-tokens", type=int, default=32)
    p.add_argument("--max-new-tokens", type=int, default=64)
    p.add_argument("--profile", action="store_true",
                   help="per-layer attention vs MLP timing breakdown "
                        "(the reference HookBasedProfiler equivalent)")
    p.add_argument("--profile-ctx", type=int, default=256)
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU instead of JAX's default backend")
    args = p.parse_args(argv)
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    from any4.utils import setup_compile_cache
    setup_compile_cache()

    from any4.models import llama, loader
    from any4.quant import api

    if args.tiny or not args.model_dir:
        cfg = llama.LlamaConfig.tiny(vocab=2048, layers=2)
        params = llama.init_params(cfg, jax.random.PRNGKey(0))
    else:
        cfg, params = loader.load_model(args.model_dir)

    prompt = jax.random.randint(jax.random.PRNGKey(1),
                                (args.batch, args.prompt_tokens), 0,
                                cfg.vocab_size)
    tps_base = decode_tokens_per_s(params, cfg, prompt, args.max_new_tokens)
    print(f"baseline: {tps_base:.1f} tok/s", file=sys.stderr)

    kw = dict(kmeans_iters=10) if args.quantize in ("any4", "anyq") else {}
    qparams = api.quant_methods[args.quantize](
        params, group_size=args.group_size, **kw)
    tps_q = decode_tokens_per_s(qparams, cfg, prompt, args.max_new_tokens)
    print(f"{args.quantize}: {tps_q:.1f} tok/s", file=sys.stderr)

    out = {
        "baseline_tok_s": round(tps_base, 2),
        f"{args.quantize}_tok_s": round(tps_q, 2),
        "speedup": round(tps_q / tps_base, 3),
        "model_bytes_baseline": api.model_size_bytes(params),
        "model_bytes_quantized": api.model_size_bytes(qparams),
    }
    if args.profile:
        from any4.profiler import profile_decode_components
        out["profile_baseline"] = profile_decode_components(
            params, cfg, batch=args.batch, ctx=args.profile_ctx)
        out["profile_quantized"] = profile_decode_components(
            qparams, cfg, batch=args.batch, ctx=args.profile_ctx)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
