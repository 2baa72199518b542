#!/usr/bin/env python
"""Model diff CLI (reference diff.py equivalent): per-layer activation MSE +
cosine similarity between a baseline model and its quantized version on one
prompt, written to diffs.csv.

  python cli_diff.py --tiny --quantize any4 --log-dir /tmp/diff
"""
import argparse

import jax
import jax.numpy as jnp


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--model-dir")
    p.add_argument("--tiny", action="store_true")
    p.add_argument("--quantize", default="any4")
    p.add_argument("--group-size", type=int, default=128)
    p.add_argument("--pseudo", action="store_true", default=True)
    p.add_argument("--log-dir", default="logs/diff")
    p.add_argument("--prompt-tokens", type=int, default=64)
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU instead of JAX's default backend")
    args = p.parse_args(argv)
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    from any4.utils import setup_compile_cache
    setup_compile_cache()

    from any4.evals import analyze, harness
    from any4.models import llama, loader
    from any4.quant import api

    harness.log_args(args.log_dir, vars(args))
    if args.tiny or not args.model_dir:
        cfg = llama.LlamaConfig.tiny(vocab=512, layers=2)
        params = llama.init_params(cfg, jax.random.PRNGKey(0))
    else:
        cfg, params = loader.load_model(args.model_dir)

    ids = jax.random.randint(jax.random.PRNGKey(1),
                             (1, args.prompt_tokens), 0, cfg.vocab_size)
    kw = dict(kmeans_iters=10) if args.quantize in ("any4", "anyq") else {}
    qparams = api.quant_methods[args.quantize](
        params, group_size=args.group_size, pseudo=True, **kw)
    rows = analyze.diff_models(params, qparams, cfg, ids,
                               out_dir=args.log_dir)
    for r in rows:
        print(f"{r['layer']}: mse {r['mse']:.3e} cossim {r['cossim']:.5f}")


if __name__ == "__main__":
    main()
