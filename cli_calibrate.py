#!/usr/bin/env python
"""Offline calibration CLI (reference calibrate.py equivalent): run forward
passes and save per-layer mean |input| activations for any4's weighted
k-means.

  python cli_calibrate.py --model-dir /path/to/model --output acts.npz
  python cli_calibrate.py --tiny --output /tmp/acts.npz
"""
import argparse

import jax
import jax.numpy as jnp


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--model-dir")
    p.add_argument("--tiny", action="store_true")
    p.add_argument("--prompt", default=None,
                   help="calibration text (default: built-in multi-domain "
                        "prompt)")
    p.add_argument("--dataset", default=None,
                   help="dataset task name (requires network/local cache)")
    p.add_argument("--num-samples", type=int, default=16)
    p.add_argument("--max-seq-len", type=int, default=2048)
    p.add_argument("--output", required=True, help=".npz output path")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU instead of JAX's default backend")
    args = p.parse_args(argv)
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    from any4.utils import setup_compile_cache
    setup_compile_cache()

    from any4 import calibrate as cal
    from any4.models import llama, loader

    if args.tiny or not args.model_dir:
        cfg = llama.LlamaConfig.tiny(vocab=2048, layers=2)
        params = llama.init_params(cfg, jax.random.PRNGKey(0))
        ids = jax.random.randint(jax.random.PRNGKey(1), (2, 64), 0,
                                 cfg.vocab_size)
    else:
        cfg, params = loader.load_model(args.model_dir)
        from transformers import AutoTokenizer
        tok = AutoTokenizer.from_pretrained(args.model_dir)
        if args.dataset:
            from any4.evals import datasets
            tokens = datasets.load_tokens(args.dataset, tok,
                                          max_tokens=args.num_samples *
                                          args.max_seq_len)
            ids = jnp.asarray(
                tokens[:len(tokens) // args.max_seq_len * args.max_seq_len]
                .reshape(-1, args.max_seq_len)[:args.num_samples])
        else:
            text = args.prompt or cal.default_prompt
            ids = jnp.asarray(tok(text)["input_ids"], jnp.int32)[None, :]

    acts = cal.calibrate(params, cfg, ids)
    cal.save_calibration(acts, args.output)
    print(f"saved {len(acts)} layer activations to {args.output}")


if __name__ == "__main__":
    main()
