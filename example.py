#!/usr/bin/env python
"""Minimal before/after-any4 example (reference example.py equivalent).

Offline-friendly: uses a random tiny model by default; pass --model-dir for
a real local HF checkpoint.
"""
import argparse

import jax
import jax.numpy as jnp

from any4.models import generate, llama, loader
from any4.quant import api


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--model-dir", default=None)
    p.add_argument("--prompt-tokens", type=int, default=8)
    args = p.parse_args()

    if args.model_dir:
        cfg, params = loader.load_model(args.model_dir)
    else:
        cfg = llama.LlamaConfig.tiny(vocab=1024, layers=2)
        params = llama.init_params(cfg, jax.random.PRNGKey(0))

    prompt = jax.random.randint(jax.random.PRNGKey(1),
                                (1, args.prompt_tokens), 0, cfg.vocab_size)
    print("before any4:",
          generate.generate(params, cfg, prompt, max_new_tokens=8)[0].tolist())

    qparams = api.quant_methods["any4"](params, group_size=128,
                                        kmeans_iters=10)
    print("after any4: ",
          generate.generate(qparams, cfg, prompt,
                            max_new_tokens=8)[0].tolist())
    print(f"model size: {api.model_size_bytes(params)/1e6:.1f} MB -> "
          f"{api.model_size_bytes(qparams)/1e6:.1f} MB")


if __name__ == "__main__":
    main()
