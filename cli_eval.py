#!/usr/bin/env python
"""Evaluation CLI -- the reference eval.py equivalent.

Examples:
  # perplexity of an any4-quantized local HF checkpoint
  python cli_eval.py --model-dir /path/to/Llama-3.2-1B \\
      --quantize any4 --quantize-args group_size=128,scale_sample_weight=True \\
      --tasks wikitext-2,c4 --log-dir logs/any4

  # offline plumbing check with a random-init tiny model + synthetic data
  python cli_eval.py --tiny --quantize int4 --tasks synthetic --log-dir logs/t
"""
import argparse
import json
import sys

import jax
import jax.numpy as jnp


def parse_kv_args(s):
    """Parse 'k=v,k2=v2' strings (the reference's simple_parse_args_string)."""
    if not s:
        return {}
    out = {}
    for part in s.split(","):
        k, _, v = part.partition("=")
        if v.lower() in ("true", "false"):
            v = v.lower() == "true"
        else:
            try:
                v = int(v)
            except ValueError:
                try:
                    v = float(v)
                except ValueError:
                    pass
        out[k.strip()] = v
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--model-dir", help="local HF checkpoint directory")
    p.add_argument("--tiny", action="store_true",
                   help="use a random-init tiny model (offline smoke)")
    p.add_argument("--load-quantized", help="load a saved quantized checkpoint")
    p.add_argument("--save-quantized", help="save quantized params to dir")
    p.add_argument("--quantize", default=None,
                   choices=[None, "int4", "int4p", "int8", "int8p", "w4a8",
                            "w8a8", "any4", "any4t", "any4q8", "nf4",
                            "fp4", "mx4", "intq", "anyq"])
    p.add_argument("--quantize-args", default="",
                   help="k=v,... forwarded to the quantizer")
    p.add_argument("--pseudo", action="store_true",
                   help="fake-quantize (dense reconstruction)")
    p.add_argument("--calibrate", action="store_true",
                   help="calibrate sample weights on the default prompt")
    p.add_argument("--tasks", default="wikitext-2",
                   help="comma-separated perplexity tasks, or 'synthetic'")
    p.add_argument("--evaluator", default="chunked",
                   choices=["chunked", "stream"],
                   help="chunked = GPTQ-style fixed-seqlen NLL (reference "
                        "data_gptq.llama_eval); stream = per-document "
                        "token-weighted NLL (reference data.eval_perplexity)")
    p.add_argument("--seqlen", type=int, default=2048)
    p.add_argument("--max-chunks", type=int, default=None)
    p.add_argument("--log-dir", default="logs/eval")
    p.add_argument("--overwrite-results", action="store_true")
    p.add_argument("--tokenizer-dir", default=None)
    p.add_argument("--lm-eval-tasks", default=None,
                   help="comma-separated lm-evaluation-harness tasks; "
                        "'local_mc' runs the builtin offline task through "
                        "the same LM protocol (no lm_eval install needed)")
    p.add_argument("--lm-eval-limit", type=int, default=None)
    p.add_argument("--code-tasks", default=None,
                   help="comma-separated BigCode-style code tasks "
                        "(builtin, humaneval): generate -> execute -> "
                        "pass@k")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU instead of JAX's default backend")
    args = p.parse_args(argv)
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    from any4.utils import setup_compile_cache
    setup_compile_cache()

    from any4.evals import harness
    from any4.models import checkpoint, llama, loader
    from any4.quant import api

    harness.log_args(args.log_dir, vars(args))

    tokenizer = None
    if args.load_quantized:
        params, cfg = checkpoint.load_params(args.load_quantized)
    elif args.tiny or not args.model_dir:
        cfg = llama.LlamaConfig.tiny(vocab=2048, layers=2)
        params = llama.init_params(cfg, jax.random.PRNGKey(0))
    else:
        cfg, params = loader.load_model(args.model_dir)
        tok_dir = args.tokenizer_dir or args.model_dir
        try:
            from transformers import AutoTokenizer
            tokenizer = AutoTokenizer.from_pretrained(tok_dir)
        except Exception as e:
            print(f"tokenizer unavailable ({e}); synthetic data only",
                  file=sys.stderr)

    if args.quantize and not args.load_quantized:
        qargs = parse_kv_args(args.quantize_args)
        sample_weight = None
        if args.calibrate:
            from any4 import calibrate as cal
            ids = None
            if tokenizer is not None:
                ids = jnp.asarray(
                    tokenizer(cal.default_prompt)["input_ids"],
                    jnp.int32)[None, :]
            else:
                ids = jax.random.randint(jax.random.PRNGKey(1), (1, 128), 0,
                                         cfg.vocab_size)
            sample_weight = cal.calibrate(params, cfg, ids)
        params = api.quant_methods[args.quantize](
            params, pseudo=args.pseudo, sample_weight=sample_weight,
            progress=True, **qargs)
        if args.save_quantized:
            checkpoint.save_params(args.save_quantized, params, cfg)

    tasks = [t.strip() for t in args.tasks.split(",") if t.strip()]
    synthetic = tasks == ["synthetic"]
    if synthetic:
        tasks = ["wikitext-2"]
    results = harness.run_perplexity_tasks(
        params, cfg, tasks, tokenizer=tokenizer, seqlen=args.seqlen,
        log_dir=args.log_dir, overwrite=args.overwrite_results,
        max_chunks=args.max_chunks, synthetic=synthetic, progress=True,
        evaluator=args.evaluator)

    lm = None
    if args.lm_eval_tasks or args.code_tasks:
        from any4.evals import tasks_local
        from any4.evals.lm_eval_adapter import JaxCausalLM
        tok = tokenizer or tasks_local.ByteTokenizer()
        lm = JaxCausalLM(params, cfg, tok, max_length=args.seqlen)

    if args.lm_eval_tasks:
        from any4.evals import lm_eval_adapter, tasks_local
        lm_tasks = [t.strip() for t in args.lm_eval_tasks.split(",")]
        local = [t for t in lm_tasks if t.startswith("local")]
        remote = [t for t in lm_tasks if not t.startswith("local")]
        for t in local:
            r = tasks_local.run_local_task(lm, t)
            results[f"lm-eval:{t}"] = r
            harness.log_results(args.log_dir, f"lm-eval:{t}", r)
        if remote:
            try:
                lm_res = lm_eval_adapter.simple_evaluate(
                    params, cfg, tokenizer, remote,
                    limit=args.lm_eval_limit, max_length=args.seqlen)
                for t, r in lm_res.get("results", {}).items():
                    results[f"lm-eval:{t}"] = r
                    harness.log_results(args.log_dir, f"lm-eval:{t}", r)
            except lm_eval_adapter.LmEvalUnavailable as e:
                print(f"lm-eval skipped: {e}", file=sys.stderr)

    if args.code_tasks:
        from any4.evals import code_eval
        code_tasks = [t.strip() for t in args.code_tasks.split(",")]
        code_res = code_eval.run_code_tasks(
            lm, code_tasks, log_dir=args.log_dir, progress=True)
        for t, r in code_res.items():
            results[f"code:{t}"] = r
            harness.log_results(args.log_dir, f"code:{t}", r)

    print(json.dumps(results, indent=2))
    return results


if __name__ == "__main__":
    main()
