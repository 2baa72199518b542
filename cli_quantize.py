#!/usr/bin/env python
"""Offline model quantization CLI: HF checkpoint -> quantized any4
checkpoint, with the native C++ data plane for host-side packing when
available.

  python cli_quantize.py --model-dir /path/Llama-3.2-1B --fmt any4 \\
      --calibrate --output /path/llama-any4
  python cli_quantize.py --tiny --fmt int4 --output /tmp/q
"""
import argparse
import time

import jax
import jax.numpy as jnp


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--model-dir")
    p.add_argument("--tiny", action="store_true")
    p.add_argument("--fmt", default="any4",
                   choices=["int4", "int4p", "int8", "int8p", "w4a8",
                            "w8a8", "any4", "any4t", "any4q8", "nf4",
                            "fp4", "mx4"])
    p.add_argument("--group-size", type=int, default=128)
    p.add_argument("--kmeans-iters", type=int, default=30)
    p.add_argument("--calibrate", action="store_true")
    p.add_argument("--scale-sample-weight", action="store_true")
    p.add_argument("--awq", action="store_true",
                   help="run AWQ scale search before quantizing")
    p.add_argument("--dump-awq", default=None,
                   help="save the AWQ search artifact (.npz) for reuse "
                        "(reference --dump_awq)")
    p.add_argument("--load-awq", default=None,
                   help="apply a saved AWQ artifact instead of searching "
                        "(reference --load_awq)")
    p.add_argument("--quantize-args", default="",
                   help="extra k=v args for the quantizer (e.g. "
                        "int_zeros=True for the reference's new_grouping/"
                        "group_q1 rounded-integer zero points, "
                        "scale_only=True for symmetric)")
    p.add_argument("--row-parallel-shards", type=int, default=1,
                   help="pack k as N shards for row-parallel TP")
    p.add_argument("--output", required=True)
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU instead of JAX's default backend")
    args = p.parse_args(argv)
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    from any4.utils import setup_compile_cache
    setup_compile_cache()

    from any4 import calibrate as cal
    from any4 import native
    from any4.models import checkpoint, llama, loader
    from any4.quant import api, awq

    print(f"native data plane: "
          f"{'on (' + str(native.num_threads()) + ' threads)' if native.available() else 'off'}")

    if args.tiny or not args.model_dir:
        cfg = llama.LlamaConfig.tiny(vocab=1024, layers=2)
        params = llama.init_params(cfg, jax.random.PRNGKey(0))
        tokenizer = None
    else:
        # host-side path: when the C++ data plane can quantize directly
        # (int4, no forward passes needed before quantization), keep the
        # checkpoint as numpy so quantize+pack skips the device round trip
        host_side = (args.fmt == "int4" and native.available()
                     and not args.awq and not args.calibrate
                     and not args.load_awq)
        cfg, params = loader.load_model(args.model_dir, as_numpy=host_side)
        if host_side:
            print("loading host-side for native quantize+pack")
        tokenizer = None
        try:
            from transformers import AutoTokenizer
            tokenizer = AutoTokenizer.from_pretrained(args.model_dir)
        except Exception:
            pass

    if tokenizer is not None:
        ids = jnp.asarray(tokenizer(cal.default_prompt)["input_ids"],
                          jnp.int32)[None, :]
    else:
        ids = jax.random.randint(jax.random.PRNGKey(1), (1, 128), 0,
                                 cfg.vocab_size)

    if args.load_awq:
        t0 = time.time()
        params = awq.apply_awq(params, awq.load_awq(args.load_awq))
        print(f"awq artifact applied in {time.time() - t0:.1f}s")
    elif args.awq:
        t0 = time.time()
        awq_results, params = awq.run_awq(params, cfg, ids,
                                          group_size=args.group_size,
                                          progress=True)
        print(f"awq done in {time.time() - t0:.1f}s")
        if args.dump_awq:
            awq.save_awq(args.dump_awq, awq_results)
            print(f"awq artifact saved to {args.dump_awq}")

    sample_weight = None
    if args.calibrate and args.fmt == "any4":
        t0 = time.time()
        sample_weight = cal.calibrate(params, cfg, ids)
        print(f"calibration done in {time.time() - t0:.1f}s")

    from cli_eval import parse_kv_args
    kw = parse_kv_args(args.quantize_args)
    if args.fmt == "any4":
        kw.update(kmeans_iters=args.kmeans_iters,
                  scale_sample_weight=args.scale_sample_weight)
    t0 = time.time()
    qparams = api.quantize_model(
        params, fmt=args.fmt, group_size=args.group_size,
        sample_weight=sample_weight, progress=True,
        row_parallel_shards=args.row_parallel_shards, **kw)
    print(f"quantized in {time.time() - t0:.1f}s; "
          f"{api.model_size_bytes(params) / 1e6:.1f} MB -> "
          f"{api.model_size_bytes(qparams) / 1e6:.1f} MB")
    checkpoint.save_params(args.output, qparams, cfg)
    print(f"saved to {args.output}")


if __name__ == "__main__":
    main()
