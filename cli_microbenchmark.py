#!/usr/bin/env python
"""Layer microbenchmark CLI (reference microbenchmark.py equivalent):
times a single quantized linear against the bf16 baseline.

  python cli_microbenchmark.py --input-dim 4096 --output-dim 4096 \\
      --quantize any4 --batch 1
"""
import argparse
import json
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np


def window(f, args, iters):
    t0 = time.perf_counter()
    r = None
    for _ in range(iters):
        r = f(*args)
    jax.block_until_ready(r)
    return (time.perf_counter() - t0) / iters


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--input-dim", type=int, default=4096)
    p.add_argument("--output-dim", type=int, default=4096)
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--quantize", default="any4",
                   choices=["int4", "int4p", "int8", "int8p", "w4a8",
                            "w8a8", "any4", "nf4", "fp4", "mx4"])
    p.add_argument("--group-size", type=int, default=128)
    p.add_argument("--rounds", type=int, default=12)
    p.add_argument("--iters", type=int, default=20)
    p.add_argument("--sweep", action="store_true",
                   help="reproduce the reference's K sweep table "
                        "(README.md:440-455): K=1024..8192 speedups")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU instead of JAX's default backend")
    args = p.parse_args(argv)
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    from any4.utils import setup_compile_cache
    setup_compile_cache()
    if args.sweep:
        return sweep(args)

    from any4.ops import linear as lin

    K, N, M = args.input_dim, args.output_dim, args.batch
    g = 32 if args.quantize == "mx4" else args.group_size
    w = jax.random.normal(jax.random.PRNGKey(0), (N, K), jnp.float32)
    x = jax.random.normal(jax.random.PRNGKey(1), (M, K)).astype(jnp.bfloat16)
    wb = w.astype(jnp.bfloat16)
    kw = dict(kmeans_iters=8) if args.quantize == "any4" else {}
    qt = lin.quantize_tensor(w, args.quantize, g, **kw)

    f_b = jax.jit(lambda a, b: a @ b.T)
    # the production dispatch (ops.linear.linear) so every format takes
    # its real path: the lookup kernel, w4a8/w8a8 activation quantization
    f_q = jax.jit(lambda a, q: lin.linear(a, q))
    qargs = (x, qt)
    jax.block_until_ready(f_b(x, wb))
    jax.block_until_ready(f_q(*qargs))
    tbs, tqs = [], []
    for _ in range(args.rounds):
        tbs.append(window(f_b, (x, wb), args.iters))
        tqs.append(window(f_q, qargs, args.iters))
    tb, tq = float(np.median(tbs)), float(np.median(tqs))
    out = {
        "fmt": args.quantize, "m": M, "k": K, "n": N,
        "bf16_us": round(tb * 1e6, 1),
        "quant_us": round(tq * 1e6, 1),
        "speedup": round(tb / tq, 3),
        "weight_bytes": qt.nbytes,
        "weight_gbps": round(qt.nbytes / tq / 1e9, 1),
    }
    print(json.dumps(out))
    return out


def sweep(args):
    """Dimension sweep over K=N in {1024..8192}, all 4-bit formats
    interleaved with the bf16 baseline (median of the windows)."""
    from any4.ops import linear as lin

    table = {}
    for K in (1024, 2048, 3072, 4096, 5120, 6144, 7168, 8192):
        N = K
        w = jax.random.normal(jax.random.PRNGKey(0), (N, K), jnp.float32)
        x = jax.random.normal(jax.random.PRNGKey(1),
                              (args.batch, K)).astype(jnp.bfloat16)
        wb = w.astype(jnp.bfloat16)
        fns = {"bf16": (jax.jit(lambda a, b: a @ b.T), (x, wb))}
        for fmt in ("int4", "nf4", "any4"):
            kw = dict(kmeans_iters=4) if fmt == "any4" else {}
            qt = lin.quantize_tensor(w, fmt, args.group_size, **kw)
            fns[fmt] = (jax.jit(lambda a, q: lin.linear(a, q)), (x, qt))
        times = {k: [] for k in fns}
        for k, (f, a) in fns.items():
            jax.block_until_ready(f(*a))
        for _ in range(args.rounds):
            for k, (f, a) in fns.items():
                times[k].append(window(f, a, args.iters))
        best = {k: float(np.median(v)) for k, v in times.items()}
        row = {fmt: round(best["bf16"] / best[fmt], 2)
               for fmt in ("int4", "nf4", "any4")}
        row["bf16_us"] = round(best["bf16"] * 1e6, 1)
        table[K] = row
        print(f"K={K}: {row}", file=sys.stderr)
    print(json.dumps(table))
    return table


if __name__ == "__main__":
    main()
