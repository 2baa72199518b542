#!/usr/bin/env python
"""Weight/quantization analysis CLI (reference analyze.py equivalent):
per-layer stats + per-format W/Y quantization MSE to stats.csv.

  python cli_analyze.py --tiny --formats int4,nf4,any4 --log-dir /tmp/an
"""
import argparse

import jax


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--model-dir")
    p.add_argument("--tiny", action="store_true")
    p.add_argument("--formats", default="int4,nf4,any4")
    p.add_argument("--group-size", type=int, default=128)
    p.add_argument("--log-dir", default="logs/analyze")
    p.add_argument("--calibration", default=None,
                   help=".npz from cli_calibrate.py for sample weights")
    p.add_argument("--no-plots", action="store_true",
                   help="skip writing plots.pdf")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU instead of JAX's default backend")
    args = p.parse_args(argv)
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    from any4.utils import setup_compile_cache
    setup_compile_cache()

    from any4.evals import analyze, harness
    from any4.models import llama, loader

    harness.log_args(args.log_dir, vars(args))
    if args.tiny or not args.model_dir:
        cfg = llama.LlamaConfig.tiny(vocab=512, layers=2)
        params = llama.init_params(cfg, jax.random.PRNGKey(0))
    else:
        cfg, params = loader.load_model(args.model_dir)

    sw = None
    if args.calibration:
        from any4 import calibrate as cal
        sw = cal.load_calibration(args.calibration)

    rows = analyze.analyze_model(
        params, fmts=[f.strip() for f in args.formats.split(",")],
        group_size=args.group_size, sample_weights=sw,
        out_dir=args.log_dir, progress=True)
    print(f"wrote {len(rows)} rows to {args.log_dir}/stats.csv")
    if not args.no_plots:
        path = analyze.write_plots(params, rows, args.log_dir)
        print(f"wrote {path}")


if __name__ == "__main__":
    main()
