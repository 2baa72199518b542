"""tools/bench_kernels.py's measurements at tiny size on the CPU: the
arms run, agree with each other and report every field."""
import importlib.util
import os

import pytest

from any4.models import llama

import chip_smoke as cs

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location(
    "bench_kernels", os.path.join(_ROOT, "tools", "bench_kernels.py"))
bk = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(bk)


@pytest.fixture(scope="module")
def tiny_model():
    cfg = llama.LlamaConfig.tiny(vocab=256, layers=2)
    return cfg, cs.build_model(cfg, 0, row_chunk=64)


@pytest.mark.parametrize("m", [1, 16])
def test_bench_linears_tiny(m):
    (row,) = bk.bench_linears([(64, 1024)], (m,), n_weights=2, iters=1)
    assert row["kernel_rel_l2"] <= cs.KERNEL_REL_L2
    assert row["xla_rel_l2"] <= cs.KERNEL_REL_L2
    assert row["kernel_us"] > 0 and row["xla_us"] > 0


def test_bench_attention_tiny():
    (row,) = bk.bench_attention(2, 4, 2, 32, (64,), 16, iters=1)
    assert row["max_abs_diff"] < 1e-2
    assert row["dense_us"] > 0 and row["library_us"] > 0


def test_bench_engine_attention_tiny(tiny_model):
    cfg, qp = tiny_model
    (row,) = bk.bench_engine_attention(qp, cfg, 2, (64,), steps=2)
    assert row["table_tokens"] == 64
    assert row["library_step_ms"] > 0 and row["dense_step_ms"] > 0


def test_bench_decode_tiny(tiny_model):
    cfg, qp = tiny_model
    out = bk.bench_decode(qp, cfg, 8, 4)
    assert out["tokens_agree"]
    assert out["kernel_tok_s"] > 0 and out["xla_tok_s"] > 0


def test_patched_restores():
    orig = bk.lin.lut_kernel_applies
    with bk.patched(bk.lin, "lut_kernel_applies", bk.never):
        assert bk.lin.lut_kernel_applies is bk.never
    assert bk.lin.lut_kernel_applies is orig
