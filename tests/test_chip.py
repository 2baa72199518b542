"""Tests that run only on an NVIDIA GPU (marker ``chip``; skipped at run
time elsewhere). On the card:

    ANY4_TEST_GPU=1 python -m pytest tests -m chip
"""
import jax
import pytest

import chip_smoke as cs
from any4.models import llama
from any4.ops import linear as lin

pytestmark = pytest.mark.chip


@pytest.mark.parametrize("m", [1, 4, 16])
def test_lut_gemv_compiled_matches_reference(m):
    rows = cs.check_kernels([(4096, 4096), (1000, 2560)], (m,))
    assert all(r["rel_l2"] <= cs.KERNEL_REL_L2 for r in rows)


@pytest.mark.parametrize("ctx", [256, 2048])
def test_library_paged_attention_compiled(ctx):
    cs.check_attention(4, 32, 8, 128, ctx)


def test_dispatch_picks_kernel_on_gpu():
    w = cs.random_any4(jax.random.PRNGKey(0), 256, 1024)
    assert lin.lut_kernel_applies(w, 1)
    assert not lin.lut_kernel_applies(w, 17)


def test_small_model_generate_and_engines():
    cfg = llama.LlamaConfig(vocab_size=1024, hidden_size=512,
                            intermediate_size=1024, num_hidden_layers=2,
                            num_attention_heads=8, num_key_value_heads=4,
                            head_dim=64)
    qp = cs.build_model(cfg, 0)
    cs.check_model(qp, cfg, 0, prompt_len=32)
    prompts = cs.make_prompts(cfg, 0, lens=(96, 40))
    rows = []
    for kv, kw in (("bf16", {}),
                   ("int8", dict(kv_layout="contig", kv_quantize=True))):
        toks = cs.run_engine(qp, cfg, prompts, 8, kv, max_ctx=128, **kw)
        assert [len(t) for t in toks] == [8, 8]
        rows += [(f"engine {kv}", p, t, cs.TIE_GAP[kv])
                 for p, t in zip(prompts, toks)]
    out = cs.check_streams(qp, cfg, rows)
    assert len(out) == 4
