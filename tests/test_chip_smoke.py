"""chip_smoke.py's phases at tiny size on the CPU (the kernels
interpreted), its refusal to run without a GPU, and the compile-cache
path choice it shares with the CLIs."""
import os

import jax
import numpy as np
import pytest

import chip_smoke as cs
from any4 import utils
from any4.models import llama
from any4.ops import linear as lin


@pytest.fixture(scope="module")
def tiny_model():
    cfg = llama.LlamaConfig.tiny(vocab=256, layers=2)
    return cfg, cs.build_model(cfg, 0, row_chunk=64)


def test_main_refuses_without_gpu(capsys):
    assert cs.main([]) == 2
    out = capsys.readouterr()
    assert out.out == "" and "needs a GPU" in out.err


@pytest.mark.parametrize("m", [1, 16])
def test_check_kernels_tiny(m):
    rows = cs.check_kernels([(64, 1024), (40, 2048)], (m,), interpret=True)
    assert len(rows) == 2
    assert all(r["rel_l2"] <= cs.KERNEL_REL_L2 and r["finite"]
               for r in rows)


def test_check_attention_tiny():
    row = cs.check_attention(2, 8, 2, 64, 128, interpret=True)
    assert row["rel_l2"] <= cs.ATTN_REL_L2


def test_check_model_tiny(tiny_model):
    cfg, qp = tiny_model
    out = cs.check_model(qp, cfg, 0, prompt_len=16, interpret=True)
    assert out["prefill_rel_l2"] <= cs.LOGITS_REL_L2
    assert out["top1_agree"] > 0.5


def test_reference_logits_are_the_f32_model(tiny_model):
    # the layer-by-layer reference is the model's own forward over the
    # dequantized weights in f32
    import dataclasses
    import jax.numpy as jnp
    cfg, qp = tiny_model
    ids = jax.random.randint(jax.random.PRNGKey(1), (1, 12), 0, 256)
    ref = cs.reference_logits(qp, cfg, ids)
    dense = jax.tree.map(
        lambda v: (lin.dequantize_tensor(v, dtype=jnp.float32)
                   if isinstance(v, lin.QuantizedTensor)
                   else v.astype(jnp.float32)),
        qp, is_leaf=lambda v: isinstance(v, lin.QuantizedTensor))
    cfg32 = dataclasses.replace(cfg, dtype=jnp.float32)
    with jax.default_matmul_precision("highest"):
        want, _ = llama.forward(dense, cfg32, ids)
    np.testing.assert_allclose(np.asarray(ref), np.asarray(want),
                               rtol=1e-4, atol=1e-4)


def test_decode_and_engines_tiny(tiny_model):
    cfg, qp = tiny_model
    prompts = cs.make_prompts(cfg, 0, lens=(40, 24, 17, 9))
    dec, gen = cs.time_decode(qp, cfg, prompts[-1], 4)
    assert dec["decode_tok_s"] > 0 and dec["new_tokens"] == 4
    assert len(gen) == 5
    rows = [("generate", prompts[-1], gen, cs.TIE_GAP["bf16"])]
    for kv, kw in (("bf16", {}),
                   ("int8", dict(kv_layout="contig", kv_quantize=True))):
        toks = cs.run_engine(qp, cfg, prompts, 6, kv, max_ctx=64, **kw)
        assert [len(t) for t in toks] == [6] * 4
        rows += [(f"engine {kv}", p, t, cs.TIE_GAP[kv])
                 for p, t in zip(prompts, toks)]
    out = cs.check_streams(qp, cfg, rows)
    assert [r["steps"] for r in out] == [5] + [6] * 8
    assert all(0 <= r["max_regret"] <= r["tol"] for r in out)


@pytest.mark.parametrize("step", [None, 0, 3])
def test_check_streams_scores_every_step(tiny_model, step):
    # a decoder's own greedy tokens pass; one token the reference ranks
    # last, at the first or a later step, fails the whole check
    cfg, qp = tiny_model
    prompt = cs.make_prompts(cfg, 1, lens=(12,))[0]
    _, gen = cs.time_decode(qp, cfg, prompt, 4)
    if step is not None:
        ids = np.concatenate([prompt, gen[:step]])[None]
        logits = llama.forward(qp, cfg, jax.numpy.asarray(ids))[0]
        gen[step] = int(np.argmin(np.asarray(logits[0, -1], np.float32)))
    rows = [("generate", prompt, gen, cs.TIE_GAP["bf16"])]
    if step is None:
        (row,) = cs.check_streams(qp, cfg, rows)
        assert row["max_regret"] <= row["tol"]
    else:
        with pytest.raises(AssertionError):
            cs.check_streams(qp, cfg, rows)


def test_four_cards_tiny():
    # the --four phase on 4 of the test session's 8 virtual CPU devices:
    # shard_params + the tp=4 engine against the one-card engine
    cfg = llama.LlamaConfig(vocab_size=256, hidden_size=128,
                            intermediate_size=256, num_hidden_layers=2,
                            num_attention_heads=8, num_key_value_heads=4,
                            head_dim=32)
    cs.four_cards(cfg, 0, lens=(24, 9), new_tokens=4, max_ctx=32)


class TestCompileCache:
    def _record(self, monkeypatch):
        calls = []
        monkeypatch.setattr(jax.config, "update",
                            lambda *a: calls.append(a))
        return calls

    def test_env_set_overrides_nothing(self, monkeypatch):
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/elsewhere")
        calls = self._record(monkeypatch)
        assert utils.setup_compile_cache() is None
        assert calls == []

    def test_default_is_fixed_path_in_checkout(self, monkeypatch):
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        calls = self._record(monkeypatch)
        first = utils.setup_compile_cache()
        assert utils.setup_compile_cache() == first
        assert calls == [("jax_compilation_cache_dir", first)] * 2
        root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        assert os.path.dirname(first) == root
        with open(os.path.join(root, ".gitignore")) as f:
            assert os.path.basename(first) + "/" in f.read().split()


def test_kernel_check_refuses_a_non_kernel_format():
    # check_kernels asserts the dispatch really picks the kernel
    w = cs.random_any4(jax.random.PRNGKey(0), 32, 1024)
    assert lin.lut_kernel_applies(w, 1, interpret=True)
    assert not lin.lut_kernel_applies(w, 1)
