"""HF checkpoint loading: safetensors -> JAX parameter pytree.

The reference loads models through transformers/accelerate
(eval.py:168-177); here we read safetensors shards directly into the
functional parameter tree of :mod:`any4.models.llama` with no torch
dependency on the hot path.
"""
from __future__ import annotations

import json
import os
from typing import Dict, Tuple

import jax.numpy as jnp
import numpy as np

from . import llama


def _cfg_from_hf(config: dict) -> "llama.LlamaConfig":
    mt = config.get("model_type", "llama")
    gemma: dict = {}
    if mt in ("gemma", "gemma2"):
        # gemma family: (1+w) norms, tanh-gelu MLP, sqrt(d)-scaled embeds
        layer_types = config.get("layer_types")
        gemma = dict(
            # HF forces tanh-gelu for gemma even when old configs say
            # hidden_act='gelu' (the checkpoints were trained with the
            # tanh approximation); only the corrected 'hidden_activation'
            # key is honored, mirroring transformers' behavior
            hidden_act=config.get("hidden_activation",
                                  "gelu_pytorch_tanh"),
            rms_norm_offset=1.0,
            embed_scale=float(config["hidden_size"]) ** 0.5,
        )
        if mt == "gemma2":
            gemma.update(
                query_pre_attn_scalar=config.get("query_pre_attn_scalar"),
                attn_logit_softcapping=config.get("attn_logit_softcapping"),
                final_logit_softcapping=config.get(
                    "final_logit_softcapping"),
                sliding_window=config.get("sliding_window"),
                layer_types=(tuple(layer_types) if layer_types else None),
                sandwich_norms=True,
            )
    return llama.LlamaConfig(
        vocab_size=config["vocab_size"],
        hidden_size=config["hidden_size"],
        intermediate_size=config["intermediate_size"],
        num_hidden_layers=config["num_hidden_layers"],
        num_attention_heads=config["num_attention_heads"],
        num_key_value_heads=config.get("num_key_value_heads",
                                       config["num_attention_heads"]),
        head_dim=config.get("head_dim"),
        max_position_embeddings=config.get("max_position_embeddings", 4096),
        rms_norm_eps=config.get("rms_norm_eps", 1e-5),
        rope_theta=config.get("rope_theta", 10000.0),
        tie_word_embeddings=config.get("tie_word_embeddings", mt == "gemma"
                                       or mt == "gemma2"),
        attention_bias=config.get("attention_bias", False),
        **gemma,
    )


def _open_shards(model_dir: str):
    from safetensors import safe_open
    index_path = os.path.join(model_dir, "model.safetensors.index.json")
    shards: Dict[str, str] = {}
    if os.path.exists(index_path):
        with open(index_path) as f:
            index = json.load(f)
        weight_map = index["weight_map"]
        files = sorted(set(weight_map.values()))
    else:
        files = [f for f in os.listdir(model_dir)
                 if f.endswith(".safetensors")]
        weight_map = None
    handles = {fn: safe_open(os.path.join(model_dir, fn), framework="np")
               for fn in files}
    if weight_map is None:
        weight_map = {}
        for fn, h in handles.items():
            for k in h.keys():
                weight_map[k] = fn

    def get(name: str) -> np.ndarray:
        fn = weight_map[name]
        return handles[fn].get_tensor(name)

    return get, set(weight_map)


def _make_arr(get, as_numpy: bool, dtype):
    """Reader for checkpoint tensors: device jnp in ``dtype``, or (with
    ``as_numpy``) host float32 numpy so the native C++ data plane can
    quantize+pack without a device round trip."""
    if as_numpy:
        def arr(name):
            a = get(name)
            if a.dtype == np.uint16:  # bf16 raw bits from safetensors
                from .. import native
                if native.available():
                    return native.bf16_to_f32(a).reshape(a.shape)
                return np.asarray(jnp.asarray(a).view(jnp.bfloat16)
                                  .astype(jnp.float32))
            return np.asarray(a, np.float32)
    else:
        def arr(name):
            return jnp.asarray(get(name)).astype(dtype)
    return arr


def load_model(model_dir: str, dtype=jnp.bfloat16, as_numpy: bool = False):
    """Load any supported HF checkpoint directory, dispatching on
    config.json's ``model_type`` (llama-family dense vs mixtral MoE) --
    the analog of the reference's AutoModelForCausalLM entry."""
    with open(os.path.join(model_dir, "config.json")) as f:
        model_type = json.load(f).get("model_type", "llama")
    if model_type == "mixtral":
        return load_mixtral(model_dir, dtype=dtype, as_numpy=as_numpy)
    return load_llama(model_dir, dtype=dtype, as_numpy=as_numpy)


def load_llama(model_dir: str, dtype=jnp.bfloat16, as_numpy: bool = False
               ) -> Tuple["llama.LlamaConfig", Dict]:
    """Load an HF Llama/Mistral/Qwen2-style checkpoint directory.

    ``as_numpy=True`` keeps weights host-side (float32 numpy) so the
    native C++ data plane can quantize+pack without a device round trip
    (see ops.linear.quantize_tensor)."""
    with open(os.path.join(model_dir, "config.json")) as f:
        hf_cfg = json.load(f)
    cfg = _cfg_from_hf(hf_cfg)
    get, names = _open_shards(model_dir)
    arr = _make_arr(get, as_numpy, dtype)

    params: Dict = {
        "embed_tokens": arr("model.embed_tokens.weight"),
        "norm": arr("model.norm.weight"),
        "layers": [],
    }
    for i in range(cfg.num_hidden_layers):
        p = f"model.layers.{i}."
        layer = {
            "input_layernorm": arr(p + "input_layernorm.weight"),
            "post_attention_layernorm":
                arr(p + "post_attention_layernorm.weight"),
            "q_proj": arr(p + "self_attn.q_proj.weight"),
            "k_proj": arr(p + "self_attn.k_proj.weight"),
            "v_proj": arr(p + "self_attn.v_proj.weight"),
            "o_proj": arr(p + "self_attn.o_proj.weight"),
            "gate_proj": arr(p + "mlp.gate_proj.weight"),
            "up_proj": arr(p + "mlp.up_proj.weight"),
            "down_proj": arr(p + "mlp.down_proj.weight"),
        }
        for biased in ("q", "k", "v", "o"):
            bname = p + f"self_attn.{biased}_proj.bias"
            if bname in names:  # Qwen2-style attention biases
                layer[f"{biased}_bias"] = arr(bname)
        for nrm in ("pre_feedforward_layernorm",
                    "post_feedforward_layernorm"):  # gemma2 sandwich norms
            if p + nrm + ".weight" in names:
                layer[nrm] = arr(p + nrm + ".weight")
        params["layers"].append(layer)
    if not cfg.tie_word_embeddings and "lm_head.weight" in names:
        params["lm_head"] = arr("lm_head.weight")
    return cfg, params


def _mixtral_cfg_from_hf(config: dict):
    from . import mixtral
    base = _cfg_from_hf(config)
    return mixtral.MixtralConfig(
        **{**base.__dict__,
           "num_local_experts": config.get("num_local_experts", 8),
           "num_experts_per_tok": config.get("num_experts_per_tok", 2)})


def load_mixtral(model_dir: str, dtype=jnp.bfloat16, as_numpy: bool = False
                 ) -> Tuple["object", Dict]:
    """Load an HF Mixtral (sparse-MoE) checkpoint directory.

    Layout (HF MixtralForCausalLM): attention/norms as Llama plus
    ``block_sparse_moe.gate`` (router) and per-expert ``experts.{e}.w1/w2/w3``.
    The reference evaluates Mixtral-8x7B through this exact HF model
    (README.md:309-327)."""
    with open(os.path.join(model_dir, "config.json")) as f:
        hf_cfg = json.load(f)
    cfg = _mixtral_cfg_from_hf(hf_cfg)
    get, names = _open_shards(model_dir)
    arr = _make_arr(get, as_numpy, dtype)

    params: Dict = {
        "embed_tokens": arr("model.embed_tokens.weight"),
        "norm": arr("model.norm.weight"),
        "layers": [],
    }
    for i in range(cfg.num_hidden_layers):
        p = f"model.layers.{i}."
        layer = {
            "input_layernorm": arr(p + "input_layernorm.weight"),
            "post_attention_layernorm":
                arr(p + "post_attention_layernorm.weight"),
            "q_proj": arr(p + "self_attn.q_proj.weight"),
            "k_proj": arr(p + "self_attn.k_proj.weight"),
            "v_proj": arr(p + "self_attn.v_proj.weight"),
            "o_proj": arr(p + "self_attn.o_proj.weight"),
            "router": arr(p + "block_sparse_moe.gate.weight"),
            "experts": [
                {"w1": arr(p + f"block_sparse_moe.experts.{e}.w1.weight"),
                 "w3": arr(p + f"block_sparse_moe.experts.{e}.w3.weight"),
                 "w2": arr(p + f"block_sparse_moe.experts.{e}.w2.weight")}
                for e in range(cfg.num_local_experts)],
        }
        params["layers"].append(layer)
    if not cfg.tie_word_embeddings and "lm_head.weight" in names:
        params["lm_head"] = arr("lm_head.weight")
    return cfg, params


def convert_torch_mixtral(model, dtype=jnp.bfloat16):
    """Convert an instantiated transformers MixtralForCausalLM (torch CPU)
    into ``(cfg, params)`` for :mod:`any4.models.mixtral`."""
    sd = {k: v.detach() for k, v in model.state_dict().items()}
    cfg = _mixtral_cfg_from_hf(model.config.to_dict())

    def arr(name):
        return jnp.asarray(sd[name].float().numpy()).astype(dtype)

    params: Dict = {
        "embed_tokens": arr("model.embed_tokens.weight"),
        "norm": arr("model.norm.weight"),
        "layers": [],
    }
    for i in range(cfg.num_hidden_layers):
        p = f"model.layers.{i}."
        params["layers"].append({
            "input_layernorm": arr(p + "input_layernorm.weight"),
            "post_attention_layernorm":
                arr(p + "post_attention_layernorm.weight"),
            "q_proj": arr(p + "self_attn.q_proj.weight"),
            "k_proj": arr(p + "self_attn.k_proj.weight"),
            "v_proj": arr(p + "self_attn.v_proj.weight"),
            "o_proj": arr(p + "self_attn.o_proj.weight"),
            "router": arr(p + "block_sparse_moe.gate.weight"),
            "experts": [
                {"w1": arr(p + f"block_sparse_moe.experts.{e}.w1.weight"),
                 "w3": arr(p + f"block_sparse_moe.experts.{e}.w3.weight"),
                 "w2": arr(p + f"block_sparse_moe.experts.{e}.w2.weight")}
                for e in range(cfg.num_local_experts)],
        })
    if "lm_head.weight" in sd and not cfg.tie_word_embeddings:
        params["lm_head"] = arr("lm_head.weight")
    return cfg, params


def convert_torch_llama(model, dtype=jnp.bfloat16):
    """Convert an instantiated transformers Llama-family model (torch CPU)
    into ``(cfg, params)`` for :mod:`any4.models.llama`.

    This is the ground-truth bridge: the reference evaluates HF torch models
    directly (eval.py:168-177), so logit-level parity against a converted
    transformers model is the strongest offline accuracy evidence."""
    sd = {k: v.detach() for k, v in model.state_dict().items()}
    cfg = _cfg_from_hf(model.config.to_dict())

    def arr(name):
        return jnp.asarray(sd[name].float().numpy()).astype(dtype)

    params: Dict = {
        "embed_tokens": arr("model.embed_tokens.weight"),
        "norm": arr("model.norm.weight"),
        "layers": [],
    }
    for i in range(cfg.num_hidden_layers):
        p = f"model.layers.{i}."
        layer = {
            "input_layernorm": arr(p + "input_layernorm.weight"),
            "post_attention_layernorm":
                arr(p + "post_attention_layernorm.weight"),
            "q_proj": arr(p + "self_attn.q_proj.weight"),
            "k_proj": arr(p + "self_attn.k_proj.weight"),
            "v_proj": arr(p + "self_attn.v_proj.weight"),
            "o_proj": arr(p + "self_attn.o_proj.weight"),
            "gate_proj": arr(p + "mlp.gate_proj.weight"),
            "up_proj": arr(p + "mlp.up_proj.weight"),
            "down_proj": arr(p + "mlp.down_proj.weight"),
        }
        for biased in ("q", "k", "v", "o"):
            bname = p + f"self_attn.{biased}_proj.bias"
            if bname in sd:
                layer[f"{biased}_bias"] = arr(bname)
        for nrm in ("pre_feedforward_layernorm",
                    "post_feedforward_layernorm"):  # gemma2 sandwich norms
            if p + nrm + ".weight" in sd:
                layer[nrm] = arr(p + nrm + ".weight")
        params["layers"].append(layer)
    if "lm_head.weight" in sd and not cfg.tie_word_embeddings:
        params["lm_head"] = arr("lm_head.weight")
    return cfg, params


def convert_torch_opt(model, dtype=jnp.bfloat16):
    """Convert an instantiated transformers OPTForCausalLM (torch CPU) into
    ``(cfg, params)`` for :mod:`any4.models.opt`."""
    from . import opt as opt_mod
    sd = {k: v.detach() for k, v in model.state_dict().items()}
    hf = model.config.to_dict()
    cfg = opt_mod.OPTConfig(
        vocab_size=hf["vocab_size"], hidden_size=hf["hidden_size"],
        ffn_dim=hf["ffn_dim"], num_hidden_layers=hf["num_hidden_layers"],
        num_attention_heads=hf["num_attention_heads"],
        max_position_embeddings=hf["max_position_embeddings"],
        do_layer_norm_before=hf.get("do_layer_norm_before", True))

    def arr(name):
        pfx = "model.decoder."
        key = pfx + name if pfx + name in sd else name
        return jnp.asarray(sd[key].float().numpy()).astype(dtype)

    params = {
        "embed_tokens": arr("embed_tokens.weight"),
        "embed_positions": arr("embed_positions.weight"),
        "final_layer_norm": {"weight": arr("final_layer_norm.weight"),
                             "bias": arr("final_layer_norm.bias")},
        "layers": [],
    }
    for i in range(cfg.num_hidden_layers):
        p = f"layers.{i}."
        params["layers"].append({
            "self_attn_layer_norm": {
                "weight": arr(p + "self_attn_layer_norm.weight"),
                "bias": arr(p + "self_attn_layer_norm.bias")},
            "final_layer_norm": {
                "weight": arr(p + "final_layer_norm.weight"),
                "bias": arr(p + "final_layer_norm.bias")},
            "q_proj": arr(p + "self_attn.q_proj.weight"),
            "k_proj": arr(p + "self_attn.k_proj.weight"),
            "v_proj": arr(p + "self_attn.v_proj.weight"),
            "out_proj": arr(p + "self_attn.out_proj.weight"),
            "q_bias": arr(p + "self_attn.q_proj.bias"),
            "k_bias": arr(p + "self_attn.k_proj.bias"),
            "v_bias": arr(p + "self_attn.v_proj.bias"),
            "out_bias": arr(p + "self_attn.out_proj.bias"),
            "fc1": arr(p + "fc1.weight"),
            "fc1_bias": arr(p + "fc1.bias"),
            "fc2": arr(p + "fc2.weight"),
            "fc2_bias": arr(p + "fc2.bias"),
        })
    return cfg, params


def load_hf_torch_model(name_or_dir: str, dtype=jnp.bfloat16):
    """Fallback: construct via transformers (torch CPU) and convert.

    Useful for random-init test models built from a config
    (``transformers.AutoConfig``) when no safetensors files exist locally.
    """
    import torch  # local import; torch is CPU-only in this image
    from transformers import AutoModelForCausalLM

    model = AutoModelForCausalLM.from_pretrained(name_or_dir,
                                                 torch_dtype=torch.float32)
    if getattr(model.config, "model_type", "") == "mixtral":
        return convert_torch_mixtral(model, dtype)
    return convert_torch_llama(model, dtype)
