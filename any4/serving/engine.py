"""Continuous-batching inference engine over the paged KV cache.

Host-side scheduler (admit / step / retire) around two jitted device
programs: a bucketed single-sequence prefill that writes prompt KV into the
paged pool, and a batched decode step over all active slots. Static shapes
throughout -- slot count, page-table width, context length and the prompt
length BUCKET are fixed per compiled program, so XLA compiles one decode
program and O(log max_prompt) prefill programs (prompts are padded to
power-of-two buckets; a per-length recompile would defeat serving).

Tensor parallelism: pass ``mesh`` + ``param_spec`` (from
``parallel.tp.shard_params``) and both programs run under ``shard_map`` --
column-parallel q/k/v, head-sharded KV pages, row-parallel o/down with
psum, replicated logits. This is the north-star configuration: sharded
decode + paged KV + continuous batching in one engine. TP logits match
the single-device engine to float tolerance (the psum sums k-shard
partials in a different order, so an exact bf16 logits tie can flip a
greedy argmax — same caveat as any TP serving system).

The reference has no serving layer; this is this project's own scope
(BASELINE.json north star).
"""
from __future__ import annotations

import functools
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..models import llama
from . import kv_cache as kvc


@dataclass
class Request:
    uid: int
    prompt: np.ndarray            # [t] int32
    max_new_tokens: int = 32
    eos_token_id: Optional[int] = None
    out_tokens: list = field(default_factory=list)
    done: bool = False


def _model_forward(params):
    """llama.forward, or mixtral.forward when the param tree carries MoE
    expert layers (key presence is static under jit)."""
    if params["layers"] and ("experts" in params["layers"][0]
                             or "moe_w13" in params["layers"][0]):
        from ..models import mixtral
        return mixtral.forward
    return llama.forward


def _ffn(layer, cfg, h, psum_axis=None):
    """Dense MLP or routed MoE FFN for one decode-step layer."""
    if "experts" in layer or "moe_w13" in layer:
        from ..models import mixtral
        return mixtral.moe_ffn(layer, cfg, h, psum_axis=psum_axis)
    return llama.mlp(layer, h, psum_axis=psum_axis,
                     act=getattr(cfg, "hidden_act", "silu"))


def _prefill_impl(params, cfg, prompt, true_len, k_pages, v_pages,
                  table_row, page_size, psum_axis=None,
                  kv_layout="paged"):
    """Run one (bucket-padded) prompt [1, L] and write its first
    ``true_len`` positions of KV into the paged pool. Returns
    (last_real_logits [vocab], k_pages, v_pages)."""
    L = prompt.shape[1]
    positions = jnp.arange(L)[None, :]
    q = jnp.arange(L)[:, None]
    s = jnp.arange(L)[None, :]
    mask = jnp.where((s <= q) & (s < true_len), 0.0,
                     -1e9)[None, None].astype(jnp.float32)
    # temporary dense cache for the prefill, then scatter into pages
    caches = llama.init_kv_caches(cfg, 1, L)
    logits, caches = _model_forward(params)(
        params, cfg, prompt, positions=positions, kv_caches=caches,
        cache_pos=None, mask=mask, psum_axis=psum_axis)
    pos = jnp.arange(L)
    real = pos < true_len
    if kv_layout == "contig":
        # contiguous layout has no sink page (page 0 belongs to slot 0):
        # padded positions write into the slot's OWN region at their
        # position -- beyond true_len they are masked by seq_len and
        # overwritten when decode reaches them
        page_ids = table_row[pos // page_size]                   # [L]
        offsets = pos % page_size
    else:
        # padded positions write to page 0, the reserved scratch sink
        page_ids = jnp.where(real, table_row[pos // page_size], 0)
        offsets = jnp.where(real, pos % page_size, 0)
    new_k, new_v = [], []
    for li in range(cfg.num_hidden_layers):
        kc, vc = caches[li]
        new_k.append(kvc.write_tokens(k_pages[li], kc, page_ids[None],
                                      offsets[None]))
        new_v.append(kvc.write_tokens(v_pages[li], vc, page_ids[None],
                                      offsets[None]))
    # (quantized pools are handled transparently by write_tokens)
    return logits[0, true_len - 1], new_k, new_v


def _decode_impl(params, cfg, tokens, seq_lens, tables, k_pages, v_pages,
                 page_size, psum_axis=None, kv_layout="paged"):
    """One decode step for all slots.

    tokens: [b] int32 current token per slot; seq_lens: [b] current length
    (the new token's position); tables: [b, pps].
    Returns (logits [b, vocab], k_pages, v_pages).
    """
    from ..ops import linear as lin
    b = tokens.shape[0]
    positions = seq_lens[:, None]                   # [b, 1]
    cos, sin = llama.rope_tables(cfg, positions)
    x = lin.embed(params["embed_tokens"], tokens[:, None], cfg.dtype)
    if cfg.embed_scale is not None:  # gemma scales embeddings, in dtype
        x = x * jnp.asarray(cfg.embed_scale, x.dtype)

    # per-slot write target for the new token. The page index is CLAMPED
    # to the bucketed table width: an inactive slot can carry a stale
    # seq_len past the bucket, and an out-of-bounds take_along_axis
    # returns the int32 fill value whose scatter lands on an arbitrary
    # page -- in the contiguous layout that corrupted live data (found
    # by test_contig_burst_continuous_batching; the paged layout only
    # survived because the clamped garbage happened to hit the sink).
    pidx = jnp.minimum(seq_lens // page_size, tables.shape[1] - 1)
    page_ids = jnp.take_along_axis(tables, pidx[:, None], axis=1)  # [b, 1]
    offsets = (seq_lens % page_size)[:, None]

    hd = cfg.head_dim_
    nq, nkv = cfg.num_attention_heads, cfg.num_key_value_heads

    new_k, new_v = list(k_pages), list(v_pages)
    eps, off = cfg.rms_norm_eps, cfg.rms_norm_offset
    # gemma2 attention options, threaded into the (dense-path) attention
    attn_scale = (cfg.query_pre_attn_scalar ** -0.5
                  if cfg.query_pre_attn_scalar is not None else None)
    softcap = cfg.attn_logit_softcapping
    for li, layer in enumerate(params["layers"]):
        h = llama.rms_norm(x, layer["input_layernorm"], eps, off)
        if "qkv_proj" in layer:  # fused projections (models/fuse.py)
            qkv = lin.linear(h, layer["qkv_proj"], layer.get("qkv_bias"))
            q = qkv[..., :nq * hd]
            k = qkv[..., nq * hd:(nq + nkv) * hd]
            v = qkv[..., (nq + nkv) * hd:]
        else:
            q = lin.linear(h, layer["q_proj"], layer.get("q_bias"))
            k = lin.linear(h, layer["k_proj"], layer.get("k_bias"))
            v = lin.linear(h, layer["v_proj"], layer.get("v_bias"))
        q = llama.apply_rope(q.reshape(b, 1, nq, hd), cos, sin)
        k = llama.apply_rope(k.reshape(b, 1, nkv, hd), cos, sin)
        v = v.reshape(b, 1, nkv, hd)

        new_k[li] = kvc.write_tokens(new_k[li], k, page_ids, offsets)
        new_v[li] = kvc.write_tokens(new_v[li], v, page_ids, offsets)

        # attention over each slot's pages (the new token was just
        # written at position seq_len, so the visible length is +1)
        attn = (kvc.contig_attention if kv_layout == "contig"
                else kvc.paged_attention)
        out = attn(q[:, 0], new_k[li], new_v[li], seq_lens + 1, tables,
                   scale=attn_scale, softcap=softcap,
                   window=(cfg.sliding_window if cfg.is_sliding(li)
                           else None))
        out = out.astype(x.dtype).reshape(b, 1, nq * hd)
        out = lin.linear(out, layer["o_proj"], layer.get("o_bias"))
        if psum_axis is not None:
            out = jax.lax.psum(out, psum_axis)
        if cfg.sandwich_norms:  # gemma2: norm attn/ffn outputs, then add
            out = llama.rms_norm(out, layer["post_attention_layernorm"],
                                 eps, off)
            x = x + out
            h = llama.rms_norm(x, layer["pre_feedforward_layernorm"],
                               eps, off)
            m = _ffn(layer, cfg, h, psum_axis=psum_axis)
            x = x + llama.rms_norm(m, layer["post_feedforward_layernorm"],
                                   eps, off)
        else:
            x = x + out
            h = llama.rms_norm(x, layer["post_attention_layernorm"],
                               eps, off)
            x = x + _ffn(layer, cfg, h, psum_axis=psum_axis)

    x = llama.rms_norm(x, params["norm"], eps, off)
    if "lm_head" in params:
        logits = lin.linear(x, params["lm_head"])
    elif isinstance(params["embed_tokens"], lin.QuantizedTensor):
        # tied quantized embeddings: fused quantized kernel off the same
        # packed table the lookup gathers (models/llama.py does the same)
        logits = lin.linear(x, params["embed_tokens"])
    else:
        logits = x @ params["embed_tokens"].T.astype(x.dtype)
    if cfg.final_logit_softcapping is not None:  # gemma2
        cap = cfg.final_logit_softcapping
        logits = (cap * jnp.tanh(logits.astype(jnp.float32) / cap)
                  ).astype(logits.dtype)
    return logits[:, -1, :], new_k, new_v


def _decode_burst_impl(params, cfg, tokens, seq_lens, tables, k_pages,
                       v_pages, page_size, n_steps, psum_axis=None,
                       kv_layout="paged"):
    """``n_steps`` greedy decode steps for all slots fused into one device
    program (lax.scan over :func:`_decode_impl`). Page tables are fixed for
    the whole burst -- the scheduler pre-allocates ``n_steps`` positions per
    slot. Amortizes the per-dispatch host cost over the burst exactly
    like ``models.generate.decode_loop``."""
    def body(carry, _):
        toks, lens, kp, vp = carry
        logits, kp, vp = _decode_impl(params, cfg, toks, lens, tables,
                                      kp, vp, page_size,
                                      psum_axis=psum_axis,
                                      kv_layout=kv_layout)
        nxt = jnp.argmax(logits, axis=-1).astype(jnp.int32)
        return (nxt, lens + 1, kp, vp), nxt

    (last, lens, kp, vp), out = jax.lax.scan(
        body, (tokens, seq_lens, k_pages, v_pages), None, length=n_steps)
    # the final carry (next token + advanced lengths) is returned so the
    # scheduler can chain bursts with DEVICE-resident state: in steady
    # decode (no admissions/retirements between bursts) the next burst
    # consumes these arrays directly and the host uploads nothing
    return out.T, last, lens, kp, vp          # [b, n_steps], [b], [b]


# The KV pools are DONATED through every device program: the engine
# always replaces its pool references with the returned ones, so the old
# buffers are dead -- and donation is what keeps the pools in their
# DEFAULT layout across the whole lifecycle. Without it XLA may choose a
# scatter-friendly layout for the prefill program's pool outputs, which
# then costs the decode burst full-pool layout copies per layer per step.
# Donated aliased outputs must match their input layout, pinning default
# end to end, and the in-loop dus writes update in place.
_decode_burst = functools.partial(
    jax.jit, static_argnames=("cfg", "page_size", "n_steps", "kv_layout"),
    donate_argnums=(5, 6))(
    lambda params, cfg, tokens, seq_lens, tables, k_pages, v_pages,
    page_size, n_steps, kv_layout="paged": _decode_burst_impl(
        params, cfg, tokens, seq_lens, tables, k_pages, v_pages,
        page_size, n_steps, kv_layout=kv_layout))


_prefill_one = functools.partial(jax.jit,
                                 static_argnames=("cfg", "page_size",
                                                  "kv_layout"),
                                 donate_argnums=(4, 5))(
    lambda params, cfg, prompt, true_len, k_pages, v_pages, table_row,
    page_size, kv_layout="paged": _prefill_impl(
        params, cfg, prompt, true_len, k_pages,
        v_pages, table_row, page_size, kv_layout=kv_layout))

_decode_batch = functools.partial(jax.jit,
                                  static_argnames=("cfg", "page_size",
                                                   "kv_layout"),
                                  donate_argnums=(5, 6))(
    lambda params, cfg, tokens, seq_lens, tables, k_pages, v_pages,
    page_size, kv_layout="paged": _decode_impl(
        params, cfg, tokens, seq_lens, tables,
        k_pages, v_pages, page_size, kv_layout=kv_layout))


class Engine:
    """Continuous-batching engine: admit requests into slots, run batched
    decode, retire finished sequences and recycle their pages."""

    MIN_PREFILL_BUCKET = 16

    def __init__(self, params, cfg, max_slots: int = 8,
                 max_ctx: int = 512, page_size: int = 16,
                 num_pages: Optional[int] = None,
                 sample_fn: Optional[Callable] = None,
                 kv_quantize: bool = False,
                 kv_layout: str = "paged",
                 mesh=None, param_spec=None):
        """``kv_layout``: "contig" gives every slot a FIXED
        contiguous region of the KV pool, so decode attention reads it as
        a reshape + slice with no gather -- the engine preallocates
        max_slots * max_ctx pages either way, so this trades nothing
        until page sharing/oversubscription exists; "paged" keeps the
        vLLM-style free-list allocator + page-table attention."""
        assert kv_layout in ("contig", "paged"), kv_layout
        self.params = params
        self.cfg = cfg
        self.page_size = page_size
        self.kv_layout = kv_layout
        self.pps = -(-max_ctx // page_size)
        self.max_ctx = self.pps * page_size
        self.max_slots = max_slots
        num_pages = num_pages or (max_slots * self.pps +
                                  (0 if kv_layout == "contig" else 1))
        self.cache = kvc.PagedKVCache.create(cfg, num_pages, page_size,
                                             quantize=kv_quantize)
        self.alloc = kvc.PageAllocator(num_pages, max_slots, self.pps,
                                       contiguous=kv_layout == "contig")
        self.slots: List[Optional[Request]] = [None] * max_slots
        self.tokens = np.zeros(max_slots, np.int32)
        self.seq_lens = np.zeros(max_slots, np.int32)
        self.pending: List[Request] = []
        self.finished: List[Request] = []
        self._uid = 0
        self._greedy = sample_fn is None
        self.sample_fn = sample_fn or (lambda lg: jnp.argmax(lg, axis=-1))
        # device-resident decode state: a burst returns its final (token,
        # seq_len) carry, so steady-state decode (no admissions or
        # retirements between bursts) chains bursts with ZERO host->device
        # uploads -- the host mirrors (self.tokens/self.seq_lens) stay the
        # bookkeeping truth and re-seed the device only when dirty.
        self._d_tokens = None
        self._d_seq_lens = None
        self._host_dirty = True
        self._tbl_cache = (None, None, None)   # (bucket, version, array)

        self.mesh = mesh
        if mesh is not None:
            assert param_spec is not None, \
                "TP engine needs the param_spec from tp.shard_params"
            self._make_tp_fns(param_spec, kv_quantize)
        else:
            self._prefill_fn = _prefill_one
            self._decode_fn = _decode_batch
            self._decode_burst_fn = _decode_burst

    # ------------------------------------------------------------------ TP
    def _make_tp_fns(self, param_spec, kv_quantize: bool):
        from jax.sharding import NamedSharding, PartitionSpec as P

        from ..parallel import tp as tpmod

        mesh = self.mesh
        tp_size = mesh.shape["tp"]
        cfg_local = tpmod.local_config(self.cfg, tp_size)
        n_layers = self.cfg.num_hidden_layers
        arr_spec = P("tp", None, None, None)
        # quantized pools are (int8 pages, scales [h, P, ps]) pairs; both
        # shard over the kv-head axis
        page_spec = ((arr_spec, P("tp", None, None)) if kv_quantize
                     else arr_spec)
        pages_spec = [page_spec for _ in range(n_layers)]
        ps = self.page_size

        kvl = self.kv_layout

        def prefill_local(params, prompt, true_len, k_pages, v_pages,
                          table_row):
            return _prefill_impl(params, cfg_local, prompt, true_len,
                                 k_pages, v_pages, table_row, ps,
                                 psum_axis="tp", kv_layout=kvl)

        def decode_local(params, tokens, seq_lens, tables, k_pages,
                         v_pages):
            return _decode_impl(params, cfg_local, tokens, seq_lens,
                                tables, k_pages, v_pages, ps,
                                psum_axis="tp", kv_layout=kvl)

        pre = jax.shard_map(
            prefill_local, mesh=mesh,
            in_specs=(param_spec, P(None, None), P(), pages_spec,
                      pages_spec, P(None)),
            out_specs=(P(None), pages_spec, pages_spec),
            check_vma=False)
        dec = jax.shard_map(
            decode_local, mesh=mesh,
            in_specs=(param_spec, P(None), P(None), P(None, None),
                      pages_spec, pages_spec),
            out_specs=(P(None, None), pages_spec, pages_spec),
            check_vma=False)
        pre, dec = jax.jit(pre), jax.jit(dec)
        # kv_layout was baked into the local closures above; the wrappers
        # accept and drop the kwarg so call sites stay uniform
        self._prefill_fn = \
            lambda params, cfg, prompt, tl, kp, vp, row, _ps, **_kw: \
            pre(params, prompt, tl, kp, vp, row)
        self._decode_fn = \
            lambda params, cfg, tokens, sl, tbl, kp, vp, _ps, **_kw: \
            dec(params, tokens, sl, tbl, kp, vp)

        burst_cache = {}

        def burst_fn(params, cfg, tokens, sl, tbl, kp, vp, _ps, n_steps,
                     **_kw):
            if n_steps not in burst_cache:
                f = jax.shard_map(
                    functools.partial(
                        lambda params, tokens, sl, tbl, kp, vp, n: (
                            _decode_burst_impl(params, cfg_local, tokens,
                                               sl, tbl, kp, vp, ps, n,
                                               psum_axis="tp",
                                               kv_layout=kvl)),
                        n=n_steps),
                    mesh=mesh,
                    in_specs=(param_spec, P(None), P(None), P(None, None),
                              pages_spec, pages_spec),
                    out_specs=(P(None, None), P(None), P(None),
                               pages_spec, pages_spec),
                    check_vma=False)
                burst_cache[n_steps] = jax.jit(f)
            return burst_cache[n_steps](params, tokens, sl, tbl, kp, vp)

        self._decode_burst_fn = burst_fn
        # shard the page pools over heads once up front
        def put(p):
            if isinstance(p, tuple):
                return tuple(jax.device_put(x, NamedSharding(mesh, s))
                             for x, s in zip(p, page_spec))
            return jax.device_put(p, NamedSharding(mesh, arr_spec))
        self.cache.k_pages = [put(p) for p in self.cache.k_pages]
        self.cache.v_pages = [put(p) for p in self.cache.v_pages]

    # ----------------------------------------------------------- requests
    def submit(self, prompt, max_new_tokens: int = 32,
               eos_token_id: Optional[int] = None) -> int:
        self._uid += 1
        self.pending.append(Request(self._uid, np.asarray(prompt, np.int32),
                                    max_new_tokens, eos_token_id))
        return self._uid

    def _bucket(self, n: int) -> int:
        L = self.MIN_PREFILL_BUCKET
        while L < n:
            L *= 2
        return min(L, self.max_ctx)

    def _ctx_table(self, extra: int):
        """Page table sliced to a power-of-two page bucket covering every
        active slot's length + ``extra`` new positions. The dense-gather
        attention path reads the full table width each step, so slicing
        the table to the live context (e.g. 128 of 512 positions early in
        decode) cuts its HBM traffic proportionally; power-of-two buckets
        keep the compile count O(log pages_per_seq)."""
        need = 1
        for i, r in enumerate(self.slots):
            if r is not None:
                need = max(need, int(self.seq_lens[i]) + extra)
        pages = -(-need // self.page_size)
        bucket = 1
        while bucket < pages:
            bucket *= 2
        bucket = min(bucket, self.pps)
        cb, cv, arr = self._tbl_cache
        if cb == bucket and cv == self.alloc.version:
            return arr                      # device copy still valid
        arr = jnp.asarray(self.alloc.table[:, :bucket])
        self._tbl_cache = (bucket, self.alloc.version, arr)
        return arr

    def _admit(self):
        newly = []
        for i in range(self.max_slots):
            if self.slots[i] is not None or not self.pending:
                continue
            req = self.pending.pop(0)
            if len(req.prompt) >= self.max_ctx:
                # keep the most recent context (positions restart at 0 for
                # the truncated prompt); without this an oversized prompt
                # can never be admitted and blocks the queue head forever
                req.prompt = req.prompt[-(self.max_ctx - 1):]
            t = len(req.prompt)
            if not self.alloc.ensure(i, t + 1, self.page_size):
                self.pending.insert(0, req)
                break
            L = self._bucket(t)
            padded = np.zeros(L, np.int32)
            padded[:t] = req.prompt
            table_row = jnp.asarray(self.alloc.table[i])
            last_logits, new_k, new_v = self._prefill_fn(
                self.params, self.cfg, jnp.asarray(padded[None]),
                jnp.int32(min(t, L)), self.cache.k_pages,
                self.cache.v_pages, table_row, self.page_size,
                kv_layout=self.kv_layout)
            self.cache.k_pages, self.cache.v_pages = new_k, new_v
            newly.append((i, req, self.sample_fn(last_logits[None])))
            self.slots[i] = req
            self.seq_lens[i] = t
        if newly:
            # one host fetch for the whole admission wave
            vals = np.asarray(jax.device_get(
                jnp.concatenate([jnp.asarray(tok).reshape(-1)
                                 for _, _, tok in newly])))
            for (i, req, _), v in zip(newly, vals):
                req.out_tokens.append(int(v))
                self.tokens[i] = int(v)
            self._host_dirty = True   # device token/len state is stale

    def _retire(self, i: int):
        req = self.slots[i]
        req.done = True
        self.finished.append(req)
        self.slots[i] = None
        self.alloc.release(i)
        # reset the slot's decode state: a stale seq_len past the context
        # bucket makes the (masked, ignored) inactive-slot decode write
        # out of table bounds (see _decode_impl's clamp)
        self.seq_lens[i] = 0
        self.tokens[i] = 0
        self._host_dirty = True   # host seq_lens/tokens diverge from device

    def step(self, burst: int = 1) -> int:
        """Admit + one batched decode burst. Returns number of active slots.

        ``burst > 1`` fuses that many greedy decode steps into one device
        dispatch (power-of-two clamped to bound compile count); admission
        and retirement happen between bursts, so a larger burst trades
        scheduling granularity for dispatch amortization. Requires the
        default greedy sampler -- a custom ``sample_fn`` (host callable)
        forces per-step dispatch.
        """
        if burst > 1 and self._greedy:
            return self._step_burst(burst)
        self._admit()
        active = [i for i, r in enumerate(self.slots) if r is not None]
        if not active:
            return 0
        # grow page tables for slots about to write position seq_len
        for i in active:
            if not self.alloc.ensure(i, int(self.seq_lens[i]) + 2,
                                     self.page_size):
                self._retire(i)  # out of pages: finish the sequence
        active = [i for i, r in enumerate(self.slots) if r is not None]
        if not active:
            return 0
        logits, new_k, new_v = self._decode_fn(
            self.params, self.cfg, jnp.asarray(self.tokens),
            jnp.asarray(self.seq_lens), self._ctx_table(2),
            self.cache.k_pages, self.cache.v_pages, self.page_size,
            kv_layout=self.kv_layout)
        self.cache.k_pages, self.cache.v_pages = new_k, new_v
        self._host_dirty = True   # single-step path keeps host-side state
        next_tokens = np.asarray(self.sample_fn(logits))
        for i in active:
            req = self.slots[i]
            self.seq_lens[i] += 1
            tok = int(next_tokens[i])
            req.out_tokens.append(tok)
            self.tokens[i] = tok
            if (len(req.out_tokens) >= req.max_new_tokens or
                    (req.eos_token_id is not None
                     and tok == req.eos_token_id)):
                self._retire(i)
        return len([s for s in self.slots if s is not None])

    def _dispatch_burst(self, burst: int, lookahead: int = 0):
        """Admit + dispatch one burst WITHOUT fetching its tokens.
        Returns (toks_device, n, [(slot, request)]), or None if nothing is
        active. ``lookahead`` reserves page capacity for that many extra
        positions beyond the burst (speculative pipelining)."""
        self._admit()
        active = [i for i, r in enumerate(self.slots) if r is not None]
        if not active:
            return None
        # shrink the burst until every active slot has page capacity for
        # all of it; a slot that cannot even fit one more position retires
        # (out of pages), matching the single-step path
        n = burst
        for i in list(active):
            while n > 1 and not self.alloc.ensure(
                    i, int(self.seq_lens[i]) + n + lookahead + 1,
                    self.page_size):
                n //= 2
            if not self.alloc.ensure(i, int(self.seq_lens[i]) + 2,
                                     self.page_size):
                self._retire(i)  # out of pages: finish the sequence
        live = [(i, self.slots[i]) for i in range(self.max_slots)
                if self.slots[i] is not None]
        if not live:
            return None
        n = 1 << (n.bit_length() - 1)        # power-of-two compile buckets
        if self._host_dirty or self._d_tokens is None:
            d_tokens = jnp.asarray(self.tokens)
            d_lens = jnp.asarray(self.seq_lens)
        else:
            # steady-state: chain off the previous burst's device carry
            # (no host->device upload this burst)
            d_tokens, d_lens = self._d_tokens, self._d_seq_lens
        toks, last, lens, new_k, new_v = self._decode_burst_fn(
            self.params, self.cfg, d_tokens, d_lens,
            self._ctx_table(n + lookahead + 1),
            self.cache.k_pages, self.cache.v_pages, self.page_size, n,
            kv_layout=self.kv_layout)
        self.cache.k_pages, self.cache.v_pages = new_k, new_v
        self._d_tokens, self._d_seq_lens = last, lens
        self._host_dirty = False
        return toks, n, live

    def _absorb_burst(self, toks, n, live) -> int:
        """Fetch a dispatched burst's tokens and do the host bookkeeping.
        Slots retired since dispatch (pipelined mode) are skipped -- their
        speculative tokens are discarded."""
        toks = np.asarray(toks)
        for i, req in live:
            if self.slots[i] is not req:
                continue      # retired while this burst was in flight
            for j in range(n):
                tok = int(toks[i, j])
                req.out_tokens.append(tok)
                self.seq_lens[i] += 1
                self.tokens[i] = tok
                if (len(req.out_tokens) >= req.max_new_tokens or
                        (req.eos_token_id is not None
                         and tok == req.eos_token_id)):
                    self._retire(i)
                    break
        return len([s for s in self.slots if s is not None])

    def _step_burst(self, burst: int) -> int:
        out = self._dispatch_burst(burst)
        if out is None:
            return 0
        return self._absorb_burst(*out)

    def _may_speculate(self, n: int, inflight_tokens: int = 0) -> bool:
        """Safe to dispatch the next burst before absorbing the in-flight
        ones? Requires: greedy sampling (already checked), no pending
        admissions (an admission would reuse pages/slots the in-flight
        bursts still reference), and page capacity on every active slot
        for the ``inflight_tokens`` already speculated plus a full extra
        burst (the host ``seq_lens`` are stale by ``inflight_tokens``)."""
        if self.pending:
            return False
        if self._host_dirty or self._d_tokens is None:
            return False  # device carry is stale; next dispatch would
            # re-upload host state that predates the in-flight burst
        for i, r in enumerate(self.slots):
            if r is not None and not self.alloc.ensure(
                    i, int(self.seq_lens[i]) + inflight_tokens + n + 1,
                    self.page_size):
                return False
        return True

    def run(self, max_steps: int = 10000, burst: int = 1,
            pipeline: bool = False, pipeline_depth: int = 2
            ) -> List[Request]:
        """Drive until all submitted requests finish.

        ``pipeline=True`` (burst > 1, greedy only) dispatches burst k+1
        off the device-resident carry BEFORE fetching burst k's tokens,
        hiding the host fetch behind device compute. ``pipeline_depth``
        keeps up to that many unabsorbed bursts in flight, for fetches
        longer than one burst's device time. Slots that finish mid-flight still decode the
        speculative bursts (their tokens are discarded at absorb);
        admissions and page capacity force sync boundaries. Token streams
        are exactly the sequential engine's at any depth.
        """
        steps = 0
        if pipeline and burst > 1 and self._greedy:
            inflight: List = []   # oldest first
            while (inflight or self.pending
                    or any(s is not None for s in self.slots)) \
                    and steps < max_steps:
                # fill the pipeline up to depth unabsorbed bursts
                while len(inflight) < max(pipeline_depth, 1) \
                        and steps < max_steps:
                    if not inflight:
                        out = self._dispatch_burst(burst)
                        steps += 1
                        if out is None:
                            break
                        inflight.append(out)
                        continue
                    ahead = sum(n for _, n, _ in inflight)
                    if not self._may_speculate(inflight[-1][1], ahead):
                        break
                    out = self._dispatch_burst(inflight[-1][1],
                                               lookahead=ahead)
                    steps += 1
                    if out is None:
                        break
                    inflight.append(out)
                if inflight:
                    self._absorb_burst(*inflight.pop(0))
            out = self.finished
            self.finished = []
            return out
        while (self.pending or any(s is not None for s in self.slots)) \
                and steps < max_steps:
            self.step(burst)
            steps += 1
        out = self.finished
        self.finished = []
        return out
