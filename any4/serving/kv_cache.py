"""Paged KV cache: fixed-size pages + per-sequence page tables.

The reference has no serving layer (SURVEY.md: "not a serving engine");
this is this project's own scope (BASELINE.json north star). Design is
vLLM-style adapted to XLA's static shapes:

- one page pool per layer: ``k_pages/v_pages [n_kv, num_pages, page_size,
  head_dim]`` (head-major);
- a page table ``[max_seqs, max_pages_per_seq] int32`` maps each sequence
  slot's logical page index to a physical page;
- page allocation/free runs host-side (a numpy free list) between jitted
  steps; the device-side write/read paths are pure gathers/scatters with
  static shapes, so decode compiles once;
- decode attention over bf16 pages runs the JAX library's Triton
  paged-attention kernel on the GPU; otherwise it gathers a dense context
  view (a free reshape + slice for the contiguous layout) and attends with
  plain XLA einsums.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List

import jax
import jax.numpy as jnp
import numpy as np

# int8 pools store code = rint(x * MAX_INT8/amax) with scales = amax, so
# dequant multiplies by amax/MAX_INT8
MAX_INT8 = 127.5
_INV_MAX_INT8 = 1.0 / MAX_INT8


def to_int8(x: jax.Array, amax: jax.Array) -> jax.Array:
    """Per-token int8 code of ``x`` under its absmax ``amax``."""
    return jnp.rint(x * (MAX_INT8 / amax)).astype(jnp.int8)


def from_int8(codes: jax.Array, amax: jax.Array,
              dtype=jnp.bfloat16) -> jax.Array:
    """Inverse of :func:`to_int8`."""
    return codes.astype(dtype) * amax / MAX_INT8


@dataclass
class PagedKVCache:
    k_pages: List   # per layer [n_kv, P, ps, hd], or (int8 pages, scales)
    v_pages: List
    page_size: int
    quantized: bool = False

    @classmethod
    def create(cls, cfg, num_pages: int, page_size: int = 16, dtype=None,
               quantize: bool = False):
        """``quantize=True`` stores pages in int8 with per-token scales
        (half the bf16 KV memory)."""
        dtype = dtype or cfg.dtype
        hd = cfg.head_dim_
        shape = (cfg.num_key_value_heads, num_pages, page_size, hd)
        if quantize:
            # scales are 3-D [h, P, ps]: one per token and head, with no
            # trailing size-1 axis
            def mk():
                return (jnp.zeros(shape, jnp.int8),
                        jnp.ones(shape[:-1], jnp.float32))
            return cls([mk() for _ in range(cfg.num_hidden_layers)],
                       [mk() for _ in range(cfg.num_hidden_layers)],
                       page_size, True)
        return cls(
            [jnp.zeros(shape, dtype) for _ in range(cfg.num_hidden_layers)],
            [jnp.zeros(shape, dtype) for _ in range(cfg.num_hidden_layers)],
            page_size)


class PageAllocator:
    """Host-side physical-page free list + per-slot page tables."""

    def __init__(self, num_pages: int, max_seqs: int, pages_per_seq: int,
                 contiguous: bool = False):
        # incremented on every table mutation so callers can cache the
        # device-side upload of `table` (the engine re-uploads only when
        # this changes)
        self.version = 0
        self.pages_per_seq = pages_per_seq
        self.contiguous = contiguous
        if contiguous:
            # each slot owns the fixed page range [i*pps, (i+1)*pps): the
            # engine's contiguous layout. The table is PREASSIGNED and
            # never mutates; no sink page is needed (a retired slot's
            # stale positions are masked by seq_len and overwritten on
            # reuse). Trades page sharing for gather-free attention.
            assert num_pages >= max_seqs * pages_per_seq, \
                (num_pages, max_seqs, pages_per_seq)
            self.free = []
            self.table = np.arange(
                max_seqs * pages_per_seq, dtype=np.int32).reshape(
                max_seqs, pages_per_seq)
            self.seq_pages: List[List[int]] = [
                list(self.table[i]) for i in range(max_seqs)]
            return
        # page 0 is reserved as a scratch sink: inactive slots' page tables
        # are all-zero, so their (masked, never-read) decode writes land
        # there instead of corrupting live pages
        self.free = list(range(num_pages - 1, 0, -1))
        self.table = np.zeros((max_seqs, pages_per_seq), np.int32)
        self.seq_pages = [[] for _ in range(max_seqs)]

    def ensure(self, slot: int, seq_len: int, page_size: int) -> bool:
        """Allocate pages so `seq_len` positions fit. False if OOM."""
        need = -(-seq_len // page_size) if seq_len else 0
        if self.contiguous:
            return need <= self.pages_per_seq
        pages = self.seq_pages[slot]
        while len(pages) < need:
            if not self.free or len(pages) >= self.pages_per_seq:
                return False
            p = self.free.pop()
            self.table[slot, len(pages)] = p
            pages.append(p)
            self.version += 1
        return True

    def release(self, slot: int):
        if self.contiguous:
            return      # preassigned ranges never move
        if self.seq_pages[slot]:
            self.version += 1
        self.free.extend(reversed(self.seq_pages[slot]))
        self.seq_pages[slot] = []
        self.table[slot] = 0


def write_tokens(pages, kv: jax.Array, page_ids: jax.Array,
                 offsets: jax.Array):
    """Scatter per-slot new tokens into the page pool.

    pages: [h, P, ps, d] (or an (int8 pages, scales [h, P, ps]) pair for
    a quantized pool); kv: [b, t, h, d] new values; page_ids/offsets:
    [b, t] physical page and in-page offset per token (garbage entries
    should point at page 0, the reserved scratch sink, so inactive slots
    never corrupt live pages).
    """
    if isinstance(pages, tuple):  # int8-quantized pool
        qpages, scales = pages
        b, t, h, d = kv.shape
        amax = jnp.max(jnp.abs(kv.astype(jnp.float32)), axis=-1,
                       keepdims=True)                       # [b, t, h, 1]
        amax = jnp.maximum(amax, 1e-6)
        q = to_int8(kv.astype(jnp.float32), amax)
        qpages = write_tokens(qpages, q, page_ids, offsets)
        scales = _write_scales(scales, amax[..., 0].astype(jnp.float32),
                               page_ids, offsets)
        return (qpages, scales)
    b, t, h, d = kv.shape
    if t == 1 and b <= 16:
        # decode hot path: per-slot dynamic_update_slice on the FLAT pool
        # instead of one scatter -- dus is the canonical in-place KV
        # update XLA aliases through while loops, where a scatter can
        # make XLA carry the pools in non-default layouts (full-pool
        # layout copies per layer per step).
        flat = pages.reshape(h, -1, d)              # [h, P*ps, d]
        pos = page_ids * pages.shape[2] + offsets   # [b, 1]
        for i in range(b):
            tok = kv[i, 0].astype(flat.dtype)[:, None, :]   # [h, 1, d]
            flat = jax.lax.dynamic_update_slice(
                flat, tok, (0, pos[i, 0], 0))
        return flat.reshape(pages.shape)
    flat = pages.reshape(h, -1, d)                  # [h, P*ps, d]
    idx = (page_ids * pages.shape[2] + offsets).reshape(-1)
    vals = kv.transpose(2, 0, 1, 3).reshape(h, b * t, d)
    flat = flat.at[:, idx].set(vals.astype(flat.dtype))
    return flat.reshape(pages.shape)


def _write_scales(scales, amax: jax.Array, page_ids: jax.Array,
                  offsets: jax.Array):
    """Scatter per-token dequant scales into the 3-D ``[h, P, ps]`` scale
    pool (mirrors :func:`write_tokens`'s decode dus / prefill scatter
    split). amax: ``[b, t, h]``."""
    b, t, h = amax.shape
    flat = scales.reshape(h, -1)                    # [h, P*ps]
    pos = page_ids * scales.shape[2] + offsets      # [b, t]
    if t == 1 and b <= 16:
        for i in range(b):
            flat = jax.lax.dynamic_update_slice(
                flat, amax[i, 0][:, None], (0, pos[i, 0]))
        return flat.reshape(scales.shape)
    flat = flat.at[:, pos.reshape(-1)].set(
        amax.transpose(2, 0, 1).reshape(h, b * t))
    return flat.reshape(scales.shape)


def gather_ctx_hmajor(pages, table: jax.Array) -> jax.Array:
    """Gather a dense [h, b, max_ctx, d] context view from the page pool
    in the gather's NATIVE dimension order -- no transpose, so XLA keeps
    the pool's default layout (a [b, ctx, h, d] result can force full-pool
    layout copies every decode step). Dequantizes int8 pools.
    table: [b, pages_per_seq]."""
    if isinstance(pages, tuple):
        qpages, scales = pages
        g = gather_ctx_hmajor(qpages, table).astype(jnp.float32)
        sc = gather_scales_hmajor(scales, table)
        # bf16 view: the KV numbers are already int8-quantized, so bf16
        # rounding is noise -- and the materialized dense view is the
        # dominant HBM traffic of the dense path (f32 doubled it)
        return from_int8(g, sc[..., None], dtype=jnp.bfloat16)
    h, P, ps, d = pages.shape
    b, pps = table.shape
    g = pages[:, table.reshape(-1)]                 # [h, b*pps, ps, d]
    return g.reshape(h, b, pps * ps, d)


def gather_scales_hmajor(scales, table: jax.Array) -> jax.Array:
    """[h, b, max_ctx] view of the 3-D [h, P, ps] scale pool (the scale
    analog of :func:`gather_ctx_hmajor`)."""
    h, P, ps = scales.shape
    b, pps = table.shape
    g = scales[:, table.reshape(-1)]                # [h, b*pps, ps]
    return g.reshape(h, b, pps * ps)


def gather_ctx(pages, table: jax.Array) -> jax.Array:
    """Dense [b, max_ctx, h, d] context view (test/debug convenience;
    the hot path uses :func:`gather_ctx_hmajor` to avoid the layout
    transpose)."""
    return gather_ctx_hmajor(pages, table).transpose(1, 2, 0, 3)


def _contig_ctx_view(pages, b: int, ctx_bucket: int):
    """Dense ``[h, b, ctx_bucket, d]`` context view of a CONTIGUOUS-slot
    pool: slot ``i`` owns pages ``[i*pps, (i+1)*pps)``, so the "gather" is
    a layout-preserving reshape + static slice -- zero data movement
    (the paged layout's :func:`gather_ctx_hmajor` pays a real gather).
    Dequantizes int8 pools."""
    if isinstance(pages, tuple):
        g = _contig_ctx_view(pages[0], b, ctx_bucket).astype(jnp.float32)
        sc = _contig_ctx_view(pages[1], b, ctx_bucket)
        # bf16 for the same reason as gather_ctx_hmajor: int8 KV numbers
        # lose nothing to bf16, the view's footprint halves
        return from_int8(g, sc[..., None], dtype=jnp.bfloat16)
    if pages.ndim == 3:                              # [h, P, ps] scale pool
        h = pages.shape[0]
        return pages.reshape(h, b, -1)[:, :, :ctx_bucket]
    h, P, ps, d = pages.shape
    return pages.reshape(h, b, P * ps // b, d)[:, :, :ctx_bucket]


def contig_attention(q: jax.Array, k_pages, v_pages,
                     seq_lens: jax.Array, table: jax.Array, scale=None,
                     softcap=None, window=None) -> jax.Array:
    """Decode attention over the CONTIGUOUS slot layout
    (PageAllocator(contiguous=True)). ``table`` only conveys the context
    BUCKET width (columns): the context view is a reshape + static slice
    of the pool feeding XLA einsums. int8 pools slice codes and scales
    separately and fold the per-token scales into the logits/probs (see
    :func:`_dense_attend_q8`)."""
    quantized = isinstance(k_pages, tuple)
    kp = k_pages[0] if quantized else k_pages
    b = q.shape[0]
    ps = kp.shape[2]
    ctx_bucket = table.shape[1] * ps
    if quantized:
        return _dense_attend_q8(
            q,
            _contig_ctx_view(k_pages[0], b, ctx_bucket),
            _contig_ctx_view(k_pages[1], b, ctx_bucket),
            _contig_ctx_view(v_pages[0], b, ctx_bucket),
            _contig_ctx_view(v_pages[1], b, ctx_bucket),
            seq_lens, scale=scale, softcap=softcap, window=window)
    kctx = _contig_ctx_view(k_pages, b, ctx_bucket)
    vctx = _contig_ctx_view(v_pages, b, ctx_bucket)
    return _dense_attend(q, kctx, vctx, seq_lens, scale=scale,
                         softcap=softcap, window=window)


def library_kernel_applies(k_pages, window=None,
                           interpret: bool = False) -> bool:
    """Does :func:`paged_attention` run the JAX library's Triton kernel?
    On the GPU (or interpreted on request) for unquantized pools without
    a sliding window."""
    return (not isinstance(k_pages, tuple) and window is None
            and (interpret or jax.default_backend() == "gpu"))


def paged_attention(q: jax.Array, k_pages, v_pages, seq_lens: jax.Array,
                    table: jax.Array, scale=None, softcap=None,
                    window=None, interpret: bool = False) -> jax.Array:
    """Paged attention for decode: q [b, nq, d] -> out [b, nq, d].

    Unquantized pools on the GPU run the JAX library's Triton
    paged-attention kernel (``jax.experimental.pallas.ops.gpu.
    paged_attention`` -- a library kernel, not one this repository
    wrote), which reads the pages in place; it measured faster than the
    dense gather at 8B decode shapes (PERF.md). Everything else gathers
    a dense context view through the page table and attends with plain
    XLA ops (see :func:`_dense_paged_attention`); ``interpret=True`` runs
    the library kernel in Pallas interpret mode."""
    if library_kernel_applies(k_pages, window, interpret):
        from jax.experimental.pallas.ops.gpu import paged_attention as lib
        d = q.shape[-1]
        scale = 1.0 / np.sqrt(d) if scale is None else scale
        out = lib.paged_attention(
            (q * scale).astype(k_pages.dtype), k_pages, v_pages,
            table.astype(jnp.int32), seq_lens.astype(jnp.int32),
            k_splits=math.gcd(table.shape[1], 16),
            attn_logits_soft_cap=softcap, interpret=interpret)
        return out.astype(q.dtype)
    return _dense_paged_attention(q, k_pages, v_pages, seq_lens, table,
                                  scale=scale, softcap=softcap,
                                  window=window)


def _dense_paged_attention(q, k_pages, v_pages, seq_lens, table,
                           scale=None, softcap=None, window=None):
    """Gather a dense context view and attend with plain XLA ops.

    int8 pools gather CODES and SCALES separately and fold the scales
    into the logits/probs (see :func:`_dense_attend_q8`): the gathered
    views stay int8 -- half the bf16 traffic -- instead of dequantizing
    to a float view."""
    if isinstance(k_pages, tuple):
        return _dense_attend_q8(
            q,
            gather_ctx_hmajor(k_pages[0], table),
            gather_scales_hmajor(k_pages[1], table),
            gather_ctx_hmajor(v_pages[0], table),
            gather_scales_hmajor(v_pages[1], table),
            seq_lens, scale=scale, softcap=softcap, window=window)
    kctx = gather_ctx_hmajor(k_pages, table)        # [h, b, ctx, d]
    vctx = gather_ctx_hmajor(v_pages, table)
    return _dense_attend(q, kctx, vctx, seq_lens, scale=scale,
                         softcap=softcap, window=window)


def _attn_mask(ctx_len: int, seq_lens, window=None):
    """Additive decode mask [1, b, 1, ctx]: positions < seq_len visible;
    with ``window`` (gemma2 sliding layers) only the last ``window``
    positions (query position = seq_len - 1, HF ``q - k < window``)."""
    ctx_pos = jnp.arange(ctx_len)[None, None, None, :]
    vis = ctx_pos < seq_lens[None, :, None, None]
    if window is not None:
        vis &= ctx_pos > (seq_lens[None, :, None, None] - 1 - window)
    return jnp.where(vis, 0.0, -1e9)


def _dense_attend_q8(q, kc, ks, vc, vs, seq_lens, scale=None, softcap=None,
                     window=None):
    """:func:`_dense_attend` over int8 code views + per-token scales.

    The dequant ``code * amax / 127.5`` is linear in the code with a
    per-TOKEN constant, so it commutes with the attention dots: the k
    scales multiply the [.., rep, ctx] logits after the QK einsum and
    the v scales fold into the [.., rep, ctx] probs before the PV
    einsum. The big int8 operands feed the dots directly (|code| <= 127
    is bf16-exact, and the int8->bf16 convert can fuse into the dot read)
    -- no dequantized view materializes."""
    b, nq, d = q.shape
    h = kc.shape[0]
    rep = nq // h
    qh = q.reshape(b, h, rep, d).transpose(1, 0, 2, 3)   # [h, b, rep, d]
    if scale is None:
        scale = 1.0 / np.sqrt(d)
    logits = jnp.einsum("hbrd,hbcd->hbrc",
                        (qh * scale).astype(jnp.bfloat16),
                        kc.astype(jnp.bfloat16),
                        preferred_element_type=jnp.float32)
    logits = logits * (ks * _INV_MAX_INT8)[:, :, None, :]
    if softcap is not None:  # gemma2 attn_logit_softcapping, pre-mask
        logits = softcap * jnp.tanh(logits / softcap)
    mask = _attn_mask(kc.shape[2], seq_lens, window)
    probs = jax.nn.softmax(logits + mask, axis=-1)
    pv = probs * (vs * _INV_MAX_INT8)[:, :, None, :]
    out = jnp.einsum("hbrc,hbcd->hbrd", pv.astype(jnp.bfloat16),
                     vc.astype(jnp.bfloat16),
                     preferred_element_type=jnp.float32)
    return out.transpose(1, 0, 2, 3).reshape(b, nq, d).astype(q.dtype)


def _dense_attend(q, kctx, vctx, seq_lens, scale=None, softcap=None,
                  window=None):
    """Decode attention over a dense ``[h, b, ctx, d]`` context view.

    Grouped-head GQA dots (q heads grouped per kv head) -- no
    jnp.repeat, which would materialize rep x the context. The big
    operands stay in the view-native [h, b, c, d] order with (h, b) as
    leading dot batch dims, so no layout copy of the views or the pools
    is needed. bf16 inputs, f32 accumulation."""
    b, nq, d = q.shape
    h = kctx.shape[0]
    rep = nq // h
    qh = q.reshape(b, h, rep, d).transpose(1, 0, 2, 3)   # [h, b, rep, d]
    if scale is None:
        scale = 1.0 / np.sqrt(d)
    logits = jnp.einsum("hbrd,hbcd->hbrc", qh * scale, kctx,
                        preferred_element_type=jnp.float32)
    if softcap is not None:  # gemma2 attn_logit_softcapping, pre-mask
        logits = softcap * jnp.tanh(logits / softcap)
    mask = _attn_mask(kctx.shape[2], seq_lens, window)
    probs = jax.nn.softmax(logits + mask, axis=-1)
    out = jnp.einsum("hbrc,hbcd->hbrd", probs.astype(vctx.dtype), vctx,
                     preferred_element_type=jnp.float32)
    return out.transpose(1, 0, 2, 3).reshape(b, nq, d).astype(q.dtype)
