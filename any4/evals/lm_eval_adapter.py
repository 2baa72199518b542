"""lm-evaluation-harness adapter.

The reference's primary NLP-task route is ``lm_eval.simple_evaluate`` over
an HFLM (eval.py:297-321). Here the LM protocol implementation
(:class:`JaxCausalLM`: ``loglikelihood`` / ``loglikelihood_rolling`` /
``generate_until``) is a standalone duck-typed class with NO lm_eval
dependency, so it is fully exercised offline (tests/test_lm_protocol.py and
the local task runner in :mod:`any4.evals.tasks_local`); when lm_eval
IS installed, :func:`make_lm` wraps it into the harness's ``LM`` ABC and
:func:`simple_evaluate` runs the real task suite.

Compile-friendly scoring: requests are bucketed to power-of-two lengths and
batched, so XLA compiles O(log max_length) programs instead of one per
unique request shape; generation left-pads prompts into buckets with an
explicit position/mask offset so prefill and decode compile once per
bucket.
"""
from __future__ import annotations

import functools
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


class LmEvalUnavailable(RuntimeError):
    pass


def _require_lm_eval():
    try:
        import lm_eval  # noqa: F401
        return lm_eval
    except ImportError as e:
        raise LmEvalUnavailable(
            "lm-eval is not installed in this environment") from e


class JaxCausalLM:
    """LM-protocol implementation over a functional JAX model.

    Methods take/return the same shapes as lm_eval's ``LM`` interface but
    accept plain ``(context, continuation)`` string tuples (or request
    objects exposing ``.args``), so the class works without lm_eval.
    """

    MIN_BUCKET = 32

    def __init__(self, params, cfg, tokenizer, batch_size: int = 8,
                 max_length: int = 2048, forward_fn=None):
        import jax  # deferred so module import stays cheap
        self._jax = jax
        self.params = params
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.batch_size = batch_size
        self.max_length = max_length
        if forward_fn is None:
            from ..models import llama
            forward_fn = llama.forward
        self._fwd = forward_fn
        self._score_fns: Dict[int, object] = {}
        self._gen_fns: Dict[Tuple[int, int], object] = {}

    # ------------------------------------------------------------- helpers
    def _encode(self, text: str) -> List[int]:
        return list(self.tokenizer.encode(text))

    def _bucket(self, n: int) -> int:
        L = self.MIN_BUCKET
        while L < n:
            L *= 2
        return min(L, self.max_length)

    def _score_fn(self, L: int):
        """Jitted full-sequence scorer for bucket length L: per-position
        target log-probs + greedy hits. One compile per bucket."""
        if L not in self._score_fns:
            import jax
            import jax.numpy as jnp
            fwd, cfg = self._fwd, self.cfg

            @jax.jit
            def score(params, ids):
                logits, _ = fwd(params, cfg, ids)
                logp = jax.nn.log_softmax(
                    logits[:, :-1].astype(jnp.float32), axis=-1)
                tgt = ids[:, 1:]
                lp = jnp.take_along_axis(logp, tgt[..., None],
                                         axis=-1)[..., 0]
                hit = jnp.argmax(logp, axis=-1) == tgt
                return lp, hit

            self._score_fns[L] = score
        return self._score_fns[L]

    def _score_batch(self, token_lists: Sequence[List[int]]
                     ) -> List[Tuple[np.ndarray, np.ndarray]]:
        """Score token sequences (already truncated to max_length).

        Returns per-sequence (logp[t-1], greedy_hit[t-1]) arrays. Sequences
        are bucketed by length and batched; right-padding cannot influence
        earlier positions under the causal mask.
        """
        import jax.numpy as jnp
        results: List[Optional[Tuple[np.ndarray, np.ndarray]]] = \
            [None] * len(token_lists)
        order = sorted(range(len(token_lists)),
                       key=lambda i: len(token_lists[i]))
        i = 0
        while i < len(order):
            L = self._bucket(len(token_lists[order[i]]))
            batch_idx = []
            while (i < len(order) and len(batch_idx) < self.batch_size
                   and self._bucket(len(token_lists[order[i]])) == L):
                batch_idx.append(order[i])
                i += 1
            ids = np.zeros((len(batch_idx), L), np.int32)
            for r, j in enumerate(batch_idx):
                toks = token_lists[j]
                ids[r, :len(toks)] = toks
            lp, hit = self._score_fn(L)(self.params, jnp.asarray(ids))
            lp = np.asarray(lp)
            hit = np.asarray(hit)
            for r, j in enumerate(batch_idx):
                t = len(token_lists[j])
                results[j] = (lp[r, :t - 1], hit[r, :t - 1])
        return results  # type: ignore[return-value]

    @staticmethod
    def _args(req):
        return req.args if hasattr(req, "args") else req

    # ------------------------------------------------------ LM interface
    def loglikelihood(self, requests) -> List[Tuple[float, bool]]:
        pairs = [self._args(r) for r in requests]
        token_lists, ncont = [], []
        for context, continuation in pairs:
            ctx = self._encode(context)
            cont = self._encode(continuation)
            if not ctx:
                ctx = [self.tokenizer.bos_token_id] if getattr(
                    self.tokenizer, "bos_token_id", None) is not None else [0]
            toks = (ctx + cont)[-self.max_length:]
            token_lists.append(toks)
            ncont.append(min(len(cont), len(toks) - 1))
        out = []
        for (lp, hit), n in zip(self._score_batch(token_lists), ncont):
            if n <= 0:  # empty continuation: lp[-0:] would be the WHOLE
                out.append((0.0, True))  # sequence, not zero tokens
            else:
                out.append((float(lp[-n:].sum()), bool(hit[-n:].all())))
        return out

    def loglikelihood_rolling(self, requests) -> List[float]:
        out = []
        for r in requests:
            (text,) = self._args(r) if isinstance(self._args(r), tuple) \
                else (self._args(r),)
            ids = self._encode(text)
            chunks = []
            for s in range(0, max(len(ids) - 1, 1), self.max_length - 1):
                chunk = ids[s:s + self.max_length]
                if len(chunk) >= 2:
                    chunks.append(chunk)
            total = 0.0
            if chunks:
                for lp, _ in self._score_batch(chunks):
                    total += float(lp.sum())
            out.append(total)
        return out

    # ---------------------------------------------------------- generate
    def _gen_fns_for(self, L: int, max_len: int):
        """Jitted (prefill, step) for a left-padded prompt bucket: padded
        slots are excluded via position offset + additive mask, so one
        program serves every prompt length in the bucket."""
        key = (L, max_len)
        if key not in self._gen_fns:
            import jax
            import jax.numpy as jnp
            fwd, cfg = self._fwd, self.cfg

            @jax.jit
            def pre(params, ids, pad, caches):
                # ids [b, L]; pad [b] number of left-pad slots
                pos = jnp.clip(jnp.arange(L)[None, :] - pad[:, None], 0)
                q = jnp.arange(L)[None, :, None]
                s = jnp.arange(max_len)[None, None, :]
                ok = (s <= q) & (s >= pad[:, None, None])
                mask = jnp.where(ok, 0.0, -1e9)[:, None].astype(jnp.float32)
                logits, caches = fwd(params, cfg, ids, positions=pos,
                                     kv_caches=caches, cache_pos=None,
                                     mask=mask)
                return logits[:, -1, :], caches

            @jax.jit
            def step(params, tok, pos, pad, caches):
                # pos: scalar cache write index; real position = pos - pad
                b = tok.shape[0]
                positions = jnp.broadcast_to(pos, (b,))[:, None] \
                    - pad[:, None]
                idx = jnp.arange(max_len)[None, None, None, :]
                ok = (idx <= pos) & (idx >= pad[:, None, None, None])
                mask = jnp.where(ok, 0.0, -1e9).astype(jnp.float32)
                logits, caches = fwd(params, cfg, tok[:, None],
                                     positions=positions, kv_caches=caches,
                                     cache_pos=pos, mask=mask)
                return logits[:, -1, :], caches

            self._gen_fns[key] = (pre, step)
        return self._gen_fns[key]

    def generate_until(self, requests) -> List[str]:
        import jax.numpy as jnp
        from ..models import llama
        out = []
        for r in requests:
            context, kwargs = self._args(r)
            kwargs = dict(kwargs or {})
            until = kwargs.get("until", []) or []
            if isinstance(until, str):
                until = [until]
            max_new = int(kwargs.get("max_gen_toks", 128))
            # keep at least one prompt bucket of context: a max_gen_toks
            # >= max_length would otherwise flip the slice sign and take
            # tokens from the FRONT (possibly an empty prompt)
            max_new = min(max_new, self.max_length - self.MIN_BUCKET)
            keep = max(self.max_length - max_new, self.MIN_BUCKET)
            ids = self._encode(context)[-keep:]
            L = self._bucket(len(ids))
            pad = L - len(ids)
            max_len = L + max_new
            pre, step = self._gen_fns_for(L, max_len)
            caches = llama.init_kv_caches(self.cfg, 1, max_len)
            padded = jnp.asarray([[0] * pad + ids], jnp.int32)
            padv = jnp.asarray([pad], jnp.int32)
            logits, caches = pre(self.params, padded, padv, caches)
            eos = getattr(self.tokenizer, "eos_token_id", None)
            toks: List[int] = []
            for i in range(max_new):
                tok = int(np.asarray(jnp.argmax(logits, axis=-1))[0])
                if eos is not None and tok == eos:
                    break
                toks.append(tok)
                if i + 1 < max_new:
                    logits, caches = step(
                        self.params, jnp.asarray([tok], jnp.int32),
                        jnp.int32(L + i), padv, caches)
                text = self.tokenizer.decode(toks)
                if any(stop in text for stop in until):
                    break
            text = self.tokenizer.decode(toks)
            for stop in until:
                idx = text.find(stop)
                if idx >= 0:
                    text = text[:idx]
            out.append(text)
        return out


def make_lm(params, cfg, tokenizer, batch_size: int = 8,
            max_length: int = 2048, forward_fn=None):
    """Wrap :class:`JaxCausalLM` into an ``lm_eval.api.model.LM``."""
    _require_lm_eval()
    from lm_eval.api.model import LM

    inner = JaxCausalLM(params, cfg, tokenizer, batch_size=batch_size,
                        max_length=max_length, forward_fn=forward_fn)

    class JaxLM(LM):
        def loglikelihood(self, requests):
            return inner.loglikelihood(requests)

        def loglikelihood_rolling(self, requests):
            return inner.loglikelihood_rolling(requests)

        def generate_until(self, requests):
            return inner.generate_until(requests)

    return JaxLM()


def simple_evaluate(params, cfg, tokenizer, tasks: List[str],
                    limit: Optional[int] = None, **kwargs) -> Dict:
    """Run lm_eval.simple_evaluate against the wrapped model."""
    lm_eval = _require_lm_eval()
    lm = make_lm(params, cfg, tokenizer, **kwargs)
    return lm_eval.simple_evaluate(model=lm, tasks=tasks, limit=limit)
