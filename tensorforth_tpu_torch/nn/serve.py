"""Autoregressive serving — KV-cache generation for LM-tier models (the
port of tensorforth_tpu/nn/serve.py).

Supported program shape (the `tiny_lm` zoo family):
  EMBED -> { [LNORM] ATTN(causal) [activation] }* -> [LNORM]
        -> PROJ -> SOFTMAX
Position-wise layers run on the single-token slice; ATTN attends over
its cache.  The batched prefill routes its causal attention through
funcs.sdpa, which on the card launches the flash kernel (ops/attn.py).

Where the JAX package compiles the decode into one program (`lax.scan`
over steps, caches threaded functionally), the port runs a Python loop
over steps and updates the KV caches IN PLACE: one preallocated buffer
per layer, written at position t, instead of a fresh cache per step.
Mesh serving (T4_MESH) is not ported yet.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..config import Config
from ..ops import rng
from . import funcs
from .ntypes import Layer

_POSWISE = (Layer.RELU, Layer.TANH, Layer.SIGMOID, Layer.SELU,
            Layer.LEAKYRL, Layer.ELU)
NEG_INF = -1.0e30
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "int8": torch.int8}


def _check_program(program):
    for kind, opts, _s in program:
        if kind in (Layer.FLATTEN, Layer.LINEAR, Layer.CONV, Layer.DCONV,
                    Layer.MAXPOOL, Layer.AVGPOOL, Layer.MINPOOL,
                    Layer.BATCHNM, Layer.USAMPLE, Layer.DROPOUT):
            raise ValueError(
                f"nn.gen: layer '{Layer.NAMES[kind].strip()}' cannot "
                f"serve incrementally")
        if kind == Layer.ATTN and not (len(opts) > 1 and opts[1]):
            # KV-cache decode IS causal attention; serving a model
            # trained bidirectionally would silently change its math
            raise ValueError(
                "nn.gen: attention layers must be causal "
                "(build with `1 h nn.attn`)")


def _quant8(v):
    """symmetric per-vector int8 quantization: v [..., dh] ->
    (q int8 [..., dh], scale f32 [...]); the dequantized value is
    q * scale.  torch.round, like jnp.round, rounds half to even."""
    s = torch.clamp(v.abs().amax(dim=-1), min=1e-8) / 127.0
    q = torch.round(v / s[..., None]).to(torch.int8)
    return q, s


def _poswise(kind, opts, p, x):
    """the layers that act on each position alone; None if not one"""
    if kind == Layer.EMBED:
        return funcs._embed_fwd(x, p[0], p[1])
    if kind == Layer.LNORM:
        return funcs._lnorm_fwd(x, p[0], p[1], opts[0])
    if kind in _POSWISE:
        return funcs._activate_fwd(kind, x, opts[0])[0]
    if kind == Layer.PROJ:
        return funcs._proj_fwd(x, p[0], p[1])
    if kind == Layer.SOFTMAX:
        return x                        # sample from logits directly
    return None


def _store(cache, t0, k1, v1):
    """write K/V rows [N, h, S, dh] into the cache at positions t0.. (in
    place), quantizing for an int8 cache"""
    ck, cv, sk, sv = cache
    t1 = t0 + k1.shape[2]
    if sk is not None:                  # int8 + scales
        k1, k1s = _quant8(k1)
        v1, v1s = _quant8(v1)
        sk[:, :, t0:t1] = k1s
        sv[:, :, t0:t1] = v1s
    ck[:, :, t0:t1] = k1.to(ck.dtype)
    cv[:, :, t0:t1] = v1.to(cv.dtype)


def _step_token(program, params, caches, tok, t, s_max, w: int = 0):
    """one decode step: tok [N] ids at position t -> (logits [N,V],
    caches).  The caches are updated in place and returned as given.
    `w` limits the attention read to the first w cache positions (the
    windowed-decode segments)."""
    n = tok.shape[0]
    x = tok.reshape(n, 1, 1, 1).to(torch.float32)
    ci = 0
    for (kind, opts, _shape), p in zip(program, params):
        y = _poswise(kind, opts, p, x)
        if y is not None:
            x = y
            continue
        if kind != Layer.ATTN:
            raise ValueError(f"nn.gen: unsupported layer {kind}")
        heads = opts[0]
        e = x.shape[2]
        dh = e // heads
        qkv = (x.reshape(n, e) @ p[0].T).reshape(n, 3, heads, dh)
        q, k1, v1 = qkv[:, 0], qkv[:, 1], qkv[:, 2]     # [N, h, dh]
        if len(opts) > 2 and opts[2]:                  # RoPE at pos t
            pos = torch.full((1,), t, dtype=torch.int64, device=x.device)
            q = funcs.rope_apply(q[:, :, None, :], pos)[:, :, 0]
            k1 = funcs.rope_apply(k1[:, :, None, :], pos)[:, :, 0]
        cache = caches[ci]
        ci += 1
        _store(cache, t, k1[:, :, None], v1[:, :, None])
        ck, cv, sk, sv = cache
        quant = sk is not None
        span = w if 0 < w < s_max else s_max
        # bf16 cache: bf16 multiplicands, f32 products and sums (the
        # rounded values multiply exactly in f32).  int8 loads exactly
        # as float and dequantizes by folding the scales into the f32
        # scores and softmax weights.
        md = torch.bfloat16 if quant else ck.dtype
        scores = torch.einsum("nhd,nhsd->nhs", q.to(md).float(),
                              ck[:, :, :span].float())
        if quant:
            scores = scores * sk[:, :, :span]
        scores = scores / math.sqrt(dh)
        live = torch.arange(span, device=x.device) <= t
        scores = torch.where(live, scores, torch.full_like(scores, NEG_INF))
        wts = torch.softmax(scores, dim=-1)
        if quant:
            wts = wts * sv[:, :, :span]
        o = torch.einsum("nhs,nhsd->nhd", wts.to(md).float(),
                         cv[:, :, :span].float())
        x = (o.reshape(n, e) @ p[1].T).reshape(n, 1, e, 1)
    return x.reshape(n, -1), caches


def _prefill(program, params, prompt, caches):
    """ONE full-prompt forward that fills every attention layer's KV
    cache for positions 0..S0-1 (in place) and returns (last-position
    logits [N, V], caches).  f32 scores/softmax/PV; K/V are cast to the
    cache's storage type only when stored."""
    n, s0 = prompt.shape
    x = prompt.reshape(n, s0, 1, 1).to(torch.float32)
    ci = 0
    for (kind, opts, _shape), p in zip(program, params):
        y = _poswise(kind, opts, p, x)
        if y is not None:
            x = y
            continue
        if kind != Layer.ATTN:
            raise ValueError(f"nn.gen: unsupported layer {kind}")
        heads = opts[0]
        e = x.shape[2]
        dh = e // heads
        qkv = (x.reshape(n, s0, e) @ p[0].T).reshape(n, s0, 3, heads, dh)
        q = qkv[:, :, 0].transpose(1, 2)               # [N, h, S0, dh]
        k1 = qkv[:, :, 1].transpose(1, 2)
        v1 = qkv[:, :, 2].transpose(1, 2)
        if len(opts) > 2 and opts[2]:                  # RoPE
            pos = torch.arange(s0, device=x.device)
            q = funcs.rope_apply(q, pos)
            k1 = funcs.rope_apply(k1, pos)
        _store(caches[ci], 0, k1, v1)
        ci += 1
        # the flash kernel for long aligned prompts on the card (the
        # S0 x S0 scores never reach device memory), exact einsum else
        o = funcs.sdpa(q.reshape(n * heads, s0, dh),
                       k1.reshape(n * heads, s0, dh),
                       v1.reshape(n * heads, s0, dh), causal=True)
        o = o.reshape(n, heads, s0, dh).transpose(1, 2).reshape(n, s0, e)
        x = (o @ p[1].T).reshape(n, s0, e, 1)
    return x.reshape(n, s0, -1)[:, -1, :], caches


def _filter_top_k(logits, k: int):
    """keep the k largest logits per row, mask the rest"""
    kth = torch.topk(logits, k, dim=-1).values[..., -1:]
    return torch.where(logits < kth, torch.full_like(logits, NEG_INF), logits)


def _filter_top_p(logits, p: float):
    """nucleus sampling: keep the smallest set of tokens whose
    cumulative probability reaches p (the first token always survives)"""
    sl = torch.sort(logits, dim=-1, descending=True).values
    probs = torch.softmax(sl, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep = (cum - probs) < p                   # exclusive prefix mass
    thr = torch.where(keep, sl, torch.full_like(sl, math.inf)).amin(
        dim=-1, keepdim=True)
    return torch.where(logits < thr, torch.full_like(logits, NEG_INF), logits)


def _new_caches(program, n, s_max, kv_dtype, device):
    kd = _DTYPES[kv_dtype]
    caches = []
    for kind, opts, shape in program:
        if kind != Layer.ATTN:
            continue
        h, d = opts[0], shape[2] // opts[0]
        kv = [torch.zeros((n, h, s_max, d), dtype=kd, device=device)
              for _ in range(2)]
        # int8 storage + one f32 scale per cached vector
        sc = ([torch.ones((n, h, s_max), dtype=torch.float32, device=device)
               for _ in range(2)] if kd == torch.int8 else [None, None])
        caches.append((*kv, *sc))
    return caches


@torch.no_grad()
def _generate(program, params, prompt, s_max: int, temp: float,
              key, top_k: int = 0, top_p: float = 0.0,
              kv_dtype: str = "float32", win: int = 0,
              prefill: bool = True):
    """prompt [N, n_prompt] int64 on the model's device -> ids [N, s_max]
    (greedy when temp == 0; optional top-k and/or nucleus top-p filtering
    before the categorical draw).  `key` is a jax.random key pair
    (ops/rng.py): as in the JAX package each pick with temp > 0 splits
    it once and draws argmax(gumbel(sub) + logits).

    kv_dtype: KV cache STORAGE dtype ('float32', 'bfloat16' or 'int8').
    win > 0: WINDOWED decode — the steps split into power-of-two segments
    (win, 2*win, ... s_max) and each segment's attention reads only its
    cache prefix.  prefill=True runs the prompt through ONE causal
    forward (_prefill) instead of n_prompt sequential steps;
    token-identical for greedy decode."""
    n, n_prompt = prompt.shape
    caches = _new_caches(program, n, s_max, kv_dtype, prompt.device)
    ids = torch.zeros((n, s_max), dtype=torch.int64, device=prompt.device)
    ids[:, :n_prompt] = prompt

    def pick(logits):
        """sample/argmax the next token from [N, V] logits"""
        nonlocal key
        if temp <= 0.0:
            return torch.argmax(logits, dim=-1)
        key, sub = rng.split(key)
        lg = logits / temp
        if 0 < top_k < lg.shape[-1]:
            lg = _filter_top_k(lg, top_k)
        if 0.0 < top_p < 1.0:
            lg = _filter_top_p(lg, top_p)
        return torch.argmax(rng.gumbel(sub, lg.shape, lg.device) + lg,
                            dim=-1)

    t0 = 0
    if prefill:
        logits, caches = _prefill(program, params, prompt, caches)
        nxt = pick(logits)
        if n_prompt < s_max:
            ids[:, n_prompt] = nxt
        t0 = n_prompt
    if t0 >= s_max - 1:
        return ids                     # nothing to decode (n_new == 0)
    # segment [t0, t1) may read positions 0..t1-1 -> window t1.  The
    # doubling reaches w >= t0 + 1 before (or at) the s_max cap.
    w = win if 0 < win < s_max else s_max
    while w < t0 + 1:
        w = min(w * 2, s_max)
    while t0 < s_max - 1:
        t1 = min(w, s_max - 1)
        for t in range(t0, t1):
            logits, caches = _step_token(program, params, caches,
                                         ids[:, t], t, s_max, w=w)
            nxt = pick(logits)
            # within the prompt, the next token is given (replay);
            # beyond it, the model's choice extends the sequence
            if t + 1 >= n_prompt:
                ids[:, t + 1] = nxt
        t0 = t1
        w = min(w * 2, s_max)
    return ids


def generate(model, prompt_ids, n_new: int, temp: float = 0.0,
             seed: int = 0, top_k: int = 0, top_p: float = 0.0,
             kv_dtype: str | None = None, win: int | None = None,
             prefill: bool = True):
    """prompt_ids: [N, S0] (or [S0]) int array -> [N, S0+n_new] ids
    (numpy int32), computed on the model's device; temp=0 is greedy;
    top_k/top_p filter the distribution when temp>0, drawn as the JAX
    package draws it from jax.random.PRNGKey(seed).

    kv_dtype ('float32'/'bfloat16'/'int8', default env T4_KV_DTYPE or
    f32) sets the KV cache storage dtype; win (default env
    T4_DECODE_WIN, 512) sets power-of-two windowed decode (0 = off)."""
    program = model._program()
    _check_program(program)
    params = model._params()
    p = np.asarray(prompt_ids)
    squeeze = p.ndim == 1
    if squeeze:
        p = p[None]
    for (kind, _o, _s), lp in zip(program, params):
        if kind == Layer.EMBED and p.size and (
                p.min() < 0 or p.max() >= lp[0].shape[0]):
            # an out-of-range id would fault the embedding gather on the
            # card (the JAX gather clamps it silently)
            raise ValueError(f"nn.gen: prompt ids outside "
                             f"[0, {lp[0].shape[0]})")
    s_max = p.shape[1] + n_new
    if kv_dtype is None:
        kv_dtype = Config.KV_DTYPE
    if win is None:
        win = Config.DECODE_WIN
    if kv_dtype not in _DTYPES:
        raise ValueError(f"nn.gen: kv_dtype {kv_dtype!r} not in {list(_DTYPES)}")
    prompt = torch.as_tensor(p.astype(np.int64), device=model.device)
    ids = _generate(program, params, prompt, s_max, float(temp),
                    rng.PRNGKey(int(seed)),
                    int(top_k), float(top_p), kv_dtype=str(kv_dtype),
                    win=int(win), prefill=bool(prefill))
    out = ids.cpu().numpy().astype(np.int32)
    return out[0] if squeeze else out
