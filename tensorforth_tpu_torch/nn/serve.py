"""Autoregressive serving — KV-cache generation for LM-tier models (the
port of tensorforth_tpu/nn/serve.py).

Supported program shape (the `tiny_lm` zoo family and its MoE variant):
  EMBED -> { [LNORM] ATTN(causal) [activation] [MOE] }* -> [LNORM]
        -> PROJ -> SOFTMAX
Position-wise layers (LNORM, activations, MOE, PROJ) run on the
single-token slice; ATTN attends over its cache.  The batched prefill
routes its causal attention through funcs.sdpa, which on the card
launches the flash kernel (ops/attn.py).

Where the JAX package compiles the decode into one program (`lax.scan`
over the steps of each window segment, the token, position and key in
the carry), the port keeps the decode's state in a Decoder's buffers,
updated IN PLACE, and its step reads the position from a device
counter: on the card each segment's step is one captured CUDA graph,
replayed once a token; on the CPU the same step runs eagerly.  The
prefill runs eagerly into the same buffers.

Under T4_MESH (funcs.word_mesh) `generate` serves as the JAX package's
`_shard_serving` lays it out: the batch over dp, the attention heads over
tp, each rank's KV caches [N/dp, h/tp, S, dh].  A rank computes its
heads' q, k, v (its rows of wqkv), their attention, and all-gathers the
heads' outputs over tp before the output projection, so its tokens are
one device's; the ids are all-gathered over dp at the end.  A sampled
pick draws the whole batch's Gumbel noise and takes its rows.  The
decode runs uncaptured (gloo's collectives run on the host).  When the
batch or the heads do not divide the mesh it serves on one device, as
the JAX package does.
"""
from __future__ import annotations

import math
from collections import OrderedDict

import numpy as np
import torch

from ..config import Config
from ..ops import rng
from ..parallel import moe
from . import cycle, funcs
from .ntypes import Layer

_POSWISE = (Layer.RELU, Layer.TANH, Layer.SIGMOID, Layer.SELU,
            Layer.LEAKYRL, Layer.ELU)
NEG_INF = -1.0e30
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "int8": torch.int8}
CACHE_SIZE = 8           # Decoders kept (each holds its KV caches)
_DECODERS: OrderedDict = OrderedDict()

# what the decodes did since the last reset_counts(): step graphs
# captured, graph replays, eager steps
COUNTS = {"captures": 0, "replays": 0, "steps": 0}


def reset_counts():
    for k in COUNTS:
        COUNTS[k] = 0


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
    if kind == Layer.MOE:
        # the route is moe_select's for this call's token count: a
        # prefill and a step may take different ones, as in the JAX
        # package
        return funcs._moe_fwd(x, p[0], p[1], opts[2])
    if kind == Layer.PROJ:
        return funcs._proj_fwd(x, p[0], p[1])
    if kind == Layer.SOFTMAX:
        return x                        # sample from logits directly
    return None


def _store(cache, t0: int, k1, v1):
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


def _store_at(cache, tt, k1, v1):
    """write one position's K/V [N, h, 1, dh] at the device position tt
    ([1] int64), in place"""
    ck, cv, sk, sv = cache
    if sk is not None:                  # int8 + scales
        k1, k1s = _quant8(k1)
        v1, v1s = _quant8(v1)
        sk.index_copy_(2, tt, k1s)
        sv.index_copy_(2, tt, v1s)
    ck.index_copy_(2, tt, k1.to(ck.dtype))
    cv.index_copy_(2, tt, v1.to(cv.dtype))


def _heads_out(mesh, o, dim):
    """the tp ranks' heads' outputs side by side (all of them)"""
    return o if mesh is None else mesh.all_gather(o, dim, "tp")


def _step_token(program, params, caches, tok, t, s_max, w: int = 0,
                mesh=None):
    """one decode step: tok [N] ids at position t -> (logits [N,V],
    caches).  t is a host int or a 0-d int64 tensor on tok's device (a
    captured step reads its position from there).  The caches are
    updated in place and returned as given.  `w` limits the attention
    read to the first w cache positions (the windowed-decode segments).
    Under a mesh the attention runs this rank's heads (params hold their
    rows of wqkv) and gathers the heads' outputs over tp."""
    n = tok.shape[0]
    tp = 1 if mesh is None else mesh.tp
    tt = torch.as_tensor(t, dtype=torch.int64, device=tok.device).reshape(1)
    x = tok.reshape(n, 1, 1, 1).to(torch.float32)
    ci = 0
    for (kind, opts, _shape), p in zip(program, params):
        y = _poswise(kind, opts, p, x)
        if y is not None:
            x = y
            continue
        if kind != Layer.ATTN:
            raise ValueError(f"nn.gen: unsupported layer {kind}")
        heads = opts[0] // tp
        e = x.shape[2]
        dh = e // opts[0]
        qkv = funcs.class_matmul(x.reshape(n, e), p[0].T).reshape(
            n, 3, heads, dh)
        q, k1, v1 = qkv[:, 0], qkv[:, 1], qkv[:, 2]     # [N, h, dh]
        if len(opts) > 2 and opts[2]:                  # RoPE at pos t
            q = funcs.rope_apply(q[:, :, None, :], tt)[:, :, 0]
            k1 = funcs.rope_apply(k1[:, :, None, :], tt)[:, :, 0]
        cache = caches[ci]
        ci += 1
        _store_at(cache, tt, k1[:, :, None], v1[:, :, None])
        ck, cv, sk, sv = cache
        quant = sk is not None
        span = w if 0 < w < s_max else s_max
        if ck.dtype == torch.float32:
            # an f32 cache: the LM tier's class (exact f32 on the CPU)
            scores = funcs.class_einsum("nhd,nhsd->nhs", q, ck[:, :, :span])
        else:
            # bf16 cache: bf16 multiplicands, f32 products and sums (the
            # rounded values multiply exactly in f32).  int8 loads
            # exactly as float and dequantizes by folding the scales
            # into the f32 scores and softmax weights.
            scores = torch.einsum("nhd,nhsd->nhs",
                                  q.to(torch.bfloat16).float(),
                                  ck[:, :, :span].float())
        if quant:
            scores = scores * sk[:, :, :span]
        scores = scores / math.sqrt(dh)
        live = torch.arange(span, device=x.device) <= tt
        scores = torch.where(live, scores, torch.full_like(scores, NEG_INF))
        wts = torch.softmax(scores, dim=-1)
        if quant:
            wts = wts * sv[:, :, :span]
        if cv.dtype == torch.float32:
            o = funcs.class_einsum("nhs,nhsd->nhd", wts, cv[:, :, :span])
        else:
            o = torch.einsum("nhs,nhsd->nhd", wts.to(torch.bfloat16).float(),
                             cv[:, :, :span].float())
        o = _heads_out(mesh, o.reshape(n, heads * dh), 1)
        x = funcs.class_matmul(o, p[1].T).reshape(n, 1, e, 1)
    return x.reshape(n, -1), caches


def _prefill(program, params, prompt, caches, mesh=None):
    """ONE full-prompt forward that fills every attention layer's KV
    cache for positions 0..S0-1 (in place) and returns (last-position
    logits [N, V], caches).  f32 scores/softmax; K/V are cast to the
    cache's storage type only when stored."""
    n, s0 = prompt.shape
    tp = 1 if mesh is None else mesh.tp
    x = prompt.reshape(n, s0, 1, 1).to(torch.float32)
    ci = 0
    for (kind, opts, _shape), p in zip(program, params):
        y = _poswise(kind, opts, p, x)
        if y is not None:
            x = y
            continue
        if kind != Layer.ATTN:
            raise ValueError(f"nn.gen: unsupported layer {kind}")
        heads = opts[0] // tp
        e = x.shape[2]
        dh = e // opts[0]
        qkv = funcs.class_matmul(x.reshape(n, s0, e), p[0].T).reshape(
            n, s0, 3, heads, dh)
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
        # S0 x S0 scores never reach device memory), the einsum path else
        o = funcs.sdpa(q.reshape(n * heads, s0, dh),
                       k1.reshape(n * heads, s0, dh),
                       v1.reshape(n * heads, s0, dh), causal=True)
        o = o.reshape(n, heads, s0, dh).transpose(1, 2).reshape(
            n, s0, heads * dh)
        x = funcs.class_matmul(_heads_out(mesh, o, 2), p[1].T).reshape(
            n, s0, e, 1)
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


def _new_caches(program, n, s_max, kv_dtype, device, tp: int = 1):
    """each attention layer's K/V cache [n, h/tp, s_max, dh] (and int8's
    scales)"""
    kd = _DTYPES[kv_dtype]
    caches = []
    for kind, opts, shape in program:
        if kind != Layer.ATTN:
            continue
        h, d = opts[0] // tp, shape[2] // opts[0]
        kv = [torch.zeros((n, h, s_max, d), dtype=kd, device=device)
              for _ in range(2)]
        # int8 storage + one f32 scale per cached vector
        sc = ([torch.ones((n, h, s_max), dtype=torch.float32, device=device)
               for _ in range(2)] if kd == torch.int8 else [None, None])
        caches.append((*kv, *sc))
    return caches


def _segments(t0: int, s_max: int, win: int):
    """the decode's window segments from position t0: [(w, steps)].
    Segment [t0, t1) may read positions 0..t1-1 -> window t1; the
    doubling reaches w >= t0 + 1 before (or at) the s_max cap.  win <= 0
    or >= s_max is one segment over the whole cache"""
    segs = []
    if t0 >= s_max - 1:
        return segs                    # nothing to decode (n_new == 0)
    w = win if 0 < win < s_max else s_max
    while w < t0 + 1:
        w = min(w * 2, s_max)
    while t0 < s_max - 1:
        t1 = min(w, s_max - 1)
        segs.append((w, t1 - t0))
        t0 = t1
        w = min(w * 2, s_max)
    return segs


def _pick(logits, temp, top_k: int, top_p: float, key, rows=None):
    """the next token from [N, V] logits: argmax when key is None (greedy),
    else argmax(gumbel(key) + filtered logits / temp), the JAX package's
    categorical draw.  temp is a 0-d tensor on the logits' device and
    key a pair of host ints or of 0-d tensors: nothing is read back.
    rows = (first row, whole batch): the logits are a dp rank's rows, and
    the noise is the whole batch's, sliced"""
    if key is None:
        return torch.argmax(logits, dim=-1)
    lg = logits / temp
    if 0 < top_k < lg.shape[-1]:
        lg = _filter_top_k(lg, top_k)
    if 0.0 < top_p < 1.0:
        lg = _filter_top_p(lg, top_p)
    if rows is None:
        g = rng.gumbel(key, lg.shape, lg.device)
    else:
        g = rng.gumbel(key, (rows[1], lg.shape[1]), lg.device)[
            rows[0]:rows[0] + lg.shape[0]]
    return torch.argmax(g + lg, dim=-1)


class Decoder:
    """the decode of one signature on buffers of its own: the ids, the KV
    caches (f32, bf16, or int8 with its scales), the position counter,
    the prompt's length, the temperature and the pick keys by position.
    `body(w)` is one step of window w at the counter's position (the JAX
    package's scan step, serve.py:342-364): it reads the token and its
    key there, writes K/V at the position, the next token at t+1 (the
    prompt's own within it) and adds one to the counter.  On the card
    each window's body is captured once into a CUDA graph (cycle.capture,
    the graphs sharing one memory pool) and a segment of L tokens is L
    replays queued back to back; on the CPU the body runs eagerly."""

    def __init__(self, program, params, n: int, s_max: int, kv_dtype: str,
                 sampled: bool, top_k: int, top_p: float, device,
                 mesh=None, rows=None):
        self.program, self.params = program, params
        self.mesh, self.rows = mesh, rows
        self.s_max, self.sampled = s_max, sampled
        self.top_k, self.top_p = top_k, top_p
        self.device = device
        self.caches = _new_caches(program, n, s_max, kv_dtype, device,
                                  1 if mesh is None else mesh.tp)
        self.ids = torch.zeros((n, s_max), dtype=torch.int64, device=device)
        self.t = torch.zeros((), dtype=torch.int64, device=device)
        self.n_prompt = torch.zeros((), dtype=torch.int64, device=device)
        self.temp = torch.ones((), dtype=torch.float32, device=device)
        self.keys = torch.zeros((s_max, 2), dtype=torch.int64, device=device)
        self.graphs = {}
        self.pool = None

    def body(self, w: int):
        t = self.t
        tt = t.view(1)
        tok = self.ids.index_select(1, tt)[:, 0]
        logits, _ = _step_token(self.program, self.params, self.caches, tok,
                                t, self.s_max, w=w, mesh=self.mesh)
        key = None
        if self.sampled:
            kt = self.keys.index_select(0, tt)[0]
            key = (kt[0], kt[1])
        nxt = _pick(logits, self.temp, self.top_k, self.top_p, key,
                    self.rows)
        # within the prompt, the next token is given (replay); beyond
        # it, the model's choice extends the sequence
        nt = torch.clamp(t + 1, max=self.s_max - 1).view(1)
        cur = self.ids.index_select(1, nt)[:, 0]
        nxt = torch.where(t + 1 < self.n_prompt, cur, nxt)
        self.ids.index_copy_(1, nt, nxt[:, None])
        t.add_(1)

    def capture(self, w: int):
        """window w's graph, captured on first use.  The warm-up runs
        write the buffers: capture before start()"""
        if w not in self.graphs:
            g = cycle.capture(lambda: self.body(w), self.t, self.device,
                              self.pool)
            if self.pool is None:
                self.pool = g.pool()
            self.graphs[w] = g
            COUNTS["captures"] += 1
        return self.graphs[w]

    def start(self, prompt, temp: float, keys: dict):
        """fresh caches, the prompt in ids, the temperature and the pick
        keys {position: key}"""
        for ck, cv, sk, sv in self.caches:
            ck.zero_()
            cv.zero_()
            if sk is not None:
                sk.fill_(1.0)
                sv.fill_(1.0)
        self.ids.zero_()
        self.ids[:, :prompt.shape[1]].copy_(prompt)
        self.n_prompt.fill_(prompt.shape[1])
        self.temp.fill_(temp)
        if keys:
            pos = list(keys)
            self.keys[pos[0]:pos[-1] + 1].copy_(torch.tensor(
                [keys[t] for t in pos], dtype=torch.int64))

    def decode(self, t0: int, segs, graphs: bool):
        """the steps from position t0, segment by segment"""
        self.t.fill_(t0)
        for w, steps in segs:
            if graphs:
                g = self.graphs[w]
                for _ in range(steps):
                    g.replay()
                COUNTS["replays"] += steps
            else:
                for _ in range(steps):
                    self.body(w)
                COUNTS["steps"] += steps


def _decoder(uid, program, params, n, s_max, kv_dtype, sampled, top_k,
             top_p, device) -> Decoder:
    """the cached Decoder of this signature, made on first use.  The key
    holds what a capture bakes in: the dots' class, the MoE routing, and
    the parameters' storage, so a reloaded model never replays stale
    weights"""
    key = (uid, program, n, s_max, kv_dtype, sampled, top_k, top_p,
           str(device), Config.PRECISION, moe.capture_key(),
           tuple(w.data_ptr() for pl in params for w in pl))
    dec = _DECODERS.get(key)
    if dec is None:
        dec = _DECODERS[key] = Decoder(program, params, n, s_max, kv_dtype,
                                       sampled, top_k, top_p, device)
        if len(_DECODERS) > CACHE_SIZE:
            _DECODERS.popitem(last=False)
    else:
        _DECODERS.move_to_end(key)
    return dec


@torch.no_grad()
def _generate(program, params, prompt, s_max: int, temp: float,
              key, top_k: int = 0, top_p: float = 0.0,
              kv_dtype: str = "float32", win: int = 0,
              prefill: bool = True, graphs: bool = False, uid=None,
              mesh=None):
    """prompt [N, n_prompt] int64 on the model's device -> ids [N, s_max]
    (greedy when temp == 0; optional top-k and/or nucleus top-p filtering
    before the categorical draw).  `key` is a jax.random key pair
    (ops/rng.py): as in the JAX package each pick with temp > 0 splits
    it once; the chain is hashed on the host before the first step.

    kv_dtype: KV cache STORAGE dtype ('float32', 'bfloat16' or 'int8').
    win > 0: WINDOWED decode — the steps split into power-of-two segments
    (win, 2*win, ... s_max) and each segment's attention reads only its
    cache prefix.  prefill=True runs the prompt through ONE causal
    forward (_prefill) instead of n_prompt sequential steps;
    token-identical for greedy decode.  graphs=True (a CUDA prompt)
    replays each segment's captured step, from the Decoder cached under
    the model's `uid`; graphs=False runs the same body eagerly.  `mesh`
    serves this rank's dp rows and tp heads (module docstring), uncaptured,
    and returns the whole batch's ids."""
    rows = None
    if mesh is not None:
        graphs = False
        big = prompt.shape[0]
        k = big // mesh.dp
        rows = (mesh.dp_idx * k, big)
        prompt = prompt[rows[0]:rows[0] + k]
        params = _head_params(program, params, mesh)
    n, n_prompt = prompt.shape
    sampled = temp > 0.0
    t0 = n_prompt if prefill else 0
    segs = _segments(t0, s_max, win)
    args = (program, params, n, s_max, kv_dtype, sampled, int(top_k),
            float(top_p), prompt.device)
    dec = _decoder(uid, *args) if graphs else Decoder(*args, mesh=mesh,
                                                      rows=rows)
    if graphs:
        for w, _steps in segs:
            dec.capture(w)
    subs = rng.split_chain(key, int(prefill) + sum(st for _w, st in segs)) \
        if sampled else []
    first = subs[0] if sampled and prefill else None
    steps = subs[int(prefill):]
    dec.start(prompt, temp, {t0 + i: k for i, k in enumerate(steps)})
    if prefill:
        logits, _ = _prefill(program, params, prompt, dec.caches, mesh)
        nxt = _pick(logits, dec.temp, top_k, top_p, first, rows)
        if n_prompt < s_max:
            dec.ids[:, n_prompt] = nxt
    dec.decode(t0, segs, graphs)
    if mesh is not None:
        return mesh.all_gather(dec.ids, 0, "dp")
    return dec.ids.clone()


def _head_params(program, params, mesh):
    """an attention layer's rows of wqkv [3E, E] for this rank's heads
    (q's, k's and v's alike); wo and the other layers whole"""
    out = []
    for (kind, opts, _shape), pl in zip(program, params):
        if kind == Layer.ATTN and mesh.tp > 1:
            wqkv, wo = pl
            e = wqkv.shape[1]
            hl = opts[0] // mesh.tp
            dh = e // opts[0]
            w = wqkv.reshape(3, opts[0], dh, e)[
                :, mesh.tp_idx * hl:(mesh.tp_idx + 1) * hl]
            pl = (w.reshape(3 * hl * dh, e), wo)
        out.append(pl)
    return tuple(out)


def serving_mesh(program, n: int):
    """T4_MESH's mesh for a batch of n prompts, or None when there is none
    or the batch or an attention layer's heads do not divide it"""
    mesh = funcs.word_mesh()
    if mesh is None or n % mesh.dp or any(
            opts[0] % mesh.tp for kind, opts, _s in program
            if kind == Layer.ATTN):
        return None
    return mesh


def generate(model, prompt_ids, n_new: int, temp: float = 0.0,
             seed: int = 0, top_k: int = 0, top_p: float = 0.0,
             kv_dtype: str | None = None, win: int | None = None,
             prefill: bool = True):
    """prompt_ids: [N, S0] (or [S0]) int array -> [N, S0+n_new] ids
    (numpy int32), computed on the model's device; temp=0 is greedy;
    top_k/top_p filter the distribution when temp>0, drawn as the JAX
    package draws it from jax.random.PRNGKey(seed).  On the card the
    decode replays captured CUDA graphs, one a token after the prefill.

    kv_dtype ('float32'/'bfloat16'/'int8', default env T4_KV_DTYPE or
    f32) sets the KV cache storage dtype; win (default env
    T4_DECODE_WIN, 512) sets power-of-two windowed decode (0 = off)."""
    return _generate_ids(model, prompt_ids, n_new, temp, seed, top_k,
                         top_p, kv_dtype, win, prefill,
                         graphs=model.device.type == "cuda")


def _generate_ids(model, prompt_ids, n_new, temp=0.0, seed=0, top_k=0,
                  top_p=0.0, kv_dtype=None, win=None, prefill=True,
                  graphs=False):
    """generate() with the decode's route given: graphs=False runs the
    uncaptured body, also on the card (the control a capture is held
    against)"""
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
                    win=int(win), prefill=bool(prefill), graphs=graphs,
                    uid=model._uid, mesh=serving_mesh(program, p.shape[0]))
    out = ids.cpu().numpy().astype(np.int32)
    return out[0] if squeeze else out
