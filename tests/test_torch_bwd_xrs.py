"""The clusters' balanced exchange at dh 384 to 1024 (csrc/sm90_gemm.cuh:
Xrs) as far as the CPU can hold it, for its three users on clusters of dh
/ 128 CTAs: K2a and K2b (flash_bwd.cu), K1's f32 class (flash_fwd.cuh)
and K3 in both classes (flash_bwd_fused.cu).

Each CTA of the cluster forms a tile's s2 and dp (K1: its s2 over 64
keys) over its 128 columns of dh: 32 partial floats a thread, 8 quads.
K1 sends all 8 once its score products are done and has one slot; K3
keeps ds^T's parts in its one slot once round 2 is read (the f32 class)
and signals that read after its dq products, or has two slots and a
place of its own for ds^T (the hybrid class).  Two rounds add them: a
reduce-scatter, in which each quad's owner (quad q of warp w's threads
belongs to CTA (q + w) mod CL) receives every peer's partial of it in its
pool and adds the cluster's partials in cluster_sum's order, and an
all-gather of the owners' sums.  Here the model of that schedule
(ops.attn.xrs_*) is checked and run on tensors of partials through
simulated pools and planes: every quad has one owner and every CTA some
of each thread's, a round's stores fit a slot without overlap, no rank
stores to itself, and every rank leaves with cluster_sum's bits (random
partials, and crafted ones whose sum shows the tree), for each user's
slots and ds^T's place.  The plans agree with the source's
static_asserts, and the f32 class's plain version with
its scores formed through the simulated exchange holds the JAX package's
Pallas backward in interpret mode at [1, 512, dh].  The kernel's own Xrs,
cut out of its header and built by g++ for the host, runs a simulated
cluster of 256 threads a CTA as each user calls it (tests/xrs_sim.cpp),
and with K3's free-arrival moved before its ds^T stores it corrupts the
sums.  Inputs come from numpy
seeds; the tolerance is tests/test_torch_attn_dh512.py's (2e-4 absolute
plus relative).
"""
import os
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from tensorforth_tpu_torch.ops import attn, gemm
from tests.test_torch_attn_dh512 import TOL_BWD, _inputs, _pallas, _ratio
from tests.test_torch_attn_dh512 import _source
from tests.test_torch_threads import one_torch_thread  # noqa: F401

CLS = (3, 4, 5, 6, 7, 8)
NQ, NW = attn.XRS_QUADS, attn.XRS_WARPS
THREADS = 256                    # a CTA: two warpgroups of four warps
# the exchange's users: (kernel, hybrid class)
USERS = (("k2", False), ("k2", True), ("k1", False), ("k3", False),
         ("k3", True))
USER_IDS = [f"{k}-{'hybrid' if hy else 'f32'}" for k, hy in USERS]
DS_BYTES = 3 * 64 * 64 * 2       # K3's ds^T, three bf16 parts [64, 64]


def _layout(user, hybrid):
    """a user's exchange in a CTA's shared memory, bytes from the first
    slot: (slots, ds^T's region or None); K1's forward has no hybrid
    class on this route (it takes the wide route there)"""
    slots = attn.xrs_slots(hybrid)
    slot = attn.BWD_EXCHANGE
    assert attn.FWD_EXCHANGE == attn.FUSED_EXCHANGE == slot == 32768
    if user != "k3":
        return slots, None
    parts = 1 if hybrid else 3
    ds = parts * DS_BYTES // 3
    return slots, ((0, ds) if slots == 1 else (2 * slot, 2 * slot + ds))


@pytest.mark.parametrize("cl", CLS)
def test_every_quad_has_one_owner_and_every_cta_some(cl):
    """quad q of warp w's threads belongs to CTA (q + w) mod CL: each of a
    thread's 8 quads (s2's 4 and dp's 4) has one owner, every CTA owns at
    least one and at most ceil(8 / CL) of each thread's (so each thread
    hears from every peer in round 2), and over a warpgroup the CTAs own
    8 / CL of the quads each, to within one a warp"""
    for w in range(NW):
        owners = [attn.xrs_owner(cl, w, q) for q in range(NQ)]
        counts = [owners.count(j) for j in range(cl)]
        assert all(1 <= c <= -(-NQ // cl) for c in counts)
        assert sum(counts) == NQ
        assert counts == [attn.xrs_owns(cl, j, w) for j in range(cl)]
    totals = [sum(attn.xrs_owns(cl, j, w) for w in range(NW))
              for j in range(cl)]
    assert max(totals) - min(totals) <= NW


@pytest.mark.parametrize("user,hybrid", USERS, ids=USER_IDS)
@pytest.mark.parametrize("cl", CLS)
def test_a_rounds_stores_fit_the_slot(cl, user, hybrid):
    """round 1: no rank stores to itself; each owner's pool takes every
    peer's partial of each quad it owns, each at a warp-plane of its own,
    below the slot's 64 (60 at most); round 2: each thread takes the sums
    of the quads it does not own, from their owners, at the quads' own
    planes; a thread stores 5 to 7 quads in round 1 and (CL - 1) times its
    owned quads in round 2, every store 16 bytes.  Per user: the slots
    hold both rounds (one slot: the same bytes in turn; two: round 2 in
    the second); K3's ds^T (f32: 24 KB) lies in its one slot over the
    round-1 pool, so the peers' next round 1 must wait for its last
    reader, or (hybrid) past both slots, where no message lands"""
    slots, ds = _layout(user, hybrid)
    slot = attn.BWD_EXCHANGE
    plane, wplane = THREADS * 16, 32 * 16
    assert NQ * plane == slot == attn.XRS_POOL * wplane
    r2 = (slots - 1) * slot            # where round 2's planes start
    if ds is not None and slots == 1:
        assert ds == (0, DS_BYTES) and DS_BYTES <= slot
    elif ds is not None:
        assert ds[0] >= 2 * slot and ds[1] - ds[0] == DS_BYTES // 3
    assert attn.exchange_barriers(cl, slots) == (4 if slots == 1 else 2)
    for j in range(cl):
        pool = {}
        for r in range(cl):
            for g in range(THREADS // 128):
                for w in range(NW):
                    one = attn.xrs_messages(cl, r, g, w, 1)
                    assert all(t != r for t, _, _ in one)
                    assert len(one) == NQ - attn.xrs_owns(cl, r, w) <= 7
                    two = attn.xrs_messages(cl, r, g, w, 2)
                    assert len(two) == (cl - 1) * attn.xrs_owns(cl, r, w)
                    for t, q, p in one:
                        if t == j:
                            assert p not in pool
                            pool[p] = (r, g, w, q)
                    got = sorted((q, p) for rr in range(cl) if rr != j
                                 for t, q, p in attn.xrs_messages(
                                     cl, rr, g, w, 2) if t == j)
                    assert got == [(q, q) for q in range(NQ)
                                   if attn.xrs_owner(cl, w, q) != j]
        assert max(pool) < attn.XRS_POOL and len(pool) <= 60
        assert sorted(pool) == list(range(len(pool)))
        assert len(pool) == 2 * attn.xrs_span(cl, j)
        # the bytes each round writes in CTA j: round 1's pool from the
        # slot's start, round 2's planes from r2 on
        one = (0, len(pool) * wplane)
        two = (r2, r2 + slot)
        assert one[1] <= slot and two[1] <= slots * slot
        if ds is not None:
            assert (ds[0] < one[1]) == (slots == 1)
            assert (ds[0] < two[1]) == (slots == 1)


def _exchange(parts, rank):
    """what CTA `rank` leaves with: tensors of partials (one a rank;
    element e is float e mod 32 of thread (e // 32) mod 256) sent through
    simulated slots by the model's stores: round 1 into the owners'
    pools, each owner's sums of its quads (xrs_sum), round 2 into the
    quads' planes (the kernel's own Xrs, with one slot and with two, runs
    in tests/xrs_sim.cpp)"""
    cl = len(parts)
    n = parts[0].numel()
    pad = -n % (THREADS * 32)
    xs = [torch.cat([p.reshape(-1), p.new_zeros(pad)]).reshape(
        -1, THREADS, NQ, 4) for p in parts]
    blocks = xs[0].shape[0]
    pool = [torch.full((attn.XRS_POOL, blocks, 32, 4), float("nan"))
            for _ in range(cl)]
    plane = [torch.full((NQ, blocks, THREADS, 4), float("nan"))
             for _ in range(cl)]

    def lanes(g, w):
        return slice(g * 128 + w * 32, g * 128 + w * 32 + 32)

    for r in range(cl):
        for g in range(THREADS // 128):
            for w in range(NW):
                for j, q, p in attn.xrs_messages(cl, r, g, w, 1):
                    pool[j][p] = xs[r][:, lanes(g, w), q]
    sums = [xs[j].clone() for j in range(cl)]
    for j in range(cl):
        for g in range(THREADS // 128):
            for w in range(NW):
                for q in range(NQ):
                    if attn.xrs_owner(cl, w, q) != j:
                        continue
                    got = [xs[j][:, lanes(g, w), q] if r == j else
                           pool[j][attn.xrs_wplane(cl, j, g, w, q, r)]
                           for r in range(cl)]
                    sums[j][:, lanes(g, w), q] = attn.xrs_sum(got)
    for j in range(cl):
        for g in range(THREADS // 128):
            for w in range(NW):
                for t, q, p in attn.xrs_messages(cl, j, g, w, 2):
                    plane[t][p, :, lanes(g, w)] = sums[j][:, lanes(g, w), q]
    out = sums[rank].clone()
    for g in range(THREADS // 128):
        for w in range(NW):
            for q in range(NQ):
                if attn.xrs_owner(cl, w, q) != rank:
                    out[:, lanes(g, w), q] = plane[rank][q, :, lanes(g, w)]
    assert not torch.isnan(out).any()
    return out.reshape(-1)[:n].reshape(parts[0].shape)


@pytest.mark.parametrize("cl", CLS)
@pytest.mark.parametrize("seed", [0, 1])
def test_every_rank_leaves_with_cluster_sums_bits(cl, seed):
    """random partials: each rank's 32 floats after both rounds are
    cluster_sum's bits, the tree of pairs' (the same at every rank), and
    past 3 CTAs (where the tree is (x0 + x1) + x2) the owner's sum is
    not the left-to-right sum on some of 2^14 elements"""
    rs = np.random.RandomState(100 + cl + 10 * seed)
    parts = [torch.from_numpy(rs.randn(1 << 14).astype(np.float32))
             for _ in range(cl)]
    want = attn.cluster_sum(parts)
    for r in range(cl):
        assert torch.equal(_exchange(parts, r), want)
        assert torch.equal(attn.cluster_sum(parts, r), want)
    left = parts[0]
    for p in parts[1:]:
        left = left + p
    assert torch.equal(want, left) == (cl == 3)


@pytest.mark.parametrize("cl", CLS)
def test_crafted_partials_show_the_tree(cl):
    """+2^40 and -2^40 at two ranks, ones elsewhere: the sum counts the
    ones added after the pair has met (an f32 1 is lost beside 2^40), so
    every placement of the pair shows where the tree joins it; the owner
    gives cluster_sum's count at every rank and every float"""
    big = float(2 ** 40)
    for a in range(cl):
        for b in range(cl):
            if a == b:
                continue
            parts = [torch.full((THREADS * 32,), big if r == a else
                                -big if r == b else 1.0) for r in range(cl)]
            want = attn.cluster_sum(parts)
            for r in range(cl):
                assert torch.equal(_exchange(parts, r), want)


@pytest.mark.parametrize("dh", [384, 512, 640, 768, 896, 1024])
@pytest.mark.parametrize("user,hybrid", USERS, ids=USER_IDS)
def test_plans_match_the_exchanges_budget(dh, user, hybrid):
    """K2: bwd_plan at dh 384 to 1024: the f32 class one 32 KB slot and
    four exchange barriers (two receipts, two reads), 230,968 bytes for
    dK/dV; the hybrid class two slots and two barriers, 165,944; dQ 512
    (1,024) bytes less (no lse and delta rows).  K1: fwd_plan's f32 class
    the dh-128 tiles, one slot and four barriers, 230,456 bytes (its
    hybrid class the wide route, no Xrs).  K3: fused_smem's f32 class
    the dh-256 route's 230,952 bytes and two barriers more, 230,968; its
    hybrid class two slots, ds^T's part and two barriers, 173,608.  Each
    is the source's static_assert and under the 232,448 bytes a CTA may
    have"""
    cl, parts = dh // 128, 1 if hybrid else 3
    if user == "k1":
        plan = attn.fwd_plan(16, 2048, dh, hybrid)
        src = _source("flash_fwd.cuh")
        if hybrid:
            assert plan.cluster in (1, 2) and "Xrs" not in src[
                src.index("struct Wide"):]
            return
        assert (plan.cluster, plan.smem) == (cl, 230456)
        assert f"Fwd<{dh}, 3, {cl}>::SMEM == 230456" in src
        assert "Xrs<CL < 3 ? 3 : CL, NT, 0, 1>::NBAR" in src
        assert plan.smem <= gemm.SM90_SMEM_LIMIT
        return
    if user == "k3":
        smem = attn.fused_smem(dh, parts)
        assert smem == (173608 if hybrid else 230968)
        assert attn.fused_plan(16, 2048, 1024, True, hybrid, dh).smem == smem
        suffix = ", 1" if hybrid else ""
        src = _source("flash_bwd_fused.cu")
        assert f"F6<{cl}{suffix}>::SMEM == {smem}" in src
        assert "SLOTS = CL > 2 && NP == 1 ? 2 : 1" in src
        assert smem <= gemm.SM90_SMEM_LIMIT
        return
    bwd = attn.bwd_plan(16, 2048, dh, hybrid)
    assert bwd.dq.cluster == bwd.dkv.cluster == cl
    assert attn.xrs_slots(hybrid) == (2 if hybrid else 1)
    assert attn.xrs_barriers(attn.xrs_slots(hybrid)) == (2 if hybrid else 4)
    assert (bwd.dq.smem, bwd.dkv.smem) == (
        (164920, 165944) if hybrid else (230456, 230968))
    assert bwd.dkv.smem <= gemm.SM90_SMEM_LIMIT == 232448
    src = _source("flash_bwd.cu")
    assert f"Bwd<{dh}, {parts}, {cl}>::SMEM_DKV == {bwd.dkv.smem}" in src
    if dh == 1024:
        assert f"Bwd<1024, {parts}, 8>::SMEM_DQ == {bwd.dq.smem}" in src
    assert "static constexpr int NBAR = SLOTS == 1 ? 4 : 2;" in _source(
        "sm90_gemm.cuh")


@pytest.mark.parametrize("dh,causal", [(384, True), (640, False),
                                       (1024, True)])
def test_split_ref_through_the_exchange_holds_pallas(dh, causal,
                                                     monkeypatch):
    """the f32 class's plain backward with its scores' partials summed
    through the simulated exchange (rank 0's result): the same bits as
    with cluster_sum, and within 2e-4 (absolute plus relative) of the JAX
    package's Pallas backward in interpret mode, with an lse cotangent,
    on the Pallas forward's o and lse"""
    q, k, v, do, dlse = _inputs(dh, 61 + causal)
    cl = dh // 128
    (oj, lj), want = _pallas(q, k, v, do, dlse, causal, False)
    plain = attn.flash_attention_bwd_split_ref(q, k, v, oj, lj, do, causal,
                                               3, dlse, cl)
    monkeypatch.setattr(attn, "cluster_sum",
                        lambda parts, rank=0: _exchange(parts, rank))
    got = attn.flash_attention_bwd_split_ref(q, k, v, oj, lj, do, causal, 3,
                                             dlse, cl)
    assert all(torch.equal(g, p) for g, p in zip(got, plain))
    assert _ratio(got, want, TOL_BWD) <= 1


@pytest.mark.parametrize("mode", ["k2", "k1", "k3", "k3-early"])
def test_the_kernels_exchange_on_a_simulated_cluster(tmp_path, mode):
    """the source's Xrs itself (sm90_gemm.cuh, from its comment to the
    per-rank macro), built by g++ against host stand-ins for shared
    memory, mbarriers and st.async (tests/xrs_sim.cpp), called as each
    user calls it: at every cluster size 3 to 8 (K2 and K3 one slot and
    two, K1 one), 256 threads a CTA over 4 tiles, every rank's floats come
    back as the tree's sum, K3's ds^T as written, no wait hangs and every
    piece is aligned; with K3's free-arrival before its ds^T stores
    (k3-early, rank 0 held until the peers' next round 1 has landed in
    its slot) ds^T overwrites their partials, and the sums come back
    wrong at every cluster size"""
    gxx = shutil.which("g++")
    assert gxx is not None, "g++ builds the simulation"
    src = _source("sm90_gemm.cuh")
    a = src.index("// ---- the clusters' balanced exchange (Xrs)")
    b = src.index("// `stmt` with `xr` the CTA's Xrs")
    (tmp_path / "xrs_body.h").write_text(src[a:b])
    sim = os.path.join(os.path.dirname(__file__), "xrs_sim.cpp")
    exe = tmp_path / "xrs_sim"
    subprocess.run([gxx, "-std=c++17", "-O0", "-pthread", "-I",
                    str(tmp_path), "-o", str(exe), sim], check=True,
                   capture_output=True)
    run = subprocess.run([str(exe), mode], capture_output=True, text=True,
                         timeout=300)
    lines = run.stdout.splitlines()
    assert run.returncode == 0, run.stdout + run.stderr
    assert len(lines) == (6 if mode in ("k1", "k3-early") else 12)
    counts = [tuple(int(x) for x in re.findall(r"(\d+) (?:mismatches|ds)",
                                              ln)) for ln in lines]
    if mode == "k3-early":
        assert all(sums > 0 for sums, _ in counts), lines
    else:
        assert all(c == (0, 0) for c in counts), lines
