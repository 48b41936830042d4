"""The port's kernels (plain versions, which the wrappers run for CPU tensors)
against the reference's Pallas kernels in interpret mode and their ref.py
oracles, with tests/test_kernels.py's shapes. The CUDA kernels themselves are
held against these plain versions on the card by chip_smoke.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import pq as rpq
from repro.kernels.flat_l2.kernel import flat_l2_pallas
from repro.kernels.flat_l2.ref import flat_l2_ref
from repro.kernels.pq_adc.kernel import pq_adc_pallas
from repro.kernels.pq_adc.ref import pq_adc_ref
from repro.kernels.pq_encode.kernel import pq_encode_pallas
from repro.kernels.pq_encode.ref import pq_encode_ref
from repro.kernels.topk_select.kernel import topk_select_pallas
from repro.kernels.topk_select.ref import topk_select_ref
from repro_torch import kernels as K
from repro_torch.core import pq as tpq
from repro_torch.kernels.pq_adc import ops as adc_ops
from repro_torch.kernels.topk_select.ops import (LONG_MAX_L, LONG_MIN_CHUNK, RADIX_MIN_CHUNK,
                                                 RANK_MAX_N, SORT_MAX_N, kernels_per_call,
                                                 long_chunks, radix_plan, sort_keys, topk_form)

INTERP = dict(interpret=True)


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("form", ["dense", "gathered"])
@pytest.mark.parametrize("B,C,M,Kc,block", [
    (1, 100, 8, 256, 64),
    (4, 1000, 16, 256, 256),
    (2, 513, 8, 256, 512),
    (3, 64, 4, 16, 128),
])
def test_pq_adc(B, C, M, Kc, block, form):
    rng = np.random.RandomState(B * 100 + C)
    if form == "dense":
        lut = rng.randn(B, M, Kc).astype(np.float32)
        codes = rng.randint(0, Kc, (C, M)).astype(np.uint8)
        got = K.pq_adc(t(lut[:, None]), t(codes), torch.zeros(C, dtype=torch.uint8)).numpy()
        ref = np.asarray(pq_adc_ref(jnp.asarray(lut), jnp.asarray(codes)))
        pallas = np.asarray(pq_adc_pallas(jnp.asarray(lut), jnp.asarray(codes), block_c=block,
                                          **INTERP))
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got, pallas, rtol=1e-5, atol=1e-5)
        return
    # gathered + versioned: two coexisting schemas, candidate ids per query
    V, N = 2, 2 * C
    luts = rng.randn(B, V, M, Kc).astype(np.float32)
    codes = rng.randint(0, Kc, (N, M)).astype(np.uint8)
    versions = rng.randint(0, V, (N,)).astype(np.uint8)
    ids = rng.randint(0, N, (B, C)).astype(np.int32)
    ids[:, ::5] = -1  # padding lanes: any value, masked by the caller
    got = K.pq_adc(t(luts), t(codes), t(versions), t(ids)).numpy()
    for b in range(B):
        safe = np.maximum(ids[b], 0)
        ref = np.asarray(rpq.adc_distance_versioned(
            jnp.asarray(luts[b]), jnp.asarray(codes[safe]), jnp.asarray(versions[safe])))
        ok = ids[b] >= 0
        np.testing.assert_allclose(got[b][ok], ref[ok], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("N,M,dsub,Kc,block", [
    (100, 4, 8, 256, 64),
    (257, 8, 4, 256, 128),
    (64, 2, 16, 64, 256),
])
def test_pq_encode(N, M, dsub, Kc, block):
    rng = np.random.RandomState(N)
    x = rng.randn(N, M * dsub).astype(np.float32)
    cb = rng.randn(M, Kc, dsub).astype(np.float32)
    got = K.pq_encode(t(x), t(cb)).numpy()
    assert got.dtype == np.uint8
    core = np.asarray(rpq.encode(rpq.PQSchema(jnp.asarray(cb), jnp.int32(0)), jnp.asarray(x)))
    np.testing.assert_array_equal(got, core)
    np.testing.assert_array_equal(got, np.asarray(pq_encode_ref(jnp.asarray(x), jnp.asarray(cb))))
    np.testing.assert_array_equal(
        got, np.asarray(pq_encode_pallas(jnp.asarray(x), jnp.asarray(cb), block_n=block, **INTERP)))


@pytest.mark.parametrize("data", ["normal", "ties"])
@pytest.mark.parametrize("B,N,L,block", [
    (1, 2048, 16, 512),
    (3, 5000, 32, 1024),
    (2, 100, 10, 256),
    (2, 20_000, 50, None),  # the Q-Flat cut's L on a long row; too long for interpret mode
    (2, 1414, 1250, None),  # the beam merge at k=250 (L = k' = 1250): the sort form
    (2, 1025, 1025, None),  # L = N just past the rank form
    (2, 20_000, 1025, None),  # the radix form, L just past the long form
    (1, 20_000, 20_000, None),  # the radix form, L = N past one sort block: merged runs
])
def test_topk_select(B, N, L, block, data):
    rng = np.random.RandomState(N + L)
    if data == "normal":
        d = rng.randn(B, N).astype(np.float32)
    else:  # integer-valued floats: many exact ties; +inf entries, one row mostly inf
        d = rng.randint(0, 8, (B, N)).astype(np.float32)
        d[rng.rand(B, N) < 0.2] = np.inf
        d[-1, : N - L // 2] = np.inf
    v, i = K.topk_select(t(d), L, mark_nonfinite=True)
    v2, i2 = topk_select_ref(jnp.asarray(d), L=L)
    np.testing.assert_array_equal(i.numpy(), np.asarray(i2))  # indices, ties included
    np.testing.assert_array_equal(v.numpy(), np.asarray(v2))
    if block is not None:
        v3, i3 = topk_select_pallas(jnp.asarray(d), L=L, block_n=block, **INTERP)
        np.testing.assert_array_equal(i.numpy(), np.asarray(i3))
        np.testing.assert_array_equal(v.numpy(), np.asarray(v3))
    # without marking: raw positions, +inf entries too, in stable-sort order
    v4, i4 = K.topk_select(t(d), L)
    np.testing.assert_array_equal(i4.numpy(), np.argsort(d, axis=1, kind="stable")[:, :L])
    np.testing.assert_array_equal(v4.numpy(), v.numpy())


@pytest.mark.parametrize("B,N,L", [
    (128, 100_000, 10), (128, 100_000, 50), (1, 4096, LONG_MAX_L), (3, 1025, 10),
    (2, 99_991, 50), (1, 1025, 1024), (7, 5003, 20), (1, 3_000_000, 1), (4096, 2000, 7),
])
def test_topk_long_chunks(B, N, L):
    """The long form's plan: S chunks of ``chunk`` entries cover the row, none
    empty, 16-byte aligned; each at least max(L, LONG_MIN_CHUNK) unless the
    row is shorter, so the merge reads S*L <= max(N, L) keys. Taking the L
    smallest of each chunk (stable, ties to the lower position) and then of
    their union is the L smallest of the row, ties included."""
    S, chunk = long_chunks(B, N, L)
    assert chunk % 4 == 0 and S >= 1
    assert (S - 1) * chunk < N <= S * chunk
    assert chunk >= min(N, max(L, LONG_MIN_CHUNK))
    assert S * L <= max(N, L)
    rng = np.random.RandomState(N + L)
    row = rng.randint(0, 8, N).astype(np.float32)  # heavy ties
    row[rng.rand(N) < 0.2] = np.inf
    kept = np.concatenate([c * chunk + np.argsort(row[c * chunk:(c + 1) * chunk], kind="stable")[:L]
                           for c in range(S)])
    merged = kept[np.lexsort((kept, row[kept]))][:L]
    np.testing.assert_array_equal(merged, np.argsort(row, kind="stable")[:L])


def _tf32(a):
    """a (f32) rounded to TF32's 10-bit mantissa, nearest with ties away (cvt.rna)."""
    return ((a.view(np.uint32) + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _tf32_trunc(a):
    """What a TF32 tensor core reads of an f32 register: the low 13 bits dropped."""
    return (a.view(np.uint32) & np.uint32(0xFFFFE000)).view(np.float32)


def test_flat_l2_3xtf32_split_error():
    """The dense kernel's arithmetic at D=768, emulated: each operand a as its
    TF32 bits hi = trunc(a) and the remainder lo = a - hi (of which the tensor
    core reads the TF32 bits), lo*hi + hi*lo + hi*hi summed in exact products
    per k8 step and f32 between steps, f32 norms. Against float64 it stays
    under chip_smoke's f32 limit 2*sqrt(D)*eps32*max(|q|^2 + |x|^2); the same
    sum of plain TF32 products (inputs rounded to nearest) exceeds it, so the
    limit tells the two apart."""
    B, N, D = 32, 256, 768
    rng = np.random.RandomState(768)
    q = rng.randn(B, D).astype(np.float32)
    x = rng.randn(N, D).astype(np.float32)
    q64, x64 = q.astype(np.float64), x.astype(np.float64)
    want = (q64 ** 2).sum(1)[:, None] + (x64 ** 2).sum(1)[None] - 2 * q64 @ x64.T
    limit = 2 * np.sqrt(D) * np.finfo(np.float32).eps * ((q64 ** 2).sum(1).max()
                                                        + (x64 ** 2).sum(1).max())

    def distances(products):
        acc = np.zeros((B, N), np.float32)
        for k in range(0, D, 8):
            for a, b in products(q[:, k:k + 8], x[:, k:k + 8]):
                acc = (acc + (a.astype(np.float64) @ b.T.astype(np.float64))
                       .astype(np.float32)).astype(np.float32)
        qn = (q * q).sum(1, dtype=np.float32)
        xn = (x * x).sum(1, dtype=np.float32)
        return np.maximum(qn[:, None] + xn[None] - np.float32(2) * acc, 0).astype(np.float64)

    def three(a, b):
        ah, bh = _tf32_trunc(a), _tf32_trunc(b)
        al, bl = _tf32_trunc(a - ah), _tf32_trunc(b - bh)
        return [(al, bh), (ah, bl), (ah, bh)]

    err_3x = np.abs(distances(three) - want).max()
    err_1x = np.abs(distances(lambda a, b: [(_tf32(a), _tf32(b))]) - want).max()
    assert err_3x <= limit / 4, (err_3x, limit)
    assert err_1x > limit, (err_1x, limit)


@pytest.mark.parametrize("B,N,D,metric,dtype", [
    (16, 128, 64, "l2", "f32"),
    (50, 333, 96, "l2", "f32"),
    (8, 64, 32, "ip", "f32"),
    (129, 257, 100, "l2", "f32"),  # ragged everything
    (16, 64, 64, "l2", "bf16"),
    (129, 257, 100, "l2", "bf16"),  # ragged B and N
    (8, 64, 32, "ip", "bf16"),
    (12, 40, 37, "l2", "bf16"),  # D % 8 != 0: the kernel's narrow copy path
    (12, 40, 48, "l2", "gathered"),
    (7, 30, 20, "ip", "gathered"),
])
def test_flat_l2(B, N, D, metric, dtype):
    rng = np.random.RandomState(B + N + D)
    q = rng.randn(B, D).astype(np.float32)
    x = rng.randn(N, D).astype(np.float32)
    if dtype == "gathered":
        ids = rng.randint(0, N, (B, 9)).astype(np.int32)
        got = K.flat_l2_gathered(t(q), t(x), t(ids), metric).numpy()
        ref = np.asarray(rpq.exact_distance(jnp.asarray(q)[:, None, :], jnp.asarray(x[ids]),
                                            metric))
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
        return
    # bf16 too: both sides compute in f32 on the same bf16-rounded values
    tol = 2e-3
    if dtype == "bf16":
        qj, xj = jnp.asarray(q).astype(jnp.bfloat16), jnp.asarray(x).astype(jnp.bfloat16)
        qt, xt = t(q).bfloat16(), t(x).bfloat16()
    else:
        qj, xj, qt, xt = jnp.asarray(q), jnp.asarray(x), t(q), t(x)
    got = K.flat_l2(qt, xt, metric).numpy()
    np.testing.assert_allclose(got, np.asarray(flat_l2_ref(qj, xj, metric=metric)),
                               rtol=tol, atol=tol)
    pallas = flat_l2_pallas(qj, xj, block_b=32, block_n=64, block_d=32, metric=metric, **INTERP)
    np.testing.assert_allclose(got, np.asarray(pallas), rtol=tol, atol=tol)


def test_wrappers_count_only_kernel_launches():
    """On CPU tensors the wrappers run the plain versions: no launch counted."""
    K.reset_launch_counts()
    K.topk_select(torch.zeros(2, 8), 3)
    K.pq_adc(torch.zeros(1, 1, 2, 4), torch.zeros(3, 2, dtype=torch.uint8),
             torch.zeros(3, dtype=torch.uint8))
    K.flat_l2_gathered(torch.zeros(1, 4), torch.zeros(3, 4), torch.zeros(1, 2, dtype=torch.int32))
    K.flat_l2(torch.zeros(2, 4), torch.zeros(3, 4))
    K.topk_select(torch.zeros(2, 3000), 20)
    K.topk_select(torch.zeros(2, 1414), 1250)
    K.topk_select(torch.zeros(1, 20_000), 1025)
    assert K.launch_counts() == {"pq_adc.gathered": 0, "pq_adc.gathered_l2": 0,
                                 "pq_adc.dense": 0, "topk_select.rank": 0,
                                 "topk_select.long": 0, "topk_select.sort": 0,
                                 "topk_select.radix": 0,
                                 "flat_l2.dense": 0, "flat_l2.dense_bf16": 0,
                                 "flat_l2.gathered": 0, "pq_encode": 0}


# -- form choice of the two kernels every beam round launches ----------------


@pytest.mark.parametrize("C,V,M,Kc,gathered,form", [
    (164, 2, 96, 256, True, "gathered"),  # a beam round after re-quantization
    (164, 1, 96, 256, True, "gathered"),  # a beam round before it
    (1, 2, 96, 256, True, "gathered_l2"),  # the search's start node
    (41, 2, 96, 256, True, "gathered_l2"),  # the build's beam (W=1)
    (41, 1, 96, 256, True, "gathered_l2"),
    (99, 2, 96, 256, True, "gathered_l2"),
    (100, 2, 96, 256, True, "gathered"),
    (164, 3, 96, 256, True, "gathered_l2"),  # a table past one block's shared memory
    (164, 2, 192, 256, True, "gathered_l2"),
    (164, 5, 96, 256, True, "gathered_l2"),
    (164, 2, 8, 16, True, "gathered"),
    (200, 2, 37, 256, True, "gathered"),
    (164, 2, 96, 6, True, "gathered_l2"),  # K % 4: rows of the table not 16-byte multiples
    (100_000, 2, 96, 256, False, "dense"),  # Q-Flat
    (100_000, 3, 96, 256, False, "gathered_l2"),  # its table does not fit a block
    (5, 2, 96, 256, False, "gathered_l2"),  # adc_distance_versioned on a few rows
])
def test_adc_form(C, V, M, Kc, gathered, form):
    """pq_adc's form by shape alone; a shape sent to the staged form fits a
    block's shared memory, computed from V, M and K."""
    assert adc_ops.adc_form(C, V, M, Kc, gathered) == form
    if form == "gathered":
        assert adc_ops.staged_smem_bytes(V, M, Kc) <= 232_448
    # the path's own calls: the start node and adc_distance_versioned's few rows
    assert adc_ops.adc_form(1, V, M, Kc, True) == "gathered_l2"
    assert adc_ops.adc_form(1, V, M, Kc, False) == "gathered_l2"


def test_adc_staged_smem_bound():
    """No shape that adc_form sends to the staged form exceeds a block's
    232 448 bytes; at M=96, K=256 one block stages up to V=2 schemas, and
    larger tables take the l2 form."""
    for V in range(1, 7):
        for M in (1, 2, 8, 16, 37, 64, 96, 128, 192, 384):
            for Kc in (4, 16, 64, 256):
                if adc_ops.adc_form(10_000, V, M, Kc, True) == "gathered":
                    assert adc_ops.staged_smem_bytes(V, M, Kc) <= adc_ops.SMEM_PER_BLOCK
    forms = [adc_ops.adc_form(164, V, 96, 256, True) for V in range(1, 6)]
    assert forms == ["gathered", "gathered", "gathered_l2", "gathered_l2", "gathered_l2"]


def _staged_chunks(M, max_chunks=8):
    """kernel.cu's partition of a staged block's subspaces into chunks."""
    Mc = 4 * -(-M // (4 * max_chunks))
    chunks = -(-M // Mc) if Mc else 0
    return [(j * Mc, min(M, (j + 1) * Mc)) for j in range(chunks)]


def test_adc_staged_chunks_cover():
    """The chunks of a query's table cover [0, M) once, in order, at most 8
    of them, each a multiple of 4 subspaces but the last."""
    for M in range(1, 200):
        ch = _staged_chunks(M)
        assert [m for lo, hi in ch for m in range(lo, hi)] == list(range(M))
        assert len(ch) <= 8
        assert all((hi - lo) % 4 == 0 for lo, hi in ch[:-1])


def _staged_sum(terms, lanes=2):
    """The staged form's order of addition, emulated in f32: each of a
    candidate's lanes sums ceil(M/lanes) subspaces in order, and lane 0's sum
    takes lane 1's."""
    C, M = terms.shape
    mh = -(-M // lanes)
    total = None
    for m0 in range(0, M, mh):
        acc = np.zeros(C, np.float32)
        for m in range(m0, min(M, m0 + mh)):
            acc = (acc + terms[:, m]).astype(np.float32)
        total = acc if total is None else (total + acc).astype(np.float32)
    return total


@pytest.mark.parametrize("V,M,Kc", [(2, 96, 256), (1, 37, 16), (2, 8, 16), (2, 3, 16)])
def test_adc_staged_sum_order(V, M, Kc):
    """The staged form's arithmetic, emulated: each candidate's terms summed
    in f32 in the order the kernel adds them (per lane of the candidate). It
    matches repro.core.pq.adc_distance_versioned within 1e-5, as the plain
    version does."""
    rng = np.random.RandomState(V * 1000 + M)
    B, C, N = 3, 40, 90
    luts = rng.randn(B, V, M, Kc).astype(np.float32)
    codes = rng.randint(0, Kc, (N, M)).astype(np.uint8)
    versions = rng.randint(0, V, (N,)).astype(np.uint8)
    ids = rng.randint(0, N, (B, C)).astype(np.int32)
    for b in range(B):
        r = ids[b]
        v = np.minimum(versions[r], V - 1)
        terms = luts[b][v[:, None], np.arange(M)[None], codes[r]]  # (C, M)
        got = _staged_sum(terms)
        want = np.asarray(rpq.adc_distance_versioned(
            jnp.asarray(luts[b]), jnp.asarray(codes[r]), jnp.asarray(versions[r])))
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_adc_distance_versioned_matches_reference():
    """The port's adc_distance_versioned (the call adc_form sends to the l2
    form on the card when the rows are few) against the reference's."""
    rng = np.random.RandomState(5)
    luts = rng.randn(2, 8, 256).astype(np.float32)
    codes = rng.randint(0, 256, (5, 8)).astype(np.uint8)
    versions = rng.randint(0, 2, (5,)).astype(np.uint8)
    got = tpq.adc_distance_versioned(t(luts), t(codes), t(versions)).numpy()
    want = np.asarray(rpq.adc_distance_versioned(jnp.asarray(luts), jnp.asarray(codes),
                                                 jnp.asarray(versions)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert adc_ops.adc_form(5, 2, 8, 256, False) == "gathered_l2"


@pytest.mark.parametrize("B,N,L,form", [
    (128, 264, 100, "rank"),  # beam merge
    (128, 100, 4, "rank"),  # frontier pick
    (128, 50, 10, "rank"),  # rerank cut
    (100, 316, 32, "rank"),  # prune cut
    (128, RANK_MAX_N, 10, "rank"),
    (128, RANK_MAX_N + 1, 10, "long"),
    (128, 100_000, 50, "long"),
    (128, 100_000, LONG_MAX_L + 1, "radix"),
    (128, 1414, 1250, "sort"),  # the beam merge at k=250: L + W * R_slack = 1250 + 164
    (128, 1250, 250, "long"),  # the rerank cut at k=250
    (128, LONG_MAX_L + 1, LONG_MAX_L + 1, "sort"),
    (128, SORT_MAX_N, 5000, "sort"),
    (128, SORT_MAX_N + 1, 1025, "radix"),
    (128, 100_000, 1250, "radix"),  # Q-Flat at k'=1250
    (128, 100_000, 5000, "radix"),
    (128, 100_000, 100_000, "radix"),
])
def test_topk_form(B, N, L, form):
    assert topk_form(N, L) == form
    if form == "sort":
        P = sort_keys(N)
        assert N <= P <= SORT_MAX_N and P & (P - 1) == 0 and kernels_per_call(B, N, L) == 1


def _key(x, i):
    """kernel.cu's make_key: order-preserving value bits << 32 | position."""
    x = np.float32(0.0) if x == 0 else np.float32(x)
    if np.isnan(x):
        u = 0xFFFFFFFF
    else:
        bits = int(np.array([x], np.float32).view(np.uint32)[0])
        u = (~bits & 0xFFFFFFFF) if bits & 0x80000000 else (bits | 0x80000000)
    return (u << 32) | i


def _bitonic(keys):
    """The rank form's network as kernel.cu runs it on P keys: each stage
    pairs i with i ^ j, and the lower of a pair keeps the min when
    (i & k) == 0 (whichever thread holds i)."""
    v = list(keys)
    P = len(v)
    k = 2
    while k <= P:
        j = k // 2
        while j > 0:
            nxt = list(v)
            for i in range(P):
                o = v[i ^ j]
                keep_min = ((i & j) == 0) == ((i & k) == 0)
                nxt[i] = min(v[i], o) if keep_min else max(v[i], o)
            v = nxt
            j //= 2
        k *= 2
    return v


@pytest.mark.parametrize("N", [1, 2, 33, 50, 100, 264, 316])
def test_topk_sort_network(N):
    """Emulated, the rank form's network on tie-heavy rows with +inf, NaN,
    -0.0 and padding orders the keys as the stable sort does, so its first L
    are NumPy's stable order and the reference's answer for every L
    (positions of +-inf and NaN marked -1, as the reference marks them). The
    keys tie -0.0 with +0.0, as NumPy does; the reference orders -0.0 first,
    so it gets the row with -0.0 written as +0.0, which has the same keys."""
    rng = np.random.RandomState(N)
    row = rng.randint(0, 6, N).astype(np.float32)
    row[rng.rand(N) < 0.2] = np.inf
    row[rng.rand(N) < 0.1] = np.nan
    row[rng.rand(N) < 0.1] = -0.0
    row[rng.rand(N) < 0.05] = -np.inf
    P = max(32, 1 << (N - 1).bit_length())
    keys = [_key(x, i) for i, x in enumerate(row)] + [2 ** 64 - 1] * (P - N)
    got = np.array([k & 0xFFFFFFFF for k in _bitonic(keys)[:N]])
    np.testing.assert_array_equal(got, np.argsort(row, kind="stable"))
    pos = np.where(row == 0, np.float32(0.0), row)
    vals, want = topk_select_ref(jnp.asarray(pos[None]), L=N)
    np.testing.assert_array_equal(np.where(np.isfinite(pos[got]), got, -1), np.asarray(want[0]))
    np.testing.assert_array_equal(pos[got], np.asarray(vals[0]))


# -- the l2 form of pq_adc: its order of addition ----------------------------


def _l2_sum(terms, groups=4):
    """The l2 form's order of addition (adc_l2_kernel), emulated in f32:
    warp g of a candidate's block adds its subspaces [g*Mg, (g+1)*Mg) in
    order, Mg = unit * ceil(M / unit / groups) with the code unit 8 when M %
    8 == 0 (8-byte aligned codes, as a fresh tensor's are), else 1; warp 0
    then adds the partial sums in warp order."""
    C, M = terms.shape
    unit = 8 if M % 8 == 0 else 1
    Mg = unit * -(-(M // unit) // groups)
    total = None
    for g in range(groups):
        acc = np.zeros(C, np.float32)
        for m in range(min(M, g * Mg), min(M, g * Mg + Mg)):
            acc = (acc + terms[:, m]).astype(np.float32)
        total = acc if total is None else (total + acc).astype(np.float32)
    return total


@pytest.mark.parametrize("V,M,Kc", [(2, 96, 256), (1, 96, 256), (2, 192, 256), (2, 36, 64),
                                    (2, 40, 64), (1, 37, 16), (2, 8, 16), (2, 3, 16),
                                    (2, 150, 16)])
def test_adc_l2_sum_order(V, M, Kc):
    """The l2 form's arithmetic, emulated (each warp's share of the
    subspaces, then the shares in warp order): against the port's plain
    version and repro.core.pq.adc_distance_versioned within 1e-5."""
    rng = np.random.RandomState(V * 1000 + M + Kc)
    B, C, N = 3, 41, 90
    luts = rng.randn(B, V, M, Kc).astype(np.float32)
    codes = rng.randint(0, Kc, (N, M)).astype(np.uint8)
    versions = rng.randint(0, 2, (N,)).astype(np.uint8)  # a version past V - 1 clamps
    ids = rng.randint(0, N, (B, C)).astype(np.int32)
    plain = K.pq_adc(t(luts), t(codes), t(versions), t(ids)).numpy()
    for b in range(B):
        r = ids[b]
        v = np.minimum(versions[r], V - 1)
        terms = luts[b][v[:, None], np.arange(M)[None], codes[r]]  # (C, M)
        got = _l2_sum(terms)
        want = np.asarray(rpq.adc_distance_versioned(
            jnp.asarray(luts[b]), jnp.asarray(codes[r]), jnp.asarray(v.astype(np.uint8))))
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got, plain[b], rtol=1e-5, atol=1e-5)


# -- pq_encode: K split over the lanes of a warp ----------------------------


def _encode_split(x, cb, lanes=32):
    """pq_encode_kernel's arithmetic, emulated in f32: lane l scores
    centroids k = l + 32 s in order as (xx - 2 dot) + |c|^2 (dot, xx and the
    norm summed in j order), keeps a score only when it is below its best
    (from +inf, with k = K for none), and the lanes' (score, k) merge to the
    smaller score, on equal scores the lower k (a lexicographic min, so the
    shuffle tree's shape does not change it; here a xor butterfly); k = K
    ends as 0."""
    N, D = x.shape
    M, Kc, dsub = cb.shape
    sub = x.reshape(N, M, dsub)
    codes = np.zeros((N, M), np.uint8)
    f = np.float32
    for n in range(N):
        for m in range(M):
            xv = sub[n, m]
            xx = f(0)
            for j in range(dsub):
                xx = f(xx + f(xv[j] * xv[j]))
            best = [(f(np.inf), Kc)] * lanes
            for k in range(Kc):
                c = cb[m, k]
                dot, nrm = f(0), f(0)
                for j in range(dsub):
                    dot = f(dot + f(xv[j] * c[j]))
                    nrm = f(nrm + f(c[j] * c[j]))
                dk = f(f(xx - f(2 * dot)) + nrm)
                lane = k % lanes
                if dk < best[lane][0]:
                    best[lane] = (dk, k)
            o = lanes // 2
            while o:
                best = [min(best[h], best[h ^ o]) for h in range(lanes)]  # (score, k) order
                o //= 2
            codes[n, m] = best[0][1] if best[0][1] < Kc else 0
    return codes


@pytest.mark.parametrize("Kc", [16, 64, 256])
@pytest.mark.parametrize("dsub", [2, 3, 4, 6, 8, 16, 32])
def test_pq_encode_split_argmin(dsub, Kc):
    """On tie-heavy inputs (integer coordinates, so every score is exact;
    centroids duplicated; rows equidistant to several centroids) the split
    argmin gives the first index of the smallest score: bit-equal to the
    port's plain version, the JAX reference and its Pallas kernel
    (interpret mode)."""
    rng = np.random.RandomState(dsub * 1000 + Kc)
    M, N = 2, 24
    cb = rng.randint(-2, 3, (M, Kc, dsub)).astype(np.float32)
    cb[:, Kc // 2:] = cb[:, : Kc - Kc // 2]  # every centroid twice, the copy at k + K/2
    cb[:, 33 % Kc] = cb[:, 2]  # a copy at a higher k in a lower lane
    x = rng.randint(-2, 3, (N, M * dsub)).astype(np.float32)
    x[: N // 2] = 0  # equidistant to every centroid of one norm
    # halfway between two centroids: equal scores from two lanes
    x[N // 2, :dsub] = (cb[0, 1] + cb[0, 2]) / 2
    got = _encode_split(x, cb)
    np.testing.assert_array_equal(got, K.pq_encode(t(x), t(cb)).numpy())
    np.testing.assert_array_equal(got, np.asarray(pq_encode_ref(jnp.asarray(x), jnp.asarray(cb))))
    np.testing.assert_array_equal(
        got, np.asarray(pq_encode_pallas(jnp.asarray(x), jnp.asarray(cb), block_n=8, **INTERP)))


# -- the device-time yardstick's window rule --------------------------------


def _chip_smoke():
    import importlib.util
    from pathlib import Path

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("named,iters,per_call,whole", [
    (20, 10, 2, True),  # two kernels a call (the long top-k: chunk and merge), all kept
    (10, 10, 2, False),  # one of each call's two kernels lost
    (19, 10, 2, False),  # one event lost
    (21, 10, 2, False),  # something else ran in the window
    (200, 200, 1, True),
    (199, 200, 1, False),
    (0, 200, 1, False),
    (0, 10, 0, False),  # no kernel a call: nothing to time
])
def test_device_ms_window_rule(named, iters, per_call, whole):
    """chip_smoke.device_ms takes a profiler window only when it holds
    exactly iters x the kernels one call launches."""
    assert _chip_smoke().window_whole(named, iters, per_call) is whole


# -- the dense form of pq_adc: bank-per-lane layout and order of addition ----


@pytest.mark.parametrize("M", [1, 3, 8, 37, 64, 96, 100, 128, 150, 224])
@pytest.mark.parametrize("pairs", [False, True])
def test_adc_dense_layout(M, pairs):
    """The dense form's lane plan gives every subspace one (slot, lane), and
    its words are a bijection onto the staged table with lane i in bank i."""
    npairs = adc_ops.dense_pairs(M) if pairs else 0
    slots, K, V = -(-M // 32), 4, 2
    seen = [adc_ops.dense_subspace(s, i, M, npairs) for s in range(slots) for i in range(32)]
    assert sorted(m for m in seen if m >= 0) == list(range(M))
    words = [adc_ops.dense_word(v, s, c, i, K, V) for v in range(V) for s in range(slots)
             for c in range(K) for i in range(32)]
    assert sorted(words) == list(range(adc_ops.dense_smem_bytes(V, M, K) // 4))
    assert all(w % 32 == i for w, i in zip(words, [i for _ in range(V * slots * K)
                                                  for i in range(32)]))


def _dense_sum(luts_b, codes, versions, M, pairs):
    """The dense form's order of addition, emulated in f32: lane i sums its
    slots of a row in slot order from the first ((t_0 + t_1) + t_2 ...; a
    slot with no subspace adds the staged 0), and the 32 lane partials
    combine as a butterfly, lane distance 16 first (the reduce-scatter keeps
    exactly those adds)."""
    V, _, Kc = luts_b.shape
    slots = -(-M // 32)
    n = codes.shape[0]
    v = np.minimum(versions, V - 1)
    part = np.zeros((n, 32), np.float32)
    for s in range(slots):
        for i in range(32):
            m = adc_ops.dense_subspace(s, i, M, pairs)
            term = luts_b[v, m, codes[:, m]] if m >= 0 else np.zeros(n, np.float32)
            part[:, i] = term if s == 0 else (part[:, i] + term).astype(np.float32)
    for o in (16, 8, 4, 2, 1):
        part = (part + part[:, np.arange(32) ^ o]).astype(np.float32)
    return part[:, 0]


@pytest.mark.parametrize("V,M,Kc", [(2, 96, 256), (1, 37, 16), (2, 8, 16), (2, 3, 16)])
def test_adc_dense_sum_order(V, M, Kc):
    """The dense form's arithmetic, emulated with and without the pair
    groups: against repro.core.pq.adc_distance_versioned and the port's
    plain version within 1e-5."""
    rng = np.random.RandomState(V * 100 + M + Kc)
    B, N = 2, 300
    luts = rng.randn(B, V, M, Kc).astype(np.float32)
    codes = rng.randint(0, Kc, (N, M)).astype(np.uint8)
    versions = rng.randint(0, 2, (N,)).astype(np.uint8)  # a version past V - 1 clamps
    plain = K.pq_adc(t(luts), t(codes), t(versions)).numpy()
    for b in range(B):
        want = np.asarray(rpq.adc_distance_versioned(
            jnp.asarray(luts[b]), jnp.asarray(codes),
            jnp.asarray(np.minimum(versions, V - 1).astype(np.uint8))))
        for pairs in sorted({0, adc_ops.dense_pairs(M)}):
            got = _dense_sum(luts[b], codes, versions, M, pairs)
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
            np.testing.assert_allclose(got, plain[b], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("C,V,M,Kc,form", [
    (100_000, 2, 96, 256, "dense"),  # Q-Flat at the paper configuration
    (100_000, 1, 37, 16, "dense"),
    (100_000, 2, 96, 6, "gathered_l2"),  # K % 4: the table's float4 staging
    (100_000, 9, 8, 16, "gathered_l2"),  # versions past the three ballots
    (100_000, 2, 224, 128, "dense"),  # 7 slots, 229 376 bytes
    (100_000, 2, 256, 128, "gathered_l2"),  # 8 slots: past the block's shared memory
])
def test_adc_dense_form(C, V, M, Kc, form):
    assert adc_ops.adc_form(C, V, M, Kc, False) == form
    if form == "dense":
        assert adc_ops.dense_smem_bytes(V, M, Kc) <= adc_ops.SMEM_PER_BLOCK


# -- topk_select for L > 1024: the radix select and the merge of sorted runs --


def _order_bits(x):
    """kernel.cu's order_bits on f32: NaN above +inf, -0.0 equal to +0.0."""
    x = np.where(x == 0, np.float32(0), x).astype(np.float32)
    bits = x.view(np.uint32).astype(np.uint64)
    u = np.where(bits & 0x80000000, ~bits & 0xFFFFFFFF, bits | 0x80000000)
    return np.where(np.isnan(x), np.uint64(0xFFFFFFFF), u).astype(np.uint64)


def _merge_runs(keys, run):
    """topk_runs_merge_kernel's passes: a key's place is its index in its run
    plus its rank in the paired run."""
    L = len(keys)
    while run < L:
        out = np.empty_like(keys)
        for r0 in range(0, L, 2 * run):
            a, b = keys[r0:r0 + run], keys[r0 + run:r0 + 2 * run]
            out[r0 + np.arange(len(a)) + np.searchsorted(b, a)] = a
            out[r0 + np.arange(len(b)) + np.searchsorted(a, b)] = b
        keys, run = out, 2 * run
    return keys


def _radix_select(row, L, min_p):
    """The radix form emulated on one row: histogram passes until the row is
    done, the candidates at or below the prefix, sorted in runs of P and
    merged. Returns (positions of the L smallest, passes that counted)."""
    N = len(row)
    plan = radix_plan(1, N, L, min_p)
    pb, cap = plan["pos_bits"], plan["cap"]
    keys = (_order_bits(row) << np.uint64(pb)) | np.arange(N, dtype=np.uint64)
    prefix, shift, below, bucket = 0, 32 + pb, 0, N
    done, counted = N <= cap, 0
    for _ in range(plan["passes"]):
        if done:
            break
        counted += 1
        width = min(11, shift)
        new = shift - width
        inb = (keys >> np.uint64(shift)) == np.uint64(prefix)
        hist = np.bincount(((keys[inb] >> np.uint64(new)) & np.uint64((1 << width) - 1))
                           .astype(np.int64), minlength=2048)
        assert hist.sum() == bucket
        cum = np.cumsum(hist)
        dg = int(np.searchsorted(cum, L - below))  # the first bin reaching L
        below, bucket = below + int(cum[dg] - hist[dg]), int(hist[dg])
        prefix, shift = (prefix << width) | dg, new
        done = below + bucket <= cap or shift == 0
    assert done
    cand = keys[(keys >> np.uint64(shift)) <= np.uint64(prefix)]
    assert L <= len(cand) == below + bucket <= cap
    P = plan["P"]
    if plan["runs"] > 1:
        assert len(cand) == L and plan["runs"] == -(-L // P)
    runs = np.concatenate([np.sort(cand[i:i + P]) for i in range(0, len(cand), P)])
    merged = _merge_runs(runs, P) if plan["runs"] > 1 else runs
    return (merged[:L] & np.uint64((1 << pb) - 1)).astype(np.int64), counted


@pytest.mark.parametrize("data", ["normal", "ties", "inf", "odd"])
@pytest.mark.parametrize("N,L,min_p", [
    (20_000, 1025, 4096), (20_000, 1025, 2048), (SORT_MAX_N + 1, 5000, 4096),
    (20_000, 20_000, 4096), (40_000, 40_000, 4096), (100_000, 1250, 4096),
])
def test_topk_radix_select(N, L, min_p, data):
    """The radix form's passes, emulated on rows of normal values, heavy ties
    (integers and 30 % +inf), all +inf (every pass, ties past cap) and with
    NaN, +-0.0 and -inf: the positions of a stable ascending sort cut to L,
    for one sort (L <= P) and for merged runs (L > SORT_MAX_N)."""
    rng = np.random.RandomState(N + L + min_p)
    if data == "normal":
        row = rng.randn(N).astype(np.float32)
    elif data == "ties":
        row = rng.randint(0, 64, N).astype(np.float32)
        row[rng.rand(N) < 0.3] = np.inf
    elif data == "inf":
        row = np.full(N, np.inf, np.float32)
    else:
        row = rng.randn(N).astype(np.float32)
        row[::7] = np.nan
        row[1::3] = 0.0
        row[2::3] = -0.0
        row[::5] = -np.inf
    got, counted = _radix_select(row, L, min_p)
    np.testing.assert_array_equal(got, np.argsort(row, kind="stable")[:L])
    if data == "inf" and L < N:  # equal values: passes past the 32 value bits split them
        assert counted > -(-32 // 11)


@pytest.mark.parametrize("B,N,L", [
    (128, 100_000, 1025), (128, 100_001, 1250), (128, 100_000, 20_000), (1, 3_000_000, 5000),
    (2, SORT_MAX_N + 1, SORT_MAX_N + 1), (4096, 20_000, 2000), (1, 50_000, 50_000),
])
def test_topk_radix_plan(B, N, L):
    """The radix form's plan: chunks cover the row (multiples of 4, none
    empty); enough passes to resolve every key bit; P holds L or runs of P
    cover it; the launches a call makes; and the workspace holds histograms,
    states and candidates (one buffer more for merged runs)."""
    p = radix_plan(B, N, L)
    assert p["chunk"] % 4 == 0 and (p["S"] - 1) * p["chunk"] < N <= p["S"] * p["chunk"]
    assert p["chunk"] >= min(N, RADIX_MIN_CHUNK)
    assert 2 ** p["pos_bits"] >= N > 2 ** (p["pos_bits"] - 1)
    assert 11 * p["passes"] >= 32 + p["pos_bits"] > 11 * (p["passes"] - 1)
    assert p["P"] & (p["P"] - 1) == 0 and p["P"] <= SORT_MAX_N and p["cap"] == max(p["P"], L)
    assert p["runs"] * p["P"] >= L and (p["runs"] == 1) == (L <= p["P"])
    assert 2 ** p["rounds"] >= p["runs"] > 2 ** (p["rounds"] - 1) - (p["runs"] == 1)
    assert p["kernels"] == kernels_per_call(B, N, L) == 3 + p["passes"] + p["rounds"]
    held = p["passes"] * B * 2048 * 4 + B * 4 + 2 * B * 24 + B * p["cap"] * 8 * (1 + (p["runs"] > 1))
    assert held <= p["ws_bytes"] <= held + 32


FAKE_CASES = {
    "pq_adc gathered": lambda g: (K.pq_adc, (torch.rand(4, 2, 8, 256, generator=g),
                                            torch.randint(0, 256, (50, 8), generator=g,
                                                          dtype=torch.uint8),
                                            torch.zeros(50, dtype=torch.uint8),
                                            torch.randint(0, 50, (4, 13), generator=g,
                                                          dtype=torch.int32))),
    "pq_adc dense": lambda g: (K.pq_adc, (torch.rand(3, 1, 8, 256, generator=g),
                                         torch.randint(0, 256, (70, 8), generator=g,
                                                       dtype=torch.uint8),
                                         torch.zeros(70, dtype=torch.uint8))),
    "topk_select": lambda g: (K.topk_select, (torch.rand(5, 40, generator=g), 7)),
    "flat_l2 f32": lambda g: (K.flat_l2, (torch.rand(3, 16, generator=g),
                                         torch.rand(20, 16, generator=g))),
    "flat_l2 bf16": lambda g: (K.flat_l2, (torch.rand(3, 16, generator=g).bfloat16(),
                                          torch.rand(20, 16, generator=g).bfloat16(), "ip")),
    "flat_l2_gathered": lambda g: (K.flat_l2_gathered,
                                   (torch.rand(3, 16, generator=g), torch.rand(20, 16, generator=g),
                                    torch.randint(0, 20, (3, 6), generator=g,
                                                  dtype=torch.int32))),
    "pq_encode": lambda g: (K.pq_encode, (torch.rand(11, 16, generator=g),
                                          torch.rand(4, 16, 4, generator=g))),
}


@pytest.mark.parametrize("case", list(FAKE_CASES))
def test_register_fake_gives_the_plain_versions_shapes(case):
    """Every operator's fake implementation (what FakeTensorMode and the
    dry-run see) gives the plain version's output shapes and dtypes, its
    FLOP formula counts a positive number, and no kernel launches."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode

    fn, args = FAKE_CASES[case](torch.Generator().manual_seed(0))
    want = fn(*args)
    want = want if isinstance(want, tuple) else (want,)
    K.reset_launch_counts()
    with FakeTensorMode(allow_non_fake_inputs=True) as mode:
        fake_args = tuple(mode.from_tensor(a) if isinstance(a, torch.Tensor) else a
                          for a in args)
        got = fn(*fake_args)
    got = got if isinstance(got, tuple) else (got,)
    assert [(tuple(g.shape), g.dtype) for g in got] == [(tuple(w.shape), w.dtype) for w in want]
    assert not any(K.launch_counts().values())
    with FlopCounterMode(display=False) as fc:
        fn(*args)
    assert fc.get_total_flops() > 0
