"""The port's sequence-parallel Smith-Waterman
(``genome_assembly_tpu_torch/parallel/seqpar.py``) against the JAX
package's, bit for bit: best, best_i, best_j and the global traceback
codes, the pipelined variant at the JAX test's (devices, rows) pairs with
at most 4 devices, the traceback, and the refusals.

The JAX side runs in this process on conftest's 8 virtual CPU devices,
each call once, on 4 devices (its own tests, tests/test_seqpar.py, hold its
answers equal across mesh sizes and between its two variants); the port's
side in one spawned gloo world of 4 CPU ranks, on meshes of 1, 2 and 4.
Both get the same numpy inputs, at tests/test_seqpar.py's shapes.

The pipelined variant's carry takes the exchange's zero fill as the
identity of the max where the per-row variant takes a large negative; the
two agree at positive indels too (ROADMAP.md, C 6), in the JAX package and
in the port.
"""

import random

import jax.numpy as jnp
import numpy as np
import pytest

import torch_parallel_workers as workers
from genome_assembly_tpu.core.encoding import PAD, encode, encode_batch
from genome_assembly_tpu.ops.oracle import local_align_oracle
from genome_assembly_tpu.parallel import mesh as jmesh
from genome_assembly_tpu.parallel import seqpar as jseqpar
from genome_assembly_tpu_torch.parallel.seqpar import traceback_host_seqpar
from genome_assembly_tpu_torch.parallel.spawn import spawn

MESHES = (1, 2, 4)
# tests/test_seqpar.py's (devices, rows) pairs with at most 4 devices, and
# one of 2 devices
PIPELINED = ((1, 4), (4, 1), (4, 8), (4, 3), (2, 8))
WORLD_TIMEOUT_S = 240


def random_dna(r, length):
    return "".join(r.choice("ACGT") for _ in range(length))


def _setup(seed, n_q, g_len, q_max):
    """tests/test_seqpar.py::_setup from random.Random(seed): planted local
    hits with mismatches and random queries; the genome padded to a
    multiple of 4 (and so of 1 and 2)."""
    rng = random.Random(seed)
    genome = random_dna(rng, g_len)
    queries = []
    for _ in range(n_q):
        if rng.random() < 0.6:
            start = rng.randint(0, g_len - q_max)
            q = genome[start:start + rng.randint(5, q_max)]
            q = "".join(c if rng.random() > 0.1 else rng.choice("ACGT")
                        for c in q)
        else:
            q = random_dna(rng, rng.randint(5, q_max))
        queries.append(q)
    q, ql = encode_batch(queries, align="left")
    gp = -(-g_len // 4) * 4
    g_pad = np.full((gp,), PAD, np.int8)
    g_pad[:g_len] = encode(genome)
    return genome, queries, q, ql, g_pad


A = _setup(12345, n_q=12, g_len=200, q_max=40)      # the per-row test's
B = _setup(54321, n_q=10, g_len=192, q_max=37)      # the pipelined test's
N_PAD_B = B[2].shape[1]


def _args(inputs):
    _, _, q, ql, g_pad = inputs
    return (q, ql, g_pad, len(inputs[0]))


CASES = (
    [(f"A/rowwise/m{n}", ("1d", n, "data"), "local_align_batch_seqpar",
      _args(A), {"gather_codes": True}) for n in MESHES]
    + [(f"B/pipelined/{n}x{rows}", ("1d", n, "data"),
        "local_align_batch_seqpar_pipelined", _args(B),
        {"rows_per_exchange": rows, "gather_codes": True})
       for n, rows in PIPELINED]
    + [(f"B/rowwise_indel+1/m{n}", ("1d", n, "data"),
        "local_align_batch_seqpar", _args(B),
        {"indel": 1, "gather_codes": True}) for n in MESHES]
    + [(f"B/pipelined_indel+1/{n}x{rows}", ("1d", n, "data"),
        "local_align_batch_seqpar_pipelined", _args(B),
        {"indel": 1, "rows_per_exchange": rows, "gather_codes": True})
       for n, rows in ((4, 8), (2, 3))]
    + [("raises/genome", ("1d", 4, "data"), "local_align_batch_seqpar",
        (A[2], A[3], np.concatenate([A[4], [PAD]]), 200), {})])

_JAX_RESULTS = {}


def jax_result(key):
    """The JAX package's answers on 4 devices, each computed once."""
    if key not in _JAX_RESULTS:
        mesh = jmesh.make_mesh(4)
        inputs, fn, kw = {
            "A": (A, jseqpar.local_align_batch_seqpar, {}),
            "B": (B, jseqpar.local_align_batch_seqpar, {}),
            "B/pipelined/3": (B, jseqpar.local_align_batch_seqpar_pipelined,
                              {"rows_per_exchange": 3}),
            "B/indel+1": (B, jseqpar.local_align_batch_seqpar, {"indel": 1}),
            "B/pipelined_indel+1": (
                B, jseqpar.local_align_batch_seqpar_pipelined,
                {"rows_per_exchange": 8, "indel": 1}),
        }[key]
        q, ql, g_pad, g_len = _args(inputs)
        out = fn(mesh, jnp.asarray(q), jnp.asarray(ql), jnp.asarray(g_pad),
                 g_len, **kw)
        _JAX_RESULTS[key] = [np.asarray(x) for x in out]
    return _JAX_RESULTS[key]


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    ranks = spawn(workers.run_cases, 4, args=(CASES,), device="cpu",
                  timeout_s=WORLD_TIMEOUT_S,
                  workdir=str(tmp_path_factory.mktemp("seqpar")))
    return {name: [r[name] for r in ranks] for name in ranks[0]}


def _members(port, name, n):
    results = port[name]
    assert all(r is None for r in results[n:])
    return results[:n]


def _assert_equal(got, want, name, rows=None):
    for i, (g, w) in enumerate(zip(got, want)):
        if i == 3 and rows is not None:
            g, w = g[:rows], w[:rows]
        np.testing.assert_array_equal(g, w, err_msg=f"{name}[{i}]")


@pytest.mark.parametrize("n", MESHES)
def test_seqpar_equals_jax(port, n):
    want = jax_result("A")
    for got in _members(port, f"A/rowwise/m{n}", n):
        _assert_equal(got, want, f"rowwise at {n}")
        assert got[3].shape == want[3].shape


@pytest.mark.parametrize("n,rows", PIPELINED)
def test_seqpar_pipelined_equals_jax(port, n, rows):
    """Equal to the JAX package's per-row answer on the query rows, and at
    R = 3 (rows padded with PAD) to its pipelined answer on every row."""
    for got in _members(port, f"B/pipelined/{n}x{rows}", n):
        _assert_equal(got, jax_result("B"), f"pipelined {n}x{rows}",
                      rows=N_PAD_B)
        assert got[3].shape[0] == -(-N_PAD_B // rows) * rows
        if rows == 3:
            _assert_equal(got, jax_result("B/pipelined/3"),
                          f"pipelined {n}x3, padded rows")


def test_exchanges_per_variant(port):
    """Two exchanges a DP row and one resolving gather for the per-row
    variant; one a step, n_pad / R + D - 1 steps, for the pipelined one."""
    n_pad = A[2].shape[1]
    for n in MESHES:
        assert port[f"A/rowwise/m{n}", "collectives"][0] == 2 * n_pad + 1
    for n, rows in PIPELINED:
        steps = -(-N_PAD_B // rows) + n - 1
        assert port[f"B/pipelined/{n}x{rows}", "collectives"][0] == steps + 1


def test_traceback_equals_jax_and_the_oracle(port):
    genome, queries = A[0], A[1]
    best, bi, bj, codes = port["A/rowwise/m4"][0]
    _, j_bi, j_bj, j_codes = jax_result("A")
    for b, query in enumerate(queries):
        got = traceback_host_seqpar(codes[:, b, :], int(bi[b]), int(bj[b]),
                                    query, genome)
        want = jseqpar.traceback_host_seqpar(j_codes[:, b, :], int(j_bi[b]),
                                             int(j_bj[b]), query, genome)
        assert got == want
        oar, oaq, oscore, ostart, oend = local_align_oracle(query, genome)
        assert int(best[b]) == oscore
        assert (*got, int(bj[b])) == (oar, oaq, ostart, oend)


@pytest.mark.parametrize("n", MESHES)
def test_rowwise_takes_a_positive_indel_as_jax(port, n):
    for got in _members(port, f"B/rowwise_indel+1/m{n}", n):
        _assert_equal(got, jax_result("B/indel+1"), f"indel +1 at {n}")


def test_pipelined_variants_agree_at_a_positive_indel_in_both(port):
    """C 6: the pipelined carry's zero identity is right at indel = +1 too
    (the first block's cummax is never negative), so the JAX package's two
    variants agree there, and the port's pipelined variant equals them."""
    rowwise = jax_result("B/indel+1")
    pipelined = jax_result("B/pipelined_indel+1")
    _assert_equal(pipelined, rowwise, "JAX pipelined at indel +1",
                  rows=N_PAD_B)
    for n, rows in ((4, 8), (2, 3)):
        for got in _members(port, f"B/pipelined_indel+1/{n}x{rows}", n):
            _assert_equal(got, rowwise, f"pipelined {n}x{rows} at indel +1",
                          rows=N_PAD_B)


def test_genome_the_mesh_does_not_divide_raises_in_both(port):
    mesh = jmesh.make_mesh(4)
    g_pad = np.concatenate([A[4], [PAD]])
    with pytest.raises(AssertionError) as jax_error:
        jseqpar.local_align_batch_seqpar(
            mesh, jnp.asarray(A[2]), jnp.asarray(A[3]), jnp.asarray(g_pad),
            200)
    for got in port["raises/genome"]:
        assert got == ("raised", str(jax_error.value))
