"""The port's two-stage build pipeline
(``genome_assembly_tpu_torch/parallel/pipeline.py``) against the JAX
package's, bit for bit: ``pipelined_candidates_score`` on a 2-rank 'stage'
mesh and ``candidates_score_unpipelined``, at tests/test_pipeline_parallel.py's
shapes.

The JAX side runs in this process on conftest's virtual CPU devices; the
port's side in one spawned gloo world of 2 CPU ranks (its unpipelined
reference on the CPU in the same ranks). Both get the same numpy inputs.
"""

import random

import jax.numpy as jnp
import numpy as np
import pytest

import torch_parallel_workers as workers
from genome_assembly_tpu.core.encoding import encode_batch
from genome_assembly_tpu.parallel import mesh as jmesh
from genome_assembly_tpu.parallel import pipeline as jpipeline
from genome_assembly_tpu_torch.parallel import pipeline as tpipeline
from genome_assembly_tpu_torch.parallel.spawn import spawn

WORLD_TIMEOUT_S = 240
NAMES = ("cand", "scores", "ends", "valid")


def random_dna(r, length):
    return "".join(r.choice("ACGT") for _ in range(length))


def _micro_reads():
    """test_pipelined_candidates_score_microbatches' 32 reads."""
    r = random.Random(12345)
    reads = [random_dna(r, r.randint(8, 24)) for _ in range(32)]
    return encode_batch(reads, align="left")


def _planted_reads():
    """test_pipelined_candidates_score_parity's 64 reads, suffix->prefix
    5-mer hits planted so that the join finds real candidates."""
    r = random.Random(12345)
    reads = [random_dna(r, r.randint(20, 40)) for _ in range(64)]
    for i in range(0, 64, 3):
        j = (i * 7 + 5) % 64
        reads[j] = reads[i][-5:] + reads[j][5:]
    return encode_batch(reads, width=max(map(len, reads)))


MICRO = _micro_reads()
PLANTED = _planted_reads()
STAGE = ("1d", 2, "stage")
CASES = (
    [(f"micro/{m}", STAGE, "pipelined_candidates_score", MICRO,
      {"k": 3, "cap": 8, "n_micro": m}) for m in (1, 2, 4)]
    + [("planted", STAGE, "pipelined_candidates_score", PLANTED,
        {"k": 5, "cap": 16, "n_micro": 4}),
       ("unpipelined/micro", None, "candidates_score_unpipelined", MICRO,
        {"k": 3, "cap": 8}),
       ("unpipelined/planted", None, "candidates_score_unpipelined", PLANTED,
        {"k": 5, "cap": 16}),
       ("raises/one_stage", ("1d", 1, "stage"), "pipelined_candidates_score",
        MICRO, {"k": 3, "cap": 8}),
       ("raises/n_micro", STAGE, "pipelined_candidates_score", MICRO,
        {"k": 3, "cap": 8, "n_micro": 3})])


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    ranks = spawn(workers.run_cases, 2, args=(CASES,), device="cpu",
                  timeout_s=WORLD_TIMEOUT_S,
                  workdir=str(tmp_path_factory.mktemp("pipeline")))
    return {name: [r[name] for r in ranks] for name in ranks[0]}


_JAX_RESULTS = {}


def _jax_unpipelined(inputs, k, cap):
    """The JAX package's unpipelined composition, computed once a case."""
    key = (id(inputs), k, cap)
    if key not in _JAX_RESULTS:
        codes, lens = inputs
        _JAX_RESULTS[key] = [
            np.asarray(x) for x in jpipeline.candidates_score_unpipelined(
                jnp.asarray(codes), jnp.asarray(lens), k=k, cap=cap)]
    return _JAX_RESULTS[key]


def _assert_equal(got, want, name):
    for g, w, part in zip(got, want, NAMES):
        np.testing.assert_array_equal(g, w, err_msg=f"{name} {part}")


@pytest.mark.parametrize("n_micro", [1, 2, 4])
def test_pipelined_equals_jax_at_every_microbatch_count(port, n_micro):
    """Against the JAX package's pipelined run at n_micro = 4 and its
    unpipelined composition, which its own tests hold equal to its
    pipelined runs at every microbatch count."""
    want = _jax_unpipelined(MICRO, k=3, cap=8)
    if n_micro == 4:
        pipelined = [np.asarray(x) for x in jpipeline.pipelined_candidates_score(
            jmesh.make_mesh(2, axis_name="stage"), jnp.asarray(MICRO[0]),
            jnp.asarray(MICRO[1]), k=3, cap=8, n_micro=4)]
        _assert_equal(pipelined, want, "JAX pipelined")
    assert len(port[f"micro/{n_micro}"]) == 2
    for got in port[f"micro/{n_micro}"]:
        _assert_equal(got, want, f"n_micro={n_micro}")


def test_pipelined_equals_jax_on_planted_hits(port):
    want = _jax_unpipelined(PLANTED, k=5, cap=16)
    assert want[3].sum() >= 20          # the join finds the planted hits
    for got in port["planted"]:
        _assert_equal(got, want, "planted")
        assert (got[1][~got[3]] == 0).all() and (got[2][~got[3]] == 0).all()


@pytest.mark.parametrize("case,k,cap", [("micro", 3, 8), ("planted", 5, 16)])
def test_unpipelined_equals_jax(port, case, k, cap):
    want = _jax_unpipelined(MICRO if case == "micro" else PLANTED, k, cap)
    for got in port[f"unpipelined/{case}"]:
        _assert_equal(got, want, case)


def test_shapes_the_pipeline_does_not_take_raise_in_both(port):
    codes, lens = jnp.asarray(MICRO[0]), jnp.asarray(MICRO[1])
    with pytest.raises(AssertionError) as one_stage:
        jpipeline.pipelined_candidates_score(
            jmesh.make_mesh(1, axis_name="stage"), codes, lens, k=3, cap=8)
    with pytest.raises(AssertionError) as n_micro:
        jpipeline.pipelined_candidates_score(
            jmesh.make_mesh(2, axis_name="stage"), codes, lens, k=3, cap=8,
            n_micro=3)
    # every rank refuses, members or not: the checks come first
    for got in port["raises/one_stage"]:
        assert got == ("raised", str(one_stage.value))
    for got in port["raises/n_micro"]:
        assert got == ("raised", str(n_micro.value))


@pytest.mark.parametrize("k", [0, 16, 31])
def test_k_outside_the_jax_join_is_refused(k):
    """The JAX package's join packs k-mers into int32 lanes and takes k in
    1..15 (its docstring); the port's join takes up to 31, and this entry
    point refuses what the JAX package's does not take."""
    codes, lens = MICRO
    with pytest.raises(ValueError, match="1..15"):
        tpipeline.candidates_score_unpipelined(codes, lens, k=k, device="cpu")
