"""The port's meshes, sharded pair scoring and pipeline steps
(``genome_assembly_tpu_torch/parallel/mesh.py``, ``sharded.py``) against
the JAX package's, bit for bit.

The JAX side runs in this process on conftest's 8 virtual CPU devices, at
meshes of 1, 2 and 4 devices; the port's side in one spawned gloo world of
4 CPU ranks (meshes of its first 1, 2 and 4 ranks, 2-D meshes) and one
world of 1 rank. Both get the same numpy inputs, at the JAX tests' shapes
(``tests/test_distributed.py``). ``sharded_pipeline_step`` samples with a
torch.Generator, which cannot match jax.random: it is held to its
contract instead (shapes, and scores, ends and coverage rebuilt from each
rank's reads by the generator rule its docstring states).
"""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_workers as workers
from genome_assembly_tpu.core.encoding import encode, encode_batch
from genome_assembly_tpu.parallel import mesh as jmesh
from genome_assembly_tpu.parallel import sharded as jsharded
from genome_assembly_tpu_torch.ops.overlap_allpairs import (
    overlap_scores_block_plain,
)
from genome_assembly_tpu_torch.parallel import mesh as tmesh
from genome_assembly_tpu_torch.parallel.spawn import spawn

MESHES = (1, 2, 4)
MESHES_2D = ((2, 2), (1, 4), (4, 1), (2, 1))
WORLD_TIMEOUT_S = 240


def random_dna(r, length, alphabet="ACGT"):
    return "".join(r.choice(alphabet) for _ in range(length))


def _with_n(r, s, count=1):
    """`s` with `count` bases inside it replaced by N."""
    s = list(s)
    for _ in range(count):
        if len(s) > 2:
            s[r.randrange(1, len(s) - 1)] = "N"
    return "".join(s)


def _pair_batch(seed, n_pairs=64, l=12, with_n=False):
    """tests/test_distributed.py::_pair_batch, optionally with an N inside
    half of the reads."""
    r = random.Random(seed)
    core_pool = [random_dna(r, l) for _ in range(10)]
    a, b = [], []
    for _ in range(n_pairs):
        core = r.choice(core_pool)[: r.randint(3, l)]
        a.append((random_dna(r, r.randint(0, 5)) + core)[-l:])
        b.append((core + random_dna(r, r.randint(0, 5)))[:l])
    if with_n:
        a = [_with_n(r, s) if i % 2 else s for i, s in enumerate(a)]
        b = [_with_n(r, s) if i % 3 == 0 else s for i, s in enumerate(b)]
    ar, al = encode_batch(a, width=l, align="right")
    bm, bl = encode_batch(b, width=l, align="left")
    return ar, al, bm, bl


def _reads(seed, n=16, lo=5, hi=10, with_n=False):
    r = random.Random(seed)
    reads = [random_dna(r, r.randint(lo, hi)) for _ in range(n)]
    if with_n:
        reads = [_with_n(r, s, 2) if i % 2 else s
                 for i, s in enumerate(reads)]
    return encode_batch(reads, width=hi, align="left")


def _indexed_inputs(seed=11, u=20, p=64):
    r = random.Random(seed)
    reads = [random_dna(r, r.randint(6, 14)) for _ in range(u)]
    reads = [_with_n(r, s) if i % 4 == 0 else s for i, s in enumerate(reads)]
    right, lens = encode_batch(reads, width=14, align="right")
    left, _ = encode_batch(reads, width=14, align="left")
    rs = np.random.RandomState(seed)
    ia = rs.randint(0, u, p).astype(np.int32)
    ib = rs.randint(0, u, p).astype(np.int32)
    return right, left, lens, ia, ib


def _assembly_reads():
    """tests/test_distributed.py::test_distributed_assembly_matches_single_chip's
    reads, from the JAX package's host samplers."""
    from genome_assembly_tpu.simulate import (
        generate_error_free_reads,
        generate_error_prone_reads,
    )

    r = random.Random(6)
    genome = random_dna(r, 300)
    reads = generate_error_free_reads(genome, 25, 60, rng=random.Random(7))
    return generate_error_prone_reads(reads, 0.02,
                                      rs=np.random.RandomState(8))


def _score_pairs_inputs():
    r = random.Random(12)
    unique = [random_dna(r, r.randint(8, 20)) for _ in range(15)]
    unique[3] = _with_n(r, unique[3])
    rs = np.random.RandomState(12)
    pairs = [(int(a), int(b)) for a, b in rs.randint(0, 15, (37, 2))]
    return unique, pairs


def _step_reads_inputs():
    """tests/test_distributed.py::test_pipeline_step_mesh_determinism_end_to_end's
    fixed reads."""
    r = random.Random(42)
    genome = random_dna(r, 256)
    n, l = 24, 20
    starts = np.array([r.randrange(len(genome)) for _ in range(n)], np.int32)
    lens = np.minimum(l, len(genome) - starts).astype(np.int32)
    reads = [genome[s:s + le] for s, le in zip(starts, lens)]
    mat, _ = encode_batch(reads, width=l, align="left")
    return mat, lens, starts, len(genome)


STEP = {"seed": 7, "genome_seed": 3, "genome_len": 256, "read_length": 32,
        "num_reads": 64, "error_prob": 0.01}


def _step_genome():
    return encode(random_dna(random.Random(STEP["genome_seed"]),
                             STEP["genome_len"]))


def _j4():
    return jmesh.make_mesh(4)


def _families():
    """family -> (port function, args, kwargs, the JAX package's call).

    The JAX package runs each family once, on 4 devices (2 x 2 for the
    tiles): its own tests (tests/test_distributed.py) hold its answers equal
    across mesh sizes. The port runs each at every mesh size."""
    fams = {}
    # reads with an N inside in each scorer
    batch = _pair_batch(1, with_n=True)
    fams["scores"] = (
        "sharded_overlap_scores", batch, {},
        lambda: jsharded.sharded_overlap_scores(
            _j4(), *map(jnp.asarray, batch)))
    reads = _reads(2, with_n=True)
    fams["allpairs"] = (
        "all_pairs_block_scores", reads, {},
        lambda: jsharded.all_pairs_block_scores(
            _j4(), *map(jnp.asarray, reads)))
    indexed = _indexed_inputs()
    fams["indexed"] = (
        "sharded_overlap_scores_indexed", indexed, {},
        lambda: jsharded.sharded_overlap_scores_indexed(
            _j4(), *map(jnp.asarray, indexed)))
    tiles = _reads(5)
    fams["allpairs2d"] = (
        "all_pairs_block_scores_2d", tiles, {},
        lambda: jsharded.all_pairs_block_scores_2d(
            jmesh.make_mesh_2d(2, 2), *map(jnp.asarray, tiles)))
    unique, pairs = _score_pairs_inputs()
    fams["score_pairs"] = (
        "distributed_score_pairs", (unique, pairs), {},
        lambda: jsharded.distributed_score_pairs(_j4(), unique, pairs))
    asm_reads = _assembly_reads()
    fams["graph"] = (
        "distributed_build_overlap_graph", (asm_reads,), {"k": 5},
        lambda: _jax_graph(jsharded.distributed_build_overlap_graph(
            _j4(), asm_reads, k=5)))
    for k in (5, 0):
        fams[f"contigs/k{k}"] = (
            "distributed_assemble_contigs", (asm_reads,), {"k": k},
            lambda k=k: jsharded.distributed_assemble_contigs(
                _j4(), asm_reads, k=k))
    step_in = _step_reads_inputs()
    fams["step_reads"] = (
        "sharded_pipeline_step_reads", step_in, {},
        lambda: jsharded.sharded_pipeline_step_reads(
            _j4(), *map(jnp.asarray, step_in[:3]), step_in[3]))
    return fams


def _raising():
    """name -> (mesh spec, port function, args, the JAX call): sizes the
    mesh does not divide, which both packages refuse."""
    batch = _pair_batch(1, n_pairs=6)
    reads6, lens6 = _reads(2, n=6)
    reads10, lens10 = _reads(2, n=10)
    indexed = _indexed_inputs(p=6)
    step = (reads6, lens6, np.zeros(6, np.int32), 64)
    return {
        "raises/scores": (
            ("1d", 4, "data"), "sharded_overlap_scores", batch,
            lambda: jsharded.sharded_overlap_scores(
                _j4(), *map(jnp.asarray, batch))),
        "raises/indexed": (
            ("1d", 4, "data"), "sharded_overlap_scores_indexed", indexed,
            lambda: jsharded.sharded_overlap_scores_indexed(
                _j4(), *map(jnp.asarray, indexed))),
        "raises/allpairs": (
            ("1d", 4, "data"), "all_pairs_block_scores", (reads6, lens6),
            lambda: jsharded.all_pairs_block_scores(
                _j4(), jnp.asarray(reads6), jnp.asarray(lens6))),
        "raises/allpairs2d": (
            ("2d", 4, 1), "all_pairs_block_scores_2d", (reads10, lens10),
            lambda: jsharded.all_pairs_block_scores_2d(
                jmesh.make_mesh_2d(4, 1), jnp.asarray(reads10),
                jnp.asarray(lens10))),
        "raises/step_reads": (
            ("1d", 4, "data"), "sharded_pipeline_step_reads", step,
            lambda: jsharded.sharded_pipeline_step_reads(
                _j4(), *map(jnp.asarray, step[:3]), step[3])),
    }


def _jax_graph(g):
    return {"unique_reads": g.unique_reads, "counts": g.counts,
            "offsets": g.offsets, "src": g.src, "dst": g.dst,
            "weight": g.weight, "end_pos": g.end_pos}


FAMILIES = _families()
RAISING = _raising()


def _spec(family, mesh):
    return ("2d", *mesh) if family == "allpairs2d" else ("1d", mesh, "data")


def _meshes(family):
    return MESHES_2D if family == "allpairs2d" else MESHES


def _name(family, mesh):
    return (f"{family}/{mesh[0]}x{mesh[1]}" if family == "allpairs2d"
            else f"{family}/m{mesh}")


PARITY = [(fam, m) for fam in FAMILIES for m in _meshes(fam)]
CASES = (
    [(_name(fam, m), _spec(fam, m), fn, args, kw)
     for fam, (fn, args, kw, _) in FAMILIES.items() for m in _meshes(fam)]
    + [(f"step/m{n}", ("1d", n, "data"), "sharded_pipeline_step",
        (_step_genome(), STEP["read_length"], STEP["num_reads"],
         STEP["error_prob"]), {"generator_seed": STEP["seed"]})
       for n in MESHES]
    + [("hosts_chips", ("hosts_chips",), "mesh", (), {})]
    + [(name, spec, fn, args, {})
       for name, (spec, fn, args, _) in RAISING.items()])
ONE_RANK = ("allpairs/m1", "scores/m1", "contigs/k5/m1", "step_reads/m1")
_JAX_RESULTS = {}


def jax_result(family):
    """The JAX package's answer for a family, computed once a module."""
    if family not in _JAX_RESULTS:
        _JAX_RESULTS[family] = FAMILIES[family][3]()
    return _JAX_RESULTS[family]


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    """{name: [each rank's result]} from the 4-rank world and, under
    ("world1", name), from the 1-rank world."""
    ranks = spawn(workers.run_cases, 4, args=(CASES,), device="cpu",
                  timeout_s=WORLD_TIMEOUT_S,
                  workdir=str(tmp_path_factory.mktemp("world4")))
    out = {name: [r[name] for r in ranks] for name in ranks[0]}
    one = [case for case in CASES if case[0] in ONE_RANK]
    single = spawn(workers.run_cases, 1, args=(one,), device="cpu",
                   timeout_s=WORLD_TIMEOUT_S,
                   workdir=str(tmp_path_factory.mktemp("world1")))
    out.update({("world1", name): value for name, value in single[0].items()})
    return out


def _flat(x):
    """A nested result as a flat list of numpy arrays and scalars."""
    if isinstance(x, dict):
        return [v for key in sorted(x) for v in _flat(x[key])]
    if isinstance(x, (list, tuple)):
        return [v for item in x for v in _flat(item)]
    return [np.asarray(x)]


def _assert_equal(got, want, name):
    got, want = _flat(got), _flat(want)
    assert len(got) == len(want), name
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape, (name, i, g.shape, w.shape)
        np.testing.assert_array_equal(g, w, err_msg=f"{name}[{i}]")


def _members(results, spec):
    """The results of the ranks inside the mesh; the others must be None."""
    kind, *rest = spec
    size = rest[0] if kind == "1d" else rest[0] * rest[1]
    assert all(r is None for r in results[size:])
    return results[:size]


@pytest.mark.parametrize("family,mesh", PARITY)
def test_port_equals_jax(port, family, mesh):
    """Every member rank returns the global result, equal to the JAX
    package's; ranks outside the mesh return None."""
    name = _name(family, mesh)
    results = _members(port[name], _spec(family, mesh))
    want = jax_result(family)
    for rank, got in enumerate(results):
        _assert_equal(got, want, f"{name} rank {rank}")
    if ("world1", name) in port:
        _assert_equal(port["world1", name], want, f"{name} 1-rank world")


@pytest.mark.parametrize("name", sorted(RAISING))
def test_sizes_the_mesh_does_not_divide_raise_in_both(port, name):
    with pytest.raises(AssertionError) as jax_error:
        RAISING[name][3]()
    for got in port[name]:
        assert got == ("raised", str(jax_error.value)), name


def test_mesh_size_invariance(port):
    """The dense and pair scorers, the assembly and the step on fixed reads
    give the same bits on meshes of 1, 2 and 4 ranks, and the 2-D tiles
    on every grid."""
    for fam in ("scores", "allpairs", "indexed", "score_pairs", "graph",
                "step_reads", "contigs/k5", "contigs/k0"):
        for n in MESHES[1:]:
            _assert_equal(port[f"{fam}/m{n}"][0], port[f"{fam}/m1"][0],
                          f"{fam} at {n}")
    first = port["allpairs2d/%dx%d" % MESHES_2D[0]][0]
    for rows, cols in MESHES_2D[1:]:
        _assert_equal(port[f"allpairs2d/{rows}x{cols}"][0], first,
                      f"allpairs2d at {rows}x{cols}")


@pytest.mark.parametrize("n", MESHES)
def test_sharded_pipeline_step_keeps_its_contract(port, n):
    """Shapes as the JAX package's; scores and ends equal the plain
    all-pairs version on the reads rebuilt from the generator rule, and
    the coverage their starts' difference array, exactly."""
    results = _members(port[f"step/m{n}"], ("1d", n))
    reads, lens, starts = workers.sample_shards(
        STEP["seed"], n, _step_genome(), STEP["read_length"],
        STEP["num_reads"], STEP["error_prob"])
    s, e = overlap_scores_block_plain(reads, lens, reads, lens)
    cov = np.zeros(STEP["genome_len"], np.int64)
    for s0, le in zip(starts.tolist(), lens.tolist()):
        cov[s0:s0 + le] += 1
    for got in results:
        scores, ends, coverage = got
        assert scores.shape == ends.shape == (STEP["num_reads"],) * 2
        assert coverage.shape == (STEP["genome_len"],)
        np.testing.assert_array_equal(scores, s.numpy())
        np.testing.assert_array_equal(ends, e.numpy())
        np.testing.assert_array_equal(coverage, cov)
    assert int(np.asarray(cov).sum()) == int(lens.sum())


def test_hosts_chips_mesh_on_one_host(port):
    """One host: a 1 x D grid (the JAX package's (1, 8) on 8 devices)."""
    want = jmesh.make_mesh_hosts_chips()
    assert want.devices.shape == (1, 8)
    for info in port["hosts_chips"]:
        assert info["axis_names"] == want.axis_names == ("hosts", "chips")
        assert info["shape"] == (1, 4)
        assert info["member"]


def test_init_distributed_without_a_coordinator_is_a_no_op(monkeypatch):
    import torch.distributed as dist

    for var in ("MASTER_ADDR", "MASTER_PORT", "JAX_COORDINATOR_ADDRESS"):
        monkeypatch.delenv(var, raising=False)
    assert jmesh.init_distributed() is None
    assert tmesh.init_distributed(device="cpu") is None
    assert not dist.is_initialized()
    mesh = tmesh.make_mesh(device="cpu")
    assert mesh.devices.shape == (1,) and mesh.member
    assert mesh.device == torch.device("cpu")
