"""The port keeps the JAX package's public names and signatures.

For every module of ``genome_assembly_tpu`` the test reads its top-level
public names (functions with their parameter lists, classes, module
constants) with ``ast`` — the JAX modules are never imported — imports the
port module at the same path, and fails on a name the port lacks or a
parameter list that differs, unless the difference stands in the
exemption tables below (ROADMAP §C lists the same, with the same
reasons). Each sub-package's re-exports (``__init__`` imports and
``__all__``) are held the same way. An exemption that no longer matches a
difference also fails, so the tables stay honest.
"""

import ast
import importlib
import inspect
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_PKG = os.path.join(ROOT, "genome_assembly_tpu")

DEVICE = "adds device= (the port's device rule: the card by default)"

# (module, name): why the port has no such name.
MISSING_BY_DESIGN = {
    ("core.dispatch", "use_device_join"):
        "the k-mer join runs on the caller's device at every size",
}

# (module, function): why its parameter list differs from the JAX one.
SIGNATURE_BY_DESIGN = {
    ("core.dispatch", "use_host_pair_scoring"):
        "a rule on the device and internal PADs, not a tunnel threshold",
    ("core.dispatch", "use_host_metrics"):
        "a rule on the device and executor, not a DP-cell threshold",
    ("ops.overlap_allpairs", "overlap_scores_block"):
        "drops the TPU tiling arguments (tm, tn, jc, interpret, shift)",
    ("ops.overlap_allpairs", "overlap_scores_all_pairs"):
        "drops the TPU tiling arguments (tm, tn, jc, interpret, shift)",
    ("ops.overlap_allpairs", "overlap_scores_all_pairs_auto"): DEVICE,
    ("ops.smith_waterman", "local_align_one"): DEVICE,
    ("graph.candidates", "candidate_pairs_device"): DEVICE,
    ("metrics.align_to_ref", "align_read_or_contig_to_reference"): DEVICE,
    ("metrics.align_to_ref", "align_contigs_to_reference"): DEVICE,
    ("metrics.measures", "calculate_genome_coverage_and_mismatch_rate"):
        DEVICE,
    ("metrics.measures", "calculate_measures"): DEVICE,
    ("simulate.reads", "reads_to_device"): DEVICE,
    ("simulate.reads", "sample_reads_device"):
        "key -> generator (a torch.Generator for jax.random's key)",
    ("simulate.errors", "inject_errors_device"):
        "key -> generator (a torch.Generator for jax.random's key)",
    ("parallel.sharded", "sharded_pipeline_step"):
        "key -> generator (a torch.Generator for jax.random's key)",
    ("parallel.mesh", "make_mesh"): DEVICE,
    ("parallel.mesh", "make_mesh_2d"): DEVICE,
    ("parallel.mesh", "make_mesh_hosts_chips"): DEVICE,
    ("parallel.mesh", "init_distributed"):
        "adds device=, backend= and timeout_s= (torch.distributed's set-up)",
    ("parallel.pipeline", "candidates_score_unpipelined"): DEVICE,
    ("models.string_graph", "transitive_reduction"): DEVICE,
    ("models.unitig", "transitive_reduction2"): DEVICE,
    ("plots.iteration", "plot_reconstructed_coverage"): DEVICE,
}


def _jax_modules():
    for dirpath, _, files in os.walk(JAX_PKG):
        for f in sorted(files):
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(dirpath, f), JAX_PKG)
                yield rel[:-3].replace(os.sep, ".").removesuffix("__init__") \
                    .rstrip(".")


def _tree(module: str) -> ast.Module:
    parts = module.split(".") if module else []
    path = os.path.join(JAX_PKG, *parts)
    path = (os.path.join(path, "__init__.py") if os.path.isdir(path)
            else path + ".py")
    with open(path, encoding="utf-8") as f:
        return ast.parse(f.read())


def _ast_params(node) -> list[tuple[str, str]]:
    a = node.args
    params = [(x.arg, "pos") for x in a.posonlyargs + a.args]
    if a.vararg:
        params.append((a.vararg.arg, "*"))
    params += [(x.arg, "kwonly") for x in a.kwonlyargs]
    if a.kwarg:
        params.append((a.kwarg.arg, "**"))
    return params


_KINDS = {inspect.Parameter.POSITIONAL_ONLY: "pos",
          inspect.Parameter.POSITIONAL_OR_KEYWORD: "pos",
          inspect.Parameter.VAR_POSITIONAL: "*",
          inspect.Parameter.KEYWORD_ONLY: "kwonly",
          inspect.Parameter.VAR_KEYWORD: "**"}


def _port_params(fn) -> list[tuple[str, str]]:
    return [(p.name, _KINDS[p.kind])
            for p in inspect.signature(fn).parameters.values()]


def _public(module: str) -> dict:
    """name -> parameter list (functions) or None (classes, constants)."""
    out = {}
    for node in _tree(module).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out[node.name] = _ast_params(node)
        elif isinstance(node, ast.ClassDef):
            out[node.name] = None
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            out.update((t.id, None) for t in targets
                       if isinstance(t, ast.Name))
    return {k: v for k, v in out.items()
            if not k.startswith("_") and k != "__all__"}


def _port(module: str):
    return importlib.import_module(
        "genome_assembly_tpu_torch" + (f".{module}" if module else ""))


def _differences():
    missing, differ = set(), set()
    for module in _jax_modules():
        port = _port(module)
        for name, params in _public(module).items():
            if not hasattr(port, name):
                missing.add((module, name))
            elif params is not None and _port_params(
                    getattr(port, name)) != params:
                differ.add((module, name))
    return missing, differ


def test_every_jax_module_has_a_port_module():
    modules = list(_jax_modules())
    assert len(modules) > 40
    for module in modules:
        _port(module)


def test_public_names_are_ported_or_exempt():
    missing, _ = _differences()
    assert missing - set(MISSING_BY_DESIGN) == set()
    assert set(MISSING_BY_DESIGN) - missing == set(), (
        "exempted names that the port now has: drop them from the table")


def test_signatures_match_or_are_exempt():
    _, differ = _differences()
    assert differ - set(SIGNATURE_BY_DESIGN) == set()
    assert set(SIGNATURE_BY_DESIGN) - differ == set(), (
        "exempted signatures that now match: drop them from the table")


def _all_list(tree: ast.Module) -> list[str]:
    for node in tree.body:
        if (isinstance(node, ast.Assign)
                and any(isinstance(t, ast.Name) and t.id == "__all__"
                        for t in node.targets)):
            return list(ast.literal_eval(node.value))
    return []


@pytest.mark.parametrize("package", sorted(
    m for m in _jax_modules()
    if os.path.isdir(os.path.join(JAX_PKG, *m.split(".")))))
def test_package_reexports_match(package):
    tree = _tree(package)
    port = _port(package)
    imported = {alias.asname or alias.name for node in tree.body
                if isinstance(node, ast.ImportFrom)
                for alias in node.names}
    jax_all = _all_list(tree)
    assert sorted(n for n in imported | set(jax_all)
                  if not hasattr(port, n)) == []
    assert set(jax_all) <= set(getattr(port, "__all__", []))
    assert all(hasattr(port, n) for n in getattr(port, "__all__", []))


def test_exemptions_carry_a_reason():
    for table in (MISSING_BY_DESIGN, SIGNATURE_BY_DESIGN):
        assert all(isinstance(why, str) and why for why in table.values())
