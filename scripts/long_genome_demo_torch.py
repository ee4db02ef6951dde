"""Long-genome demonstration of the PyTorch/CUDA port on one card.

The port's counterpart of ``scripts/long_genome_demo.py``, with its inputs
and rows: a G = 50,000 bp random genome (``random.Random(0)``), N = 15,000
reads of l = 150 (``Random(1)``) with p = 0.005 substitutions
(``RandomState(2)``), assembled in both layout modes (exact parity, and
the fast greedy chaining with its consensus polish) at k = 15 and k = 5.
Per row:

- the assembly, then the metrics pass with stability-verified banded
  Smith-Waterman (the banded kernel on a card);
- unless LONG_GENOME_FULL_DELTA=0, the full-width metrics pass over the
  full contig set (the full-width kernel) and the banded-minus-full
  metric deltas;
- on the fast rows, ``banded_check``: 256 distinct contigs aligned both
  ways, with the details and the positions that agree.

Each row has ``long_genome_demo.py``'s keys plus the card's name, the
kernels' launches, the contigs' sha256 and total length, the five measures
(banded and full width) and whether the row equals the JAX package's run
(``EXPECTED``: contigs and measures recorded on the CPU; the JAX
package's full-width measures equal its banded ones on every row, and its
banded check gave 256 of 256 on both fast rows). The script exits 1 when
a row differs, when its full-width measures differ from ``EXPECTED``'s, or
when a banded check finds a sampled contig whose banded details differ.

    python3 scripts/long_genome_demo_torch.py [G N l]

LONG_GENOME_SKIP (e.g. ``fast:15,exact:5``) skips rows. Rows go to stdout
and to LONG_GENOME_OUT (default ``results/long_genome_torch.json``,
which ``.gitignore`` lists); the tracked ``LONG_GENOME.json`` is the JAX
package's and is never written. Runs on the card only: without one it
raises.
"""

from __future__ import annotations

import json
import os
import random
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

G, N, READ_LENGTH, P = 50_000, 15_000, 150, 0.005
GENOME_SEED, READ_SEED, ERROR_SEED = 0, 1, 2
CHECK_SAMPLE = 256
ROWS = (("fast", 15), ("exact", 15), ("fast", 5), ("exact", 5))
DEFAULT_OUT = os.path.join(ROOT, "results", "long_genome_torch.json")

# What the JAX package returns on these inputs at the default G, N, l
# (assemble_contigs_using_overlap_graphs, then calculate_measures with
# banded=True; on the CPU). "exact, k=15" is chip_smoke.py's LONG_EXPECTED.
EXPECTED = {
    ("fast", 15): {
        "contigs": 14487,
        "n50": 150,
        "total_length": 2170171,
        "sha256": "315cf5ae37dcdeca319589c236652073aef52bef5e5cb3b3077ad078a4edef35",
        "measures": {
            "Number of Contigs": 14487,
            "Genome Coverage": 0.99986,
            "N50": 150,
            "Mismatch Rate Aligned Regions": 0.23771327985918028,
            "Mismatch Rate Genome Level": 0.23782,
        },
    },
    ("exact", 15): {
        "contigs": 11901,
        "n50": 150,
        "total_length": 1814753,
        "sha256": "cf4f0c279017e061011d12c28c90355692a6a2c6cc3c5db12d5d9dd82a25568d",
        "measures": {
            "Number of Contigs": 11901,
            "Genome Coverage": 0.99986,
            "N50": 150,
            "Mismatch Rate Aligned Regions": 0.7057188006320885,
            "Mismatch Rate Genome Level": 0.70576,
        },
    },
    ("fast", 5): {
        "contigs": 14136,
        "n50": 150,
        "total_length": 2138221,
        "sha256": "9b7bf6bd9c8c482b76b022f502f864427c8451a8cf41925207d343294ef7371a",
        "measures": {
            "Number of Contigs": 14136,
            "Genome Coverage": 0.99986,
            "N50": 150,
            "Mismatch Rate Aligned Regions": 0.23809333306662933,
            "Mismatch Rate Genome Level": 0.2382,
        },
    },
    ("exact", 5): {
        "contigs": 3147,
        "n50": 175,
        "total_length": 582031,
        "sha256": "032139f5a04f122be19a29f66b507e1f307fb58258a33890c54262b73c8452f2",
        "measures": {
            "Number of Contigs": 3147,
            "Genome Coverage": 0.9997,
            "N50": 175,
            "Mismatch Rate Aligned Regions": 0.9657497249174752,
            "Mismatch Rate Genome Level": 0.96576,
        },
    },
}


def long_inputs(g: int = G, n: int = N, l: int = READ_LENGTH, p: float = P):
    """(genome, reads): ``long_genome_demo.py``'s seeded inputs."""
    from genome_assembly_tpu_torch.simulate import (
        generate_error_free_reads,
        generate_error_prone_reads,
    )

    rng = random.Random(GENOME_SEED)
    genome = "".join(rng.choice("ACGT") for _ in range(g))
    reads = generate_error_prone_reads(
        generate_error_free_reads(genome, l, n, rng=random.Random(READ_SEED)),
        p, rs=np.random.RandomState(ERROR_SEED))
    return genome, reads


def banded_check(contigs: list[str], genome: str, l: int, dev) -> dict:
    """The first CHECK_SAMPLE distinct contigs of at least l bases aligned
    banded and full width: how many details and positions agree."""
    from genome_assembly_tpu_torch.metrics.align_to_ref import (
        align_contigs_to_reference,
    )

    sample = [c for c in dict.fromkeys(contigs) if len(c) >= l][:CHECK_SAMPLE]
    t0 = time.perf_counter()
    d_band = align_contigs_to_reference(sample, genome, l, banded=True,
                                        device=dev)
    t_band = time.perf_counter() - t0
    t0 = time.perf_counter()
    d_full = align_contigs_to_reference(sample, genome, l, banded=False,
                                        device=dev)
    t_full = time.perf_counter() - t0
    ends = ("Start Position", "End Position")
    return {
        "sample": len(sample),
        "details_identical": sum(d_band[c] == d_full[c] for c in sample),
        "positions_identical": sum(
            tuple(d_band[c][e] for e in ends)
            == tuple(d_full[c][e] for e in ends) for c in sample),
        "banded_s": t_band,
        "full_width_s": t_full,
    }


def run_row(genome: str, reads: list[str], k: int, mode: str, device="cuda",
            full_delta: bool = True, expected: dict | None = None) -> dict:
    """One row of ``long_genome_demo.py`` on `device`, with ``equal``:
    whether contigs and measures equal `expected` (None without one), the
    full-width measures too when they were run, and every sampled contig's
    banded details the full-width ones on a fast row."""
    import torch

    from genome_assembly_tpu_torch.core.dispatch import resolve_device
    from genome_assembly_tpu_torch.metrics.measures import (
        calculate_measures,
        contig_summary,
    )
    from genome_assembly_tpu_torch.models.overlap_graph import (
        assemble_contigs_using_overlap_graphs,
    )
    from genome_assembly_tpu_torch.ops import overlap as op
    from genome_assembly_tpu_torch.ops import overlap_allpairs as oa
    from genome_assembly_tpu_torch.ops import smith_waterman as sw
    from genome_assembly_tpu_torch.utils.tracing import global_tracer

    dev = resolve_device(device)
    n, l = len(reads), len(reads[0])

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    tracer = global_tracer()
    tracer.reset()
    oa.launches = op.launches = 0
    sw.full_width_launches = sw.banded_launches = 0
    sync()
    t0 = time.perf_counter()
    contigs = assemble_contigs_using_overlap_graphs(
        reads, k=k, exact_parity=mode == "exact", device=dev)
    sync()
    t_asm = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        measures, _ = calculate_measures(
            contigs, reads, n, l, P, k, genome, f"long_{mode}_k{k}", 1,
            path=tmp, banded=True, device=dev)
        sync()
        t_metrics = time.perf_counter() - t0
        stages = dict(tracer.times)
        launches = {"overlap_pairs": op.launches,
                    "overlap_allpairs": oa.launches,
                    "sw_full_width": sw.full_width_launches,
                    "sw_banded": sw.banded_launches}
        got = {**contig_summary(contigs), "measures": measures}
        row = {
            "k": k, "mode": mode,
            "platform": dev.type,
            "card": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                     else None),
            "assembly_s": t_asm,
            "metrics_banded_s": t_metrics,
            "stages": stages,
            "num_contigs": len(contigs),
            "n50": measures["N50"],
            "coverage": float(measures["Genome Coverage"]),
            "mismatch_genome": float(measures["Mismatch Rate Genome Level"]),
            "launches": launches,
            **{key: got[key] for key in ("sha256", "total_length",
                                         "measures")},
        }
        equal = None if expected is None else got == expected
        if full_delta:
            t0 = time.perf_counter()
            m_full, _ = calculate_measures(
                contigs, reads, n, l, P, k, genome, f"long_{mode}_k{k}_fw",
                1, path=tmp, banded=False, device=dev)
            sync()
            t_fw = time.perf_counter() - t0
            row["full_width_metrics_s"] = t_fw
            row["full_width_measures"] = m_full
            row["full_width_launches"] = sw.full_width_launches - launches[
                "sw_full_width"]
            row["metric_delta_banded_minus_full"] = {
                "coverage": measures["Genome Coverage"]
                - m_full["Genome Coverage"],
                "mismatch_genome": measures["Mismatch Rate Genome Level"]
                - m_full["Mismatch Rate Genome Level"],
                "n50": measures["N50"] - m_full["N50"],
            }
            row["banded_speedup_metrics"] = t_fw / max(t_metrics, 1e-9)
            if expected is not None:
                equal = equal and m_full == expected["measures"]
    if mode == "fast":
        check = banded_check(contigs, genome, l, dev)
        row["banded_check"] = check
        if expected is not None:
            equal = equal and (check["details_identical"]
                               == check["positions_identical"]
                               == check["sample"])
    row["equal"] = equal
    return row


def build(device) -> None:
    """Build the path's kernels and the C++ engine before the first row."""
    from genome_assembly_tpu_torch.core.dispatch import resolve_device
    from genome_assembly_tpu_torch.native import graphcore
    from genome_assembly_tpu_torch.ops import overlap as op
    from genome_assembly_tpu_torch.ops import overlap_allpairs as oa
    from genome_assembly_tpu_torch.ops import smith_waterman as sw

    if resolve_device(device).type == "cuda":
        for load in (oa.load_kernel, op.load_kernel, sw.load_kernel):
            load()
    graphcore.load()


def main(argv: list[str]) -> int:
    g = int(argv[0]) if len(argv) > 0 else G
    n = int(argv[1]) if len(argv) > 1 else N
    l = int(argv[2]) if len(argv) > 2 else READ_LENGTH
    default_size = (g, n, l) == (G, N, READ_LENGTH)
    skip = set(filter(None, os.environ.get("LONG_GENOME_SKIP",
                                           "").split(",")))
    full_delta = os.environ.get("LONG_GENOME_FULL_DELTA", "1") == "1"
    build("cuda")
    genome, reads = long_inputs(g, n, l)
    out = {"G": g, "N": n, "l": l, "p": P, "platform": "cuda", "rows": []}
    path = os.environ.get("LONG_GENOME_OUT", DEFAULT_OUT)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    for mode, k in ROWS:
        if f"{mode}:{k}" in skip:
            continue
        row = run_row(genome, reads, k, mode, device="cuda",
                      full_delta=full_delta,
                      expected=EXPECTED[mode, k] if default_size else None)
        out["rows"].append(row)
        print(json.dumps(row), flush=True)
        with open(path, "w", encoding="utf-8") as f:
            json.dump(out, f, indent=1)
    print("long-genome demo complete", flush=True)
    bad = [f"{r['mode']}:{r['k']}" for r in out["rows"]
           if r["equal"] is False]
    if bad:
        print(f"long_genome_demo_torch: rows {bad} differ from the JAX "
              f"package's", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
