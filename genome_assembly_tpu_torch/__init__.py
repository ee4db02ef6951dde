"""genome_assembly_tpu_torch — the PyTorch/CUDA port of genome_assembly_tpu.

The JAX package ``genome_assembly_tpu`` stays the reference; this package
computes the same contigs, measures and alignment details for the same
inputs, in PyTorch, with hand-written CUDA kernels for Hopper (sm_90a) in
place of the JAX package's Pallas TPU kernels. It never imports JAX or the
JAX package: host helpers it needs are copied here.

Module paths and public names mirror the JAX package:

- ``core``        int8 sequence encoding, config, device dispatch rules
- ``simulate``    read sampling + sequencing-error injection, on the host
                  and as torch ops with a ``torch.Generator``
- ``ops``         the hand kernels (``csrc/``: all-pairs and pair-list
                  overlap scoring, Smith-Waterman) and their plain PyTorch
                  versions, the gapped overlap DP as torch ops, and the
                  host oracles
- ``graph``       the k-mer join, overlap-graph construction, cycle
                  removal, layout, the fast greedy layout, consensus
- ``models``      the three assembly families: the overlap-graph pipeline
                  (exact-parity and fast layouts), the string graph with its
                  Myers reduction, and the unitig pipeline
- ``metrics``     assembly quality measures (N50, coverage, mismatch rates)
- ``parallel``    meshes of ranks on ``torch.distributed``: sharded pair
                  scoring and the pipeline step, sequence-parallel
                  Smith-Waterman, the two-stage build pipeline, and a
                  spawn launcher for ranks sharing one card
- ``experiments`` ``test_assembly`` (one assemble-and-measure run) and
                  ``test_assembly_new_pipeline`` (its string-graph twin), the
                  sweep runners (``run_for_params``,
                  ``run_simulations_parallel``: spawned workers sharing
                  the card) and the three-experiment harness
- ``persist``     results.csv / summary.csv, written and read with the
                  standard library, byte- and record-equal to the JAX
                  package's pandas route
- ``plots``       the matplotlib and pandas plot suite, imported only when
                  plots are drawn
- ``utils``       stage timing; ``utils.tracing.profile``, a
                  torch.profiler trace of a block
- ``native``      the C++ graph engine (ctypes), built at first use
- ``__main__``    the CLI: ``python -m genome_assembly_tpu_torch
                  assemble|experiments ... [--device cuda|cpu]``

Public entry points take ``device="cuda"`` by default and raise when no
card is present; pass ``device="cpu"`` to run on the host.
"""

__version__ = "0.1.0"
