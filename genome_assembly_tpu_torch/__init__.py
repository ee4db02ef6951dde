"""genome_assembly_tpu_torch — the PyTorch/CUDA port of genome_assembly_tpu.

The JAX package ``genome_assembly_tpu`` stays the reference; this package
computes the same contigs, measures and alignment details for the same
inputs, in PyTorch, with hand-written CUDA kernels for Hopper (sm_90a) in
place of the JAX package's Pallas TPU kernels. It never imports JAX or the
JAX package: host helpers it needs are copied here.

Module paths and public names mirror the JAX package:

- ``core``        int8 sequence encoding, config, device dispatch rules
- ``simulate``    host read sampling + sequencing-error injection
- ``ops``         the hand kernels (``csrc/``: all-pairs and pair-list
                  overlap scoring, Smith-Waterman) and their plain PyTorch
                  versions
- ``graph``       the k-mer join, overlap-graph construction, cycle
                  removal, layout, the fast greedy layout, consensus
- ``models``      the overlap-graph assembly pipeline (exact-parity and
                  fast layouts)
- ``metrics``     assembly quality measures (N50, coverage, mismatch rates)
- ``experiments`` ``test_assembly`` (one assemble-and-measure run), the
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
