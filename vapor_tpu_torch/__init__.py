"""vapor_tpu_torch - structural-variant validation on a CUDA card.

The PyTorch/CUDA port of vapor_tpu (long-read validation of structural
variants via k-mer recurrence plots).  The host side (I/O, SV grammar,
output) is pure Python; the per-(read x haplotype) scoring engine runs
as hand-written CUDA kernels for Hopper (sm_90a) with plain PyTorch
between them, and as the kernels' plain PyTorch versions on the CPU.

Layer map:
  io/       - indexed FASTA + BAM/BGZF readers, CIGAR clipping
  grammar/  - SV letter grammar
  engine/   - numpy oracle, host window refiner, fused engine + kernels
  stats/    - QS/GS/GT/GQ genotyping
  writers/  - .vapor TSV + annotated VCF output
  cli.py    - the bed subcommand
  sim/      - synthetic worklist builder
"""

__version__ = "0.1.0"
vapor_version = f"vapor-tpu-torch V{__version__}"
